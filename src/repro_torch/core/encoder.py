"""Port copy of ``repro.core.encoder``: host-side numpy, returning the
(B, C) int32 kernel input. Kept as a copy because importing ``repro``
loads JAX.

Query encoder — the paper's *Encoder* module (§4.1).

Adapts software data representations (raw ids, code-share fields) to the
dense dictionary-encoded form the accelerator consumes. Cross-matching
criteria (v2 §3.2.3/3.2.4) are resolved HERE: the marketing vs operating
carrier / flight-number is selected by the code-share indicator, so the
kernel stays a generic conjunction engine.

Vectorised (numpy) — in the deployed system this runs on the host,
pipelined with the previous batch's kernel execution.

Two paths give the same bytes. ``queries_to_arrays`` + ``encode`` is the
per-key path, a copy of the reference's: it gathers every key of every query
and rebuilds each dictionary's lookup on every batch. ``EncodePlan`` is the
online path: compiled from a table once, it reads a batch in one pass over its
rows and maps every categorical column in one gather.
"""
from __future__ import annotations

import operator
import struct
import threading
from itertools import starmap
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.compiler import OOV_CODE, CompiledRuleTable
from repro_torch.core.rules import WILDCARD


def queries_to_arrays(queries: Sequence[Dict[str, int]]) -> Dict[str, np.ndarray]:
    """AoS -> SoA: list of query dicts to arrays per field."""
    if not queries:
        return {}
    keys = set()
    for q in queries:
        keys.update(q.keys())
    return {k: np.asarray([q.get(k, 0) for q in queries], np.int64)
            for k in sorted(keys)}


def encode(table: CompiledRuleTable, fields: Dict[str, np.ndarray]
           ) -> np.ndarray:
    """Encode raw query fields into the (B, C) int32 kernel input."""
    n = len(next(iter(fields.values())))
    out = np.zeros((n, table.n_cols), np.int32)
    for j, col in enumerate(table.columns):
        if col.cross_fields is not None:
            # cross-matching (v2): select the query field by the code-share
            # indicator; the kernel stays a generic conjunction engine.
            primary, fallback, cs_f = col.cross_fields
            cs = fields[cs_f].astype(bool)
            raw = np.where(cs, fields[primary], fields[fallback]) \
                .astype(np.int64)
        else:
            src = col.source
            raw = fields[src].astype(np.int64)
        if col.kind == "cat":
            d = table.dictionaries[col.source]
            lut_keys = np.fromiter(d.keys(), np.int64, len(d))
            lut_vals = np.fromiter(d.values(), np.int64, len(d))
            codes = np.full(raw.shape, int(OOV_CODE), np.int64)
            if len(d):
                sort = np.argsort(lut_keys)
                pos = np.searchsorted(lut_keys[sort], raw)
                pos = np.clip(pos, 0, len(d) - 1)
                hit = lut_keys[sort][pos] == raw
                codes = np.where(hit, lut_vals[sort][pos], codes)
            out[:, j] = codes.astype(np.int32)
        else:  # range / range_lo / range_hi: raw numeric value
            out[:, j] = raw.astype(np.int32)
    return out


class EncodePlan:
    """The online encoder of one table: what ``encode`` works out on every
    batch, worked out once.

    - ``fields``: the query fields the table reads (every column's source,
      or its cross-field triple), in sorted order.
    - Per column, the field index of its source (a cross column's primary
      value), and per cross column those of its fallback and its
      code-share selector, so v2's cross-matching is one ``np.where`` over
      the batch.
    - The categorical columns' dictionaries as lookup arrays: a direct-index
      array with an out-of-range slot holding ``OOV_CODE`` where the keys
      span a range small next to the dictionary (``_DENSE_SLACK``), else
      the sorted keys and codes for ``searchsorted``.

    ``encode`` packs each query's fields into an int64 row (``struct``
    rejects what is not an integer or does not fit in 64 bits) and maps the
    batch with whole-array numpy operations. A batch it cannot read so, a
    query missing a field or a value that is not an integer, goes whole to
    the per-key path, which gives what it gives today, bytes or exception.
    Fields the table does not read are not read: the per-key path converts
    them too, and raises on one that is not an integer.

    ``n_plan`` and ``n_fallback`` count the batches encoded by each path;
    several threads may share one plan.
    """

    # direct-index lookup where a dictionary's key range is at most this
    # many times its size (plus a fixed allowance); sorted keys otherwise
    _DENSE_SLACK = 8
    _DENSE_FIXED = 1024

    def __init__(self, table: CompiledRuleTable):
        self.table = table
        cols = table.columns
        reads = [c.cross_fields or (c.source,) for c in cols]
        self.fields: Tuple[str, ...] = tuple(sorted({f for r in reads
                                                     for f in r}))
        at = {f: i for i, f in enumerate(self.fields)}
        self._src = np.array([at[r[0]] for r in reads], np.intp)
        cross = [j for j, r in enumerate(reads) if len(r) == 3]
        self._cross = np.array(cross, np.intp)
        self._fall, self._sel = (np.array([at[reads[j][k]] for j in cross],
                                          np.intp) for k in (1, 2))
        self._get = operator.itemgetter(*self.fields)
        self._pack = struct.Struct(f"={len(self.fields)}q").pack

        dense, lo, span, base, luts = [], [], [], [], []
        self._sorted = []
        n_lut = 0
        for j, c in enumerate(cols):
            if c.kind != "cat":
                continue
            d = table.dictionaries[c.source]
            keys = np.fromiter(d.keys(), np.int64, len(d))
            vals = np.fromiter(d.values(), np.int64, len(d)).astype(np.int32)
            k0 = int(keys.min()) if len(d) else 0
            n = int(keys.max()) - k0 + 1 if len(d) else 0
            if n > self._DENSE_SLACK * len(d) + self._DENSE_FIXED:
                order = np.argsort(keys)
                self._sorted.append((j, keys[order], vals[order]))
                continue
            # [code of k0, ..., code of k0 + n - 1, OOV]
            lut = np.full(n + 1, OOV_CODE, np.int32)
            lut[keys - k0] = vals
            dense.append(j)
            lo.append(k0)
            span.append(n)
            base.append(n_lut)
            luts.append(lut)
            n_lut += n + 1
        self._dense = np.array(dense, np.intp)
        self._lo = np.array(lo, np.int64)
        self._span = np.array(span, np.uint64)
        self._base = np.array(base, np.uint64)
        self._lut = (np.concatenate(luts) if luts
                     else np.zeros(0, np.int32))
        self._lock = threading.Lock()
        self.n_plan = 0
        self.n_fallback = 0

    def encode(self, queries: Sequence[Dict[str, int]]
               ) -> Tuple[np.ndarray, bool]:
        """(the (B, C) int32 kernel input, whether the per-key path made
        it). An empty batch gives a (0, C) array."""
        try:
            buf = b"".join(starmap(self._pack, map(self._get, queries)))
        except (KeyError, TypeError, struct.error):
            with self._lock:
                self.n_fallback += 1
            return encode(self.table, queries_to_arrays(queries)), True
        with self._lock:
            self.n_plan += 1
        raw = np.frombuffer(buf, np.int64).reshape(-1, len(self.fields))
        x = raw[:, self._src]
        x[:, self._cross] = np.where(raw[:, self._sel] != 0,
                                     x[:, self._cross], raw[:, self._fall])
        # range columns wrap as astype does; C order, as the kernel reads it
        # (the column gathers above leave x in F order)
        out = x.astype(np.int32, order="C")
        # a key's offset from the column's lowest key, read unsigned so that
        # one minimum sends a key below or above the range to the OOV slot;
        # an offset that wraps in int64 is out of range and wraps to below 0
        # or to at least the range
        off = (x[:, self._dense] - self._lo).view(np.uint64)
        out[:, self._dense] = self._lut[np.minimum(off, self._span)
                                        + self._base]
        for j, keys, vals in self._sorted:
            v = x[:, j]
            pos = np.searchsorted(keys, v).clip(0, len(keys) - 1)
            out[:, j] = np.where(keys[pos] == v, vals[pos], OOV_CODE)
        return out, False


def encode_queries(table: CompiledRuleTable,
                   queries: Sequence[Dict[str, int]]) -> np.ndarray:
    return EncodePlan(table).encode(queries)[0]
