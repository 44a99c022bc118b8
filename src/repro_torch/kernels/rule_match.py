"""Rule-match kernel for Hopper: packed table, build, binding and wrappers.

``rule_match_packed`` is the entry the main path calls, on the table that
``pack`` lays out once per upload: bounds ``(C, R, 2)`` of ``(base, span)``
pairs in the kernel's criterion order ``criterion_order``, and weights with
-1 for rules that can never match. ``rule_match`` keeps the signature and
criterion-major layout of ``repro.kernels.rule_match.rule_match_pallas`` by
packing on the fly. On a CUDA tensor both launch the hand-written kernel of
``csrc/rule_match.cu`` (notes on its design and bound are in that file) or
raise; on a CPU tensor they run the plain PyTorch version in ``ref.py``.
There is no fall back from the one to the other.

The kernel is compiled with nvcc for ``sm_90a`` at first use, from the
package's own source, into ``build/repro_torch_kernels/`` at the root of the
checkout, keyed by a hash of the source, and bound with ``ctypes`` through a
plain C interface. ctypes releases the interpreter lock during the call, so
worker threads that share an engine launch concurrently.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels import ref as ref_mod

SOURCE = Path(__file__).resolve().parent / "csrc" / "rule_match.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_CRIT = 64
# Batches up to this the launch sorts itself, with a one-block bitonic sort
# in 16 KB of shared memory (kSortMax in csrc/rule_match.cu); above it
# torch.argsort's radix sort is the faster (chip_smoke.py phase 5 times both
# at B = 256, 1024 and 4096).
SORT_MAX = 2048
# Bound values at or above this are the compiler's sentinels (the OOV code
# INT32_MAX - 2 and the wildcard top INT32_MAX - 1), not codes.
SENTINEL_FLOOR = 2 ** 31 - 3

_build_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_plans: dict = {}
build_info: dict = {}   # seconds, path and ptxas report of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the rule-match kernel is built with "
                       "the CUDA toolkit on the machine with the card")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library. nvcc
    writes a shared library under BUILD_DIR, and ptxas's report beside it."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        so = BUILD_DIR / f"rule_match_{key}.so"
        log_file = so.with_suffix(".log")
        t0 = time.perf_counter()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
            log_file.write_text(log)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.rule_match_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.rule_match_plan.restype = ctypes.c_int
        lib.rule_match_packed_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.rule_match_packed_launch.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                          log=log_file.read_text() if log_file.exists()
                          else "")
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# The packed table
# ---------------------------------------------------------------------------


def criterion_order(mins_t: torch.Tensor, maxs_t: torch.Tensor
                    ) -> torch.Tensor:
    """The kernel's criterion order, most selective first, from the table
    alone: for each criterion, the mean over rules of the share of its
    finite code range (the bound values below ``SENTINEL_FLOOR``) that the
    rule's interval covers. Exact integer sums, so the order is the same on
    every device. mins_t/maxs_t: (C, R). Returns (C,) int32."""
    mn, mx = mins_t.long(), maxs_t.long()
    vals = torch.cat([mn, mx], dim=1)
    finite = vals < SENTINEL_FLOOR
    lo = torch.where(finite, vals, SENTINEL_FLOOR).amin(dim=1, keepdim=True)
    hi = torch.where(finite, vals, -2 ** 31).amax(dim=1, keepdim=True)
    hi = torch.maximum(hi, lo)             # no finite value: one-code range
    covered = (torch.minimum(mx, hi) - torch.maximum(mn, lo) + 1).clamp_min(0)
    share = covered.sum(dim=1).double() / (hi - lo + 1)[:, 0].double()
    return torch.sort(share, stable=True).indices.to(torch.int32)


def pack(mins_t, maxs_t, weights, crit_order):
    """Packed kernel table: bounds (C, R', 2) int32 of (base, span) with
    base = min and span = max - min as uint32 (two's complement in int32),
    rows in ``crit_order``; weights_k (R',) int32, -1 where some min > max.
    R' is R rounded up to even with never-matching rules (the kernel copies
    16-byte chunks of two rules)."""
    idx = crit_order.long()
    mn = mins_t.index_select(0, idx).long()
    span = maxs_t.index_select(0, idx).long() - mn
    valid = (span >= 0).all(dim=0)
    span = span.clamp_min(0)
    span = torch.where(span >= 2 ** 31, span - 2 ** 32, span)
    bounds = torch.stack([mn, span], dim=-1).to(torch.int32)
    weights_k = torch.where(valid, weights.reshape(-1), -1).to(torch.int32)
    if bounds.shape[1] % 2:
        bounds = torch.cat([bounds, bounds.new_zeros((bounds.shape[0], 1, 2))],
                           dim=1)
        weights_k = torch.cat([weights_k, weights_k.new_full((1,), -1)])
    return bounds.contiguous(), weights_k.contiguous()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_packed(queries, bounds, weights_k, crit_order, order):
    if any(t.dtype != torch.int32
           for t in (queries, bounds, weights_k, crit_order)):
        raise TypeError("rule_match_packed takes int32 queries, bounds, "
                        "weights_k and crit_order")
    if order is not None and order.dtype != torch.int64:
        raise TypeError("order is an int64 permutation (argsort's dtype)")
    tensors = [queries, bounds, weights_k, crit_order] + \
        ([] if order is None else [order])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("rule_match_packed inputs must lie on one device")
    B, C = queries.shape
    if bounds.dim() != 3 or bounds.shape[0] != C or bounds.shape[2] != 2 \
            or weights_k.shape != (bounds.shape[1],) \
            or crit_order.shape != (C,) \
            or (order is not None and order.shape != (B,)):
        raise ValueError(
            f"shapes: queries {tuple(queries.shape)}, bounds "
            f"{tuple(bounds.shape)}, weights_k {tuple(weights_k.shape)}, "
            f"crit_order {tuple(crit_order.shape)}"
            + ("" if order is None else f", order {tuple(order.shape)}"))
    return B, C, bounds.shape[1]


def plan(dev, C, B, R) -> dict:
    """The grid the kernel picks for one call on ``dev`` (cached): runs of
    rules and their length, batch tiles, dynamic shared memory a block,
    resident blocks a SM, SMs, threads a block and queries a thread (two up
    to 32 criteria, one above)."""
    key = (dev.index, C, B, R)
    got = _plans.get(key)
    if got is None:
        lib = build()
        out = (ctypes.c_int * 8)()
        with torch.cuda.device(dev):
            err = lib.rule_match_plan(C, B, R, ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"rule_match plan refused: CUDA error {err}")
        got = _plans[key] = dict(zip(
            ("n_runs", "run", "n_btiles", "smem", "blocks_per_sm", "sms",
             "threads", "qpt"), list(out)))
    return got


def rule_match_packed(queries, bounds, weights_k, crit_order, order=None, *,
                      sort_col=None, tracer=None):
    """Match on the packed table.

    queries: (B, C) int32, any strides, in the caller's column order;
    bounds/weights_k/crit_order from ``pack``/``criterion_order``. The
    kernel takes the queries in the order ``order`` ((B,) int64
    permutation), or sorted by their code in column ``sort_col`` (a warp's
    queries then pass or fail the leading criterion together), or as they
    come; the results are in the caller's order either way. On the card the
    sort is a kernel of the same launch up to ``SORT_MAX`` queries (argsort
    above). Returns (best_w (B,), best_i (B,)).

    With a ``Tracer`` (``tracer``), the calling thread's laps go on with
    ``lane.sort`` (the argument checks and the argsort, only where the
    batch is sorted above ``SORT_MAX``: on the card the launch sorts the
    smaller ones itself, and the plain version's argsort stands for that)
    and ``lane.launch`` (the rest, through the kernel's launch).
    """
    B, C, R = _check_packed(queries, bounds, weights_k, crit_order, order)
    if order is not None and sort_col is not None:
        raise ValueError("pass order or sort_col, not both")
    dev = queries.device
    if dev.type == "cpu":
        if sort_col is not None:
            order = torch.argsort(queries[:, sort_col])
            if tracer is not None and B > SORT_MAX:
                tracer.lap("lane.sort")
        q = queries if order is None else queries[order]
        w, i = ref_mod.rule_match_packed_ref(q, bounds, weights_k, crit_order)
        if order is not None:
            w = torch.empty_like(w).index_copy_(0, order, w)
            i = torch.empty_like(i).index_copy_(0, order, i)
        if tracer is not None:
            tracer.lap("lane.launch")
        return w, i
    if dev.type != "cuda":
        raise ValueError(f"rule_match runs on CUDA or CPU tensors, not {dev}")
    if not 1 <= C <= MAX_CRIT:
        raise ValueError(f"the kernel takes 1..{MAX_CRIT} criteria (C={C})")
    if R % 2 or not (bounds.is_contiguous() and weights_k.is_contiguous()
                     and crit_order.is_contiguous()
                     and (order is None or order.is_contiguous())) \
            or bounds.data_ptr() % 16 or weights_k.data_ptr() % 16:
        raise ValueError("bounds and weights_k must be contiguous, 16-byte "
                         "aligned and hold an even rule count (pack does so)")
    if B == 0:
        return (torch.empty((0,), dtype=torch.int32, device=dev),) * 2
    if sort_col is not None and B > SORT_MAX:
        order, sort_col = torch.argsort(queries[:, sort_col]), None
        if tracer is not None:
            tracer.lap("lane.sort")
    out = _launch(queries, bounds, weights_k, crit_order, order, sort_col,
                  plan(dev, C, B, R))
    if tracer is not None:
        tracer.lap("lane.launch")
    return out


def _launch(queries, bounds, weights_k, crit_order, order, sort_col, grid):
    """One launch of sort (if ``sort_col``), pass 1 on the grid ``grid`` (a
    ``plan``) and pass 2; inputs checked by ``rule_match_packed``."""
    B, C = queries.shape
    R = bounds.shape[1]
    dev = queries.device
    lib = build()
    runs = grid["n_runs"]
    # one allocation: out_w, out_i, the sort's order (int64), the partials
    buf = torch.empty((2 * runs + 4) * B, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    if sort_col is not None:
        order_ptr = base + 8 * B
    else:
        order_ptr = None if order is None else order.data_ptr()
    part = base + 16 * B
    ctx = torch.cuda.device(dev) if dev.index != torch.cuda.current_device() \
        else contextlib.nullcontext()
    with ctx:
        err = lib.rule_match_packed_launch(
            queries.data_ptr(), queries.stride(0), queries.stride(1),
            order_ptr, -1 if sort_col is None else sort_col,
            crit_order.data_ptr(), bounds.data_ptr(), weights_k.data_ptr(),
            part, part + 4 * runs * B, base, base + 4 * B, C, B, R,
            grid["threads"], runs, grid["run"],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rule_match kernel launch failed: CUDA error {err}")
    with _count_lock:
        rule_match.launches += 1
    return buf[:B], buf[B:2 * B]


def _check(queries_t, mins_t, maxs_t, weights, tile_b, tile_r):
    tensors = (queries_t, mins_t, maxs_t, weights)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("rule_match takes int32 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("rule_match inputs must lie on one device")
    C, B = queries_t.shape
    if mins_t.shape[0] != C or maxs_t.shape != mins_t.shape \
            or weights.shape != (1, mins_t.shape[1]):
        raise ValueError(f"shapes: queries_t {tuple(queries_t.shape)}, "
                         f"mins_t {tuple(mins_t.shape)}, maxs_t "
                         f"{tuple(maxs_t.shape)}, weights {tuple(weights.shape)}")
    R = mins_t.shape[1]
    if B % tile_b or R % tile_r:
        raise ValueError(f"B={B} % tile_b={tile_b} and R={R} % tile_r={tile_r} "
                         "must be 0 (ops.py pads)")
    return C, B, R


def rule_match(queries_t, mins_t, maxs_t, weights, *, tile_b: int = 256,
               tile_r: int = 512):
    """queries_t: (C, B) int32; mins_t/maxs_t: (C, R); weights: (1, R).

    The Pallas kernel's signature: packs the table on the fly and runs
    ``rule_match_packed`` (the kernel tiles the batch and the rules itself;
    tile_b and tile_r only keep the Pallas shape contract).
    B % tile_b == 0 and R % tile_r == 0 (ops.py pads).
    Returns (best_w (1, B), best_i (1, B)).
    """
    _check(queries_t, mins_t, maxs_t, weights, tile_b, tile_r)
    dev = queries_t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rule_match runs on CUDA or CPU tensors, not {dev}")
    crit = criterion_order(mins_t, maxs_t)
    bounds, weights_k = pack(mins_t, maxs_t, weights, crit)
    w, i = rule_match_packed(queries_t.T, bounds, weights_k, crit)
    return w[None], i[None]


rule_match.launches = 0   # kernel launches since the last reset
