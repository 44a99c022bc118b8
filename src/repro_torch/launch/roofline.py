"""Roofline terms from dry-run records.

Port of ``repro.launch.roofline`` with an NVIDIA H100 in place of the
reference's TPU: the peaks below are the H100 SXM5 80GB data sheet's.

  compute term    = FLOPs(per device) / PEAK_FLOPS
  memory term     = bytes(per device) / HBM_BW
  collective term = ring-model wire bytes(per device) / LINK_BW

The per-device FLOPs, bytes and wire bytes come from the dry run's
``launch.cost_analysis`` (the ``"cost"`` entry of a record).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

# NVIDIA H100 SXM5 80GB data sheet: bf16 tensor-core peak, dense (no
# sparsity), at the 700 W power limit
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth
HBM_BW = 3.35e12
# one GPU's inter-node NIC, 400 Gb/s (NVIDIA ConnectX-7 / NDR InfiniBand,
# one per GPU in an 8-GPU HGX H100 node) = 50 GB/s: every 16-wide
# production axis spans two 8-GPU nodes, so the inter-node link sets the
# ring's pace (NVLink inside a node is faster)
LINK_BW = 50e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    flops: float
    bytes: float
    coll_wire_bytes: float
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time (no overlap assumed = max of terms;
        perfect overlap would be max, serial would be sum — report max)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def usefulness(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat/redundancy waste."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilisation upper bound at the roofline step time."""
        denom = self.step_s * PEAK_FLOPS * self.n_devices
        return self.model_flops / denom if denom else 0.0


def from_record(rec: dict) -> Optional[Roofline]:
    if not rec.get("ok"):
        return None
    c = rec["cost"]
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=c["flops"] / PEAK_FLOPS,
        memory_s=c["bytes"] / HBM_BW,
        collective_s=c["collective_wire_bytes"] / LINK_BW,
        model_flops=rec["model_flops"],
        flops=c["flops"], bytes=c["bytes"],
        coll_wire_bytes=c["collective_wire_bytes"],
        n_devices=rec["n_devices"])


def load_all(art_dir, variant: Optional[str] = "") -> List[Roofline]:
    """variant="" -> baseline records only; None -> everything."""
    out = []
    for p in sorted(Path(art_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if variant is not None and rec.get("variant", "") != variant:
            continue
        r = from_record(rec)
        if r is not None:
            out.append(r)
    return out


def table_markdown(rows: List[Roofline]) -> str:
    hdr = ("| arch | shape | mesh | compute(s) | memory(s) | collective(s) "
           "| dominant | MODEL/counted | MFU-bound |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        body += (f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.4g} "
                 f"| {r.memory_s:.4g} | {r.collective_s:.4g} "
                 f"| **{r.dominant}** | {r.usefulness:.2f} "
                 f"| {r.mfu_bound:.3f} |\n")
    return hdr + body
