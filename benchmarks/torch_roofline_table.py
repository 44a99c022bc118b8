"""Roofline table from the port's dry-run records: three terms per (arch x
shape x mesh) cell against an H100's peaks (``repro_torch.launch.
roofline``); the counterpart of ``benchmarks/roofline_table.py``.

The records are those of ``python -m repro_torch.launch.dryrun`` (default
``artifacts/dryrun_torch/``); the markdown goes to
``build/torch_roofline_table.md``. The terms are bounds computed from the
dry run's counts, not measurements.

    PYTHONPATH=src python3 benchmarks/torch_roofline_table.py [--device cpu]
"""
from __future__ import annotations

from repro_torch.launch.roofline import load_all, table_markdown
from torch_common import BUILD, ROOT, Bench, cli

ART = ROOT / "artifacts" / "dryrun_torch"
OUT = BUILD / "torch_roofline_table.md"


def run(bench: Bench = None, *, art_dir=ART):
    """Returns the ``Roofline`` rows (empty without records)."""
    bench = bench or Bench.on()
    rows = load_all(art_dir)
    if not rows:
        bench.emit("roofline/missing", 0.0,
                   "run: python -m repro_torch.launch.dryrun --all "
                   "--mesh both")
        return []
    rows.sort(key=lambda r: (r.mesh, r.arch, r.shape))
    for r in rows:
        bench.emit(f"roofline/{r.arch}_{r.shape}_{r.mesh}", r.step_s * 1e6,
                   f"dom={r.dominant};comp={r.compute_s:.4g};"
                   f"mem={r.memory_s:.4g};coll={r.collective_s:.4g};"
                   f"useful={r.usefulness:.2f};mfu_bound={r.mfu_bound:.3f}",
                   compute_s=r.compute_s, memory_s=r.memory_s,
                   collective_s=r.collective_s, dominant=r.dominant)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(table_markdown(rows))
    bench.emit("roofline/table_written", 0.0, str(OUT))
    return rows


if __name__ == "__main__":
    run(cli(__doc__)[0])
