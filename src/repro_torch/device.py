"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``: the port runs
on the card unless the caller asks for the CPU, where the kernels' plain
PyTorch versions run instead. A CUDA device with no card present is an error,
never a silent fall back to the CPU. ``"meta"`` (shapes and dtypes, no
storage) is accepted only where the caller allows it (``meta_ok``): a
model's parameters for the dry run; it is never a default.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda", *, meta_ok: bool = False
                   ) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA card is present; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu") and not (meta_ok
                                                and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work; a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
