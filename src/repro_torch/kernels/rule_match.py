"""Rule-match kernel for Hopper: build, binding and wrapper.

``rule_match`` keeps the signature and criterion-major layout of
``repro.kernels.rule_match.rule_match_pallas``. On a CUDA tensor it launches
the hand-written kernel of ``csrc/rule_match.cu`` (notes on its design and
bound are in that file) or raises; on a CPU tensor it runs the plain PyTorch
version in ``ref.py``. There is no fall back from the one to the other.

The kernel is compiled with nvcc for ``sm_90a`` at first use, from the
package's own source, into ``build/repro_torch_kernels/`` at the root of the
checkout, keyed by a hash of the source, and bound with ``ctypes`` through a
plain C interface. ctypes releases the interpreter lock during the call, so
worker threads that share an engine launch concurrently.
"""
from __future__ import annotations

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

_build_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
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
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"rule_match_{key}.so"
        t0 = time.perf_counter()
        log = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.rule_match_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.rule_match_launch.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                          log=log)
        _lib = lib
        return lib


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

    B % tile_b == 0 and R % tile_r == 0 (ops.py pads).
    Returns (best_w (1, B), best_i (1, B)).
    """
    C, B, R = _check(queries_t, mins_t, maxs_t, weights, tile_b, tile_r)
    dev = queries_t.device
    if dev.type == "cpu":
        w, i = ref_mod.rule_match_ref(queries_t.T, mins_t.T, maxs_t.T,
                                      weights[0])
        return w[None], i[None]
    if dev.type != "cuda":
        raise ValueError(f"rule_match runs on CUDA or CPU tensors, not {dev}")
    if not 1 <= C <= MAX_CRIT or not 1 <= tile_b <= 1024:
        raise ValueError(f"the kernel takes 1..{MAX_CRIT} criteria and "
                         f"1..1024 queries a block (C={C}, tile_b={tile_b})")
    lib = build()
    q, mn, mx, w = (t.contiguous() for t in (queries_t, mins_t, maxs_t, weights))
    n_tiles = R // tile_r
    part_w = torch.empty((n_tiles, B), dtype=torch.int32, device=dev)
    part_i = torch.empty((n_tiles, B), dtype=torch.int32, device=dev)
    out_w = torch.empty((1, B), dtype=torch.int32, device=dev)
    out_i = torch.empty((1, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rule_match_launch(
            q.data_ptr(), mn.data_ptr(), mx.data_ptr(), w.data_ptr(),
            part_w.data_ptr(), part_i.data_ptr(), out_w.data_ptr(),
            out_i.data_ptr(), C, B, R, tile_b, tile_r, stream)
    if err != 0:
        raise RuntimeError(f"rule_match kernel launch failed: CUDA error {err}")
    with _count_lock:
        rule_match.launches += 1
    return out_w, out_i


rule_match.launches = 0   # kernel launches since the last reset
