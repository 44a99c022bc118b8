"""Process groups and production meshes.

Port of ``repro.launch.mesh``. Functions, not module-level constants:
importing this module touches no device and starts no process group.
:func:`init_distributed` brings the group up: NCCL on the card, gloo on the
CPU, and PyTorch's ``fake`` backend for the dry run, where one process
stands for every rank of a production mesh. Nothing on a machine tells a
program of its cluster, so the caller gives the world size, the rank and
the rendezvous address.
"""
from __future__ import annotations

import datetime
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda", *, world_size: int = 1, rank: int = 0,
                     init_method: Optional[str] = None,
                     timeout_s: float = 300.0) -> None:
    """Start the default process group for ``device``.

    ``device``: ``"cuda"`` (NCCL; raises without a card; rank ``r`` takes
    card ``r`` mod the host's cards), ``"cpu"`` (gloo) or ``"fake"`` (the
    dry run's backend: no peers, collectives return at once; its meshes
    are CPU meshes). ``init_method`` is the rendezvous (``file://...`` or
    ``tcp://host:port``); the default, a free localhost port, serves a
    one-process group only.
    """
    timeout = datetime.timedelta(seconds=timeout_s)
    if device == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size, timeout=timeout)
        return
    dev = resolve_device(device)
    if init_method is None:
        if world_size != 1:
            raise ValueError("a group of several ranks needs init_method")
        init_method = f"tcp://localhost:{_free_port()}"
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl", init_method=init_method, rank=rank,
            world_size=world_size, timeout=timeout,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        return
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the started group's ranks, its axes named."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh_for(n_devices: int, model_parallel: int = 0,
                  device_type: str = "cuda") -> DeviceMesh:
    """Best-effort (data, model) mesh over n_devices (tests, small runs)."""
    if model_parallel <= 0:
        model_parallel = 1
        for cand in (16, 8, 4, 2):
            if n_devices % cand == 0 and n_devices >= cand:
                model_parallel = cand
                break
    return make_mesh((n_devices // model_parallel, model_parallel),
                     ("data", "model"), device_type)


def batch_axes_of(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
