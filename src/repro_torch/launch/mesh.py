"""Meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``DeviceMesh`` over the first ``prod(shape)`` ranks of the
process group, its dims named by ``axes``.  The process group is set up
by ``init_distributed`` (one process per rank: NCCL on the card, gloo on
the CPU) or ``init_fake`` (one process standing for every rank of a fake
group, for meshes larger than the machine: the production meshes), never
at import.

Mesh geometry (the reference's TPU v5e target): 16x16 = 256 chips per pod;
the multi-pod mesh adds a leading "pod" axis (2 pods = 512 chips).  Axis
meaning:
  pod    slow inter-pod links (DCN) — data parallelism only
  data   intra-pod ICI — data parallelism / FSDP
  model  intra-pod ICI — tensor/expert parallelism (or pipeline stages)
"""
from __future__ import annotations

import datetime
import math
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import device as _device


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(rank: int = 0, world_size: int = 1,
                     init_method: str | None = None,
                     device=None, timeout_s: float | None = None
                     ) -> torch.device:
    """Join this process to the process group as ``rank`` of
    ``world_size``, on ``device`` (default: the card, raising without
    one; ``"cpu"`` selects gloo).  ``init_method`` is the rendezvous
    (``file://...`` or ``tcp://host:port``); it may be left out only for a
    world of one, which then meets on a free port of ``localhost``.
    ``timeout_s`` bounds the wait of every collective (torch's default
    otherwise).  Returns the rank's device."""
    dev = _device.resolve(device)
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_method is needed for a world of "
                             f"{world_size} ranks")
        init_method = f"tcp://localhost:{_free_port()}"
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            rank=rank, world_size=world_size, **kw)
    return dev


def init_fake(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this one process
    (rank 0): meshes and sharding specs can be built at any size, and no
    collective moves data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ranks ``0 .. prod(shape) - 1``
    (row-major), its dims named ``axes``, on ``device``'s type."""
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or "
                           "init_fake) first")
    have = dist.get_world_size()
    if have < n:
        raise ValueError(f"need {n} devices, have {have} "
                         "(is the process group large enough?)")
    dev = _device.resolve(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device=None) -> DeviceMesh:
    """Single-host debugging mesh (``model`` ranks; 1 by default)."""
    return make_mesh((1, model), ("data", "model"), device)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of any
    object with the reference's mesh interface (``.shape`` a dict, as the
    reference's tests pass a fake mesh)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))
