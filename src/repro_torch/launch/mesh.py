"""Device mesh construction.

Port of ``repro/launch/mesh.py`` on ``torch.distributed``.  Functions (not
module-level constants) so importing this module never touches a device or
a process group.  Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod: (2, 16, 16) = 512 ranks, axes (pod, data, model); 'pod' composes
with 'data' for hierarchical gradient reduction.

A mesh is one rank a device over the default process group.  When no group
exists, the functions start a world of one with an in-process ``HashStore``
(no network rendezvous); a multi-rank job starts its group first
(``torch.distributed.init_process_group`` with its own address, world size
and rank) and then calls them on every rank.  A dry run starts a fake world
instead (``start_fake_world``): one process that is rank 0 of 256 or 512.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _world(device: DeviceLike = None) -> Tuple[str, int]:
    """(device type, world size) of the default process group, which is
    started as a world of one (``HashStore``) when there is none."""
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        dist.init_process_group(_backend(device_type), store=dist.HashStore(), rank=0,
                                world_size=1)
    return device_type, dist.get_world_size()


def start_fake_world(world_size: int) -> None:
    """Make this process rank 0 of a world of ``world_size`` ranks in which
    no other rank exists: the ``"fake"`` backend of
    ``torch.testing._internal.distributed.fake_pg`` (a collective returns at
    once and moves nothing; with FakeTensors only shapes flow).  Then
    ``make_production_mesh`` builds the 16 x 16 mesh (256) or the 2 x 16 x
    16 one (512; a world of 512 holds both) without a card or a network.  A
    fake world already as large is kept; any other group raises."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= world_size:
            return
        raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks "
                           f"is running: cannot start a fake world of {world_size}")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _mesh(device_type: str, shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    n = math.prod(shape)
    if n == dist.get_world_size():
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    device_type, have = _world(device)
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; have {have}. Start the process group "
            f"with world size {n} first.")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model_parallel: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """Whatever the job has (tests / examples): a (world // mp, mp) mesh over
    ("data", "model"); ``device=None`` is the CUDA card (nccl), "cpu" gloo."""
    device_type, n = _world(device)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel groups of "
                         f"{model_parallel}")
    return _mesh(device_type, (n // model_parallel, model_parallel), ("data", "model"))
