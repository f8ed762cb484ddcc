"""Production meshes over a fake process group (port of
``repro/launch/mesh.py``).

The reference's dry-run asks XLA for 512 placeholder host devices
(``--xla_force_host_platform_device_count=512``) and lays its meshes out
on them.  The port's counterpart is PyTorch's fake process group
(``torch.testing._internal.distributed.fake_pg``): one process plays rank
0 of a 512-rank world whose collectives complete at once and move no
data, and each ``DeviceMesh`` is a sub-mesh of that world.  DTensors on
such a mesh hold rank 0's local shards, so tracing a step on them runs
exactly the local operations and collectives one chip would.

The group is made on the first mesh request, once per process; importing
this module never makes it.  A process that has initialised CUDA never
makes a fake mesh, and ``repro_torch.device.resolve_device`` refuses CUDA
in a process that has one: the dry-run and the card do not share a
process.

``make_mesh`` also lays a mesh over a real process group, where one of
gloo (a CPU mesh) or NCCL (a CUDA mesh) is initialised with exactly the
mesh's ranks: the sharded training path (``TrainLoop.run(shardings=...)``)
runs on it, as the reference's ``make_mesh`` lays out whatever devices
the process has.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.device import fake_group_active

#: ranks of the fake world: the reference's host device count
WORLD_SIZE = 512


def _ensure_group() -> None:
    import torch.distributed as dist
    if fake_group_active():
        return
    if dist.is_initialized():
        raise RuntimeError(
            f"a {dist.get_backend()!r} process group exists; the dry-run "
            "meshes need the fake group and their own process")
    if torch.cuda.is_initialized():
        raise RuntimeError("this process uses CUDA: make meshes in a "
                           "process of their own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD_SIZE)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if n > WORLD_SIZE:
        raise ValueError(f"mesh {shape} needs {n} ranks; the fake world "
                         f"has {WORLD_SIZE}")
    _ensure_group()
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


#: the device type of a mesh over each real backend
REAL_BACKENDS = {"gloo": "cpu", "nccl": "cuda"}


def _real_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A mesh over the initialised gloo or NCCL group, which must hold
    exactly the mesh's ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    if backend not in REAL_BACKENDS:
        raise RuntimeError(f"a {backend!r} process group exists; a mesh "
                           f"over real ranks needs one of "
                           f"{sorted(REAL_BACKENDS)}")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks; the {backend} "
                         f"process group has {world}")
    return init_device_mesh(REAL_BACKENDS[backend], shape,
                            mesh_dim_names=names)


def make_mesh(data: int, model: int, pod: int = 1):
    """Elastic mesh constructor for tests, small runs and scale-down: over
    the initialised gloo or NCCL group where there is one (of exactly
    ``pod * data * model`` ranks), else over the fake world."""
    import torch.distributed as dist
    if pod > 1:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    if dist.is_available() and dist.is_initialized() and \
            not fake_group_active():
        return _real_mesh(shape, names)
    return _mesh(shape, names)


def mesh_chip_count(mesh) -> int:
    return mesh.size()

