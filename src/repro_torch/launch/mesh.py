"""Production and host meshes; the port of ``repro.launch.mesh``.

The production meshes are ``DeviceMesh``es over a *fake* process group:
16x16 = 256 ranks ``("data", "model")`` or 2x16x16 = 512 ranks ``("pod",
"data", "model")``.  The reference lowers its steps against 512 simulated
host devices; the port has one card, so it runs its steps on DTensors over a
fake group (collectives return at once, moving nothing) under
``FakeTensorMode`` (tensors carry shapes and no memory).  That group comes
from ``torch.testing._internal.distributed.fake_pg``, which is why this is
the one module of the port that imports it.

A process has one default group, so the fake group is made only by a
process that owns its start-up: the dry run (``launch/dryrun.py``), exactly
as the reference's dry run owns the 512-device flag.  A process that serves
or trains never calls these builders.  The group is made once, at the
largest size the process needs (:func:`fake_group`), and each mesh takes
its first ranks: DTensor caches its plans by mesh, and a mesh made again
over a new group would find plans that name the old group's members.  It
raises when a group not made here already exists, or when a larger mesh
is asked of a smaller group made here.

Functions, never module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

_OWNED: Optional[int] = None      # world size of the fake group made here


def fake_group(world: int) -> None:
    """Make this process's fake group of ``world`` ranks, or keep the one
    made here if it has at least that many."""
    global _OWNED
    if dist.is_initialized():
        if _OWNED is None:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks already "
                f"exists; the {world}-rank fake mesh needs a process of its "
                "own")
        if _OWNED < world:
            raise RuntimeError(
                f"the fake group made here has {_OWNED} ranks, fewer than "
                f"{world}: make the largest first (fake_group)")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _OWNED = world


def release() -> None:
    """Tear down the fake group made here (no-op otherwise)."""
    global _OWNED
    if _OWNED is not None and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = None


def make_fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                   device: DeviceLike = None) -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the fake
    group (made at that size if there is none); ``device`` (``cuda``
    unless named) is the device type its fake tensors carry."""
    dev = resolve_device(device)
    world = 1
    for n in shape:
        world *= n
    fake_group(world)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model).  Over a fake
    group."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_fake_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """What this host offers: ``(torch.cuda.device_count(), 1)`` on the
    card, (1, 1) when the caller asks for the CPU.  Needs the process's
    default group of that many ranks to exist."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return init_device_mesh(dev.type, (n, 1),
                            mesh_dim_names=("data", "model"))
