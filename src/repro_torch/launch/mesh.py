"""Device meshes (port of ``repro/launch/mesh.py``): functions, never a
module-level mesh, so importing this module touches no process group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
current process group (one device a rank), with the reference's axis names.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} {axes} needs {need} "
                         f"ranks; this process group has {world}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device="cuda") -> DeviceMesh:
    """(world // model, model) ("data", "model") over every rank of the
    current process group (tests, examples, one card)."""
    n = dist.get_world_size()
    assert n % model == 0
    return init_device_mesh(torch.device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of the "fake" backend with ``world`` ranks,
    this process rank 0, for the dry runs: every collective completes at
    once without sending a byte (``utils.comms`` still sees it), so
    :func:`make_production_mesh` builds its 256- or 512-rank mesh in one
    process. Destroyed on exit, also when the body raises. Raises if a
    default group already exists: it never reuses one."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; the "
                           "fake world needs a process without one")
    # importing the module registers the backend with c10d
    from torch.testing._internal.distributed import fake_pg
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=fake_pg.FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
