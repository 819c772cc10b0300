"""Elastic scaling (port of ``repro/ft/elastic.py``, DESIGN.md §6): move
checkpointed state onto a mesh of another extent.

Because shardings are derived from logical rules (``sharding/rules.py``),
any mesh whose axis sizes divide the logical dims is valid — growing or
shrinking the ("pod", "data") extent only changes the spec resolution. The
elastic path is therefore: checkpoint (saved whole) → build the new mesh →
re-derive the specs → :func:`reshard` the restored host state onto it.
:func:`plan_remesh` picks the largest usable device count (whole
data-parallel replicas) after failures.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import rules


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    n_devices: int
    data: int
    model: int

    def make(self, device="cuda") -> DeviceMesh:
        """The (data, model) mesh over the ranks of the current process
        group, which must have ``n_devices`` of them."""
        world = dist.get_world_size()
        if world != self.n_devices:
            raise ValueError(f"{self} needs {self.n_devices} ranks; this "
                             f"process group has {world}")
        return make_host_mesh(model=self.model, device=device)


def plan_remesh(n_alive: int, model_parallel: int) -> MeshPlan:
    """Largest mesh using whole model-parallel groups on alive devices."""
    assert n_alive >= model_parallel, "fewer devices than one model replica"
    data = n_alive // model_parallel
    return MeshPlan(n_devices=data * model_parallel, data=data,
                    model=model_parallel)


def reshard(state: dict, mesh: DeviceMesh, specs: dict) -> dict:
    """Host (or old-mesh full) state -> ``mesh``: ``specs`` has ``state``'s
    structure, a leaf a ``rules.Spec``; that leaf becomes a DTensor of the
    spec's placements, each rank copying its own block of the full tensor
    to the mesh's device (no collective). A leaf without a spec (AdamW's
    ``step``) is copied whole to the device on every rank, as the trainer
    keeps it."""
    dev = torch.device(mesh.device_type)
    out = {}
    for k, v in state.items():
        s = specs.get(k)
        v = v if isinstance(v, dict) else torch.as_tensor(v)
        if isinstance(v, dict):
            out[k] = reshard(v, mesh, s or {})
        elif s is None:
            out[k] = v.to(dev, copy=True)
        else:
            out[k] = rules.place(v, mesh, s.placements, dev)
    return out
