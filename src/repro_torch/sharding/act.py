"""The mesh trainer's per-layer weight gather (port of
``repro/sharding/act.py``).

The reference pins activations to batch-sharded layouts at layer
boundaries (``constrain``, and ``constrain_expert`` on MoE dispatch
buffers) so that GSPMD picks the ZeRO-style weight all-gather strategy for
FSDP-sharded weights, and not a contracting-dim one (activations replicated
over batch, per-layer all-reduces). The port runs that strategy by hand:
each rank computes on its own batch shard as plain tensors, and each block
gathers its ``DTensor`` parameters just before it runs
(``w.full_tensor(grad_placements=...)``). The gradient comes back
``Partial("avg")`` over the batch axes (each rank's loss is the mean of its
shard) and ``Replicate()`` over "model" (every model rank holds the same
batch shard), and autograd turns it into the parameter's own placements: a
reduce-scatter over the data axes. Inside ``layers.remat`` the backward's
recompute gathers again, as ZeRO-3 does, so no gathered weight is kept
between a block's forward and its backward.

``constrain`` and ``constrain_expert`` have no counterpart and no call
sites: an activation is always the rank's local batch shard, a plain
tensor, so there is no layout to pin.

The serve steps on a mesh (``serve/step.py``) gather the same way
without ``layers.remat``: each family's decode step gathers its non-layer
parameters around the call and each block inside its loop
(``with gathered(blk): ...``).

The launchers enable the gather with ``with activation_sharding(mesh,
("pod", "data")): ...`` around a step. Without it, or on plain parameters,
:func:`gathering` and :func:`gathered` change nothing: the models run
exactly as on one device.
"""
from __future__ import annotations

import contextlib
import contextvars

from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes):
    """batch_axes: the mesh axis names the batch dim is sharded over."""
    tok = _CTX.set((mesh, tuple(batch_axes)) if mesh is not None else None)
    try:
        yield
    finally:
        _CTX.reset(tok)


def _grad_placements(ctx) -> list:
    mesh, batch_axes = ctx
    return [Partial("avg") if a in batch_axes else Replicate()
            for a in mesh.mesh_dim_names]


@contextlib.contextmanager
def _swap(targets, grad_placements):
    """Each (module, name) whose parameter is a DTensor holds its gathered
    local tensor for the duration."""
    saved = []
    try:
        for mod, name in targets:
            p = mod._parameters[name]
            if isinstance(p, DTensor):
                saved.append((mod, name, p))
                mod._parameters[name] = p.full_tensor(
                    grad_placements=grad_placements)
        yield
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


def _params_of(module: nn.Module):
    return [(m, n) for m in module.modules() for n in m._parameters
            if m._parameters[n] is not None]


def gathering(fn):
    """``fn`` wrapped so that every ``nn.Module`` among its arguments (a
    block) has its DTensor parameters gathered while it runs: the block's
    functional code sees the full weights as plain tensors. ``fn`` itself
    outside :func:`activation_sharding`. ``layers.remat`` wraps each block
    with it, so the recompute gathers again."""
    ctx = _CTX.get()
    if ctx is None:
        return fn
    grad_placements = _grad_placements(ctx)

    def run(*args):
        targets = [t for a in args if isinstance(a, nn.Module)
                   for t in _params_of(a)]
        with _swap(targets, grad_placements):
            return fn(*args)

    return run


@contextlib.contextmanager
def gathered(model: nn.Module, *names: str):
    """The model's non-layer parameters, gathered around its block loop:
    each name is a submodule of ``model`` (``embed``: the embedding and
    ``lm_head``; ``final_norm``) whose parameters are gathered, or a
    parameter of ``model`` itself (whisper's ``dec_pos``). With no names,
    every parameter of ``model`` (a block, in the decode steps' loops).
    No-op outside :func:`activation_sharding`."""
    ctx = _CTX.get()
    if ctx is None:
        yield
        return
    targets = [] if names else _params_of(model)
    for name in names:
        if name in model._parameters:
            targets.append((model, name))
        else:
            targets += _params_of(getattr(model, name))
    with _swap(targets, _grad_placements(ctx)):
        yield

