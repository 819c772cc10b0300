"""Activation layouts and the per-block weight gather on a mesh (port of
``repro/sharding/act.py``).

The reference pins activations to batch-sharded layouts at layer
boundaries (``constrain``, and ``constrain_expert`` on MoE dispatch
buffers): batch over the data axes, replicated over "model". GSPMD then
gathers FSDP-sharded weights over the data axes (ZeRO-style) and computes
each rank's slice of every block over "model" in place (Megatron style):
attention heads, the MLP's d_ff, the MoE experts and the vocab, as
``rules.param_specs`` places them.

The port runs that plan by hand. Each rank computes on its own batch shard
as plain tensors. A block gathers its ``DTensor`` parameters just before
it runs, over the data axes only: ``redistribute`` to ``Replicate`` there,
the "model" placement kept, then ``to_local(grad_placements=...)`` with
``Partial("avg")`` over the data axes (each rank's loss is the mean of its
shard) and the parameter's own placement over "model". Autograd turns the
gradient into the parameter's placements: a reduce-scatter over the data
axes, nothing over "model". Inside ``layers.remat`` the backward's
recompute gathers again, as ZeRO-3 does.

Over "model" (size > 1) every family keeps each rank's slice and
computes with it (the model and block modules set ``tensor_parallel =
True``, which :func:`is_tensor_parallel` reads), and
:func:`tensor_parallel` tells the layers so: attention's heads, the MLP's
d_ff, the MoE experts and the vocab (dense, MoE, recurrentgemma's local
attention, whisper), rwkv6's heads and channel-mix columns, the RG-LRU's
channels. The layout changes at these points, the Megatron pair, two
gathers and the reference's expert constraint:

  * :func:`enter` (Megatron's f): a replicated activation enters a
    column-parallel product: identity forward, sum over "model" backward;
  * :func:`constrain` (Megatron's g): a row-parallel product's partial sums
    join the reference's layout: sum over "model" forward, identity
    backward;
  * :func:`gather_model`: the rank's columns of a projected activation
    gathered over "model", where each rank then computes a different part
    from the whole (attention's heads where the heads or K/V heads do not
    divide "model", the RG-LRU's gates from every channel of ``u``):
    reduce-scatter backward;
  * :func:`gather_replicated`: the same gather where every rank then
    computes the same thing from the whole (rwkv6's channel-mix
    receptance, its projections where its heads do not divide "model"):
    the rank's slice of the gradient backward, no collective (Megatron's
    ``gather_from_tensor_model_parallel_region``);
  * :func:`constrain_expert`: the rank's experts' tile of a replicated
    dispatch buffer, built locally (no collective), as the reference's
    (B over data, E over model) layout lets every rank build it.

The collectives run on the mesh's "model" group through
``torch.distributed`` (functional all-reduces and reduce-scatters, the
in-place all-gather), so ``utils.comms.CollectiveCounter`` sees them.
No parameter split over "model" is gathered over "model".

The launchers enable the gather with ``with activation_sharding(mesh,
("pod", "data")): ...`` around a step. Without it, on plain parameters or
with a "model" axis of size 1, every function here changes nothing and
issues no collective: the models run exactly as on one device.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)
_TP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tensor_parallel", default=None)
_KV: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kv_split", default=None)

# torch >= 2.13 names them *_single; the older names remain (deprecated)
_reduce_scatter = getattr(funcol, "reduce_scatter_single", None) or \
    funcol.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class TP(NamedTuple):
    """The "model" axis as a block sees it: its process group, this rank's
    coordinate on it and its size (> 1), and where a decode step's KV cache
    is split over it (:func:`kv_split`)."""
    group: object
    rank: int
    size: int
    kv_split: Optional[str]


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes):
    """batch_axes: the mesh axis names the batch dim is sharded over."""
    tok = _CTX.set((mesh, tuple(batch_axes)) if mesh is not None else None)
    try:
        yield
    finally:
        _CTX.reset(tok)


@contextlib.contextmanager
def kv_split(where: Optional[str]):
    """A decode step's KV cache split over "model": ``"heads"`` (the KV
    heads, when they divide it), ``"seq"`` (the sequence, flash-decode
    style) or None (replicated over it)."""
    tok = _KV.set(where)
    try:
        yield
    finally:
        _KV.reset(tok)


def tensor_parallel() -> Optional[TP]:
    """The "model" axis while a tensor-parallel family's block or non-layer
    parameters run on a mesh whose "model" axis has more than one rank;
    None otherwise (the layers then run their single-device code)."""
    return _TP.get()


def _tp_of(ctx) -> Optional[TP]:
    mesh = ctx[0]
    names = mesh.mesh_dim_names
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return TP(mesh.get_group("model"), mesh.get_local_rank("model"),
              mesh.size(names.index("model")), _KV.get())


def _placements(ctx, p: DTensor, keep_model: bool):
    """(placements of the gathered tensor, its gradient's placements): the
    data axes replicated (gradient ``Partial("avg")``), "model" as the
    parameter's own with ``keep_model``, else replicated too."""
    mesh, batch_axes = ctx
    to, grad = [], []
    for a, pl in zip(mesh.mesh_dim_names, p.placements):
        if a in batch_axes:
            to.append(Replicate())
            grad.append(Partial("avg"))
        elif keep_model:
            to.append(pl)
            grad.append(pl)
        else:
            to.append(Replicate())
            grad.append(Replicate())
    return to, grad


def _local(ctx, p: DTensor, keep_model: bool) -> torch.Tensor:
    to, grad = _placements(ctx, p, keep_model)
    return p.redistribute(p.device_mesh, to).to_local(grad_placements=grad)


@contextlib.contextmanager
def _swap(ctx, targets, keep_model: bool):
    """Each (module, name) whose parameter is a DTensor holds its gathered
    local tensor for the duration; with ``keep_model`` (a tensor-parallel
    family on a "model" axis > 1) the context says so to the layers."""
    saved = []
    tp = _tp_of(ctx) if keep_model else None
    tok = _TP.set(tp)
    try:
        for mod, name in targets:
            p = mod._parameters[name]
            if isinstance(p, DTensor):
                saved.append((mod, name, p))
                mod._parameters[name] = _local(ctx, p, tp is not None)
        yield
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p
        _TP.reset(tok)


def _params_of(module: nn.Module):
    return [(m, n) for m in module.modules() for n in m._parameters
            if m._parameters[n] is not None]


def is_tensor_parallel(module: nn.Module) -> bool:
    """Whether ``module`` (a model or a block) belongs to a tensor-parallel
    family: one whose class sets ``tensor_parallel = True``."""
    return getattr(module, "tensor_parallel", False)


def gathering(fn):
    """``fn`` wrapped so that every ``nn.Module`` among its arguments (a
    block) has its DTensor parameters gathered while it runs: over the data
    axes, and over "model" too unless the block is tensor-parallel. ``fn``
    itself outside :func:`activation_sharding`. ``layers.remat`` wraps each
    block with it, so the recompute gathers again."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def run(*args):
        mods = [a for a in args if isinstance(a, nn.Module)]
        targets = [t for m in mods for t in _params_of(m)]
        tp = bool(mods) and all(map(is_tensor_parallel, mods))
        with _swap(ctx, targets, tp):
            return fn(*args)

    return run


@contextlib.contextmanager
def gathered(model: nn.Module, *names: str):
    """The model's non-layer parameters, gathered around its block loop:
    each name is a submodule of ``model`` (``embed``: the embedding and
    ``lm_head``; ``final_norm``) whose parameters are gathered, or a
    parameter of ``model`` itself (whisper's ``dec_pos``). With no names,
    every parameter of ``model`` (a block, in the decode steps' loops).
    A tensor-parallel ``model`` keeps its "model" shards and the body
    runs with :func:`tensor_parallel` set. No-op outside
    :func:`activation_sharding`."""
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
    with _swap(ctx, targets, is_tensor_parallel(model)):
        yield


@contextlib.contextmanager
def model_axis(model: nn.Module):
    """:func:`tensor_parallel` set for a tensor-parallel ``model``'s code
    that runs outside its blocks and :func:`gathered` (a serve step's
    logits), gathering nothing. No-op outside
    :func:`activation_sharding`."""
    ctx = _CTX.get()
    tp = ctx is not None and is_tensor_parallel(model)
    tok = _TP.set(_tp_of(ctx) if tp else None)
    try:
        yield
    finally:
        _TP.reset(tok)


# ------------------------------------------------ the "model" collectives --

def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return _wait(funcol.all_reduce(x.contiguous(), "sum", group))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """(...) -> (size, ...): every rank's tensor, stacked in rank order;
    the gradient reduce-scattered back (``same``: its rank's slice)."""
    @staticmethod
    def forward(ctx, x, group, size, rank, same):
        ctx.group, ctx.rank, ctx.same = group, rank, same
        # the in-place c10d op: gloo's functional all-gather of CUDA
        # tensors crashes (torch 2.11), its in-place one runs
        return _gather0(x, group, size).view((size,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        if ctx.same:
            return g[ctx.rank], None, None, None, None
        g = g.contiguous()
        out = _wait(_reduce_scatter(g.reshape((-1,) + tuple(g.shape[2:])),
                                    "sum", 0, ctx.group))
        return out.reshape(g.shape[1:]), None, None, None, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x`` (replicated over "model") unchanged, its
    gradient summed over "model" (each rank's column-parallel product
    contributes a part). Identity without :func:`tensor_parallel`."""
    tp = _TP.get()
    return x if tp is None else _Enter.apply(x, tp.group)


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g, where the reference pins its layout: the partial sums
    of a row-parallel product summed over "model" (batch over data,
    replicated over "model"); the gradient passes unchanged. Identity
    without :func:`tensor_parallel`."""
    tp = _TP.get()
    return x if tp is None else _Constrain.apply(x, tp.group)


def gather_model(x: torch.Tensor) -> torch.Tensor:
    """Every "model" rank's ``x`` (of one shape), stacked on a new leading
    dim in rank order; the gradient reduce-scattered back. Right where
    each rank goes on to compute a different part from the gathered
    tensor (its own heads, its own columns of a weight), so that the
    rank's gradient of it is a partial sum: attention's q / K / V / head
    outputs where the heads do not divide "model", the RG-LRU's ``u``
    entering the rank's columns of ``w_a`` / ``w_x``."""
    tp = _TP.get()
    return _Gather.apply(x, tp.group, tp.size, tp.rank, False)


def gather_replicated(x: torch.Tensor) -> torch.Tensor:
    """:func:`gather_model`'s forward, with the rank's slice of the
    gradient backward and no collective. Right where every rank goes on to
    compute the same thing from the gathered tensor, so that its gradient
    is already whole and the same on every rank: rwkv6's channel-mix
    receptance (multiplied by the summed value), its r / k / v / g where
    its heads do not divide "model" (every rank then runs every head).
    :func:`gather_model` there would sum ``size`` equal gradients."""
    tp = _TP.get()
    return _Gather.apply(x, tp.group, tp.size, tp.rank, True)


def gather_cat(x: torch.Tensor, dim: int = -1, same: bool = False
               ) -> torch.Tensor:
    """Every "model" rank's ``x`` concatenated along ``dim`` in rank order
    (the rank's columns of an activation, its block of a cache leaf ->
    the whole): :func:`gather_replicated` with ``same``, else
    :func:`gather_model`."""
    full = (gather_replicated if same else gather_model)(x)
    dim = dim % x.dim()
    return full.movedim(0, dim).reshape(*x.shape[:dim], -1,
                                        *x.shape[dim + 1:])


def own_block(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """The rank's ``n`` entries of ``x`` along ``dim`` (a replicated
    tensor's block, as ``rules`` splits it over "model"): a view, no
    collective."""
    return x.narrow(dim, _TP.get().rank * n, n)


def reduce_model(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over "model" (``"sum"`` or ``"max"``), no gradient
    (a stabiliser's max, a decode step's combine)."""
    tp = _TP.get()
    if tp is None:
        return x
    return _wait(funcol.all_reduce(x.detach().contiguous(), op, tp.group))


def _gather0(x: torch.Tensor, group, size: int) -> torch.Tensor:
    y = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(y, x.contiguous(), group=group)
    return y


def whole_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the rank's rows of a batch) -> every row of the batch in
    order, gathered over the data axes (innermost first), no gradient: a
    decode step's MoE groups the whole batch, as the reference's does.
    ``x`` itself outside :func:`activation_sharding`."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, batch_axes = ctx
    for a in reversed(batch_axes):
        n = mesh.size(mesh.mesh_dim_names.index(a))
        if n > 1:
            x = _gather0(x.detach(), mesh.get_group(a), n)
    return x


def batch_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's ``n`` rows of the whole batch ``x`` (:func:`whole_batch`'s
    inverse)."""
    ctx = _CTX.get()
    if ctx is None or x.shape[0] == n:
        return x
    mesh, batch_axes = ctx
    i = 0
    for a in batch_axes:
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return x.narrow(0, i * n, n)


def constrain_expert(x: torch.Tensor, n: int, axis: int = 1
                     ) -> torch.Tensor:
    """The rank's experts' tile of a dispatch buffer whose ``axis`` holds
    every expert's slots in order (replicated over "model"): its ``n``
    entries at the rank's place, as ``rules`` splits the experts over
    "model". Built locally: no collective. Call it only where the experts
    are split over "model" (:func:`tensor_parallel` set)."""
    return own_block(x, n, axis)
