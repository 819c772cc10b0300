"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (port of ``repro/optim/adamw.py``), written out rather than taken
from ``torch.optim.AdamW``, whose step differs from the reference's: it
adds ``eps`` to ``sqrt(v)/sqrt(bc2)`` where the reference adds it to
``sqrt(v/bc2)``, applies the decay as ``p·(1 − lr·wd)`` before the step
where the reference takes ``p − lr·(m̂/(√v̂ + ε) + wd·p)`` in one
expression, and its parameter groups usually spare norms and biases,
which the reference decays too.

Trees are nested dicts of tensors (a model's ``dict(named_parameters())``
is a flat one); their leaves are visited in sorted-key order at every
level, the order of ``jax.tree_util.tree_leaves``. The scalars are float32
tensors, computed as the reference computes them (``b1 ** step`` and
``cos(π·prog)`` in float32, not in Python doubles). :func:`update` writes
the parameters and ``m`` / ``v`` in place under ``torch.no_grad()``: a
functional copy would hold a second set of parameters.

A leaf may be a ``DTensor`` (the mesh trainer's, ``launch/train.py``):
:func:`init` keeps its placements, :func:`global_norm` reduces each leaf's
sum of squares over the shards before adding it, and :func:`update`, being
elementwise on leaves of equal placements, runs on the local shards (no
DTensor dispatch, the same arithmetic per element).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree: dict, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, keys sorted at every level;
    paths ``/``-joined."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio·lr; float32."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps,
                                torch.clamp(warm, max=1.0), cos)


def init(params: dict) -> dict:
    """float32 ``m`` and ``v`` shaped (and, for DTensor leaves, placed) as
    ``params``, an int32 ``step`` on their device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = next(leaves(params))[1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares, added one
    leaf after another in :func:`leaves` order (a model's flat dict: its
    sorted parameter names), as the reference adds them in its tree
    order. A DTensor leaf's sum is reduced over its shards first (one
    all-reduce a sharded leaf)."""
    total = None
    for _, leaf in leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Scales ``grads`` by min(1, max_norm / norm); returns them and the
    norm before scaling. float32 leaves are scaled IN PLACE; a leaf of
    another dtype is replaced, in the returned tree, by its float32
    product, as the reference promotes ``g * scale``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(g):
        if g.dtype == torch.float32:
            _local(g).mul_(scale)
            return g
        return g.float() * scale
    return tree_map(clip, grads), norm


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: in-place writes reach the
    DTensor), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: AdamWConfig
           ) -> tuple[dict, dict, dict]:
    """One clipped AdamW step, in place on ``params``, ``state`` and (the
    clip) float32 ``grads``. Returns (params, state, metrics) as the reference
    does: the same objects, and ``lr`` and ``grad_norm`` as device
    scalars."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    state["step"] += 1
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    sf = state["step"].float()
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    for (kp, p), (kg, g), (km, m), (kv, v) in zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"]), strict=True):
        if not kp == kg == km == kv:
            raise KeyError(f"trees differ: {kp}, {kg}, {km}, {kv}")
        if isinstance(p, DTensor):
            if not (_placements(p) == _placements(g) == _placements(m)
                    == _placements(v)):
                raise ValueError(f"{kp}: placements differ: {_placements(p)}"
                                 f", {_placements(g)}, {_placements(m)}, "
                                 f"{_placements(v)}")
            p, g, m, v = p.to_local(), g.to_local(), m.to_local(), v.to_local()
        gf = g.float()
        t = torch.mul(gf, 1 - b1)
        m.mul_(b1).add_(t)                       # b1·m + (1-b1)·g
        torch.mul(gf, 1 - b2, out=t).mul_(gf)
        v.mul_(b2).add_(t)                       # b2·v + (1-b2)·g·g
        torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)
        u = torch.div(m, bc1).div_(t)            # m̂ / (√v̂ + ε)
        if p.dtype == torch.float32:
            u.add_(torch.mul(p, cfg.weight_decay, out=t))
            u.mul_(lr)
            p.sub_(u)
        else:
            # the reference's wd·p is in p's dtype (a weakly typed Python
            # float takes p's dtype), the rest in float32
            wd = torch.tensor(cfg.weight_decay, dtype=p.dtype,
                              device=p.device)
            u.add_(torch.mul(p, wd)).mul_(lr)
            p.copy_(p.float().sub_(u))           # p - lr·(…) in float32
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _placements(t) -> tuple:
    return tuple(t.placements) if isinstance(t, DTensor) else ()
