"""Gradient compression for the thin cross-pod hop (port of
``repro/optim/compression.py``).

int8 symmetric quantization with per-tensor scales and error feedback: the
quantization residual is carried to the next step so the compressed SGD
direction stays unbiased over time (Seide et al. / EF-SGD). Used as the
``grad_transform`` hook of ``train/step.py``, around the cross-pod sum:

    g_q, state = compress(g + state.residual)
    g_hat      = decompress(sum(g_q))          # 4x fewer bytes on the wire
    residual'  = (g + residual) - decompress(g_q)

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
and scales equal the reference's on the same input. Gradient trees are
nested dicts of tensors (``optim.adamw.tree_map``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import collectives
from repro_torch.optim.adamw import tree_map


class EFState(NamedTuple):
    residual: dict     # same tree as grads


def init_state(grads_like: dict) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, state: EFState
                  ) -> tuple[dict, dict, EFState]:
    """-> (q_tree, scale_tree, new_state). Error feedback included."""
    def one(g, r):
        gf = g.float() + r
        q, s = quantize(gf)
        return q, s, gf - dequantize(q, s)

    out = _map2(one, grads, state.residual)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out),
            EFState(residual=tree_map(lambda t: t[2], out)))


def decompress_tree(qs: dict, ss: dict) -> dict:
    return _map2(dequantize, qs, ss)


def make_compressed_psum(group=None):
    """The compressed cross-rank sum over ``group`` (default: the whole
    process group): fn(grads, state) -> (summed grads, state). The wire
    format is the int8 payload and a float32 scale: the codes are summed
    widened to int32 and the scales reduced by MAX (conservative), each
    through ``collectives.all_reduce``, and the sum is dequantised with
    that scale."""
    def fn(grads: dict, state: EFState):
        qs, ss, state = compress_tree(grads, state)

        def reduce(q, s):
            wide = q.to(torch.int32)
            collectives.all_reduce(wide, dist.ReduceOp.SUM, group=group)
            s = s.clone()
            collectives.all_reduce(s, dist.ReduceOp.MAX, group=group)
            return wide.float() * s

        return _map2(reduce, qs, ss), state
    return fn


def _map2(fn, a: dict, b: dict) -> dict:
    return {k: _map2(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}
