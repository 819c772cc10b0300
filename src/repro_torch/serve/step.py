"""Serve-step factories (port of ``repro/serve/step.py``): prefill (full
forward, last-position logits) and decode (one token against a KV cache or
recurrent state), for every model family.

The reference's ``_with_unroll`` patches ``lax.scan`` and has no
counterpart: the port runs its layers in a Python loop.

On a mesh (``mesh=``; the dry run's cells) the parameters are DTensors
placed by ``sharding.rules`` and every input is placed too (the batch by
``rules.batch_specs``, the cache by ``rules.cache_specs``). As the mesh
trainer, a rank computes on its own batch shard with plain tensors and
gathers the weights block by block over the data axes (``act.gathered``
in each family's decode loop, ``act.gathering`` in ``forward``).

Every family is tensor-parallel: it keeps the "model" shards, and a
decode step reads and writes the rank's block of each cache leaf in place,
split as ``cache_specs`` splits it (no leaf is gathered or re-split
around the step). A KV cache is split
over its KV heads where they divide "model" (the rank attends with its
heads), else over the sequence (the rank attends over its rows, the
partials combined over "model"; the new token written by the rank that
holds its position: recurrentgemma's K/V ring, KV = 1, whose writes at
``pos % window`` pass from the last rank's rows to rank 0's when the ring
wraps). Recurrent state is split by head (rwkv6's matrix state, or its
key dim where the heads do not divide "model") or by channel (the RG-LRU
and conv states, rwkv6's token shifts), and the families read each block
as it lies (``rwkv6.tm_step``). The logits of both steps are gathered
over the vocab for the last position alone.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models import get_family, layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.sharding import act


def _on_mesh(mesh):
    """The context a serve step runs in: on a mesh, the batch over the data
    axes, so that the families gather each block's weights when it runs."""
    if mesh is None:
        return contextlib.nullcontext()
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return act.activation_sharding(mesh, dp)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _tree(fn, tree):
    return ({k: _tree(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def _kv_split(cache: dict):
    """How a family's KV cache is split over "model": its ``k`` leaf's
    placement there (``"heads"``: dim 3, ``"seq"``: dim 2, None:
    replicated, or no KV cache: rwkv6's state is all its decode reads). A
    split over the head dim (4) has no attention route and raises."""
    k = cache.get("k")
    if not isinstance(k, DTensor) or "model" not in \
            k.device_mesh.mesh_dim_names:
        return None
    pl = k.placements[k.device_mesh.mesh_dim_names.index("model")]
    if not isinstance(pl, Shard):
        return None
    if pl.dim not in (2, 3):
        raise ValueError(f"a KV cache split over dim {pl.dim} by 'model': "
                         "only its KV heads (3) or its sequence (2) can be")
    return "seq" if pl.dim == 2 else "heads"


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """prefill(params, batch) -> last-position logits (B, V); on a
    ``mesh`` the rank's rows of them.

    For whisper this is the encoder pass, the cross-K/V precompute into an
    8-row cache and one decoder step of BOS (token 0) logits: the prefill
    work of encoder-decoder serving.
    """
    fam = get_family(cfg)

    @torch.no_grad()
    def prefill(params, batch):
        batch = {k: _local(v) for k, v in batch.items()}
        with _on_mesh(mesh):
            return _prefill(params, batch)

    def _last(params, batch):
        """The last position's logits over the whole vocab (a
        vocab-parallel rank's slices gathered)."""
        logits = fam.forward(params, batch, cfg)[:, -1]
        with act.model_axis(params):
            return L.whole_logits(logits, cfg)

    def _prefill(params, batch):
        if cfg.family == "whisper":
            enc_out = fam.encode(params, batch["frames"], cfg)
            b, dev = enc_out.shape[0], enc_out.device
            # a "model" axis: the rank's KV heads of both caches, as
            # ``prefill_cross`` writes the cross-attention's
            m = _model_ranks(mesh)
            cache = fam.init_cache(cfg.replace(n_kv=cfg.n_kv // m), b, 8,
                                   enc_len=enc_out.shape[1], device=dev)
            cache = fam.prefill_cross(params, enc_out, cache, cfg)
            bos = torch.zeros((b,), dtype=torch.long, device=dev)
            with act.kv_split("heads" if m > 1 else None):
                return fam.decode_step(params, cache, bos, cfg)[0]
        return _last(params, batch)

    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None):
    """decode(params, cache, tokens (B,)) -> (logits (B, V), new cache); on
    a ``mesh`` the rank's rows of the logits and the cache in its
    placements."""
    fam = get_family(cfg)

    def decode(params, cache, tokens):
        if mesh is None:
            return fam.decode_step(params, cache, tokens, cfg)
        with _on_mesh(mesh), act.kv_split(_kv_split(cache)):
            logits, new = fam.decode_step(params, _tree(_local, cache),
                                          _local(tokens), cfg)
        return logits, _merge(new, cache)

    return decode


def _model_ranks(mesh) -> int:
    """The size of the mesh's "model" axis (1 without one)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


def _merge(new, old):
    """The step's cache leaves (each the rank's block, written in place)
    back in ``old``'s placements."""
    if isinstance(new, dict):
        return {k: _merge(v, old[k]) for k, v in new.items()}
    if not isinstance(old, DTensor):
        return new
    return DTensor.from_local(new, old.device_mesh, old.placements,
                              run_check=False, shape=old.shape,
                              stride=old.stride())
