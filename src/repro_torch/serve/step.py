"""Serve-step factories (port of ``repro/serve/step.py``): prefill (full
forward, last-position logits) and decode (one token against a KV cache or
recurrent state), for every model family.

The reference's ``_with_unroll`` patches ``lax.scan`` and has no
counterpart: the port runs its layers in a Python loop.

On a mesh (``mesh=``; the dry run's cells) the parameters are DTensors
placed by ``sharding.rules`` and every input is placed too (the batch by
``rules.batch_specs``, the cache by ``rules.cache_specs``). As the mesh
trainer, a rank computes on its own batch shard with plain tensors and
gathers the weights block by block (``act.gathered`` in each family's
decode loop, ``act.gathering`` in ``forward``): the port has no
tensor parallelism. So a decode step first gathers each cache leaf's
shard over the mesh axes other than the batch's (the KV heads or
sequence the reference keeps split over "model"), and hands back each
leaf in its own placements, a view of the rank's block: no collective.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import get_family
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


def _batch_only(x):
    """A cache leaf's rank block over the batch dim (1) alone: its shards
    over every other dim gathered (a plain tensor)."""
    if not isinstance(x, DTensor):
        return x
    keep = [p if isinstance(p, Shard) and p.dim == 1 else Replicate()
            for p in x.placements]
    return x.redistribute(x.device_mesh, keep).to_local()


def _replace(new, old):
    """``new`` (a rank's batch-only block) back in ``old``'s placements:
    the rank's chunk of every dim it had gathered, as a view."""
    if not isinstance(old, DTensor):
        return new
    mesh, coord = old.device_mesh, old.device_mesh.get_coordinate()
    for i, p in enumerate(old.placements):
        if isinstance(p, Shard) and p.dim != 1:
            new = new.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(new, mesh, old.placements, run_check=False,
                              shape=old.shape, stride=old.stride())


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

    def _prefill(params, batch):
        if cfg.family == "whisper":
            enc_out = fam.encode(params, batch["frames"], cfg)
            b, dev = enc_out.shape[0], enc_out.device
            cache = fam.init_cache(cfg, b, 8, enc_len=enc_out.shape[1],
                                   device=dev)
            cache = fam.prefill_cross(params, enc_out, cache, cfg)
            bos = torch.zeros((b,), dtype=torch.long, device=dev)
            return fam.decode_step(params, cache, bos, cfg)[0]
        return fam.forward(params, batch, cfg)[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None):
    """decode(params, cache, tokens (B,)) -> (logits (B, V), new cache); on
    a ``mesh`` the rank's rows of the logits and the cache in its
    placements."""
    fam = get_family(cfg)

    def decode(params, cache, tokens):
        if mesh is None:
            return fam.decode_step(params, cache, tokens, cfg)
        local = _tree(_batch_only, cache)
        with _on_mesh(mesh):
            logits, new = fam.decode_step(params, local, _local(tokens), cfg)
        return logits, _merge(new, cache)

    return decode


def _merge(new, old):
    if isinstance(new, dict):
        return {k: _merge(v, old[k]) for k, v in new.items()}
    return _replace(new, old)
