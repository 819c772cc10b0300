"""Serve-step factories (port of ``repro/serve/step.py``): prefill (full
forward, last-position logits) and decode (one token against a KV cache or
recurrent state), for every model family.

The reference's ``_with_unroll`` patches ``lax.scan`` and has no
counterpart: the port runs its layers in a Python loop.
"""
from __future__ import annotations

import torch

from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, batch) -> last-position logits (B, V).

    For whisper this is the encoder pass, the cross-K/V precompute into an
    8-row cache and one decoder step of BOS (token 0) logits: the prefill
    work of encoder-decoder serving.
    """
    fam = get_family(cfg)

    @torch.no_grad()
    def prefill(params, batch):
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


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens (B,)) -> (logits (B, V), new cache)."""
    fam = get_family(cfg)

    def decode(params, cache, tokens):
        return fam.decode_step(params, cache, tokens, cfg)

    return decode
