"""Serve-step factories (port of ``repro/serve/step.py``): prefill (full
forward, last-position logits) and decode (one token against a KV cache).

Only the dense family is ported (``models.get_family`` raises for the
others, whisper's encoder prefill included). The reference's
``_with_unroll`` patches ``lax.scan`` and has no counterpart: the port
runs its layers in a Python loop.
"""
from __future__ import annotations

from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, batch) -> last-position logits (B, V)."""
    fam = get_family(cfg)

    def prefill(params, batch):
        return fam.forward(params, batch, cfg)[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens (B,)) -> (logits (B, V), new cache)."""
    fam = get_family(cfg)

    def decode(params, cache, tokens):
        return fam.decode_step(params, cache, tokens, cfg)

    return decode
