"""Model-family registry (port of ``repro/models/__init__.py``): family
name -> module with the uniform API (init / forward / loss_fn / init_cache
/ decode_step; whisper adds encode / decode / prefill_cross, dense adds
prefill). An unknown family raises ``KeyError``.
"""
from __future__ import annotations

from repro_torch.models import moe, rglru, rwkv6, transformer, whisper
from repro_torch.models.base import ModelConfig

FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "rglru": rglru,
    "rwkv6": rwkv6,
    "whisper": whisper,
}


def get_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return FAMILIES[cfg.family]
