"""Model-family registry (port of ``repro/models/__init__.py``): family
name -> module with the uniform API (init / forward / loss_fn / init_cache
/ decode_step / prefill).

Only the dense family is ported. The others (moe, rglru, rwkv6, whisper)
raise ``NotImplementedError``: they are ROADMAP.md queue 1 item 2. No
family falls back to the dense model.
"""
from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.base import ModelConfig

FAMILIES = {"dense": transformer}
NOT_PORTED = ("moe", "rglru", "rwkv6", "whisper")


def get_family(cfg: ModelConfig):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet "
            "(ROADMAP.md queue 1 item 2: the other families)")
    raise KeyError(f"unknown model family {cfg.family!r}")
