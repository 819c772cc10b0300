"""Abstract inputs of every (arch × shape) cell (port of
``repro/launch/specs.py``): meta tensors, the families' own ``init`` /
``init_cache`` on ``device="meta"``, so no cell allocates a byte, not even
qwen3-moe-235b's parameters.

Shape grid (assignment):
    train_4k     seq=4096   global_batch=256   (train_step)
    prefill_32k  seq=32768  global_batch=32    (prefill)
    decode_32k   seq=32768  global_batch=128   (decode: 1 token, KV cache=seq)
    long_500k    seq=524288 global_batch=1     (decode; sub-quadratic archs only)

Modality frontends are stubs per the assignment: pixtral gets precomputed
patch/token embeddings (B, S, D); whisper gets precomputed frame embeddings.
Whisper train/decode use dec_len decoder tokens and a 1500-frame (native)
cross-attention span for decode cells.
"""
from __future__ import annotations

import torch

from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig

SHAPES = {
    "train_4k":    dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k":  dict(seq=32768, batch=128, kind="decode"),
    "long_500k":   dict(seq=524288, batch=1, kind="decode"),
}

SUBQUADRATIC = {"rglru", "rwkv6"}
_WHISPER_NATIVE_ENC = 1504   # ~30 s of audio frames, padded to a lane multiple


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, ("full-attention architecture: a 524288-token decode "
                       "needs sub-quadratic attention (skip noted in DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_for(cfg: ModelConfig, shape: str) -> dict:
    """Meta tensors for the *data* inputs of the cell."""
    info = SHAPES[shape]
    s, b, kind = info["seq"], info["batch"], info["kind"]
    tok = torch.int32
    act = torch.bfloat16
    if kind == "train":
        if cfg.family == "whisper":
            return {"frames": _meta((b, s, cfg.d_model), act),
                    "tokens": _meta((b, cfg.dec_len), tok),
                    "labels": _meta((b, cfg.dec_len), tok)}
        if cfg.input_mode == "embeds":
            return {"embeds": _meta((b, s, cfg.d_model), act),
                    "labels": _meta((b, s), tok)}
        return {"tokens": _meta((b, s), tok), "labels": _meta((b, s), tok)}
    if kind == "prefill":
        if cfg.family == "whisper":
            return {"frames": _meta((b, s, cfg.d_model), act)}
        if cfg.input_mode == "embeds":
            return {"embeds": _meta((b, s, cfg.d_model), act)}
        return {"tokens": _meta((b, s), tok)}
    # decode: tokens only; the cache comes from cache_specs_for
    return {"tokens": _meta((b,), tok)}


def cache_specs_for(cfg: ModelConfig, shape: str) -> dict:
    """The family's KV-cache / recurrent state for a decode cell, on
    ``meta``."""
    info = SHAPES[shape]
    s, b = info["seq"], info["batch"]
    kw = {"enc_len": _WHISPER_NATIVE_ENC} if cfg.family == "whisper" else {}
    return get_family(cfg).init_cache(cfg, b, s, device="meta", **kw)


def param_specs_for(cfg: ModelConfig) -> dict:
    """Parameter name -> meta tensor, float32 as the reference (and the
    trainer) holds every parameter. The family's ``init`` on ``meta`` with
    a CPU generator (a meta generator does not exist; a meta draw consumes
    nothing)."""
    model = get_family(cfg).init(cfg, torch.Generator(), "meta",
                                 param_dtype=torch.float32)
    return dict(model.named_parameters())
