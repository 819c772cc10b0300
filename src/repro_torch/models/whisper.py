"""Whisper-medium encoder-decoder backbone, port of
``repro/models/whisper.py``. The conv/mel frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, S_enc, D).

Encoder: bidirectional pre-LN transformer with sinusoidal positions.
Decoder: causal self-attention and cross-attention to the encoder output,
learned positions (``dec_pos[pos % 4096]``). Parametric LayerNorm, no
RoPE, a GELU MLP (tanh approximation, ``jax.nn.gelu``'s default).
Cross-attention adds the query bias only; the encoder's K/V carry none.
Each encoder and decoder layer runs under ``layers.remat`` (the
reference's ``jax.checkpoint``). Attention runs by device
(``layers.attend``); the encoder's and the cross-attention's mask-free
form lets SDPA take its flash backend on the card. Parameters and the
family API follow :mod:`repro_torch.models.transformer`;
:func:`decode_step` writes the self-attention cache in place.

The family is tensor-parallel (``tensor_parallel``): on a mesh whose
"model" axis has more than one rank, each rank runs its heads of the
encoder's, the decoder's and the cross-attention (``layers.head_share``),
its d_ff columns of the MLPs and, where the vocab divides "model", its
vocab slice (whisper-medium's 51,865 does not: the embedding, the logits
and the loss run whole on every rank), and decodes with its KV heads of
both caches.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.sharding import act

_MAX_DEC = 4096  # learned decoder positions allocated (whisper ships 448)


class GeluMLP(nn.Module):
    """``wi`` (d, ff), ``wo`` (ff, d) in ``cfg.dtype``: not gated."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.wi = L._normal(generator, (d, ff), 1.0 / math.sqrt(d), dt, device)
        self.wo = L._normal(generator, (ff, d), 1.0 / math.sqrt(ff), dt,
                            device)


def _mlp(p: GeluMLP, x, cfg: ModelConfig):
    """GELU MLP; tensor-parallel (``act.tensor_parallel`` and ``wi``'s
    columns split over "model"), the rank's d_ff columns of ``wi`` and
    rows of ``wo``, summed over "model", as ``layers.apply_mlp``."""
    tp = act.tensor_parallel() is not None and p.wi.shape[-1] < cfg.d_ff
    if tp:
        x = act.enter(x)
    y = F.gelu(x @ p.wi.to(x.dtype), approximate="tanh") @ p.wo.to(x.dtype)
    return act.constrain(y) if tp else y


class EncLayer(nn.Module):
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.attn = L.attn_init(cfg, generator, device)
        self.mlp = GeluMLP(cfg, generator, device)
        self.ln1 = L.norm_init(cfg, cfg.d_model, device)
        self.ln2 = L.norm_init(cfg, cfg.d_model, device)


class DecLayer(nn.Module):
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.self_attn = L.attn_init(cfg, generator, device)
        self.cross_attn = L.attn_init(cfg, generator, device)
        self.mlp = GeluMLP(cfg, generator, device)
        self.ln1 = L.norm_init(cfg, cfg.d_model, device)
        self.ln2 = L.norm_init(cfg, cfg.d_model, device)
        self.ln3 = L.norm_init(cfg, cfg.d_model, device)


class Whisper(nn.Module):
    """``embed``, ``dec_pos`` (4096, d), ``enc_layers``, ``dec_layers``,
    ``enc_norm`` and ``dec_norm``."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator, device)
                                        for _ in range(cfg.n_layers))
        self.embed = L.embed_init(cfg, generator, device)
        self.dec_pos = L._normal(generator, (_MAX_DEC, cfg.d_model), 0.01,
                                 cfg.torch_dtype, device)
        self.enc_norm = L.norm_init(cfg, cfg.d_model, device)
        self.dec_norm = L.norm_init(cfg, cfg.d_model, device)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
         param_dtype: torch.dtype | None = None) -> Whisper:
    """Random weights drawn from ``generator`` (on ``device``), at the
    reference's scales; matrices in ``cfg.dtype`` (or ``param_dtype``)."""
    return Whisper(L.param_cfg(cfg, param_dtype), generator,
                   ops.resolve_device(device))


def _sinusoid(s: int, d: int, dtype, device):
    """Sinusoidal positions (S, D), computed in float64 as the reference's
    numpy ones are."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(emb, dtype=dtype, device=device)


def encode(model: Whisper, frames, cfg: ModelConfig):
    """frames (B, S_enc, D) stub embeddings -> encoder output (B, S_enc,
    D)."""
    x = frames.to(cfg.torch_dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    for lp in model.enc_layers:
        x = L.remat(_enc_layer, lp, x, cfg)
    with act.gathered(model, "enc_norm"):
        return L.apply_norm(model.enc_norm, x, cfg)


def _enc_layer(lp: EncLayer, x, cfg: ModelConfig):
    h = L.apply_norm(lp.ln1, x, cfg)
    x = x + L.causal_attention(lp.attn, h, cfg, causal=False)
    return x + _mlp(lp.mlp, L.apply_norm(lp.ln2, x, cfg), cfg)


def _cross_attention(p: L.Attention, x, enc_kv, cfg: ModelConfig,
                     sh: Optional[L.HeadShare] = None):
    """x (B, Sd, D) queries against precomputed encoder K/V (B, S_enc, KV,
    hd); every key visible. ``sh``: the heads to compute, those of
    ``enc_kv`` (``layers.attention_share`` by default: tensor-parallel the
    rank's heads, ``x`` entering the column-parallel ``wq`` and the
    output summed over "model" by ``layers.out_project``)."""
    sh = sh or L.attention_share(p, cfg)
    b, s, _ = x.shape
    if sh.tp is not None:
        x = act.enter(x)
    hd = cfg.hd
    q = L._columns(x, p.wq, p.bq if cfg.qkv_bias else None,
                   cfg.n_heads * hd, sh.lo * hd, sh.hi * hd, sh.tp)
    q = q.reshape(b, s, sh.hi - sh.lo, hd)
    k, v = enc_kv
    return L.out_project(p, L.attend(q, k, v, None, sh.cfg), cfg, sh)


def _enc_kv(p: L.Attention, enc_out, cfg: ModelConfig,
            sh: Optional[L.HeadShare] = None):
    """The cross-attention's K/V (B, S_enc, KV, hd) of the encoder output
    (no bias); ``sh`` as in :func:`_cross_attention`: tensor-parallel the
    rank's K/V heads, ``enc_out`` entering the column-parallel products."""
    sh = sh or L.attention_share(p, cfg)
    b, se, _ = enc_out.shape
    if sh.tp is not None:
        enc_out = act.enter(enc_out)
    hd, width = cfg.hd, cfg.n_kv * cfg.hd
    k, v = (L._columns(enc_out, w, None, width, sh.klo * hd, sh.khi * hd,
                       sh.tp).reshape(b, se, -1, hd) for w in (p.wk, p.wv))
    if sh.kv_index is not None:
        idx = torch.tensor(sh.kv_index, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return k, v


def _cached_share(p: L.Attention, cfg: ModelConfig) -> L.HeadShare:
    """A decode step's cross-attention heads, those its ``xk`` / ``xv``
    hold: the rank's (a cache split over its KV heads, as
    :func:`prefill_cross` writes it) or every head (one device, or a cache
    replicated over "model"). A cross-attention cache split over its
    sequence has no route here and raises."""
    sh = L.attention_share(p, cfg)
    tp = act.tensor_parallel()
    split = None if tp is None else tp.kv_split
    if split == "heads":
        return sh
    if split is None:
        return L._every_head(cfg, sh.tp)
    raise ValueError(f"a cross-attention cache split over 'model' by "
                     f"{split!r}: only its KV heads can be")


def decode(model: Whisper, tokens, enc_out, cfg: ModelConfig):
    """Teacher-forced decoder -> logits (B, S_dec, V) float32."""
    x = L.embed(model.embed, tokens, cfg)
    x = x + model.dec_pos[:tokens.shape[1]][None].to(x.dtype)
    for lp in model.dec_layers:
        x = L.remat(_dec_layer, lp, x, enc_out, cfg)
    x = L.apply_norm(model.dec_norm, x, cfg)
    return L.unembed(model.embed, x, cfg)


def _dec_layer(lp: DecLayer, x, enc_out, cfg: ModelConfig):
    h = L.apply_norm(lp.ln1, x, cfg)
    x = x + L.causal_attention(lp.self_attn, h, cfg.replace(rope_theta=0.0))
    h = L.apply_norm(lp.ln2, x, cfg)
    x = x + _cross_attention(lp.cross_attn, h,
                             _enc_kv(lp.cross_attn, enc_out, cfg), cfg)
    return x + _mlp(lp.mlp, L.apply_norm(lp.ln3, x, cfg), cfg)


_NON_LAYER = ("embed", "dec_pos", "enc_norm", "dec_norm")


def forward(model: Whisper, batch, cfg: ModelConfig):
    """batch ``frames`` (B, S_enc, D) and ``tokens`` (B, S_dec) -> logits
    (B, S_dec, V) float32 (non-layer parameters gathered on a mesh, as
    ``transformer.forward``; with a "model" axis that splits the vocab,
    the rank's vocab slice)."""
    with act.gathered(model, *_NON_LAYER):
        return decode(model, batch["tokens"],
                      encode(model, batch["frames"], cfg), cfg)


def loss_fn(model: Whisper, batch, cfg: ModelConfig):
    with act.gathered(model, *_NON_LAYER):
        logits = decode(model, batch["tokens"],
                        encode(model, batch["frames"], cfg), cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               vocab=cfg.vocab)


# ------------------------------------------------------------- serving -----

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int = 0,
               device="cuda") -> dict:
    """Self-attention K/V (L, B, max_len, KV, hd) and cross-attention K/V
    ``xk`` / ``xv`` (L, B, enc_len or max_len, KV, hd) in ``dtype``;
    ``pos`` a scalar."""
    dev = ops.resolve_device(device)
    l, kv, hd = cfg.n_layers, cfg.n_kv, cfg.hd
    enc_len = enc_len or max_len

    def zeros(n):
        return torch.zeros((l, batch, n, kv, hd), dtype=dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(enc_len),
            "xv": zeros(enc_len),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def prefill_cross(model: Whisper, enc_out, cache: dict, cfg: ModelConfig):
    """The cache with ``xk`` / ``xv`` (L, B, S_enc, KV, hd), in the cache's
    dtype, from the encoder output (B, S_enc, D): every decoder layer's
    cross-attention K/V. S_enc sets their length, as in the reference.
    Tensor-parallel, the rank's KV heads (a cache split over them)."""
    kvs = [act.gathering(_layer_enc_kv)(lp, enc_out, cfg)
           for lp in model.dec_layers]
    return {**cache,
            "xk": torch.stack([k for k, _ in kvs]).to(cache["xk"].dtype),
            "xv": torch.stack([v for _, v in kvs]).to(cache["xv"].dtype)}


def _layer_enc_kv(lp: DecLayer, enc_out, cfg: ModelConfig):
    return _enc_kv(lp.cross_attn, enc_out, cfg)


@torch.no_grad()
def decode_step(model: Whisper, cache: dict, tokens, cfg: ModelConfig):
    """One token for every sequence against the self-attention cache
    (written in place) and the cross-attention K/V. ``pos`` a scalar or
    per slot. Returns (logits (B, V) float32, the cache with
    ``pos + 1``). On a mesh the non-layer parameters are gathered for the
    call and each layer's inside the loop (``act.gathered``); with a
    "model" axis the caches are the rank's KV heads (``serve.step``) and
    the logits are gathered over the vocab where it is split."""
    with act.gathered(model, "embed", "dec_pos", "dec_norm"):
        x = L.embed(model.embed, tokens[:, None], cfg)    # (B, 1, D)
        pos = cache["pos"]
        # index_select, not indexing: a 0-d index would be read on the host
        rows = (pos % _MAX_DEC).long().reshape(-1)
        x = x + model.dec_pos.index_select(0, rows).reshape(
            -1, 1, cfg.d_model).to(x.dtype)
        no_rope = cfg.replace(rope_theta=0.0)
        slots = L.decode_slots(x, L.cache_rows(cache["k"]), pos, no_rope)
        for i, lp in enumerate(model.dec_layers):
            with act.gathered(lp):
                x = _decode_layer(lp, x, cache, i, pos, no_rope, slots)
        x = L.apply_norm(model.dec_norm, x, cfg)
        logits = L.whole_logits(L.unembed(model.embed, x, cfg)[:, 0], cfg)
    return logits, {**cache, "pos": pos + 1}


def _decode_layer(lp: DecLayer, x, cache: dict, i: int, pos,
                  cfg: ModelConfig, slots):
    """Decoder layer ``i``'s step (``cfg`` without rope): self-attention
    against its cache (written in place), cross-attention against the
    precomputed K/V."""
    h = L.apply_norm(lp.ln1, x, cfg)
    x = x + L.cached_decode_attention(lp.self_attn, h, cache["k"][i],
                                      cache["v"][i], pos, cfg, slots)[0]
    h = L.apply_norm(lp.ln2, x, cfg)
    x = x + _cross_attention(lp.cross_attn, h,
                             (cache["xk"][i].to(x.dtype),
                              cache["xv"][i].to(x.dtype)), cfg,
                             _cached_share(lp.cross_attn, cfg))
    return x + _mlp(lp.mlp, L.apply_norm(lp.ln3, x, cfg), cfg)
