"""Layers shared by the model families (port of ``repro/models/layers.py``):
norms, RoPE, grouped-query attention (full, chunked online-softmax,
chunked sliding-window, cached decode with a bfloat16 or int8 KV cache),
the SwiGLU MLP and embeddings.

Conventions:
  * parameters live in small ``nn.Module``\\ s (:class:`Norm`,
    :class:`Attention`, :class:`MLP`, :class:`Embed`: containers, no
    ``forward``) under the reference's names, matrices in the reference's
    (in, out) layout; the functions below compute on them, as the
    reference's do on its param dicts.
  * matrices are stored in ``cfg.dtype``: the reference keeps them in
    float32 and casts each at use (``x @ w.astype(x.dtype)``), which gives
    the same values. A family's ``init(..., param_dtype=torch.float32)``
    (:func:`param_cfg`) stores them in float32 as the reference does: the
    trainer's master weights. Norm scales and biases stay float32 and are
    used as the reference uses them (scales in float32 arithmetic, biases
    cast to the activations' dtype).
  * compute dtype is ``cfg.dtype``; norms, softmax and logits are float32.
  * attention (:func:`attend`) runs by the tensors' device: on the card
    PyTorch's ``scaled_dot_product_attention`` (:func:`sdpa_library`, a
    library call: no Pallas kernel computes attention in the reference),
    on the CPU the reference's grouped-query einsum form (:func:`_sdpa`),
    which the tests hold against the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.base import ModelConfig
from repro_torch.sharding import act


def param_cfg(cfg: ModelConfig, param_dtype: Optional[torch.dtype]
              ) -> ModelConfig:
    """The config a family's modules are built from: ``cfg`` with
    ``param_dtype`` (e.g. ``torch.float32``, how the reference holds every
    parameter) as the matrices' storage dtype; ``cfg`` itself when None.
    Only storage changes: every use casts to the compute dtype."""
    if param_dtype is None:
        return cfg
    return cfg.replace(dtype=str(param_dtype).removeprefix("torch."))


def remat(fn, *args):
    """``jax.checkpoint``'s counterpart: ``fn(*args)`` keeping only its
    inputs for the backward pass, which recomputes the rest, while grad is
    enabled; a plain call under ``torch.no_grad()`` (the serve steps).
    Under ``act.activation_sharding`` the block among ``args`` has its
    DTensor parameters gathered inside ``fn`` (``act.gathering``), so the
    recompute gathers them again."""
    fn = act.gathering(fn)
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _normal(generator: torch.Generator, shape, scale: float, dtype,
            device) -> nn.Parameter:
    """N(0, 1)·scale drawn in float32 on ``device`` and stored as ``dtype``
    (one weight's float32 transient at a time)."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype))


def _const(shape, value: float, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                   device=device))


# ---------------------------------------------------------------- norms ----

class Norm(nn.Module):
    """``cfg.norm``'s parameters, float32: rmsnorm a ``scale``, layernorm a
    ``scale`` and a ``bias``, OLMo's ``layernorm_nonparam`` none."""

    def __init__(self, cfg: ModelConfig, dim: int, device):
        super().__init__()
        if cfg.norm != "layernorm_nonparam":
            self.scale = _const((dim,), 1.0, device)
        if cfg.norm == "layernorm":
            self.bias = _const((dim,), 0.0, device)


def norm_init(cfg: ModelConfig, dim: int, device) -> Norm:
    return Norm(cfg, dim, device)


def apply_norm(p: Norm, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * p.scale).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm_nonparam":     # OLMo: non-parametric LN
        return xf.to(x.dtype)
    return (xf * p.scale + p.bias).to(x.dtype)


# ----------------------------------------------------------------- rope ----

def rope_freqs(cfg: ModelConfig, positions: torch.Tensor):
    """positions (...,) -> cos/sin of shape (..., hd/2), float32. The
    inverse frequencies are computed in float64 and rounded to float32, as
    the reference's numpy ones are, on ``positions``' device (no host copy
    in a decode step)."""
    hd = cfg.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float64,
                        device=positions.device) / hd
    inv = (1.0 / cfg.rope_theta ** exps).float()
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------ attention ----

class Attention(nn.Module):
    """``wq`` (d, H·hd), ``wk`` / ``wv`` (d, KV·hd), ``wo`` (H·hd, d) in
    ``cfg.dtype``; ``bq`` / ``bk`` / ``bv`` with ``qkv_bias``, ``q_norm`` /
    ``k_norm`` (hd,) with ``qk_norm`` (float32)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        d = cfg.d_model
        h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        scale, dt = 1.0 / math.sqrt(d), cfg.torch_dtype
        self.wq = _normal(generator, (d, h * hd), scale, dt, device)
        self.wk = _normal(generator, (d, kv * hd), scale, dt, device)
        self.wv = _normal(generator, (d, kv * hd), scale, dt, device)
        self.wo = _normal(generator, (h * hd, d), scale, dt, device)
        if cfg.qkv_bias:
            self.bq = _const((h * hd,), 0.0, device)
            self.bk = _const((kv * hd,), 0.0, device)
            self.bv = _const((kv * hd,), 0.0, device)
        if cfg.qk_norm:
            self.q_norm = _const((hd,), 1.0, device)
            self.k_norm = _const((hd,), 1.0, device)


def attn_init(cfg: ModelConfig, generator: torch.Generator,
              device) -> Attention:
    return Attention(cfg, generator, device)


def _qk_rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def qkv_project(p: Attention, x, cfg: ModelConfig, positions, rope=None):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd) with RoPE applied.
    ``rope``: ``rope_freqs(cfg, positions)`` when the caller computed it
    once for every layer (``positions`` is then unused)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = _qk_rmsnorm(q, p.q_norm)
        k = _qk_rmsnorm(k, p.k_norm)
    if cfg.rope_theta > 0:
        cos, sin = rope if rope is not None else rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask bool broadcastable to
    (B,1,Sq,Sk), or None (every key: the reference's all-true mask)
    -> (B, Sq, H·hd).

    Grouped-query form: q is reshaped to (B,Sq,KV,rep,hd) and contracted
    against the UN-repeated K/V; scores and softmax in float32 with a
    -1e30 mask, probabilities cast back to ``q.dtype``.
    """
    h, kv = cfg.n_heads, cfg.n_kv
    rep = h // kv
    b, sq = q.shape[:2]
    qg = q.reshape(b, sq, kv, rep, cfg.hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    scores = scores / math.sqrt(cfg.hd)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, -1e30)  # (B,g,r,Sq,Sk)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, sq, h * cfg.hd)


def sdpa_library(q, k, v, mask, cfg: ModelConfig):
    """:func:`_sdpa` through ``torch.nn.functional.
    scaled_dot_product_attention`` (``enable_gqa``: query head h reads KV
    head h // rep, as the grouped reshape does), with the same boolean
    mask (None: no mask, which lets the flash backend run)."""
    b, sq = q.shape[:2]
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2).reshape(b, sq, cfg.n_heads * cfg.hd)


def attend(q, k, v, mask, cfg: ModelConfig):
    """Attention over the un-repeated K/V: :func:`sdpa_library` on the
    card, :func:`_sdpa` on the CPU."""
    if q.is_cuda:
        return sdpa_library(q, k, v, mask, cfg)
    return _sdpa(q, k, v, mask, cfg)


def causal_attention(p: Attention, x, cfg: ModelConfig, positions=None,
                     rope=None, causal=True):
    """Full (quadratic) attention over x (B, S, D); ``rope`` as in
    :func:`qkv_project`; ``causal=False``: every query sees every key
    (whisper's encoder)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, positions, rope)
    mask = None
    if causal:
        qpos = torch.arange(s, device=x.device)
        mask = (qpos[:, None] >= qpos[None, :])[None, None]
    out = attend(q, k, v, mask, cfg)
    return out @ p.wo.to(x.dtype)


def chunked_causal_attention(p: Attention, x, cfg: ModelConfig,
                             positions=None, block: int = 512):
    """Flash-style causal attention: online softmax over KV blocks, one
    (B, S, KV, rep, block) score tile at a time, so the (S, S) score matrix
    never exists. Plain torch: this IS the algorithm the reference's
    ``chunked_attn`` configs run."""
    b, s, _ = x.shape
    if s <= block:
        return causal_attention(p, x, cfg, positions)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, positions)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    rep = h // kv
    pad = (-s) % block
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(b, s, kv, rep, hd)
    qpos = torch.arange(s, device=x.device)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, s, kv, rep), -math.inf, dtype=torch.float32,
                   device=x.device)
    l = torch.zeros((b, s, kv, rep), dtype=torch.float32, device=x.device)
    acc = torch.zeros((b, s, kv, rep, hd), dtype=torch.float32,
                      device=x.device)
    for bidx in range((s + pad) // block):
        kblk = kp[:, bidx * block:(bidx + 1) * block]
        vblk = vp[:, bidx * block:(bidx + 1) * block]
        kpos = bidx * block + torch.arange(block, device=x.device)
        mask = qpos[:, None] >= kpos[None, :]               # (S, block)
        sc = torch.einsum("bqgrd,bkgd->bqgrk", qg, kblk).float() * scale
        sc = torch.where(mask[None, :, None, None, :], sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p_blk = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_blk.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqgrk,bkgd->bqgrd", p_blk.to(qg.dtype), vblk).float()
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(x.dtype)
    return out.reshape(b, s, h * hd) @ p.wo.to(x.dtype)


def windowed_attention(p: Attention, x, cfg: ModelConfig, positions=None,
                       rope=None):
    """Chunked sliding-window attention (``cfg.window`` = W), exact for
    window <= chunk; ``rope`` as in :func:`qkv_project`.

    S is padded to a multiple of W; each chunk attends to itself and the
    previous chunk under the combined causal+window mask (chunk 0's zero
    "previous chunk" masked out). The (B·C, W, 2W) chunks go to
    :func:`attend` as one batch, so compute is O(S · 2W), not O(S²). For
    S <= W it is :func:`causal_attention`.
    """
    w = cfg.window
    b, s, _ = x.shape
    if s <= w:
        return causal_attention(p, x, cfg, positions, rope)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, positions, rope)
    pad = (-s) % w
    nchunk = (s + pad) // w

    def chunks(t):             # (B, S, heads, hd) -> (B, C, W, heads, hd)
        return F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(
            b, nchunk, w, *t.shape[2:])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    # keys for chunk i = chunks [i-1, i]
    kk = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1),
                    kc], dim=2)                        # (B, C, 2W, KV, hd)
    vv = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1),
                    vc], dim=2)
    qpos = torch.arange(w, device=x.device)             # within-chunk query
    kpos = torch.arange(2 * w, device=x.device) - w     # relative key pos
    rel = qpos[:, None] - kpos[None, :]                 # how far back
    mask = ((rel >= 0) & (rel < w)).expand(nchunk, w, 2 * w).clone()
    mask[0] &= kpos[None, :] >= 0                       # chunk 0 has no prev
    mask = mask[None, :, None].expand(b, nchunk, 1, w, 2 * w)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    out = attend(qc.reshape(b * nchunk, w, h, hd),
                 kk.reshape(b * nchunk, 2 * w, kv, hd),
                 vv.reshape(b * nchunk, 2 * w, kv, hd),
                 mask.reshape(b * nchunk, 1, w, 2 * w), cfg)
    out = out.reshape(b, nchunk * w, h * hd)[:, :s]
    return out @ p.wo.to(x.dtype)


def kv_quantize(x):
    """(..., hd) -> int8 payload + per-token float32 scale: the int8 KV
    cache (half the bytes a decode step reads from a bfloat16 cache).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    s = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def kv_dequantize(q, s, dtype):
    return q.to(dtype) * s[..., None].to(dtype)


class DecodeSlots(NamedTuple):
    """What every layer of one decode step shares (:func:`decode_slots`):
    the positions, the cache write row(s), the causal mask over the cache,
    RoPE's cos/sin (None without RoPE), and with per-slot positions the
    slot rows and which of them write (a row past the cache does not)."""
    pos: torch.Tensor
    write: torch.Tensor
    mask: torch.Tensor
    rope: Optional[tuple]
    rows: Optional[torch.Tensor]
    ok: Optional[torch.Tensor]


def decode_slots(x, s_max: int, pos, cfg: ModelConfig) -> DecodeSlots:
    """``pos`` a scalar (every sequence) or (B,) (one per slot), for a
    (B, 1, D) step against an ``s_max``-row cache. A scalar write row past
    the cache clamps to its last row and a per-slot one is dropped, as the
    reference's ``dynamic_update_slice`` / ``.at[].set`` do."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    kpos = torch.arange(s_max, device=x.device)
    write = (pos % s_max if cfg.window else pos).long()
    rows = ok = None
    if pos.dim() == 0:
        rope_pos = pos.expand(b, 1)
        mask = (kpos <= pos)[None, None, None, :]
    else:
        rope_pos = pos[:, None]
        mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]
        rows = torch.arange(b, device=x.device)
        ok = write < s_max
    write = torch.clamp(write, max=s_max - 1)
    rope = rope_freqs(cfg, rope_pos) if cfg.rope_theta > 0 else None
    return DecodeSlots(pos, write, mask, rope, rows, ok)


def _write(cache, new, sl: DecodeSlots):
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at the step's
    row(s), in place; a slot whose row lies past the cache keeps its
    contents."""
    new = new.to(cache.dtype)
    if sl.rows is None:
        cache.index_copy_(1, sl.write.reshape(1), new)
        return
    keep = sl.ok.reshape((-1,) + (1,) * (new.dim() - 2))
    cache[sl.rows, sl.write] = torch.where(keep, new[:, 0],
                                           cache[sl.rows, sl.write])


def cached_decode_attention_q8(p: Attention, x, ck, cv, ks, vs, pos,
                               cfg: ModelConfig,
                               slots: Optional[DecodeSlots] = None):
    """Decode against an int8-quantized cache. ck/cv (B,S,KV,hd) int8,
    ks/vs (B,S,KV) float32, written in place. Returns (out, ck, cv, ks,
    vs). ``pos`` and ``slots`` as in :func:`cached_decode_attention`."""
    sl = slots if slots is not None else decode_slots(x, ck.shape[1], pos,
                                                      cfg)
    q, k, v = qkv_project(p, x, cfg, None, sl.rope)
    k8, k_s = kv_quantize(k)
    v8, v_s = kv_quantize(v)
    for cache, new in ((ck, k8), (cv, v8), (ks, k_s), (vs, v_s)):
        _write(cache, new, sl)
    kf = kv_dequantize(ck, ks, q.dtype)
    vf = kv_dequantize(cv, vs, q.dtype)
    out = attend(q, kf, vf, sl.mask, cfg)
    return out @ p.wo.to(x.dtype), ck, cv, ks, vs


def cached_decode_attention(p: Attention, x, cache_k, cache_v, pos,
                            cfg: ModelConfig,
                            slots: Optional[DecodeSlots] = None):
    """One-token decode against a (B, S_max, KV, hd) cache, written in place.

    Returns (out (B, 1, D), cache_k, cache_v). ``pos`` is the write
    position: a scalar applied to every sequence, or a (B,) vector of
    per-sequence positions (continuous batching: each serving slot decodes
    at its own depth, so RoPE phase, cache write row and the causal mask
    are all per slot; see ``serve/engine.py``).
    If cfg.window > 0 the cache is a ring buffer of size S_max (= window).
    ``slots``: ``decode_slots(x, S_max, pos, cfg)`` when the caller
    computed it once for every layer (``pos`` is then unused).
    """
    sl = slots if slots is not None else decode_slots(x, cache_k.shape[1],
                                                      pos, cfg)
    q, k, v = qkv_project(p, x, cfg, None, sl.rope)
    _write(cache_k, k, sl)
    _write(cache_v, v, sl)
    out = attend(q, cache_k.to(q.dtype), cache_v.to(q.dtype), sl.mask, cfg)
    return out @ p.wo.to(x.dtype), cache_k, cache_v


# ---------------------------------------------------------------- mlp ------

class MLP(nn.Module):
    """SwiGLU: ``wi`` / ``wg`` (d, ff), ``wo`` (ff, d) in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = cfg.torch_dtype
        self.wi = _normal(generator, (d, ff), 1.0 / math.sqrt(d), dt, device)
        self.wg = _normal(generator, (d, ff), 1.0 / math.sqrt(d), dt, device)
        self.wo = _normal(generator, (ff, d), 1.0 / math.sqrt(ff), dt,
                          device)


def mlp_init(cfg: ModelConfig, generator: torch.Generator, device) -> MLP:
    return MLP(cfg, generator, device)


def apply_mlp(p: MLP, x, cfg: ModelConfig):
    """SwiGLU (qwen/olmo/pixtral families) — silu(x wg) * (x wi) wo."""
    g = F.silu(x @ p.wg.to(x.dtype))
    h = x @ p.wi.to(x.dtype)
    return (g * h) @ p.wo.to(x.dtype)


# ------------------------------------------------------------ embedding ----

class Embed(nn.Module):
    """``embedding`` (V, d) and, unless tied, ``lm_head`` (d, V), in
    ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.embedding = _normal(generator, (cfg.vocab, cfg.d_model), 0.02,
                                 dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _normal(generator, (cfg.d_model, cfg.vocab), 0.02,
                                   dt, device)


def embed_init(cfg: ModelConfig, generator: torch.Generator,
               device) -> Embed:
    return Embed(cfg, generator, device)


def embed(p: Embed, tokens, cfg: ModelConfig):
    return p.embedding[tokens].to(cfg.torch_dtype)


def unembed(p: Embed, x, cfg: ModelConfig):
    w = p.embedding.T if cfg.tie_embeddings else p.lm_head
    return (x @ w.to(x.dtype)).float()


def cross_entropy(logits, labels, mask=None):
    """Mean token CE in float32. logits (B, S, V), labels (B, S) int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
