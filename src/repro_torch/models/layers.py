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
  * tensor parallelism: inside a tensor-parallel family's block on a mesh
    whose "model" axis has more than one rank (``act.tensor_parallel``),
    the matrices are the rank's slices as ``sharding.rules`` places them
    and the functions compute the rank's share (:func:`head_share`):
    attention's query heads (column-parallel ``wq``, row-parallel ``wo``;
    full, chunked, windowed and cached), the MLP's d_ff columns, the vocab
    of the embedding, ``lm_head`` and the loss; the partial sums are
    summed over "model" by ``act``'s f / g pair. Without it they run the
    single-device code.
"""
from __future__ import annotations

import functools
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
    DTensor parameters gathered inside ``fn`` (``act.gathering``: over the
    data axes, and over "model" too unless the family is tensor-parallel),
    so the recompute gathers them again."""
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


class HeadShare(NamedTuple):
    """A rank's share of an attention layer over "model": query heads
    ``lo``..``hi``, the K/V heads ``klo``..``khi`` they read, ``cfg`` with
    the rank's head counts (``n_heads``, ``n_kv``), and ``kv_index``: each
    local query head's K/V head when the heads do not fall in whole
    groups (K/V are then widened to one a query head), else None."""
    cfg: ModelConfig
    lo: int
    hi: int
    klo: int
    khi: int
    kv_index: Optional[tuple]
    tp: act.TP


def head_share(cfg: ModelConfig, tp: act.TP) -> HeadShare:
    """Rank ``tp.rank``'s query heads: the ``j·H // m`` boundaries, so the
    heads are split evenly where ``m`` divides ``H`` and within one head a
    rank otherwise (qwen2-7b's 28 or qwen1.5-32b's 40 over 16)."""
    return HeadShare(*_head_share(cfg, tp.size, tp.rank), tp)


@functools.lru_cache(maxsize=256)
def _head_share(cfg: ModelConfig, m: int, j: int) -> tuple:
    h, kv = cfg.n_heads, cfg.n_kv
    if h < m:
        raise ValueError(f"{h} attention heads over a 'model' axis of {m}: "
                         "a rank would have no head")
    rep = h // kv
    lo, hi = j * h // m, (j + 1) * h // m
    klo, khi = lo // rep, (hi - 1) // rep + 1
    n, nk = hi - lo, khi - klo
    if (lo % rep == 0 and n % rep == 0) or nk == 1:
        return cfg.replace(n_heads=n, n_kv=nk), lo, hi, klo, khi, None
    index = tuple(i // rep - klo for i in range(lo, hi))
    return cfg.replace(n_heads=n, n_kv=n), lo, hi, klo, khi, index


def attention_share(p: Attention, cfg: ModelConfig) -> HeadShare:
    """The rank's :class:`HeadShare` when attention runs tensor-parallel
    (``act.tensor_parallel`` and ``wq``'s columns split over "model");
    else every head with ``tp`` None: the single-device code (also where
    the rules left ``wq`` whole, its width not divisible by "model")."""
    tp = act.tensor_parallel()
    if tp is None or p.wq.shape[-1] == cfg.n_heads * cfg.hd:
        return _every_head(cfg, None)
    return head_share(cfg, tp)


def _every_head(cfg: ModelConfig, tp: Optional[act.TP]) -> HeadShare:
    return HeadShare(cfg, 0, cfg.n_heads, 0, cfg.n_kv, None, tp)


def _affine(x, w, b):
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def _columns(x, w, b, width: int, a: int, z: int, tp: act.TP):
    """Columns ``a``..``z`` of ``x @ w + b`` (``width`` columns in all):
    the rank's own product when its columns of ``w`` are exactly those,
    else every rank's gathered over "model" (:func:`act.gather_model`) and
    sliced. A ``w`` the rules left whole (replicated over "model") gives
    the slice from its own columns, its gradient summed over "model"
    (``act.enter``: each rank uses a part)."""
    c = w.shape[-1]
    if c == width:
        if (a, z) != (0, width):
            w = act.enter(w)[..., a:z]
            b = None if b is None else act.enter(b)[a:z]
        return _affine(x, w, b)
    y = _affine(x, w, b)
    if (a, z) == (tp.rank * c, (tp.rank + 1) * c):
        return y
    return act.gather_cat(y)[..., a:z]


def qkv_project(p: Attention, x, cfg: ModelConfig, positions, rope=None,
                sh: Optional[HeadShare] = None):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd) with RoPE applied.
    ``rope``: ``rope_freqs(cfg, positions)`` when the caller computed it
    once for every layer (``positions`` is then unused). ``sh``: the heads
    to compute (:func:`attention_share`; None: every head, on one device):
    q (B, S, hi - lo, hd), k / v (B, S, sh.cfg.n_kv, hd). Tensor-parallel
    (``sh.tp``), ``x`` enters the column-parallel products
    (``act.enter``) and ``q_norm`` / ``k_norm`` (replicated over "model",
    applied to the rank's heads) have their gradients summed over it."""
    sh = sh or _every_head(cfg, None)
    b, s, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv
    enter = act.enter if sh.tp is not None else (lambda t: t)
    x = enter(x)
    bias = cfg.qkv_bias
    q = _columns(x, p.wq, p.bq if bias else None, h * hd, sh.lo * hd,
                 sh.hi * hd, sh.tp)
    k = _columns(x, p.wk, p.bk if bias else None, kv * hd, sh.klo * hd,
                 sh.khi * hd, sh.tp)
    v = _columns(x, p.wv, p.bv if bias else None, kv * hd, sh.klo * hd,
                 sh.khi * hd, sh.tp)
    q = q.reshape(b, s, sh.hi - sh.lo, hd)
    k = k.reshape(b, s, sh.khi - sh.klo, hd)
    v = v.reshape(b, s, sh.khi - sh.klo, hd)
    if cfg.qk_norm:
        q = _qk_rmsnorm(q, enter(p.q_norm))
        k = _qk_rmsnorm(k, enter(p.k_norm))
    if cfg.rope_theta > 0:
        cos, sin = rope if rope is not None else rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if sh.kv_index is not None:
        idx = torch.tensor(sh.kv_index, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v


def _gather_heads(out, cfg: ModelConfig, tp: act.TP):
    """Every rank's attention output (its ``j·H // m`` heads), gathered
    over "model" (padded to the most heads a rank has) -> (B, S, H·hd)."""
    h, m, hd = cfg.n_heads, tp.size, cfg.hd
    n = [(j + 1) * h // m - j * h // m for j in range(m)]
    pad = max(n) * hd - out.shape[-1]
    full = act.gather_model(F.pad(out, (0, pad)))
    return torch.cat([full[j, ..., :n[j] * hd] for j in range(m)], dim=-1)


def out_project(p: Attention, out, cfg: ModelConfig, sh: HeadShare):
    """``wo`` on the attention output of heads ``sh.lo``..``sh.hi``: on one
    device (``sh.tp`` None) the whole product; tensor-parallel, the rank's
    rows of H·hd (row-parallel; every head with ``lo, hi = 0, H``), the
    partial sums summed over "model" (``act.constrain``). Rows that do not
    line up with the rank's heads read every rank's output
    (:func:`_gather_heads`)."""
    hd, tp = cfg.hd, sh.tp
    if tp is None:
        return out @ p.wo.to(out.dtype)
    r = p.wo.shape[0]
    a, z = sh.lo * hd, sh.hi * hd
    own = (tp.rank * r, (tp.rank + 1) * r)
    if (a, z) != own:
        if (a, z) != (0, cfg.n_heads * hd):
            out = _gather_heads(out, cfg, tp)
        out = out[..., own[0]:own[1]]
    return act.constrain(out @ p.wo.to(out.dtype))


def causal_attention(p: Attention, x, cfg: ModelConfig, positions=None,
                     rope=None, causal=True):
    """Full (quadratic) attention over x (B, S, D); ``rope`` as in
    :func:`qkv_project`; ``causal=False``: every query sees every key
    (whisper's encoder)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sh = attention_share(p, cfg)
    q, k, v = qkv_project(p, x, cfg, positions, rope, sh)
    mask = None
    if causal:
        qpos = torch.arange(s, device=x.device)
        mask = (qpos[:, None] >= qpos[None, :])[None, None]
    return out_project(p, attend(q, k, v, mask, sh.cfg), cfg, sh)


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
    sh = attention_share(p, cfg)
    q, k, v = qkv_project(p, x, cfg, positions, None, sh)
    h, kv, hd = sh.cfg.n_heads, sh.cfg.n_kv, sh.cfg.hd
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
    return out_project(p, out.reshape(b, s, h * hd), cfg, sh)


def windowed_attention(p: Attention, x, cfg: ModelConfig, positions=None,
                       rope=None):
    """Chunked sliding-window attention (``cfg.window`` = W), exact for
    window <= chunk; ``rope`` as in :func:`qkv_project`.

    S is padded to a multiple of W; each chunk attends to itself and the
    previous chunk under the combined causal+window mask (chunk 0's zero
    "previous chunk" masked out). The (B·C, W, 2W) chunks go to
    :func:`attend` as one batch, so compute is O(S · 2W), not O(S²). For
    S <= W it is :func:`causal_attention`. Tensor-parallel, the rank's
    heads (:func:`attention_share`), as :func:`causal_attention`.
    """
    w = cfg.window
    b, s, _ = x.shape
    if s <= w:
        return causal_attention(p, x, cfg, positions, rope)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sh = attention_share(p, cfg)
    q, k, v = qkv_project(p, x, cfg, positions, rope, sh)
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
    h, kv, hd = sh.cfg.n_heads, sh.cfg.n_kv, sh.cfg.hd
    out = attend(qc.reshape(b * nchunk, w, h, hd),
                 kk.reshape(b * nchunk, 2 * w, kv, hd),
                 vv.reshape(b * nchunk, 2 * w, kv, hd),
                 mask.reshape(b * nchunk, 1, w, 2 * w), sh.cfg)
    out = out.reshape(b, nchunk * w, h * hd)[:, :s]
    return out_project(p, out, cfg, sh)


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


def _write(cache, new, sl: DecodeSlots, first: int = 0):
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at the step's
    row(s), in place; a slot whose row lies past the cache keeps its
    contents. ``first``: the cache holds rows ``first``.. of the sequence
    (a rank's slice of a sequence-split cache): a row outside them is
    another rank's, and kept."""
    new = new.to(cache.dtype)
    n = cache.shape[1]
    if first == 0 and n == sl.mask.shape[-1]:
        if sl.rows is None:
            cache.index_copy_(1, sl.write.reshape(1), new)
            return
        keep = sl.ok.reshape((-1,) + (1,) * (new.dim() - 2))
        cache[sl.rows, sl.write] = torch.where(keep, new[:, 0],
                                               cache[sl.rows, sl.write])
        return
    row = sl.write - first
    mine = (row >= 0) & (row < n)
    if sl.ok is not None:
        mine = mine & sl.ok
    row = row.clamp(0, n - 1)
    if sl.rows is None:
        row = row.reshape(1)
        cache.index_copy_(1, row, torch.where(mine, new,
                                              cache.index_select(1, row)))
        return
    keep = mine.reshape((-1,) + (1,) * (new.dim() - 2))
    cache[sl.rows, row] = torch.where(keep, new[:, 0], cache[sl.rows, row])


def cache_rows(cache_k, seq_dim: int = 2) -> int:
    """The sequence length of a KV cache (``seq_dim``: 2 for the stacked
    (L, B, S, KV, hd) leaf, 1 for a layer's): on a mesh whose decode step
    splits the cache over "model" by sequence (``act.kv_split("seq")``),
    the rank's rows times the ranks."""
    n = cache_k.shape[seq_dim]
    tp = act.tensor_parallel()
    return n * tp.size if tp is not None and tp.kv_split == "seq" else n


def _split_attend(q, k, v, mask, cfg: ModelConfig):
    """:func:`_sdpa` over a rank's slice of the keys, every rank's slice
    combined over "model" (flash-decode): the scores' max by one
    all-reduce, then the softmax denominators and the weighted values by
    one. Float32 throughout; -> (B, Sq, H·hd) in ``q.dtype``."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    b, sq = q.shape[:2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() / math.sqrt(hd)
    sc = torch.where(mask[:, :, None], sc, -1e30)       # (B,g,r,Sq,Sk)
    top = act.reduce_model(sc.amax(dim=-1), "max")
    pr = torch.exp(sc - top[..., None])
    o = torch.einsum("bgrqk,bkgd->bqgrd", pr, v.float())
    den = pr.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # (B,Sq,g,r,1)
    lo = act.reduce_model(torch.cat([den, o], dim=-1))
    out = lo[..., 1:] / lo[..., :1]
    return out.reshape(b, sq, h * hd).to(q.dtype)


def _decode(p: Attention, x, ck, cv, scales, sl: DecodeSlots,
            cfg: ModelConfig):
    """A decode step's attention, split over "model" as ``act.kv_split``
    says the cache is: None (one device, or a cache replicated over
    "model"): every head against the whole cache; ``"heads"``: the rank's
    query heads against its KV heads' cache; ``"seq"``: every head against
    the rank's rows of the cache (the new token written by the rank whose
    rows hold its position), combined over "model"
    (:func:`_split_attend`). ``scales``: the int8 cache's (ks, vs), split
    as the cache or (``"seq"``) replicated over "model"; None: a cache of
    K/V themselves. Returns what :func:`cached_decode_attention` (or its
    ``_q8``) returns."""
    sh = attention_share(p, cfg)
    tp = act.tensor_parallel()
    split = None if tp is None else tp.kv_split
    if split == "heads":
        if sh.tp is None or cfg.n_kv % tp.size or (
                scales is not None and scales[0].shape[2] != ck.shape[2]):
            raise ValueError("a KV cache split over its heads needs the "
                             "heads to divide 'model', the attention split "
                             "over them and the scales split as the cache")
    else:
        sh = _every_head(cfg, sh.tp)
    first = tp.rank * ck.shape[1] if split == "seq" else 0
    q, k, v = qkv_project(p, x, cfg, None, sl.rope, sh)
    if scales is None:
        _write(ck, k, sl, first)
        _write(cv, v, sl, first)
        kf, vf = ck.to(q.dtype), cv.to(q.dtype)
    else:
        ks, vs = scales
        k8, k_s = kv_quantize(k)
        v8, v_s = kv_quantize(v)
        _write(ck, k8, sl, first)
        _write(cv, v8, sl, first)
        rows = (first if ks.shape[1] == ck.shape[1] else 0)
        _write(ks, k_s, sl, rows)
        _write(vs, v_s, sl, rows)
        n = ck.shape[1]
        kf = kv_dequantize(ck, ks.narrow(1, first - rows, n), q.dtype)
        vf = kv_dequantize(cv, vs.narrow(1, first - rows, n), q.dtype)
    if split == "seq":
        mask = sl.mask[..., first:first + ck.shape[1]]
        out = _split_attend(q, kf, vf, mask, sh.cfg)
    else:
        out = attend(q, kf, vf, sl.mask, sh.cfg)
    out = out_project(p, out, cfg, sh)
    return (out, ck, cv) if scales is None else (out, ck, cv) + scales


def cached_decode_attention_q8(p: Attention, x, ck, cv, ks, vs, pos,
                               cfg: ModelConfig,
                               slots: Optional[DecodeSlots] = None):
    """Decode against an int8-quantized cache. ck/cv (B,S,KV,hd) int8,
    ks/vs (B,S,KV) float32, written in place. Returns (out, ck, cv, ks,
    vs). ``pos`` and ``slots`` as in :func:`cached_decode_attention`."""
    sl = slots if slots is not None else decode_slots(x, cache_rows(ck, 1),
                                                      pos, cfg)
    return _decode(p, x, ck, cv, (ks, vs), sl, cfg)


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
    sl = slots if slots is not None else decode_slots(
        x, cache_rows(cache_k, 1), pos, cfg)
    return _decode(p, x, cache_k, cache_v, None, sl, cfg)


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
    """SwiGLU (qwen/olmo/pixtral families) — silu(x wg) * (x wi) wo. Tensor
    parallel (``act.tensor_parallel`` and ``wi`` split over "model"): the
    rank's d_ff columns of ``wi`` / ``wg`` and rows of ``wo``, the partial
    sums summed over "model"."""
    tp = act.tensor_parallel() is not None and p.wi.shape[-1] < cfg.d_ff
    if tp:
        x = act.enter(x)
    g = F.silu(x @ p.wg.to(x.dtype))
    h = x @ p.wi.to(x.dtype)
    y = (g * h) @ p.wo.to(x.dtype)
    return act.constrain(y) if tp else y


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


def _vocab_first(p: Embed, cfg: ModelConfig) -> Optional[int]:
    """The first vocab row of the rank's slice when the vocab is split over
    "model" (``act.tensor_parallel`` and the embedding's rows split); None
    otherwise."""
    tp = act.tensor_parallel()
    v = p.embedding.shape[0]
    return None if tp is None or v == cfg.vocab else tp.rank * v


def _own(ids, first: int, n: int):
    """(``ids`` - ``first`` clamped into the slice, whether each id lies in
    the slice ``first``..``first + n``)."""
    t = ids.long() - first
    return t.clamp(0, n - 1), (t >= 0) & (t < n)


def embed(p: Embed, tokens, cfg: ModelConfig):
    """The embedding rows of ``tokens``; vocab-parallel: the rank's rows,
    zero for a token outside its slice, summed over "model"."""
    first = _vocab_first(p, cfg)
    if first is None:
        return p.embedding[tokens].to(cfg.torch_dtype)
    t, mine = _own(tokens, first, p.embedding.shape[0])
    e = p.embedding[t].to(cfg.torch_dtype) * mine[..., None]
    return act.constrain(e)


def unembed(p: Embed, x, cfg: ModelConfig):
    """Logits (..., V) float32; vocab-parallel: the rank's slice of the
    vocab (..., V / model), from ``x`` entering the column-parallel
    product."""
    w = p.embedding.T if cfg.tie_embeddings else p.lm_head
    if _vocab_first(p, cfg) is not None:
        x = act.enter(x)
    return (x @ w.to(x.dtype)).float()


def whole_logits(logits, cfg: ModelConfig):
    """``logits`` (B, V or its slice) with the whole vocab: a
    vocab-parallel rank's slices gathered over "model" (a serve step's
    last position alone, never the (B, S, V) logits)."""
    tp = act.tensor_parallel()
    if tp is None or logits.shape[-1] == cfg.vocab:
        return logits
    return act.gather_cat(logits)


def _nll_vocab_parallel(lf, labels, first: int):
    """``logsumexp - logit[label]`` over the vocab split over "model":
    the max (a constant of the sum) by one all-reduce, the sum of exps
    and the label's logit (zero off its slice) summed over "model"."""
    top = act.reduce_model(lf.amax(dim=-1), "max")
    lse = top + torch.log(act.constrain(
        torch.exp(lf - top[..., None]).sum(dim=-1)))
    t, mine = _own(labels, first, lf.shape[-1])
    ll = torch.gather(lf, -1, t[..., None])[..., 0] * mine
    return lse - act.constrain(ll)


def cross_entropy(logits, labels, mask=None, vocab: Optional[int] = None):
    """Mean token CE in float32. logits (B, S, V), labels (B, S) int.
    ``vocab``: the whole vocab's size, where ``logits`` may be a
    vocab-parallel rank's slice of it (``unembed``): then the sums run over
    "model" and the (B, S, V) logits are never gathered."""
    lf = logits.float()
    tp = act.tensor_parallel()
    if vocab is not None and tp is not None and lf.shape[-1] < vocab:
        nll = _nll_vocab_parallel(lf, labels, tp.rank * lf.shape[-1])
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
