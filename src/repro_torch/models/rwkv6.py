"""RWKV-6 "Finch" (rwkv6-1.6b), port of ``repro/models/rwkv6.py``:
attention-free, data-dependent decay.

Time mixing keeps a per-head matrix state S (hd × hd):

    out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ

with data-dependent decay ``w_t = exp(-exp(w0 + tanh(x_w A_w) B_w))`` and
token-shift interpolation with LoRA-modulated mixing coefficients (ddlerp).
Heads are fixed at 64 channels (H = d_model / 64).

A sequence longer than ``cfg.rwkv_chunk`` runs the chunk-parallel WKV
(:func:`_wkv_chunked`: a loop over S/c chunks carrying S), a shorter one
the per-token recurrence (:func:`_wkv_sequential`); decode is the O(1)
single-step update. The reference's casts are kept: projections in
``cfg.dtype``; r/k/v/w, the decay and the WKV state in float32. Weights
the reference uses in float32 (``lora_b``, ``decay_a``, ``decay_b``, the
mixing and decay vectors) are stored in float32, the projections in
``cfg.dtype``. Each layer runs under ``layers.remat`` (the reference's
``jax.checkpoint``). Parameters and the family API follow
:mod:`repro_torch.models.transformer`.

The family is tensor-parallel (``tensor_parallel``): on a mesh whose
"model" axis has more than one rank, each rank runs its heads of the time
mix (H / model of them where they divide "model"; else every head from
the gathered projections, and its rows of ``wo``), its d_ff columns of
the channel mix and its vocab slice, and decodes with its block of the
state (:func:`tm_step`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.sharding import act

_LORA = 32     # lora rank for the ddlerp / decay modulators
_MIX = 5       # r, w, k, v, g
_HD = 64       # rwkv head dim is fixed


class TimeMix(nn.Module):
    """ddlerp ``mu_x`` (d,), ``mu`` (5, d), ``lora_a`` (d, 5·32) and
    ``lora_b`` (5, 32, d); decay ``w0`` (d,), ``decay_a`` (d, 32),
    ``decay_b`` (32, d); bonus ``u`` (d,); projections ``wr`` ``wk`` ``wv``
    ``wg`` ``wo`` (d, d); the group norm's ``ln_scale`` (d,)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.torch_dtype, torch.float32
        s = 1.0 / math.sqrt(d)
        self.mu_x = L._const((d,), 0.5, device)
        self.mu = L._const((_MIX, d), 0.5, device)
        self.lora_a = L._normal(generator, (d, _MIX * _LORA), s, dt, device)
        self.lora_b = L._normal(generator, (_MIX, _LORA, d), 0.01, f32,
                                device)
        self.w0 = L._const((d,), -3.0, device)
        self.decay_a = L._normal(generator, (d, _LORA), s, f32, device)
        self.decay_b = L._normal(generator, (_LORA, d), 0.01, f32, device)
        self.u = L._normal(generator, (d,), 0.1, f32, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, L._normal(generator, (d, d), s, dt, device))
        self.ln_scale = L._const((d,), 1.0, device)


class ChannelMix(nn.Module):
    """``mu_k`` / ``mu_r`` (d,), ``wk`` (d, ff), ``wv`` (ff, d), ``wr``
    (d, d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.mu_k = L._const((d,), 0.5, device)
        self.mu_r = L._const((d,), 0.5, device)
        self.wk = L._normal(generator, (d, f), 1.0 / math.sqrt(d), dt, device)
        self.wv = L._normal(generator, (f, d), 1.0 / math.sqrt(f), dt, device)
        self.wr = L._normal(generator, (d, d), 1.0 / math.sqrt(d), dt, device)


def _ddlerp(p: TimeMix, x, xx):
    """Data-dependent token-shift mix -> [x_r, x_w, x_k, x_v, x_g]."""
    base = x + (xx - x) * p.mu_x.to(x.dtype)
    lora = torch.tanh(base @ p.lora_a.to(x.dtype))
    lora = lora.reshape(*lora.shape[:-1], _MIX, _LORA)
    delta = torch.einsum("...mr,mrd->...md", lora.float(),
                          p.lora_b.float())
    mix = p.mu + delta                                   # (B, S, 5, D)
    return [x + (xx - x) * mix[..., i, :].to(x.dtype) for i in range(_MIX)]


class _Route(NamedTuple):
    """How a time-mix block runs over "model": ``tp`` None on one device
    (or where the rules left its projections whole); else ``own``: the
    rank computes its own H / model heads (the heads divide "model"), or
    every rank computes every head from the gathered projections."""
    tp: Optional[act.TP]
    own: bool


def _route(p: TimeMix, cfg: ModelConfig) -> _Route:
    tp = act.tensor_parallel()
    if tp is None or p.wr.shape[-1] == cfg.d_model:
        return _Route(None, False)
    return _Route(tp, cfg.rwkv_heads % tp.size == 0)


def _tm_projections(p: TimeMix, x, xx, cfg: ModelConfig, rt: _Route):
    """Shared by the sequence and the step: r, k, v, w (..., h, hd)
    float32, the gate g in x's dtype, and the bonus ``u`` (h, hd) and the
    group norm's scale (h·hd) of those heads: every head on one device;
    tensor-parallel the rank's heads (``rt.own``: the mixed inputs enter
    the column-parallel ``wr`` / ``wk`` / ``wv`` / ``wg``, the decay's
    low-rank product the rank's columns of ``decay_b``, and ``w0``, ``u``,
    ``ln_scale`` and ``decay_b`` (replicated) are sliced after
    ``act.enter``, so their gradients sum over "model"), or every head
    (the rank's columns of r / k / v / g gathered with
    ``act.gather_replicated``; the decay whole). The ddlerp is replicated
    over "model": every rank computes it whole."""
    xr, xw, xk, xv, xg = _ddlerp(p, x, xx)
    t = torch.tanh(xw.float() @ p.decay_a.float())
    w0, decay_b, u, ln = p.w0, p.decay_b, p.u, p.ln_scale

    def proj(xi, wt):
        return xi @ wt.to(x.dtype)
    if rt.tp is not None:
        if rt.own:
            c = p.wr.shape[-1]
            w0, decay_b, u, ln = (act.own_block(act.enter(v), c)
                                  for v in (w0, decay_b, u, ln))
            t = act.enter(t)

            def proj(xi, wt):
                return act.enter(xi) @ wt.to(x.dtype)
        else:
            def proj(xi, wt):
                return act.gather_cat(act.enter(xi) @ wt.to(x.dtype),
                                      same=True)
    shape = (*x.shape[:-1], -1, _HD)
    r = proj(xr, p.wr).reshape(shape).float()
    k = proj(xk, p.wk).reshape(shape).float()
    v = proj(xv, p.wv).reshape(shape).float()
    g = F.silu(proj(xg, p.wg))
    dec = w0 + t @ decay_b.float()
    w = torch.exp(-torch.exp(dec)).reshape(shape)
    return r, k, v, g, w, u.reshape(-1, _HD), ln


def _gn(o, scale):
    """Per-head group norm on the wkv output (..., H, hd), population
    variance; ``scale`` (H·hd)."""
    mean = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 1e-5)
    return o.reshape(*o.shape[:-2], -1) * scale


def _tm_out(p: TimeMix, og, rt: _Route):
    """(o·g) @ ``wo``; tensor-parallel the rank's rows, summed over
    "model" (``act.constrain``). Where every rank ran every head, ``og``
    is replicated: it enters (``act.enter``) before the rank takes its
    rows, so that its gradient, and every gradient before it, is whole on
    every rank."""
    if rt.tp is None:
        return og @ p.wo.to(og.dtype)
    if not rt.own:
        og = act.own_block(act.enter(og), p.wo.shape[0])
    return act.constrain(og @ p.wo.to(og.dtype))


def _wkv_sequential(r, k, v, w, u):
    """The per-token recurrence. r/k/v/w (B, S, H, hd) float32, u (H, hd)
    -> (B, S, H, hd)."""
    b, s, h, hd = r.shape
    state = r.new_zeros(b, h, hd, hd)
    outs = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, t, ..., None] * state + kv
    return torch.stack(outs, dim=1)


def _wkv_chunked(r, k, v, w, u, chunk: int):
    """Chunk-parallel WKV (DESIGN.md §3/§7).

    Within a chunk of length c the recurrence expands to a masked
    quasi-attention:   out_t = r̃_t·S_in + Σ_{s<t}(r̃_t·k̃_s) v_s + (r_t⊙u⊙k_t)·v_t
    with r̃_t = r_t ⊙ exp(cum_{t-1} - cum_mid), k̃_s = k_s ⊙ exp(cum_mid - cum_s)
    (cum = within-chunk cumulative log-decay; the mid-chunk shift bounds
    the exponents by half a chunk of decay). A loop over S/c chunks
    carries S.
    """
    b, s, h, hd = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (s + pad) // chunk
    rc, kc, vc, wc = (t.reshape(b, n, chunk, h, hd) for t in (r, k, v, w))
    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = torch.cumsum(logw, dim=2)                # inclusive, (B,n,c,H,hd)
    cum_prev = cum - logw                          # exclusive (cum_{t-1})
    mid = cum[:, :, chunk // 2][:, :, None]
    r_t = rc * torch.exp(cum_prev - mid)
    k_t = kc * torch.exp(mid - cum)
    k_end = kc * torch.exp(cum[:, :, -1:] - cum)   # for the state update
    idx = torch.arange(chunk, device=r.device)
    mask = (idx[:, None] > idx[None, :]).to(r.dtype)
    state = r.new_zeros(b, h, hd, hd)
    outs = []
    for i in range(n):
        # intra-chunk masked quasi-attention, plus the current-token bonus
        scores = torch.einsum("bthk,bshk->bhts", r_t[:, i], k_t[:, i]) * mask
        intra = torch.einsum("bhts,bshv->bthv", scores, vc[:, i])
        bonus = torch.einsum("bthk,hk,bthk->bth", rc[:, i], u, kc[:, i])
        intra = intra + bonus[..., None] * vc[:, i]
        # inter-chunk: carry-in state
        carry = torch.einsum("bthk,bhkv->bthv",
                             rc[:, i] * torch.exp(cum_prev[:, i]), state)
        state = torch.exp(cum[:, i, -1])[..., None] * state + torch.einsum(
            "bshk,bshv->bhkv", k_end[:, i], vc[:, i])
        outs.append(intra + carry)
    return torch.stack(outs, dim=1).reshape(b, s + pad, h, hd)[:, :s]


def tm_fwd(p: TimeMix, x, cfg: ModelConfig):
    """Full-sequence time mixing. x (B, S, D)."""
    s = x.shape[1]
    xx = F.pad(x, (0, 0, 1, 0))[:, :-1]                  # token shift
    rt = _route(p, cfg)
    r, k, v, g, w, u, ln = _tm_projections(p, x, xx, cfg, rt)
    if s > cfg.rwkv_chunk:
        o = _wkv_chunked(r, k, v, w, u, cfg.rwkv_chunk)
    else:
        o = _wkv_sequential(r, k, v, w, u)
    o = _gn(o, ln).to(x.dtype)
    return _tm_out(p, o * g, rt)


def _whole(t, width: int, dim: int = -1):
    """A decode state's block -> the whole (gathered over "model", no
    gradient) where it is narrower than ``width`` along ``dim``."""
    return t if t.shape[dim] == width else act.gather_cat(t, dim)


def _mine(t, like, dim: int = -1):
    """``t`` (whole) cut to the rank's block where the state ``like`` is
    one."""
    n = like.shape[dim]
    return t if t.shape[dim] == n else act.own_block(t, n, dim)


def tm_step(p: TimeMix, x, state: dict, cfg: ModelConfig):
    """Single token. x (B, D); state {"S": (B,H,hd,hd) float32, "shift":
    (B, D)} -> (out (B, D), the new state). Tensor-parallel, the state is
    the rank's block (``rules.cache_specs``): ``shift`` its channels
    (gathered for the ddlerp, which reads all of them; the new one is the
    rank's channels of ``x``), ``S`` its heads (the heads divide "model":
    the rank's own), else its rows of the key dim (gathered: every rank
    runs every head, and keeps its rows of the new state)."""
    rt = _route(p, cfg)
    xx = _whole(state["shift"], cfg.d_model)[:, None].to(x.dtype)
    r, k, v, g, w, u, ln = _tm_projections(p, x[:, None], xx, cfg, rt)
    r, k, v, w = r[:, 0], k[:, 0], v[:, 0], w[:, 0]
    s0 = state["S"]
    if rt.own and s0.shape[1] != r.shape[1]:
        raise ValueError("an RWKV state not split over 'model' by head, "
                         "as the heads are")
    s_all = _whole(s0, _HD, -2)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, s_all + u[None, :, :, None] * kv)
    new_s = w[..., None] * s_all + kv
    o = _gn(out[:, None], ln).to(x.dtype)
    o = _tm_out(p, o * g, rt)
    return o[:, 0], {"S": _mine(new_s, s0, -2),
                     "shift": _mine(x, state["shift"])}


def cm_fwd(p: ChannelMix, x, xx, cfg: ModelConfig):
    """Channel mixing. Tensor-parallel: ``relu²(enter(xk) @ wk) @ wv`` on
    the rank's d_ff columns, summed over "model"; the receptance
    ``sigmoid(enter(xr) @ wr)`` on the rank's columns, gathered with
    ``act.gather_replicated`` (every rank multiplies the whole by the
    summed value)."""
    xk = x + (xx - x) * p.mu_k.to(x.dtype)
    xr = x + (xx - x) * p.mu_r.to(x.dtype)
    tp = act.tensor_parallel()
    ff = tp is not None and p.wk.shape[-1] < cfg.d_ff
    k = torch.square(F.relu((act.enter(xk) if ff else xk)
                            @ p.wk.to(x.dtype)))
    kv = k @ p.wv.to(x.dtype)
    if ff:
        kv = act.constrain(kv)
    if tp is not None and p.wr.shape[-1] < cfg.d_model:
        r = act.gather_cat(torch.sigmoid(act.enter(xr) @ p.wr.to(x.dtype)),
                           same=True)
    else:
        r = torch.sigmoid(xr @ p.wr.to(x.dtype))
    return r * kv


class Block(nn.Module):
    """``ln1`` → time mixing ``tm`` → residual, ``ln2`` → channel mixing
    ``cm`` → residual."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.tm = TimeMix(cfg, generator, device)
        self.cm = ChannelMix(cfg, generator, device)
        self.ln1 = L.norm_init(cfg, cfg.d_model, device)
        self.ln2 = L.norm_init(cfg, cfg.d_model, device)


class RWKV(nn.Module):
    """``embed``, ``layers`` (``cfg.n_layers`` blocks) and ``final_norm``."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.embed = L.embed_init(cfg, generator, device)
        self.final_norm = L.norm_init(cfg, cfg.d_model, device)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
         param_dtype: torch.dtype | None = None) -> RWKV:
    """Random weights drawn from ``generator`` (on ``device``), at the
    reference's scales and constants; projections in ``cfg.dtype`` (or
    ``param_dtype``)."""
    return RWKV(L.param_cfg(cfg, param_dtype), generator,
                ops.resolve_device(device))


def _layer_fwd(p: Block, x, cfg: ModelConfig):
    x = x + tm_fwd(p.tm, L.apply_norm(p.ln1, x, cfg), cfg)
    h = L.apply_norm(p.ln2, x, cfg)
    hh = F.pad(h, (0, 0, 1, 0))[:, :-1]
    return x + cm_fwd(p.cm, h, hh, cfg)


def _logits(model: RWKV, batch, cfg: ModelConfig):
    x = L.embed(model.embed, batch["tokens"], cfg)
    for blk in model.layers:
        x = L.remat(_layer_fwd, blk, x, cfg)
    x = L.apply_norm(model.final_norm, x, cfg)
    return L.unembed(model.embed, x, cfg)


def forward(model: RWKV, batch, cfg: ModelConfig):
    """-> logits (B, S, V) float32 (non-layer parameters gathered on a
    mesh, as ``transformer.forward``; with a "model" axis the rank's vocab
    slice)."""
    with act.gathered(model, "embed", "final_norm"):
        return _logits(model, batch, cfg)


def loss_fn(model: RWKV, batch, cfg: ModelConfig):
    with act.gathered(model, "embed", "final_norm"):
        logits = _logits(model, batch, cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               vocab=cfg.vocab)


# ------------------------------------------------------------- serving -----

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """O(1)-per-token state, independent of ``max_len``: the WKV state
    ``S`` (L, B, H, 64, 64) float32, and per layer the normed inputs of
    the last token to time mixing (``tm_shift``) and to channel mixing
    (``cm_shift``), (L, B, D) in ``dtype``."""
    dev = ops.resolve_device(device)
    l, b, d = cfg.n_layers, batch, cfg.d_model
    return {"S": torch.zeros((l, b, cfg.rwkv_heads, _HD, _HD), device=dev),
            "tm_shift": torch.zeros((l, b, d), dtype=dtype, device=dev),
            "cm_shift": torch.zeros((l, b, d), dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def decode_step(model: RWKV, cache: dict, tokens, cfg: ModelConfig):
    """One token for every sequence; the state is written in place.
    Returns (logits (B, V) float32, the cache with ``pos + 1``). On a
    mesh the non-layer parameters are gathered for the call and each
    block's inside the loop (``act.gathered``); with a "model" axis the
    state is the rank's block (:func:`tm_step`) and the logits are
    gathered over the vocab."""
    with act.gathered(model, "embed", "final_norm"):
        x = L.embed(model.embed, tokens[:, None], cfg)[:, 0]   # (B, D)
        for i, blk in enumerate(model.layers):
            with act.gathered(blk):
                x = _decode_block(blk, x, cache, i, cfg)
        x = L.apply_norm(model.final_norm, x[:, None], cfg)
        logits = L.whole_logits(L.unembed(model.embed, x, cfg)[:, 0], cfg)
    return logits, {**cache, "pos": cache["pos"] + 1}


def _decode_block(blk: Block, x, cache: dict, i: int, cfg: ModelConfig):
    """Block ``i``'s decode step, its state written into ``cache`` in
    place."""
    h = L.apply_norm(blk.ln1, x[:, None], cfg)[:, 0]
    o, st = tm_step(blk.tm, h, {"S": cache["S"][i],
                                "shift": cache["tm_shift"][i]}, cfg)
    x = x + o
    h = L.apply_norm(blk.ln2, x[:, None], cfg)[:, 0]
    cm_shift = cache["cm_shift"][i]
    o = cm_fwd(blk.cm, h[:, None],
               _whole(cm_shift, cfg.d_model)[:, None].to(x.dtype), cfg)[:, 0]
    cache["S"][i].copy_(st["S"])
    cache["tm_shift"][i].copy_(st["shift"])
    cm_shift.copy_(_mine(h, cm_shift))
    return x + o
