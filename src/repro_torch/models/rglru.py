"""RecurrentGemma / Griffin hybrid (recurrentgemma-9b), port of
``repro/models/rglru.py``: repeating (recurrent, recurrent, local
attention) blocks, each temporal-mixing block followed by the SwiGLU MLP.

The RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙ x_t)``
runs over a sequence as a doubling scan (:func:`linear_scan`: log2 S
steps of torch ops on float32 (a, b), where the reference runs
``lax.associative_scan``) and as a single-step update in decode. Local
attention is ``layers.windowed_attention``; decode keeps window-sized K/V
rings (``layers.decode_slots`` writes at ``pos % window``).

Parameters: ``groups`` of three blocks (rec1, rec2, attn) and a ``tail``
of ``n_layers % 3`` recurrent blocks, each an ``nn.ModuleList`` (the
reference stacks them on a leading axis). Weights the reference uses in
float32 (the LRU gates ``w_a`` / ``w_x``, their biases, ``lru_lambda``;
the conv taps, float32 in decode) are stored in float32, the projections
in ``cfg.dtype``. Each group and each tail block runs under
``layers.remat`` (the reference's ``jax.checkpoint``). The family API
follows :mod:`repro_torch.models.transformer`.

The family is tensor-parallel (``tensor_parallel``): on a mesh whose
"model" axis has more than one rank, each rank runs its W / model
channels of every recurrent block (the conv, the gates' columns, the
scan, ``w_out``'s rows; ``u`` gathered over "model" for the dense gate
products), its heads of the local attention (K / V gathered: KV = 1), its
d_ff columns and its vocab slice, and decodes with its channels of each
state and its rows of each K/V ring.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L, transformer as T
from repro_torch.models.base import ModelConfig
from repro_torch.sharding import act

_C = 8.0   # RG-LRU decay sharpness constant (Griffin)


def _w(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


# ------------------------------------------------------- recurrent block ---

class Recurrent(nn.Module):
    """``w_in`` / ``w_gate`` (d, W), ``w_out`` (W, d); the causal conv's
    ``conv_w`` (cw, W) and ``conv_b`` (W,); the LRU's ``lru_lambda`` (W,)
    and gates ``w_a`` / ``w_x`` (W, W) with biases ``b_a`` / ``b_x``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        d, w, dt, f32 = cfg.d_model, _w(cfg), cfg.torch_dtype, torch.float32
        s_d, s_w = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
        self.w_in = L._normal(generator, (d, w), s_d, dt, device)
        self.w_gate = L._normal(generator, (d, w), s_d, dt, device)
        self.w_out = L._normal(generator, (w, d), s_w, dt, device)
        self.conv_w = L._normal(generator, (cfg.conv_width, w), 0.1, f32,
                                device)
        self.conv_b = L._const((w,), 0.0, device)
        lam = torch.rand((w,), generator=generator, device=device)
        self.lru_lambda = nn.Parameter(lam.mul_(0.8).add_(0.1))
        self.w_a = L._normal(generator, (w, w), s_w, f32, device)
        self.b_a = L._const((w,), 0.0, device)
        self.w_x = L._normal(generator, (w, w), s_w, f32, device)
        self.b_x = L._const((w,), 0.0, device)


def _causal_conv(p: Recurrent, x):
    """Per-channel causal conv, width cw. x (B, S, W)."""
    cw = p.conv_w.shape[0]
    out = torch.zeros_like(x)
    for j in range(cw):
        shifted = F.pad(x, (0, 0, j, 0))[:, :x.shape[1]]
        out = out + shifted * p.conv_w[cw - 1 - j].to(x.dtype)
    return out + p.conv_b.to(x.dtype)


def _split(p: Recurrent, cfg: ModelConfig) -> bool:
    """Whether the block runs its rank's channels: tensor-parallel and
    ``w_in``'s columns split over "model"."""
    return act.tensor_parallel() is not None and p.w_in.shape[-1] < _w(cfg)


def _lru_coeffs(p: Recurrent, u, split: bool = False):
    """u (..., W) conv output -> (a, b) recurrence coefficients
    (float32). ``split``: ``u`` is the rank's channels, every rank's
    gathered over "model" for the gates (dense (W, W) products whose
    columns are the rank's: ``act.gather_model``, each rank's gradient of
    the whole a partial sum), ``b`` from the rank's own."""
    uf = u.float()
    whole = act.gather_cat(uf) if split else uf
    r = torch.sigmoid(whole @ p.w_a + p.b_a)
    i = torch.sigmoid(whole @ p.w_x + p.b_x)
    log_a = -_C * F.softplus(p.lru_lambda) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def linear_scan(a, b):
    """h_t = a_t ⊙ h_{t-1} + b_t along dim 1, from h = 0: a doubling
    (Hillis-Steele) scan of the pairs (a, b) under
    (a1, b1) ∘ (a2, b2) = (a1·a2, b1·a2 + b2), log2 S steps of
    elementwise torch ops. Returns h, the shape of b."""
    s, off = a.shape[1], 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return b


def _out(p: Recurrent, h, gate, split: bool):
    """(h·gate) @ ``w_out``; ``split``: the rank's rows, summed over
    "model"."""
    y = (h.to(gate.dtype) * gate) @ p.w_out.to(gate.dtype)
    return act.constrain(y) if split else y


def rec_fwd(p: Recurrent, x, cfg: ModelConfig):
    """Full-sequence recurrent block. x (B, S, D) -> (B, S, D).
    Tensor-parallel, the rank's W / model channels (``w_in`` / ``w_gate``
    columns, the conv, the scan, ``w_out`` rows), ``x`` entering the
    column-parallel products (``act.enter``)."""
    split = _split(p, cfg)
    if split:
        x = act.enter(x)
    u = _causal_conv(p, x @ p.w_in.to(x.dtype))
    h = linear_scan(*_lru_coeffs(p, u, split))
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(x @ p.w_gate.to(x.dtype), approximate="tanh")
    return _out(p, h, gate, split)


def rec_step(p: Recurrent, x, state: dict, cfg: ModelConfig):
    """Single-token step. x (B, 1, D); state {"h": (B, W) float32, "conv":
    (B, cw-1, W)} -> (out (B, 1, D), the new state). Tensor-parallel, the
    state is the rank's channels (``rules.cache_specs``), as
    :func:`rec_fwd` computes them."""
    split = _split(p, cfg)
    if split and state["h"].shape[-1] != p.w_in.shape[-1]:
        raise ValueError("an RG-LRU state not split over 'model' as its "
                         "channels are")
    xi = x[:, 0] @ p.w_in.to(x.dtype)                     # (B, W)
    dt = torch.promote_types(state["conv"].dtype, xi.dtype)
    hist = torch.cat([state["conv"].to(dt), xi[:, None].to(dt)], dim=1)
    u = torch.einsum("bcw,cw->bw", hist.float(), p.conv_w.float()) \
        + p.conv_b
    a, b = _lru_coeffs(p, u, split)
    h = a * state["h"] + b
    gate = F.gelu(x[:, 0] @ p.w_gate.to(x.dtype), approximate="tanh")
    return _out(p, h, gate, split)[:, None], {
        "h": h, "conv": hist[:, 1:].to(state["conv"].dtype)}


# --------------------------------------------------------------- blocks ----

class Block(nn.Module):
    """``ln1`` → ``mix`` (:class:`Recurrent`, or local attention) →
    residual, ``ln2`` → ``mlp`` → residual."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device,
                 kind: str):
        super().__init__()
        self.mix = (Recurrent(cfg, generator, device) if kind == "rec"
                    else L.attn_init(cfg, generator, device))
        self.mlp = L.mlp_init(cfg, generator, device)
        self.ln1 = L.norm_init(cfg, cfg.d_model, device)
        self.ln2 = L.norm_init(cfg, cfg.d_model, device)


class Group(nn.Module):
    """Blocks ``rec1``, ``rec2`` and ``attn``."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.rec1 = Block(cfg, generator, device, "rec")
        self.rec2 = Block(cfg, generator, device, "rec")
        self.attn = Block(cfg, generator, device, "attn")


def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.attn_every or 3
    return cfg.n_layers // per, cfg.n_layers % per


class Griffin(nn.Module):
    """``embed``, ``groups``, ``tail`` (absent when ``n_layers % 3`` is 0)
    and ``final_norm``."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        g, tail = n_groups(cfg)
        self.groups = nn.ModuleList(Group(cfg, generator, device)
                                    for _ in range(g))
        if tail:
            self.tail = nn.ModuleList(Block(cfg, generator, device, "rec")
                                      for _ in range(tail))
        self.embed = L.embed_init(cfg, generator, device)
        self.final_norm = L.norm_init(cfg, cfg.d_model, device)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
         param_dtype: torch.dtype | None = None) -> Griffin:
    """Random weights drawn from ``generator`` (on ``device``), at the
    reference's scales (``lru_lambda`` uniform in [0.1, 0.9)); projections
    in ``cfg.dtype`` (or ``param_dtype``)."""
    return Griffin(L.param_cfg(cfg, param_dtype), generator,
                   ops.resolve_device(device))


def _block_fwd(p: Block, x, cfg: ModelConfig, rope=None):
    h = L.apply_norm(p.ln1, x, cfg)
    if isinstance(p.mix, Recurrent):
        x = x + rec_fwd(p.mix, h, cfg)
    else:
        x = x + L.windowed_attention(p.mix, h, cfg, rope=rope)
    return x + L.apply_mlp(p.mlp, L.apply_norm(p.ln2, x, cfg), cfg)


def _group_fwd(grp: Group, x, cfg: ModelConfig, rope):
    for blk in (grp.rec1, grp.rec2, grp.attn):
        x = _block_fwd(blk, x, cfg, rope)
    return x


def _logits(model: Griffin, batch, cfg: ModelConfig):
    x = L.embed(model.embed, batch["tokens"], cfg)
    rope = T._rope(x, cfg)
    for grp in model.groups:
        x = L.remat(_group_fwd, grp, x, cfg, rope)
    for blk in getattr(model, "tail", ()):
        x = L.remat(_block_fwd, blk, x, cfg)
    x = L.apply_norm(model.final_norm, x, cfg)
    return L.unembed(model.embed, x, cfg)


def forward(model: Griffin, batch, cfg: ModelConfig):
    """-> logits (B, S, V) float32 (non-layer parameters gathered on a
    mesh, as ``transformer.forward``; with a "model" axis the rank's vocab
    slice)."""
    with act.gathered(model, "embed", "final_norm"):
        return _logits(model, batch, cfg)


def loss_fn(model: Griffin, batch, cfg: ModelConfig):
    with act.gathered(model, "embed", "final_norm"):
        logits = _logits(model, batch, cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               vocab=cfg.vocab)


# ------------------------------------------------------------- serving -----

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Recurrent state and ring-buffer attention caches: ``rec1`` /
    ``rec2`` (and ``tail``) hold ``h`` (n, B, W) float32 and ``conv``
    (n, B, cw-1, W) in ``dtype``; ``k`` / ``v`` (G, B, win, KV, hd) with
    win = min(window, max_len), so memory is O(window), not
    O(max_len)."""
    dev = ops.resolve_device(device)
    g, tail = n_groups(cfg)
    w = _w(cfg)
    win = min(cfg.window or max_len, max_len)

    def rec_state(n):
        return {"h": torch.zeros((n, batch, w), device=dev),
                "conv": torch.zeros((n, batch, cfg.conv_width - 1, w),
                                    dtype=dtype, device=dev)}

    shape = (g, batch, win, cfg.n_kv, cfg.hd)
    cache = {"rec1": rec_state(g), "rec2": rec_state(g),
             "k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev),
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if tail:
        cache["tail"] = rec_state(tail)
    return cache


def _rec_block_step(p: Block, x, st: dict, i: int, cfg: ModelConfig):
    """One recurrent block's decode step on layer ``i`` of the state
    ``st``, written in place."""
    o, new = rec_step(p.mix, L.apply_norm(p.ln1, x, cfg),
                      {"h": st["h"][i], "conv": st["conv"][i]}, cfg)
    st["h"][i].copy_(new["h"])
    st["conv"][i].copy_(new["conv"])
    x = x + o
    return x + L.apply_mlp(p.mlp, L.apply_norm(p.ln2, x, cfg), cfg)


@torch.no_grad()
def decode_step(model: Griffin, cache: dict, tokens, cfg: ModelConfig):
    """One token for every sequence; states and K/V rings written in
    place. Returns (logits (B, V) float32, the cache with ``pos + 1``).
    On a mesh the non-layer parameters are gathered for the call and each
    group's or tail block's inside its loop (``act.gathered``); with a
    "model" axis the states are the rank's channels and the K/V rings its
    block (``serve.step``: over the sequence, as KV = 1 cannot be split),
    and the logits are gathered over the vocab."""
    with act.gathered(model, "embed", "final_norm"):
        x = L.embed(model.embed, tokens[:, None], cfg)
        pos = cache["pos"]
        slots = L.decode_slots(x, L.cache_rows(cache["k"]), pos, cfg)
        for i, grp in enumerate(model.groups):
            with act.gathered(grp):
                x = _group_step(grp, x, cache, i, pos, cfg, slots)
        for i, blk in enumerate(getattr(model, "tail", ())):
            with act.gathered(blk):
                x = _rec_block_step(blk, x, cache["tail"], i, cfg)
        x = L.apply_norm(model.final_norm, x, cfg)
        logits = L.whole_logits(L.unembed(model.embed, x, cfg)[:, 0], cfg)
    return logits, {**cache, "pos": pos + 1}


def _group_step(grp: Group, x, cache: dict, i: int, pos, cfg: ModelConfig,
                slots):
    """Group ``i``'s decode step: its two recurrent blocks and its
    attention block, the states and K/V ring written in place."""
    x = _rec_block_step(grp.rec1, x, cache["rec1"], i, cfg)
    x = _rec_block_step(grp.rec2, x, cache["rec2"], i, cfg)
    h = L.apply_norm(grp.attn.ln1, x, cfg)
    x = x + L.cached_decode_attention(grp.attn.mix, h, cache["k"][i],
                                      cache["v"][i], pos, cfg, slots)[0]
    return x + L.apply_mlp(grp.attn.mlp, L.apply_norm(grp.attn.ln2, x, cfg),
                           cfg)
