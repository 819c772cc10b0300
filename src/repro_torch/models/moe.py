"""Mixture-of-Experts decoder (qwen3-moe family), port of
``repro/models/moe.py``: token-choice top-k routing with capacity-bounded
dispatch, no (T, E, C) one-hot tensors (DESIGN.md §4).

Dispatch (per group): each (token, slot) gets its position in its expert
from a cumsum over the token-major (S·k, E) assignment matrix; an
assignment at or past the capacity ``c`` is dropped and goes to the trash
slot ``E·c``. Token ids are scattered into the slots, the (E, C, D) buffer
is gathered from them (an unfilled slot gathers the zero pad row ``S``),
the expert FFNs run as one batched einsum over E, and each slot's gated
output is added back to its token (``index_add_``). Dropped tokens pass
through the residual: GShard semantics. ``forward`` groups by sequence;
``decode_step`` makes the whole batch one group of B tokens, as the
reference does; the two differ exactly when tokens are dropped.

On a mesh the family is tensor-parallel as the dense one (attention,
vocab) with its experts over "model" (EP): the router runs on the
replicated activations, so every rank routes, dispatches and drops
exactly as one device does; the rank builds its experts' tile of the
dispatch buffer locally (``act.constrain_expert``, the reference's
(B over data, E over model) layout), runs them, adds their gated outputs
and sums over "model" (``act.constrain``). No all-to-all, no expert
weight gathered over "model". The reference's ``jax.checkpoint`` of each
layer is ``layers.remat`` (the recomputed routing is the first pass's:
the stable sort is deterministic). Parameters and the family API follow
:mod:`repro_torch.models.transformer`.
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


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert: the reference's Python float expression, so that
    ``ceil`` agrees at exact integers."""
    c = int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(c, cfg.top_k)


class MoE(nn.Module):
    """``router`` (d, E), ``wi`` / ``wg`` (E, d, f), ``wo`` (E, f, d), in
    ``cfg.dtype`` (the reference casts each to the activations' dtype at
    use)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        s_in, s_out, dt = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f), \
            cfg.torch_dtype
        self.router = L._normal(generator, (d, e), s_in, dt, device)
        self.wi = L._normal(generator, (e, d, f), s_in, dt, device)
        self.wg = L._normal(generator, (e, d, f), s_in, dt, device)
        self.wo = L._normal(generator, (e, f, d), s_out, dt, device)


def top_k(gates, k: int):
    """The k largest of ``gates`` along the last axis, largest first and
    the lowest index first among equal gates, as ``jax.lax.top_k`` orders
    them (``torch.topk`` leaves the order of ties unspecified)."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(p: MoE, x, cfg: ModelConfig):
    """x (B, S, D) -> normalised top-k gates (B, S, k) in x's dtype and
    expert ids (B, S, k). The router product runs in x's dtype (bfloat16
    on the card), the softmax in float32."""
    logits = (x @ p.router.to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, cfg.top_k)
    return (topv / topv.sum(-1, keepdim=True)).to(x.dtype), topi


def dispatch(topi, n_experts: int, c: int):
    """Expert ids (B, S, k) -> (the slot of each (token, slot) assignment
    (B, S·k), ``E·c`` where it is dropped; ``keep`` (B, S, k))."""
    b, s, k = topi.shape
    onehot = F.one_hot(topi, n_experts)                  # (B, S, k, E)
    pos = torch.cumsum(onehot.reshape(b, s * k, n_experts), dim=1) - 1
    pos = (pos.reshape(b, s, k, n_experts) * onehot).sum(-1)   # (B, S, k)
    keep = pos < c
    slot = topi * c + torch.where(keep, pos, 0)
    return torch.where(keep, slot, n_experts * c).reshape(b, s * k), keep


def apply_moe(p: MoE, x, cfg: ModelConfig):
    """x (B, S, D) -> (B, S, D); groups = sequences. Expert-parallel
    (``act.tensor_parallel`` and the experts split over "model"): the rank
    runs its experts' slots alone, its ``x`` and gates entering that part
    (``act.enter``), and the output is summed over "model"."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    el = p.wi.shape[0]                      # the rank's experts
    ep = act.tensor_parallel() is not None and el < e
    c = capacity(cfg, s)
    topv, topi = route(p, x, cfg)
    flat_slot, _ = dispatch(topi, e, c)
    if ep:
        x, topv = act.enter(x), act.enter(topv)
    # token ids into their slots (trash slot E·c sliced off; unfilled
    # slots keep the pad id S), then the rank's experts' slots
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    slot_tok = torch.full((b, e * c + 1), s, dtype=torch.long,
                          device=x.device)
    slot_tok = slot_tok.scatter_(1, flat_slot,
                                 tok.expand(b, s * k))[:, :e * c]
    if ep:
        slot_tok = act.constrain_expert(slot_tok, el * c)
    # the buffer by a gather
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    xe = torch.gather(x_pad, 1, slot_tok[..., None].expand(b, el * c, d))
    xe = xe.reshape(b, el, c, d)
    g = F.silu(torch.einsum("becd,edf->becf", xe, p.wg.to(x.dtype)))
    h = torch.einsum("becd,edf->becf", xe, p.wi.to(x.dtype))
    ye = torch.einsum("becf,efd->becd", g * h, p.wo.to(x.dtype))
    gate_slot = x.new_zeros(b, e * c + 1).scatter_(
        1, flat_slot, topv.reshape(b, s * k))[:, :e * c]
    if ep:
        gate_slot = act.constrain_expert(gate_slot, el * c)
    # combine: each slot's gated output added to its token (pad row S
    # takes the unfilled slots)
    rows = torch.arange(b, device=x.device)[:, None] * (s + 1)
    out = x.new_zeros(b * (s + 1), d)
    out.index_add_(0, (rows + slot_tok).reshape(-1),
                   (ye.reshape(b, el * c, d) * gate_slot[..., None]
                    ).reshape(-1, d))
    out = out.reshape(b, s + 1, d)[:, :s]
    return act.constrain(out) if ep else out


class Block(nn.Module):
    """One decoder layer: ``ln1`` → ``attn`` → residual, ``ln2`` →
    ``moe`` → residual."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.attn = L.attn_init(cfg, generator, device)
        self.moe = MoE(cfg, generator, device)
        self.ln1 = L.norm_init(cfg, cfg.d_model, device)
        self.ln2 = L.norm_init(cfg, cfg.d_model, device)


class MoETransformer(nn.Module):
    """``embed``, ``layers`` (``cfg.n_layers`` blocks) and ``final_norm``."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.embed = L.embed_init(cfg, generator, device)
        self.final_norm = L.norm_init(cfg, cfg.d_model, device)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
         param_dtype: torch.dtype | None = None) -> MoETransformer:
    """Random weights drawn from ``generator`` (on ``device``): matrices
    N(0, 1/fan_in) (the experts' ``wo`` 1/d_ff) in ``cfg.dtype`` (or
    ``param_dtype``), norm scales 1 in float32, as the reference
    initialises them."""
    return MoETransformer(L.param_cfg(cfg, param_dtype), generator,
                          ops.resolve_device(device))


def _layer_fwd(p: Block, x, cfg: ModelConfig, rope=None):
    h = x + T._attn(p.attn, L.apply_norm(p.ln1, x, cfg), cfg, rope)
    return h + apply_moe(p.moe, L.apply_norm(p.ln2, h, cfg), cfg)


def _logits(model: MoETransformer, batch, cfg: ModelConfig):
    x = L.embed(model.embed, batch["tokens"], cfg)
    rope = T._rope(x, cfg)
    for blk in model.layers:
        x = L.remat(_layer_fwd, blk, x, cfg, rope)
    x = L.apply_norm(model.final_norm, x, cfg)
    return L.unembed(model.embed, x, cfg)


def forward(model: MoETransformer, batch, cfg: ModelConfig):
    """-> logits (B, S, V) float32 (non-layer parameters gathered on a
    mesh, and the rank's vocab slice with a "model" axis, as
    ``transformer.forward``)."""
    with act.gathered(model, "embed", "final_norm"):
        return _logits(model, batch, cfg)


def loss_fn(model: MoETransformer, batch, cfg: ModelConfig):
    with act.gathered(model, "embed", "final_norm"):
        logits = _logits(model, batch, cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               vocab=cfg.vocab)


# ------------------------------------------------------------- serving -----

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """(L, B, max_len, KV, hd) K and V caches in ``dtype``; ``pos`` a
    scalar."""
    dev = ops.resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def decode_step(model: MoETransformer, cache: dict, tokens,
                cfg: ModelConfig):
    """One token for every sequence; the MoE dispatch groups the whole
    batch as one group of B tokens (on a mesh every data rank's tokens,
    gathered: ``act.whole_batch``). ``pos`` scalar or per slot; K/V
    written in place. Returns (logits (B, V) float32, the cache with
    ``pos + 1``). On a mesh the non-layer parameters are gathered for the
    call and each block's inside the loop (``act.gathered``); with a
    "model" axis as ``transformer.decode_step``."""
    with act.gathered(model, "embed", "final_norm"):
        x = L.embed(model.embed, tokens[:, None], cfg)    # (B, 1, D)
        pos = cache["pos"]
        slots = L.decode_slots(x, L.cache_rows(cache["k"]), pos, cfg)
        for i, blk in enumerate(model.layers):
            with act.gathered(blk):
                h = L.apply_norm(blk.ln1, x, cfg)
                x = x + L.cached_decode_attention(
                    blk.attn, h, cache["k"][i], cache["v"][i], pos, cfg,
                    slots)[0]
                h = act.whole_batch(L.apply_norm(blk.ln2, x, cfg)[:, 0])
                y = apply_moe(blk.moe, h[None], cfg)[0]
                x = x + act.batch_rows(y, x.shape[0])[:, None]
        x = L.apply_norm(model.final_norm, x, cfg)
        logits = L.whole_logits(L.unembed(model.embed, x, cfg)[:, 0], cfg)
    return logits, {**cache, "pos": pos + 1}
