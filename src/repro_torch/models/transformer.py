"""Dense GQA decoder-only transformer (qwen2 / qwen1.5 / qwen2.5 / olmo /
pixtral-backbone families), port of ``repro/models/transformer.py``.

The reference stacks each weight over a leading layer axis and runs the
layers under ``lax.scan``; here a :class:`Transformer` holds an
``nn.ModuleList`` of :class:`Block`\\ s (parameter containers, as the
layers' modules are) and a Python loop runs them. The family API is the
reference's, as plain functions over the module:
:func:`init`, :func:`forward`, :func:`loss_fn`, :func:`init_cache`,
:func:`decode_step`, :func:`prefill`. ``input_mode='embeds'`` (pixtral)
consumes precomputed frontend embeddings instead of token ids.

Each layer runs under ``layers.remat`` (the reference's
``jax.checkpoint``): with grad enabled its activations are recomputed in
the backward pass. The family is tensor-parallel (``tensor_parallel``):
on a mesh each rank computes its heads, d_ff columns and vocab slice
(``layers``, ``sharding.act``); :func:`forward` then returns the rank's
vocab slice of the logits, which :func:`loss_fn` reduces over "model"
without gathering them. Attention runs by the tensors' device
(``layers.attend``: SDPA on the card, the reference's grouped form on the
CPU); configs with ``chunked_attn`` run the chunked online-softmax form in
:func:`forward`, as the reference does. :func:`decode_step` writes the new
token's K/V into the cache's tensors in place (the reference returns new
arrays) and returns the cache dict with ``pos`` advanced.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.sharding import act


class Block(nn.Module):
    """One decoder layer: ``ln1`` → ``attn`` → residual, ``ln2`` → ``mlp``
    → residual."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.attn = L.attn_init(cfg, generator, device)
        self.mlp = L.mlp_init(cfg, generator, device)
        self.ln1 = L.norm_init(cfg, cfg.d_model, device)
        self.ln2 = L.norm_init(cfg, cfg.d_model, device)


class Transformer(nn.Module):
    """``embed``, ``layers`` (``cfg.n_layers`` blocks) and ``final_norm``."""
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        # layer by layer: each weight's float32 draw is the only transient
        self.layers = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.embed = L.embed_init(cfg, generator, device)
        self.final_norm = L.norm_init(cfg, cfg.d_model, device)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
         param_dtype: torch.dtype | None = None) -> Transformer:
    """Random weights drawn from ``generator`` (on ``device``): matrices
    N(0, 1/fan_in) (embeddings N(0, 0.02²)) in ``cfg.dtype`` (or
    ``param_dtype``: ``layers.param_cfg``), norm scales 1 and biases 0 in
    float32, as the reference initialises them."""
    return Transformer(L.param_cfg(cfg, param_dtype), generator,
                       ops.resolve_device(device))


def _attn(p: L.Attention, h, cfg: ModelConfig, rope):
    if cfg.chunked_attn:
        return L.chunked_causal_attention(p, h, cfg, block=cfg.attn_block)
    return L.causal_attention(p, h, cfg, rope=rope)


def _layer_fwd(p: Block, x, cfg: ModelConfig, rope=None):
    h = x + _attn(p.attn, L.apply_norm(p.ln1, x, cfg), cfg, rope)
    return h + L.apply_mlp(p.mlp, L.apply_norm(p.ln2, h, cfg), cfg)


def _rope(x, cfg: ModelConfig):
    """RoPE's cos/sin for positions 0..S-1, once for every layer."""
    if cfg.rope_theta <= 0:
        return None
    return L.rope_freqs(cfg, torch.arange(x.shape[1], device=x.device)[None])


def _inputs(model: Transformer, batch, cfg: ModelConfig):
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(cfg.torch_dtype)
    return L.embed(model.embed, batch["tokens"], cfg)


def backbone(model: Transformer, x, cfg: ModelConfig):
    """x (B, S, D) activations -> (B, S, D) after all layers."""
    rope = _rope(x, cfg)
    for blk in model.layers:
        x = L.remat(_layer_fwd, blk, x, cfg, rope)
    return L.apply_norm(model.final_norm, x, cfg)


def _logits(model: Transformer, batch, cfg: ModelConfig):
    x = backbone(model, _inputs(model, batch, cfg), cfg)
    return L.unembed(model.embed, x, cfg)


def forward(model: Transformer, batch, cfg: ModelConfig):
    """-> logits (B, S, V) float32 (on a mesh with a "model" axis the
    rank's vocab slice). On a mesh the non-layer parameters (the
    embedding, ``lm_head``, the final norm) are gathered over the data
    axes around the block loop (``act.gathered``), each block inside
    ``layers.remat``."""
    with act.gathered(model, "embed", "final_norm"):
        return _logits(model, batch, cfg)


def loss_fn(model: Transformer, batch, cfg: ModelConfig):
    with act.gathered(model, "embed", "final_norm"):
        logits = _logits(model, batch, cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               vocab=cfg.vocab)


# ------------------------------------------------------------- serving -----

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """(L, B, max_len, KV, hd) K and V caches in ``dtype`` (bfloat16
    whatever ``cfg.dtype`` is, as the reference), or int8 with float32
    per-token scales ``ks`` / ``vs`` under ``kv_quant``; ``pos`` a scalar."""
    dev = ops.resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.ones(shape[:-1], device=dev),
                "vs": torch.ones(shape[:-1], device=dev),
                "pos": pos}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": pos}


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, tokens, cfg: ModelConfig):
    """One token for every sequence in the batch. tokens (B,) int. The
    cache's ``pos`` is a scalar or (B,) per-slot positions. Returns
    (logits (B, V) float32, the cache with ``pos + 1``). On a mesh the
    non-layer parameters are gathered for the call and each block's
    inside the loop (``act.gathered``); with a "model" axis the cache is
    the rank's block (``serve.step``) and the logits are gathered over
    the vocab (``layers.whole_logits``)."""
    with act.gathered(model, "embed", "final_norm"):
        x = L.embed(model.embed, tokens[:, None], cfg)    # (B, 1, D)
        pos = cache["pos"]
        slots = L.decode_slots(x, L.cache_rows(cache["k"]), pos, cfg)
        for i, blk in enumerate(model.layers):
            with act.gathered(blk):
                x = _decode_block(blk, x, cache, i, pos, cfg, slots)
        x = L.apply_norm(model.final_norm, x, cfg)
        logits = L.whole_logits(L.unembed(model.embed, x, cfg)[:, 0], cfg)
    return logits, {**cache, "pos": pos + 1}


def _decode_block(blk: Block, x, cache: dict, i: int, pos, cfg: ModelConfig,
                  slots):
    """Block ``i``'s decode step, its K/V written into ``cache`` in
    place."""
    h = L.apply_norm(blk.ln1, x, cfg)
    if cfg.kv_quant:
        a = L.cached_decode_attention_q8(
            blk.attn, h, cache["k"][i], cache["v"][i], cache["ks"][i],
            cache["vs"][i], pos, cfg, slots)[0]
    else:
        a = L.cached_decode_attention(blk.attn, h, cache["k"][i],
                                      cache["v"][i], pos, cfg, slots)[0]
    x = x + a
    return x + L.apply_mlp(blk.mlp, L.apply_norm(blk.ln2, x, cfg), cfg)


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig,
            max_len: int | None = None, dtype=torch.bfloat16):
    """Populate a KV cache from a full prompt; returns (cache,
    last_logits). The cache holds ``dtype`` K/V zero-padded to
    ``max_len`` (no int8 cache, as in the reference) and ``pos`` = S. The
    engine's single-device prefill (a mesh's prefill step is
    ``serve.step.make_prefill_step``)."""
    x = _inputs(model, batch, cfg)
    b, s, _ = x.shape
    max_len = max_len or s
    rope = _rope(x, cfg)
    qpos = torch.arange(s, device=x.device)
    mask = (qpos[:, None] >= qpos[None, :])[None, None]
    shape = (cfg.n_layers, b, max_len, cfg.n_kv, cfg.hd)
    ks = torch.zeros(shape, dtype=dtype, device=x.device)
    vs = torch.zeros(shape, dtype=dtype, device=x.device)
    for i, blk in enumerate(model.layers):
        h = L.apply_norm(blk.ln1, x, cfg)
        q, k, v = L.qkv_project(blk.attn, h, cfg, None, rope)
        a = L.attend(q, k, v, mask, cfg) @ blk.attn.wo.to(x.dtype)
        x = x + a
        x = x + L.apply_mlp(blk.mlp, L.apply_norm(blk.ln2, x, cfg), cfg)
        ks[i, :, :s] = k
        vs[i, :, :s] = v
    x = L.apply_norm(model.final_norm, x, cfg)
    logits = L.unembed(model.embed, x[:, -1:], cfg)[:, 0]
    cache = {"k": ks, "v": vs,
             "pos": torch.full((), s, dtype=torch.int32, device=x.device)}
    return cache, logits
