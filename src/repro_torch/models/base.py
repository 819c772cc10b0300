"""Model configuration shared by all assigned architecture families (port
of ``repro/models/base.py``, copied by value; :attr:`ModelConfig.torch_dtype`
is the port's own)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | rglru | rwkv6 | whisper
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False       # qwen3-style per-head RMSNorm on q/k
    norm: str = "rmsnorm"       # rmsnorm | layernorm | layernorm_nonparam
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (RG-LRU) ---
    attn_every: int = 0         # 1 attention block per this many (0 = none)
    window: int = 0             # sliding-window size for local attention
    lru_width: int = 0
    conv_width: int = 4
    kv_quant: bool = False      # int8 KV cache for decode (dense family)
    chunked_attn: bool = False  # flash-style online-softmax attention for
                                # train/prefill (never materializes (S,S))
    attn_block: int = 512
    # --- rwkv ---
    rwkv_chunk: int = 128       # chunk-parallel WKV width (train/prefill)
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    dec_len: int = 448          # decoder length used for train shapes
    # --- input handling ---
    input_mode: str = "tokens"  # tokens | embeds (stub frontend) | encdec
    dtype: str = "bfloat16"     # activation/compute dtype

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // 64   # RWKV6 uses fixed 64-dim heads

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype ``dtype`` names, e.g. ``torch.bfloat16``."""
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        d, ff, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, h, kv = self.hd, self.n_heads, self.n_kv
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            tm = 6 * d * d            # r,k,v,g,o,w projections (approx, incl. lora)
            cm = 2 * d * ff
            return emb + l * (tm + cm)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * ff
        else:
            mlp = 3 * d * ff
        if self.family == "rglru":
            g = self.n_layers // (self.attn_every or 3)
            rec_layers = l - g
            w = self.lru_width or d
            rec = 2 * d * w + w * d + 4 * w   # in/gate/out proj + lru params
            return emb + rec_layers * (rec + mlp) + g * (attn + mlp)
        if self.family == "whisper":
            enc = self.enc_layers * (attn + mlp)
            dec = l * (2 * attn + mlp)        # self + cross attention
            return emb + enc + dec
        return emb + l * (attn + mlp)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, h, kv = self.hd, self.n_heads, self.n_kv
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = self.top_k * 3 * d * ff
        return emb + l * (attn + mlp)
