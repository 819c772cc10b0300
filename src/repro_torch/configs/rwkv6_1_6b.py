"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=7168, vocab=65536, norm="layernorm",
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=2, n_kv=2,
                          head_dim=64, d_ff=256, vocab=256)
