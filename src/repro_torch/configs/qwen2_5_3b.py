"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5 family; hf]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv=2, head_dim=128,
    d_ff=11008, vocab=151936, qkv_bias=True, norm="rmsnorm",
    rope_theta=1_000_000.0,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                          head_dim=16, d_ff=128, vocab=256)
