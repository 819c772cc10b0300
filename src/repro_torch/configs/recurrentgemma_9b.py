"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1, local attn)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 1 attn per 3 blocks,
window 2048 [arXiv:2402.19427]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, head_dim=256,
    d_ff=12288, vocab=256000, norm="rmsnorm", rope_theta=10_000.0,
    attn_every=3, window=2048, lru_width=4096, conv_width=4,
    tie_embeddings=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=8, d_model=64, n_heads=4, n_kv=1,
                          head_dim=16, d_ff=128, vocab=256, window=16,
                          lru_width=64)
