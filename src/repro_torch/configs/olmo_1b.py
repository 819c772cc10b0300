"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304
— non-parametric LayerNorm, no biases, tied embeddings [arXiv:2402.00838]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=8192, vocab=50304, qkv_bias=False, norm="layernorm_nonparam",
    rope_theta=10_000.0, tie_embeddings=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=4,
                          head_dim=16, d_ff=128, vocab=256)
