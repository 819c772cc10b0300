"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — mistral-nemo decoder backbone; the pixtral-ViT patch frontend
is a STUB (input_specs supplies precomputed patch/token embeddings)
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=131072, qkv_bias=False, norm="rmsnorm",
    rope_theta=1_000_000.0, input_mode="embeds",
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                          head_dim=16, d_ff=128, vocab=256)
