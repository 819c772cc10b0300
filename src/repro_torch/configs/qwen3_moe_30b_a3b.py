"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8, qk-norm [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, head_dim=128,
    d_ff=768, vocab=151936, qkv_bias=False, qk_norm=True, norm="rmsnorm",
    rope_theta=1_000_000.0, n_experts=128, top_k=8,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                          head_dim=16, d_ff=32, vocab=256, n_experts=8,
                          top_k=2)
