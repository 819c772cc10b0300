"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
— GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, head_dim=128,
    d_ff=18944, vocab=152064, qkv_bias=True, norm="rmsnorm",
    rope_theta=1_000_000.0,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                          head_dim=16, d_ff=128, vocab=256)
