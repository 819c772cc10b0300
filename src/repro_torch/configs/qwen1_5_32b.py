"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, i.e. MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5 family; hf]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, head_dim=128,
    d_ff=27392, vocab=152064, qkv_bias=True, norm="rmsnorm",
    rope_theta=1_000_000.0,
    # MHA (kv=40): the int8 KV cache halves the decode cache's bytes
    # (the port's ServeEngine refuses it, as the reference's cannot serve it)
    kv_quant=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=4,
                          head_dim=16, d_ff=160, vocab=256)
