"""whisper-medium [audio]: 24L (enc) + 24L (dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — enc-dec; conv/mel frontend is a STUB (input_specs
supplies precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="whisper",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16,
    head_dim=64, d_ff=4096, vocab=51865, qkv_bias=True, norm="layernorm",
    rope_theta=0.0, input_mode="encdec", dec_len=448,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                          n_kv=4, head_dim=16, d_ff=128, vocab=256,
                          dec_len=16)
