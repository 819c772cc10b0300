"""PyTorch / CUDA port of the Dynamic Prober for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``kernels``, ``data``) so each module's counterpart is easy to
find. It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro``.

Numerics: float32 matrix products and convolutions run in full float32 (TF32
off for both cuBLAS and cuDNN), because hash codes are compared bit for bit
with the reference and a TF32-rounded projection or distance flips bucket
and qualification decisions.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
