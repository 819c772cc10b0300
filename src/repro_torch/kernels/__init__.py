"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref``) and the device-dispatching wrappers (``ops``)."""
