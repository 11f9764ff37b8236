"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its
plain PyTorch version; built by ``build`` at first use."""
