"""The benchmark's plain reference: the served model's forward pass in
float32 (``model``) and the FLOP and byte counts behind ``mfu`` and the
kernels' roofline shares (``flops``).  Plain PyTorch; it imports neither
JAX, nor the JAX package, nor anything of the program."""
