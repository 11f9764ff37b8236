"""The benchmark's plain reference: the served model's forward pass in
float32 (the shared pieces and the replay loop in ``model``, each
architecture's layer and logits in ``<model_type>``) and the FLOP and
byte counts behind ``mfu`` and the kernels' roofline shares
(``flops``).  Plain PyTorch; it imports neither
JAX, nor the JAX package, nor anything of the program."""
