"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors the JAX package's layout (``core``, ``gateway``, ``serving``,
``models``, ``configs``, ``kernels``, ``launch``); imports ``torch``
and never ``jax`` or ``repro``.
"""
