"""PyTorch and CUDA port of the Relational Memory reproduction.

The JAX package ``repro`` is the reference; this package is its port to an
NVIDIA H100, module for module (``repro_torch.core.engine`` mirrors
``repro.core.engine``, and so on).  It imports ``torch`` and numpy only,
never ``jax`` and nothing of ``repro``.  Every Pallas kernel on the ported
path is a hand-written CUDA kernel under ``csrc/``, with a plain PyTorch
version beside it that the CPU runs.
"""
