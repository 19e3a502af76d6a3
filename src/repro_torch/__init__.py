"""PyTorch/CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package keeps its
module names and public layouts so each function can be held against its
counterpart. It imports ``torch``, numpy and the standard library only,
never ``jax`` and nothing of ``repro``. Importing this package loads
nothing heavy; submodules import torch.
"""
