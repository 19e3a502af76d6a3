"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module builds its CUDA source at first use (never at import)
and launches it only for tensors on a CUDA device; CPU tensors take the
plain version in ``ref``. ``ops`` is the entry the model code calls."""
