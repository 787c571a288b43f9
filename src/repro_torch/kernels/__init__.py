"""Hand-written CUDA kernels (``csrc/``), each with its wrapper and its
plain PyTorch version."""
