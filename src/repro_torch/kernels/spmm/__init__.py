"""BSR SpMM: the CUDA kernel's wrapper, its plain version and the operand."""
