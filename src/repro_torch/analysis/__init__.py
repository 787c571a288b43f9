"""Analysis of measured kernel runs (the JAX package's ``analysis/``, the
part the port's kernels need)."""
