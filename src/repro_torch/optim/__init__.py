"""Optimizers: the JAX package's AdamW, schedule, clipping and int8
gradient compression on torch."""
