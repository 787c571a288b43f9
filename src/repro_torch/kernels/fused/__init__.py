"""Fused SpMM->eMA: the CUDA kernel's wrapper, its plain version and the
card's fit model."""
