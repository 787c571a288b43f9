"""llama3-8b: dense GQA LM with 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig, LMConfig
from repro_torch.configs.shapes import lm_cells

CONFIG = ArchConfig(
    arch_id="llama3-8b", family="lm",
    model=LMConfig(
        name="llama3-8b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab_size=128256, rope_theta=500_000.0),
    cells=lm_cells(),
)
