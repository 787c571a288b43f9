"""smollm-360m: llama-arch small dense LM [hf:HuggingFaceTB/SmolLM; hf]."""
from repro_torch.configs.base import ArchConfig, LMConfig
from repro_torch.configs.shapes import lm_cells

CONFIG = ArchConfig(
    arch_id="smollm-360m", family="lm",
    model=LMConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15,
        n_kv_heads=5, d_ff=2560, vocab_size=49152),
    cells=lm_cells(),
    notes="GQA 3:1 (15q/5kv); heads not divisible by model axis -> "
          "head_dim-sharded attention (see train/sharding.py).",
)
