"""gemma3-1b: 5:1 local:global sliding-window attention, 262k vocab
[hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ArchConfig, LMConfig
from repro_torch.configs.shapes import lm_cells

CONFIG = ArchConfig(
    arch_id="gemma3-1b", family="lm",
    model=LMConfig(
        name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4,
        n_kv_heads=1, d_ff=6912, vocab_size=262144, d_head=256,
        sliding_window=512, global_every=6, rope_theta=1_000_000.0),
    cells=lm_cells(),
    notes="Every 6th layer global, others 512-token window; long_500k decode "
          "runs with full-length cache (window-trimmed cache is a recorded "
          "Perf optimization).",
)
