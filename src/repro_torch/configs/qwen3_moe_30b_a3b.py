"""qwen3-moe-30b-a3b: 128 experts top-8, QK-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, LMConfig, MoEConfig
from repro_torch.configs.shapes import lm_cells

CONFIG = ArchConfig(
    arch_id="qwen3-moe-30b-a3b", family="lm",
    model=LMConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=768, vocab_size=151936, d_head=128,
        use_qk_norm=True, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8)),
    cells=lm_cells(),
)
