"""deepseek-moe-16b: 2 shared + 64 routed experts, top-6, fine-grained
[arXiv:2401.06066]. Layer 0 is a dense FFN (d_ff 10944) per the paper."""
from repro_torch.configs.base import ArchConfig, LMConfig, MoEConfig
from repro_torch.configs.shapes import lm_cells

CONFIG = ArchConfig(
    arch_id="deepseek-moe-16b", family="lm",
    model=LMConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab_size=102400,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2),
        first_dense_layers=1, dense_d_ff=10944),
    cells=lm_cells(),
)
