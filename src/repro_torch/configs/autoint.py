"""autoint: self-attentive feature interaction CTR model [arXiv:1810.11921]."""
from repro_torch.configs.base import ArchConfig, RecsysConfig
from repro_torch.configs.shapes import recsys_cells

CONFIG = ArchConfig(
    arch_id="autoint", family="recsys",
    model=RecsysConfig(name="autoint", n_sparse=39, embed_dim=16,
                       n_attn_layers=3, n_heads=2, d_attn=32,
                       vocab_size=1_000_000, n_dense=13),
    cells=recsys_cells(),
)
