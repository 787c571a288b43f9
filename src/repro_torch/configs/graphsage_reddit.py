"""graphsage-reddit: 2-layer mean-aggregator GraphSAGE [arXiv:1706.02216]."""
from repro_torch.configs.base import ArchConfig, GNNConfig
from repro_torch.configs.shapes import gnn_cells

CONFIG = ArchConfig(
    arch_id="graphsage-reddit", family="gnn",
    model=GNNConfig(name="graphsage-reddit", kind="graphsage", n_layers=2,
                    d_hidden=128, n_classes=41,
                    extras=(("sample_sizes", (25, 10)),)),
    cells=gnn_cells(),
)
