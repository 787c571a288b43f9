"""gatedgcn: 16-layer edge-gated GCN [arXiv:2003.00982 / 1711.07553]."""
from repro_torch.configs.base import ArchConfig, GNNConfig
from repro_torch.configs.shapes import gnn_cells

CONFIG = ArchConfig(
    arch_id="gatedgcn", family="gnn",
    model=GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                    d_hidden=70, n_classes=64),
    cells=gnn_cells(),
)
