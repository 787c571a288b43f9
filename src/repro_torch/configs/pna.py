"""pna: Principal Neighbourhood Aggregation — 4 aggregators x 3 scalers
[arXiv:2004.05718]."""
from repro_torch.configs.base import ArchConfig, GNNConfig
from repro_torch.configs.shapes import gnn_cells

CONFIG = ArchConfig(
    arch_id="pna", family="gnn",
    model=GNNConfig(name="pna", kind="pna", n_layers=4, d_hidden=75,
                    n_classes=64),
    cells=gnn_cells(),
)
