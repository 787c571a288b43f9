"""nequip: O(3)-equivariant interatomic potential, l_max=2
[arXiv:2101.03164]. Cartesian-irrep implementation (see models/equivariant)."""
from repro_torch.configs.base import ArchConfig, GNNConfig
from repro_torch.configs.shapes import gnn_cells

CONFIG = ArchConfig(
    arch_id="nequip", family="gnn",
    model=GNNConfig(name="nequip", kind="nequip", n_layers=5, d_hidden=32,
                    n_classes=1,
                    extras=(("l_max", 2), ("n_rbf", 8), ("cutoff", 5.0))),
    cells=gnn_cells(),
    notes="Non-molecule cells feed synthetic positions/species with the "
          "cell's node/edge counts (graph shapes are family-wide).",
)
