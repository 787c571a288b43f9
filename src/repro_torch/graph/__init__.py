"""Graph substrate: structures, generators, coloring, reordering.

The names of the JAX package's ``repro.graph`` but ``EdgeChunks``, its
padded edge operand for the TPU: the port's gather SpMM reads the
``GatherPrep`` of ``repro_torch.kernels.spmm.ops`` instead.
"""

from repro_torch.graph.coloring import iteration_key, random_coloring
from repro_torch.graph.generators import (barabasi_albert, complete_graph,
                                          erdos_renyi, grid_2d, path_graph,
                                          random_regular, rmat, star)
from repro_torch.graph.reorder import (ORDERINGS, apply_order, degree_order,
                                       inverse_order, rcm_order)
from repro_torch.graph.structure import BsrMatrix, Graph

__all__ = [
    "iteration_key", "random_coloring",
    "barabasi_albert", "complete_graph", "erdos_renyi", "grid_2d",
    "path_graph", "random_regular", "rmat", "star",
    "ORDERINGS", "apply_order", "degree_order", "inverse_order", "rcm_order",
    "BsrMatrix", "Graph",
]
