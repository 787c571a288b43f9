"""Models of the assigned architectures on the card: the GNNs (GraphSAGE,
PNA, GatedGCN in ``gnn``, NequIP in ``equivariant``)."""
