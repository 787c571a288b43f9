"""Models of the registered architectures on the card: the GNNs
(GraphSAGE, PNA, GatedGCN in ``gnn``, NequIP in ``equivariant``), the
decoder LMs (``transformer``, built from ``layers`` and the MoE FFN in
``moe``) and AutoInt with its EmbeddingBag (``recsys``)."""
