"""Training: the train and serve steps, data-parallel training with the
int8-compressed all-reduce, checkpoints that either package restores, and
the sharding rules as DTensor placements. A port of the JAX package's
``train/``."""
