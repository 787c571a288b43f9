"""DTensor sharding rules for the scatters DTensor cannot split itself.

DTensor has no strategy for ``aten.index_add`` or
``aten.scatter_reduce.two``, and its ``scatter_add`` strategy keeps the
scattered dim whole. Where a step's ids and source are split along the
scattered dim (a GNN's edges), DTensor would then gather the whole edge
stream on every rank. XLA's partitioner splits the same scatter into
partial results and one reduction, and :func:`install` gives DTensor that
plan. Each rule offers the strategies the partitioner has:

- ids and source split along the scattered dim give a ``Partial`` output,
  reduced by the scatter's own reduction (``sum`` for the adds, ``max``
  for ``amax``, ``min`` for ``amin``); the target takes the same
  ``Partial`` (a zero or ``-inf`` buffer takes it for free);
- a dim other than the scattered one, split alike on target, source,
  (for a scatter) ids and output, stays split: the MoE dispatch's group
  dim, a feature dim over ``model``;
- everything replicated.

It has no strategy for ``aten.mv`` either; its rule is the plain one:
rows split alike, or the contracted dim split into a partial sum.

The target of a ``Partial`` strategy cannot be a replicated tensor
written in place, so the models call the out-of-place ops
(``torch.index_add``, ``torch.scatter_add``, ``Tensor.scatter_reduce``)
on a fresh buffer. On plain tensors nothing here runs.

:func:`install` registers the rules once a process; the entry points that
make DTensors (``train/step.distribute_state``,
``launch/dryrun.run_cell``) call it, never an import.
"""

from __future__ import annotations

__all__ = ["install", "PARTIAL_OF"]

# a scatter's reduction -> the Partial placement's reduce op
PARTIAL_OF = {"sum": "sum", "amax": "max", "amin": "min"}

_installed = False


def _shard_dims(target, source, ids=None, skip: int = -1):
    """Dims other than ``skip`` on which target and source (and ``ids``,
    given) have the same size, so that one split of each lines up."""
    dims = []
    for d in range(len(target.shape)):
        if d == skip or target.shape[d] != source.shape[d]:
            continue
        if ids is not None and ids.shape[d] != source.shape[d]:
            continue
        dims.append(d)
    return dims


def _index_add_rule(target, dim, ids, source, alpha=1):
    """``index_add(target, dim, ids, source)``: placements are
    ``([output], [target, dim, ids, source])``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dim %= len(target.shape)
    rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
    part = Partial("sum")
    rules.append(([part], [part, None, Shard(0), Shard(dim)]))
    for d in _shard_dims(target, source, skip=dim):
        rules.append(([Shard(d)], [Shard(d), None, Replicate(), Shard(d)]))
    return rules


def _scatter_rules(target, dim, ids, source, reduce: str | None):
    """A scatter along ``dim`` with ids of the source's shape:
    ``([output], [target, dim, ids, source])``; ``reduce`` names the
    Partial of the split along ``dim`` (none: no such strategy)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dim %= len(target.shape)
    rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
    if reduce is not None and ids.shape[dim] == source.shape[dim]:
        part = Partial(reduce)
        rules.append(([part], [part, None, Shard(dim), Shard(dim)]))
    for d in _shard_dims(target, source, ids, skip=dim):
        rules.append(([Shard(d)], [Shard(d), None, Shard(d), Shard(d)]))
    return rules


def _scatter_add_rule(target, dim, ids, source):
    return _scatter_rules(target, dim, ids, source, "sum")


def _scatter_reduce_rule(target, dim, ids, source, reduce,
                         include_self=True):
    # a Partial needs every rank's target in the reduction: include_self
    return [(out, [*ins, None, None]) for out, ins in _scatter_rules(
        target, dim, ids, source,
        PARTIAL_OF.get(reduce) if include_self else None)]


def _mv_rule(matrix, vector):
    """``mv(matrix, vector)``: rows split give rows split; the contracted
    dim split on both gives a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [([Replicate()], [Replicate(), Replicate()]),
            ([Shard(0)], [Shard(0), Replicate()]),
            ([Partial("sum")], [Shard(1), Shard(0)])]


def install() -> None:
    """Register the rules with DTensor (once a process)."""
    global _installed
    if _installed:
        return
    import torch
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    register_sharding(aten.index_add.default)(_index_add_rule)
    register_sharding(aten.scatter_add.default)(_scatter_add_rule)
    register_sharding(aten.scatter_reduce.two)(_scatter_reduce_rule)
    register_sharding(aten.mv.default)(_mv_rule)
    _installed = True
