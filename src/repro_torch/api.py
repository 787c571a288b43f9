"""Query API of the port: estimate the count of one template on a graph.

``count(g, template, max_iters=..., rel_stderr=...)`` builds one PGBSC
:class:`~repro_torch.core.engines.CountingEngine` and runs the JAX
package's round loop (``repro.api.CompiledQuery.run``): rounds of
``round_size`` colorings until the precision contract is met or the
iteration cap is reached. Colorings come from the reference's stream, so
the samples match ``repro.api.count`` sample by sample.

Multi-template queries (``count_many``, cross-template fused plans) are not
ported yet (``ROADMAP.md``).

Typical use::

    from repro_torch.api import count
    res = count(g, "u12", max_iters=8, memory_budget_bytes=32 << 30)
    print(res.estimate, "+-", res.stderr)
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.core.colorsets import colorful_probability
from repro_torch.core.engines import CountingEngine
from repro_torch.core.templates import TemplateSpec
from repro_torch.service.requests import RequestResult, RunningStat

__all__ = ["CountQuery", "CompiledQuery", "RequestResult", "count",
           "DEFAULT_MAX_ITERS"]

# hard iteration ceiling for queries that only set a rel_stderr target
DEFAULT_MAX_ITERS = 64


@dataclasses.dataclass
class CountQuery:
    """One template + a precision contract + a budget. The contract is the
    reference's: ``rel_stderr`` adaptive target and/or ``max_iters`` cap,
    ``min_iters`` early-stop guard; ``memory_budget_bytes`` bounds the
    engine's device tables through the executor's memory model."""

    template: TemplateSpec
    rel_stderr: float | None = None
    max_iters: int | None = None
    min_iters: int = 4
    seed: int = 0
    plan: str = "optimized"
    round_size: int = 8
    memory_budget_bytes: int | None = None
    batch_size: int | None = None

    def __post_init__(self):
        self.template = TemplateSpec.of(self.template)

    def validate(self) -> None:
        if self.rel_stderr is None and self.max_iters is None:
            raise ValueError("query needs a precision contract: "
                             "rel_stderr and/or max_iters")
        if self.rel_stderr is not None and self.rel_stderr <= 0:
            raise ValueError(f"rel_stderr must be > 0, got {self.rel_stderr}")
        if self.max_iters is not None and self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")

    @property
    def cap(self) -> int:
        return self.max_iters if self.max_iters is not None \
            else DEFAULT_MAX_ITERS


class CompiledQuery:
    """A :class:`CountQuery` lowered onto one graph and device: its engine
    (dispatch counters, fusion report and memory model exposed for
    introspection) and the round loop :meth:`run`."""

    def __init__(self, g, query: CountQuery, *, dtype=None, device=None):
        query.validate()
        self.g = g
        self.query = query
        kw = {"plan": query.plan, "device": device}
        if query.memory_budget_bytes is not None:
            kw["memory_budget_bytes"] = int(query.memory_budget_bytes)
        if dtype is not None:
            kw["dtype"] = dtype
        self.engine = CountingEngine(g, query.template.tree, **kw)

    def _satisfied(self, stat: RunningStat) -> bool:
        q = self.query
        if stat.n >= q.cap:
            return True
        return (q.rel_stderr is not None
                and stat.n >= min(q.min_iters, q.cap)
                and stat.rel_stderr <= q.rel_stderr)

    def run(self) -> RequestResult:
        q, eng = self.query, self.engine
        t0 = time.time()
        scale = 1.0 / (q.template.automorphisms * colorful_probability(eng.k))
        stat = RunningStat()
        cursor = 0
        while not self._satisfied(stat):
            n_new = min(q.round_size, q.cap - cursor)
            if n_new <= 0:
                break
            ids = list(range(cursor, cursor + n_new))
            per = eng.count_iterations_batch(ids, seed=q.seed,
                                             batch_size=q.batch_size)
            for it in ids:
                if not self._satisfied(stat):
                    stat.update(per[it] * scale)
            cursor += n_new
        return RequestResult(
            estimate=stat.mean, stderr=stat.stderr,
            rel_stderr=stat.rel_stderr, ci95=stat.ci95, iterations=stat.n,
            target_met=(q.rel_stderr is None
                        or stat.rel_stderr <= q.rel_stderr),
            seconds=time.time() - t0)


def count(g, template, *, rel_stderr: float | None = None,
          max_iters: int | None = None, min_iters: int = 4, seed: int = 0,
          plan: str = "optimized", round_size: int = 8,
          memory_budget_bytes: int | None = None,
          batch_size: int | None = None, dtype=None,
          device=None) -> RequestResult:
    """Estimate the count of one template (a registry name, a
    :class:`TemplateSpec`, a TreeTemplate or an edge list) in ``g``.
    Runs on CUDA unless ``device="cpu"``; ``dtype`` is the table storage
    dtype (f32 by default, or bf16)."""
    if rel_stderr is None and max_iters is None:
        max_iters = DEFAULT_MAX_ITERS
    query = CountQuery(
        template=template, rel_stderr=rel_stderr, max_iters=max_iters,
        min_iters=min_iters, seed=seed, plan=plan, round_size=round_size,
        memory_budget_bytes=memory_budget_bytes, batch_size=batch_size)
    return CompiledQuery(g, query, dtype=dtype, device=device).run()
