"""Query API of the port: estimate the counts of tree templates on a graph.

The unit of a query is a :class:`~repro_torch.core.templates.TemplateSpec`
(edge list + root + optional name, coerced from registry names,
``TreeTemplate`` objects and raw edge lists). A :class:`CountQuery`
bundles N specs with a precision contract (``rel_stderr`` target and/or
``max_iters`` cap); :func:`compile_query` lowers it onto a graph as one
fused :class:`~repro_torch.core.engines.CountingEngine` per template size
k, so canonical rooted sub-templates shared across the bundle are computed
once per coloring. :meth:`CompiledQuery.run` is the JAX package's round
loop (``repro.api.CompiledQuery.run``): rounds of ``round_size`` colorings
until every template meets its contract or the iteration cap is reached, a
template that met its target retiring from the statistics. Colorings come
from the reference's stream, so the samples match ``repro.api.count_many``
sample by sample.

Typical use::

    from repro_torch.api import count, count_many
    res = count(g, "u12", max_iters=8, memory_budget_bytes=32 << 30)
    print(res.estimate, "+-", res.stderr)
    for r in count_many(g, ["u5", "path5", "star5"], max_iters=16):
        print(r.estimate)
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.colorsets import colorful_probability
from repro_torch.core.engines import CountingEngine, build_engine
from repro_torch.core.motif_features import motif_features
from repro_torch.core.templates import TemplateSpec
from repro_torch.service.requests import RequestResult, RunningStat

__all__ = ["CountQuery", "CompiledQuery", "RequestResult", "TemplateSpec",
           "compile_query", "count", "count_many", "template",
           "motif_features", "DEFAULT_MAX_ITERS"]

# hard iteration ceiling for queries that only set a rel_stderr target
DEFAULT_MAX_ITERS = 64


@dataclasses.dataclass
class CountQuery:
    """N templates + a precision contract + a budget. The contract is the
    reference's: ``rel_stderr`` adaptive target and/or ``max_iters`` cap,
    ``min_iters`` early-stop guard; ``memory_budget_bytes`` bounds each
    fused engine's device tables through the executor's memory model
    (colorset chunking where one coloring does not fit); ``reorder``
    ("rcm" or "degree") permutes the graph once per engine for locality,
    with results mapped back to the caller's vertex ids. ``engine`` picks
    ``"pgbsc"`` or the paper's baselines ``"fascia"`` / ``"pfascia"``."""

    templates: tuple[TemplateSpec, ...]
    rel_stderr: float | None = None
    max_iters: int | None = None
    min_iters: int = 4
    seed: int = 0
    engine: str = "pgbsc"
    plan: str = "optimized"
    round_size: int = 8
    memory_budget_bytes: int | None = None
    batch_size: int | None = None
    reorder: str | None = None

    def __post_init__(self):
        tpls = self.templates
        if isinstance(tpls, str) or not isinstance(tpls, (list, tuple)):
            tpls = (tpls,)
        self.templates = tuple(TemplateSpec.of(t) for t in tpls)

    def validate(self) -> None:
        if not self.templates:
            raise ValueError("query needs at least one template")
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
    """A :class:`CountQuery` lowered onto one graph and device.

    Templates are grouped by k (one coloring stream per k) and each group
    becomes a single fused-plan engine; :meth:`run` drives adaptive rounds
    per group and returns one :class:`RequestResult` per template, in query
    order. ``groups`` and ``engines`` expose the group engines (dispatch
    counters, fusion report and memory model) for introspection. With an
    ``engine_cache`` (:class:`~repro_torch.service.cache.EngineCache`) the
    group engines come from it, keyed by canonical hashes and the device.
    ``engine_kw`` are further :class:`CountingEngine` keywords for every
    group engine (``{"autotune_blocks": True}``, ``{"spmm_method":
    "gather"}``), part of the engine cache's key.
    """

    def __init__(self, g, query: CountQuery, *, dtype=None, device=None,
                 engine_cache=None, engine_kw: dict | None = None):
        query.validate()
        self.g = g
        self.query = query
        by_k: dict[int, list[int]] = {}
        for i, spec in enumerate(query.templates):
            by_k.setdefault(spec.k, []).append(i)
        kw = {**(engine_kw or {}), "device": device}
        if query.memory_budget_bytes is not None:
            kw["memory_budget_bytes"] = int(query.memory_budget_bytes)
        if query.reorder:
            kw["reorder"] = query.reorder
        if dtype is not None:
            kw["dtype"] = dtype
        self.groups: list[tuple[list[int], CountingEngine]] = []
        for k in sorted(by_k):
            specs = [query.templates[i] for i in by_k[k]]
            if engine_cache is not None:
                eng = engine_cache.get(
                    g, specs if len(specs) > 1 else specs[0], query.engine,
                    query.plan, **kw)
            else:
                trees = [s.tree for s in specs]
                eng = build_engine(g, trees if len(trees) > 1 else trees[0],
                                   query.engine, plan=query.plan, **kw)
            self.groups.append((by_k[k], eng))

    @property
    def engines(self) -> list[CountingEngine]:
        return [eng for _, eng in self.groups]

    @property
    def engine(self) -> CountingEngine:
        """The engine of a single-k query."""
        if len(self.groups) != 1:
            raise ValueError(f"the query spans {len(self.groups)} template "
                             "sizes; use .engines")
        return self.groups[0][1]

    def _satisfied(self, stat: RunningStat) -> bool:
        q = self.query
        if stat.n >= q.cap:
            return True
        return (q.rel_stderr is not None
                and stat.n >= min(q.min_iters, q.cap)
                and stat.rel_stderr <= q.rel_stderr)

    def run(self) -> list[RequestResult]:
        q = self.query
        out: list[RequestResult | None] = [None] * len(q.templates)
        for idxs, eng in self.groups:
            t0 = time.time()
            p = colorful_probability(eng.k)
            scales = [1.0 / (q.templates[i].automorphisms * p) for i in idxs]
            stats = [RunningStat() for _ in idxs]
            cursor = 0
            while not all(self._satisfied(s) for s in stats):
                n_new = min(q.round_size, q.cap - cursor)
                if n_new <= 0:
                    break
                ids = list(range(cursor, cursor + n_new))
                per = eng.count_iterations_batch(ids, seed=q.seed,
                                                 batch_size=q.batch_size)
                for it in ids:
                    vals = np.atleast_1d(np.asarray(per[it]))
                    for j, stat in enumerate(stats):
                        # retired templates stop consuming samples
                        if not self._satisfied(stat):
                            stat.update(float(vals[j]) * scales[j])
                cursor += n_new
            seconds = time.time() - t0
            for j, i in enumerate(idxs):
                stat = stats[j]
                out[i] = RequestResult(
                    estimate=stat.mean, stderr=stat.stderr,
                    rel_stderr=stat.rel_stderr, ci95=stat.ci95,
                    iterations=stat.n,
                    target_met=(q.rel_stderr is None
                                or stat.rel_stderr <= q.rel_stderr),
                    shared_group=len(idxs) > 1, seconds=seconds)
        return out


def compile_query(g, query: CountQuery, *, dtype=None, device=None,
                  engine_cache=None, engine_kw: dict | None = None
                  ) -> CompiledQuery:
    """Lower a :class:`CountQuery` onto ``g``: one fused engine per k
    (served from ``engine_cache`` when given: two spellings of the same
    tree share one engine), built with ``engine_kw`` besides the query's
    own options."""
    return CompiledQuery(g, query, dtype=dtype, device=device,
                         engine_cache=engine_cache, engine_kw=engine_kw)


def count_many(g, templates, *, rel_stderr: float | None = None,
               max_iters: int | None = None, min_iters: int = 4,
               seed: int = 0, engine: str = "pgbsc",
               plan: str = "optimized", round_size: int = 8,
               memory_budget_bytes: int | None = None,
               batch_size: int | None = None, reorder: str | None = None,
               dtype=None, device=None,
               engine_kw: dict | None = None) -> list[RequestResult]:
    """Estimate counts for N templates with cross-template subplan sharing.

    Accepts any mix of registry names, :class:`TemplateSpec`, TreeTemplate
    objects and raw edge lists; returns one result per template, in input
    order. Same-k templates run on ONE fused plan; each template's samples
    still come from exactly the colorings a solo :func:`count` with the
    same seed would draw. Runs on CUDA unless ``device="cpu"``; ``dtype``
    is the table storage dtype (f32 by default, or bf16); ``reorder``
    relabels the graph once per engine (:class:`CountQuery`); ``engine_kw``
    are further engine keywords, e.g. ``{"autotune_blocks": True}``.
    """
    if rel_stderr is None and max_iters is None:
        max_iters = DEFAULT_MAX_ITERS
    if isinstance(templates, str):    # a bare name is one template, not
        templates = (templates,)      # an iterable of characters
    query = CountQuery(
        templates=tuple(templates), rel_stderr=rel_stderr,
        max_iters=max_iters, min_iters=min_iters, seed=seed, engine=engine,
        plan=plan, round_size=round_size,
        memory_budget_bytes=memory_budget_bytes, batch_size=batch_size,
        reorder=reorder)
    return compile_query(g, query, dtype=dtype, device=device,
                         engine_kw=engine_kw).run()


def count(g, template, **kw) -> RequestResult:
    """Estimate the count of one template (see :func:`count_many` for the
    accepted template forms and keywords)."""
    return count_many(g, [template], **kw)[0]


def template(obj) -> TemplateSpec:
    """Coerce anything template-ish into a :class:`TemplateSpec`."""
    return TemplateSpec.of(obj)
