"""Request API for the multi-tenant counting service.

A :class:`CountRequest` names a registered graph, a template — a registry
name (sugar), a :class:`~repro_torch.core.templates.TemplateSpec`, a
TreeTemplate, or a raw edge list; arbitrary user trees are first-class —
an engine/plan choice, and a *precision contract*: either a
relative-standard-error target (``rel_stderr``, adaptive stopping) or a
fixed iteration cap (``max_iters``), or both (stop at whichever comes
first). The service answers with a :class:`RequestResult` carrying the
estimate, its standard error, and a 95% confidence interval computed from
the per-iteration color-coding samples. Request identity — for dispatch
groups and every cache — is the template's *canonical hash*, never its
name: two spellings of the same rooted tree share one sample stream.

A copy of the JAX package's ``service/requests.py``.

Status lifecycle (see the ``repro_torch.service`` package docstring for
the full narrative)::

    PENDING --> RUNNING --> DONE
        \\          \\-----> FAILED
         \\---------------> DONE       (served from the estimate cache)
          \\--------------> CANCELLED  (cancel() before completion)
           \\-------------> SHED       (admission control rejected it)

``SHED`` is terminal at submission time: the async front end's admission
control refused the request (bounded queue full, modeled memory over
budget) instead of letting it degrade everyone else's tail latency. The
shed reason travels in the request's ``error`` field and in the
``service_shed_total{reason}`` counter.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from repro_torch.core.templates import TemplateSpec

__all__ = ["RequestStatus", "CountRequest", "RequestResult", "RunningStat"]


class RequestStatus(str, enum.Enum):
    PENDING = "pending"       # submitted, not yet scheduled into a round
    RUNNING = "running"       # attached to a dispatch group, consuming samples
    DONE = "done"             # precision target met, cap reached, or cached
    FAILED = "failed"         # engine build / dispatch raised
    CANCELLED = "cancelled"   # withdrawn by the client
    SHED = "shed"             # rejected by admission control (backpressure)


@dataclasses.dataclass
class CountRequest:
    """One tenant's counting query.

    ``graph`` names a graph registered with the service (the service keys
    caches by the graph's content fingerprint, so two names for the same
    graph share everything). Precision: ``rel_stderr`` is the adaptive
    target stderr/|mean|; ``max_iters`` caps iterations (service default
    applies when None). ``min_iters`` guards against spuriously-early
    stopping on the first few lucky samples.
    """

    graph: str
    template: object          # str name | TemplateSpec | TreeTemplate | edges
    engine: str = "pgbsc"
    plan: str = "optimized"
    rel_stderr: float | None = None
    max_iters: int | None = None
    min_iters: int = 4
    seed: int = 0

    @property
    def spec(self) -> TemplateSpec:
        """The request's template as a :class:`TemplateSpec` (coerced once;
        registry names are sugar resolved here)."""
        sp = self.__dict__.get("_spec")
        if sp is None or self.__dict__.get("_spec_src") is not self.template:
            sp = TemplateSpec.of(self.template)
            self.__dict__["_spec"] = sp
            self.__dict__["_spec_src"] = self.template
        return sp

    @property
    def template_name(self) -> str:
        """Human-readable label (names when given, hash prefix otherwise)."""
        if isinstance(self.template, str):
            return self.template
        return self.spec.display_name

    def validate(self) -> None:
        self.spec.tree       # coerce + validate: unknown names raise
        #  KeyError, malformed edge lists a descriptive ValueError
        if self.rel_stderr is None and self.max_iters is None:
            raise ValueError("request needs a precision target: "
                             "rel_stderr and/or max_iters")
        if self.rel_stderr is not None and self.rel_stderr <= 0:
            raise ValueError(f"rel_stderr must be > 0, got {self.rel_stderr}")
        if self.max_iters is not None and self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")

    def group_key(self, graph_fingerprint: str) -> tuple:
        """Requests sharing this key can consume one sample stream: same
        graph content, same *canonical* template (names never enter — two
        spellings of one tree share a group), engine, plan, and seed."""
        return (graph_fingerprint, self.spec.canonical_hash, self.engine,
                self.plan, self.seed)


@dataclasses.dataclass
class RequestResult:
    """Final answer for one request."""

    estimate: float
    stderr: float
    rel_stderr: float
    ci95: tuple[float, float]
    iterations: int
    target_met: bool
    from_cache: bool = False      # served by the persistent estimate cache
    shared_group: bool = False    # joined an existing dispatch group
    seconds: float = 0.0
    # per-request latency attribution (queue_s / compile_s / execute_s /
    # total_s), filled by the scheduler at retirement; None for cache hits
    breakdown: dict | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ci95"] = list(self.ci95)
        return d


class RunningStat:
    """Welford running mean/variance over per-iteration estimator samples.

    Numerically stable single-pass accumulation; ``stderr`` is the standard
    error of the mean, ``rel_stderr`` the stopping statistic (inf until two
    samples exist or while the mean is zero, so zero-count templates run to
    their iteration cap instead of retiring on a degenerate target).
    """

    __slots__ = ("n", "mean", "_m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def update(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self._m2 += d * (x - self.mean)

    @property
    def variance(self) -> float:
        """Unbiased sample variance (ddof=1)."""
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def stderr(self) -> float:
        return math.sqrt(self.variance / self.n) if self.n > 1 else float("inf")

    @property
    def rel_stderr(self) -> float:
        if self.n < 2 or self.mean == 0.0:
            return float("inf")
        return self.stderr / abs(self.mean)

    @property
    def ci95(self) -> tuple[float, float]:
        se = self.stderr if self.n > 1 else 0.0
        return (self.mean - 1.96 * se, self.mean + 1.96 * se)
