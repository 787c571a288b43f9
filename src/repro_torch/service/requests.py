"""Query results: the estimate with its standard error and 95% interval,
and the Welford running statistic the round loop stops on.

A copy of ``RequestResult`` and ``RunningStat`` from the JAX package's
``service/requests.py``; the service around them is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["RequestResult", "RunningStat"]


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
