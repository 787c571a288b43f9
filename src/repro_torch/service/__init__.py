"""Multi-tenant subgraph-counting service of the port (a copy of the JAX
package's ``repro.service``; engines run on the card unless a service is
given ``device="cpu"``).

This package is the serving layer above the color-coding engines: many
tenants submit counting queries against registered graphs, and a
round-based scheduler answers all of them with the fewest possible device
dispatches. It exists because the estimator's unit of work — one coloring
iteration — is small, deterministic, and embarrassingly parallel, so the
interesting systems problem is *scheduling and reuse*, not the kernel.

Request lifecycle
-----------------
1. **Register** graphs: ``service.add_graph("web", g)``. Cache identity is
   the graph's content fingerprint, never its name.
2. **Submit** a :class:`~repro_torch.service.requests.CountRequest` — template,
   engine/plan choice, and a precision contract (``rel_stderr`` target
   and/or ``max_iters`` cap). The request starts ``PENDING``; if the
   persistent estimate cache already holds an answer at least as precise
   as the contract, it completes ``DONE`` immediately with
   ``from_cache=True``.
3. **Schedule**: each :meth:`~repro_torch.service.scheduler.CountingService.step`
   round attaches pending requests to dispatch groups keyed by
   ``(graph fingerprint, template, engine, plan, seed)`` (status
   ``RUNNING``). Engines come from the
   :class:`~repro_torch.service.cache.EngineCache`, so concurrent and repeated
   requests never rebuild an engine; group members share ONE sample
   stream, so N identical queries cost one query's device work.
4. **Adapt**: every round extends each needed group by ``round_size``
   iterations in a single batched device dispatch, journaled through the
   fault-tolerant runner ledger (kill the process, restart, and the group
   resumes with zero recomputation). Each request folds samples into a
   Welford running mean and retires ``DONE`` as soon as its relative
   standard error meets its target — tight targets run longer, loose ones
   stop early, and nobody burns a fixed iteration budget.
5. **Collect**: results carry the estimate, standard error, 95% confidence
   interval, iterations consumed, and cache/sharing provenance. Finished
   answers feed the estimate cache for future tenants. ``FAILED`` (bad
   engine / build error) and ``CANCELLED`` are the other terminal states.

Two front ends share this machinery:

* :class:`~repro_torch.service.scheduler.CountingService` — the synchronous
  round scheduler (`run()`), right for offline batch jobs where all
  requests are known up front;
* :class:`~repro_torch.service.async_loop.AsyncCountingService` — a
  continuously-admitting dispatcher thread with QoS classes
  (interactive / batch / deadline), per-tenant weighted fairness,
  bounded-queue backpressure with load shedding (``SHED``), and warm
  engine pools; `repro_torch.service.frontend` puts an HTTP/JSON API on top.
  Estimates are bitwise-identical between the two (samples are
  deterministic functions of ``(seed, iteration id)``).

Typical use::

    from repro_torch.service import CountingService, CountRequest

    svc = CountingService(round_size=16)
    svc.add_graph("g", g)
    ids = [svc.submit(CountRequest("g", t, rel_stderr=0.05))
           for t in ("u5", "u7", "u5")]
    for rid, res in svc.run().items():
        print(rid, res.estimate, "+-", res.stderr, res.ci95)
"""

from repro_torch.service.async_loop import AsyncCountingService
from repro_torch.service.cache import EngineCache, EstimateCache
from repro_torch.service.qos import (AdmissionQueue, FairScheduler, QoS,
                                     QoSClass)
from repro_torch.service.requests import (CountRequest, RequestResult,
                                          RequestStatus, RunningStat)
from repro_torch.service.scheduler import CountingService

__all__ = [
    "CountingService", "AsyncCountingService",
    "CountRequest", "RequestResult", "RequestStatus", "RunningStat",
    "EngineCache", "EstimateCache",
    "QoS", "QoSClass", "FairScheduler", "AdmissionQueue",
]
