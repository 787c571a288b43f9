"""QoS primitives for the async serving front end (a copy of the JAX
package's ``service/qos.py``).

Three request classes, in strict priority order at dispatch boundaries:

* ``deadline`` — carries an absolute deadline; scheduled earliest-
  deadline-first *ahead of everything else*. Preemption is at dispatch
  boundaries: a running batch group is never killed mid-dispatch, but the
  next round always goes to the most urgent deadline group first.
* ``interactive`` — latency-sensitive best effort; always dispatched
  before batch work.
* ``batch`` — throughput traffic; absorbs whatever device time the two
  classes above leave.

Within ``interactive`` and ``batch``, tenants share the device by
**weighted fair queuing**: each tenant accrues virtual time
``work / weight`` per dispatch, and the group whose tenants have the
least virtual time goes next — a tenant with weight 2 gets twice the
dispatch share of a weight-1 tenant under contention, and an idle
tenant's unused share is redistributed instead of banked (newcomers
start at the current virtual-time floor, so nobody replays history).

Admission control is a bounded FIFO (:class:`AdmissionQueue`): when the
queue is full the request is **shed** — rejected immediately with a
reason (``queue_full``) instead of silently growing an unbounded backlog
whose tail latency is everyone's problem. The async loop sheds for
modeled-memory overruns the same way (``memory_budget``); shed reasons
are the labels on the ``service_shed_total`` counter.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Iterable

from repro_torch.obs import metrics as _metrics

__all__ = [
    "QoSClass", "QoS", "GroupView", "FairScheduler", "AdmissionQueue",
    "SHED_QUEUE_FULL", "SHED_MEMORY", "SHED_CLOSED",
    "DEFAULT_DEADLINE_S",
]

# shed reasons (the ``reason`` label of ``service_shed_total``)
SHED_QUEUE_FULL = "queue_full"
SHED_MEMORY = "memory_budget"
SHED_CLOSED = "closed"

# a ``deadline`` request that names no deadline gets this budget
DEFAULT_DEADLINE_S = 30.0


class QoSClass(str, enum.Enum):
    DEADLINE = "deadline"
    INTERACTIVE = "interactive"
    BATCH = "batch"

    @property
    def rank(self) -> int:
        """Strict dispatch priority; lower dispatches first."""
        return _RANK[self]


_RANK = {QoSClass.DEADLINE: 0, QoSClass.INTERACTIVE: 1, QoSClass.BATCH: 2}


@dataclasses.dataclass(frozen=True)
class QoS:
    """One request's service contract: class, tenant identity for fair
    sharing, tenant weight, and (deadline class) a relative deadline in
    seconds from submission."""

    klass: QoSClass = QoSClass.INTERACTIVE
    tenant: str = "default"
    weight: float = 1.0
    deadline_s: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "klass", QoSClass(self.klass))
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if self.klass is QoSClass.DEADLINE and self.deadline_s is None:
            object.__setattr__(self, "deadline_s", DEFAULT_DEADLINE_S)


@dataclasses.dataclass
class GroupView:
    """What the dispatcher tells the policy about one dispatchable group:
    the best (lowest-rank) class among its live members, the earliest
    absolute deadline any member carries (inf when none), and the
    ``(tenant, weight)`` pairs of its live members."""

    key: object
    rank: int
    deadline: float
    tenants: tuple[tuple[str, float], ...]


class FairScheduler:
    """Pick the next group to dispatch: strict class priority, EDF inside
    the deadline class, weighted fair queuing across tenants inside the
    other classes. Stateful only in per-tenant virtual time."""

    def __init__(self):
        self._vt: dict[str, float] = {}

    def _floor(self) -> float:
        return min(self._vt.values(), default=0.0)

    def pick(self, groups: list[GroupView]) -> GroupView:
        """The next group to dispatch (``groups`` must be non-empty). Ties
        resolve to the earliest-listed group, so callers listing groups in
        creation order get FIFO among equals."""
        # SFQ activity accounting: only tenants with backlogged work keep
        # virtual-time standing. A tenant absent from every dispatchable
        # group is idle — it drops out and rejoins at the then-current
        # floor, so idle time is redistributed, never banked. Present
        # tenants keep their vt (a starved tenant's low vt is exactly its
        # claim to the next dispatch).
        present = {t for gv in groups for t, _ in gv.tenants}
        self._vt = {t: v for t, v in self._vt.items() if t in present}
        floor = self._floor()
        for t in present:
            self._vt.setdefault(t, floor)

        def urgency(gv: GroupView):
            vt = min((self._vt[t] for t, _ in gv.tenants), default=floor)
            if gv.rank == QoSClass.DEADLINE.rank:
                return (gv.rank, gv.deadline, vt)
            return (gv.rank, vt, gv.deadline)

        return min(groups, key=urgency)

    def charge(self, tenants: Iterable[tuple[str, float]],
               cost: float) -> None:
        """Account one dispatch of ``cost`` work units (iterations) to the
        group's live tenants: the cost splits evenly across members and
        each tenant's virtual time advances by its share over its weight.
        Newly-seen tenants start at the current floor — idle time earns no
        banked credit."""
        ts = list(tenants)
        if not ts:
            return
        floor = self._floor()
        share = cost / len(ts)
        for tenant, weight in ts:
            base = max(self._vt.get(tenant, floor), floor)
            self._vt[tenant] = base + share / max(weight, 1e-9)

    def virtual_times(self) -> dict[str, float]:
        """Per-tenant virtual time (introspection / tests)."""
        return dict(self._vt)


class AdmissionQueue:
    """Bounded FIFO with reject-on-full backpressure.

    :meth:`offer` never blocks: it either enqueues and returns None, or
    returns a shed reason (``queue_full``). The dispatcher drains with
    :meth:`drain`. Depth is published as the ``service_queue_depth``
    gauge; admissions count into ``service_queue_admitted_total``.
    """

    def __init__(self, maxsize: int = 1024):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._items: list = []
        self._lock = threading.Lock()

    def offer(self, item) -> str | None:
        with self._lock:
            if len(self._items) >= self.maxsize:
                return SHED_QUEUE_FULL
            self._items.append(item)
            depth = len(self._items)
        _metrics.counter("service_queue_admitted_total").inc()
        _metrics.gauge("service_queue_depth").set(depth)
        return None

    def drain(self) -> list:
        with self._lock:
            items, self._items = self._items, []
        if items:
            _metrics.gauge("service_queue_depth").set(0)
        return items

    def contents(self) -> list:
        """Queued items, oldest first, without draining (supervision uses
        this to tell drained-but-unattached requests from queued ones)."""
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
