"""Retry budgets, jittered exponential backoff, and a dispatch watchdog
(a copy of the JAX package's ``resilience/retry.py``).

The dispatch path wraps every device dispatch in
:func:`run_with_timeout` + a :class:`RetryPolicy` loop: a crashed dispatch
retries with backoff (the retries re-run the *same* iteration ids, and
samples are deterministic functions of ``(seed, id)``, so a retried
dispatch produces bitwise-identical results); a hung dispatch is detected
by wall clock and abandoned. Exhausting the budget FAILS the affected
requests with a structured error instead of killing the dispatcher.

The watchdog cannot kill a hung Python thread; it *abandons* it. The
abandoned worker receives a ``cancelled`` event so that, should it ever
wake up, it returns without side effects instead of racing the retry.
On the card the watched function must end in a host copy of its result
(the engine's ``count_iterations_batch`` does), so the clock covers the
device work and not only its launches. An abandoned dispatch's kernels
stay queued on the stream, so a retry on the same device queues behind
them.
"""

from __future__ import annotations

import dataclasses
import random
import threading

__all__ = ["RetryPolicy", "DispatchTimeout", "run_with_timeout"]


class DispatchTimeout(TimeoutError):
    """A dispatch attempt exceeded its wall-clock budget and was abandoned."""

    def __init__(self, name: str, timeout_s: float):
        self.name = name
        self.timeout_s = timeout_s
        super().__init__(f"{name} exceeded {timeout_s:g}s wall clock "
                         "(abandoned by watchdog)")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Budget + backoff shape for one retried operation.

    ``max_attempts`` counts total tries (1 = no retry). Backoff for the
    attempt-N retry is ``base_delay_s * 2**(N-1)`` capped at
    ``max_delay_s``, plus up to ``jitter`` of itself (drawn from the
    caller's RNG, so tests can pin it). ``timeout_s`` is the per-attempt
    wall-clock watchdog; None disables the watchdog thread entirely.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    timeout_s: float | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        base = min(self.base_delay_s * (2.0 ** max(attempt - 1, 0)),
                   self.max_delay_s)
        if self.jitter <= 0:
            return base
        r = rng.random() if rng is not None else random.random()
        return base * (1.0 + self.jitter * r)


def run_with_timeout(fn, timeout_s: float | None, name: str = "dispatch"):
    """Run ``fn(cancelled_event)``, abandoning it after ``timeout_s``.

    With ``timeout_s=None`` the call is direct (no thread, no overhead).
    Otherwise ``fn`` runs on a daemon worker; on timeout the worker's
    ``cancelled`` event is set, :class:`DispatchTimeout` raises here, and
    the worker — which must check ``cancelled`` after any blocking step —
    is left to die quietly. Exceptions inside ``fn`` re-raise here.
    """
    cancelled = threading.Event()
    if timeout_s is None:
        return fn(cancelled)
    box: dict = {}

    def work():
        try:
            box["result"] = fn(cancelled)
        except BaseException as exc:          # noqa: BLE001 — re-raised below
            box["error"] = exc

    t = threading.Thread(target=work, name=f"{name}-watchdog", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        cancelled.set()
        raise DispatchTimeout(name, timeout_s)
    if "error" in box:
        raise box["error"]
    return box.get("result")
