"""Typed serving outcomes (counterpart of paddle_tpu/resilience/__init__.py).

Only what the scheduler, the engine and the inference Predictor use is
ported: the backpressure errors ``Overloaded`` and ``Shed``, the falsy
``TimeoutResult`` partial result, the wall-clock ``Deadline``, the
``deadline_miss`` count and the ``AdmissionGate`` (with its count of
refused requests, ``admission_rejects``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Optional

__all__ = ["Overloaded", "Shed", "TimeoutResult", "Deadline",
           "deadline_miss", "deadline_misses", "AdmissionGate",
           "admission_rejects"]


class Overloaded(RuntimeError):
    """Queue admission refused the request (backpressure, not failure):
    retry later or shed load upstream."""


class Shed(Overloaded):
    """The request was dropped on purpose to protect higher-priority
    traffic. Subclasses `Overloaded` so every retry/backpressure handler
    keeps working, and carries the measurement that triggered it."""

    def __init__(self, msg: str, measurement: Optional[dict] = None):
        super().__init__(msg)
        self.measurement = dict(measurement or {})


@dataclasses.dataclass
class TimeoutResult:
    """Typed deadline-expiry outcome. Falsy on purpose: callers that treat
    the return as data can gate on truthiness, while
    `isinstance(r, TimeoutResult)` keeps the explicit protocol."""

    kind: str                 # "serving_engine" | ...
    budget_s: float
    elapsed_s: float
    completed: int = 0        # units of work done (decode steps, ...)
    partial: Any = None       # partial outputs when they exist

    def __bool__(self) -> bool:
        return False


class Deadline:
    """A wall-clock budget. Cheap to poll between decode steps."""

    __slots__ = ("budget_s", "_t0")

    def __init__(self, budget_s: float):
        self.budget_s = float(budget_s)
        self._t0 = time.monotonic()

    @property
    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    def remaining_s(self) -> float:
        return self.budget_s - self.elapsed_s

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0


_miss_total = 0


def deadline_miss() -> None:
    """Count one missed deadline (read back with `deadline_misses`)."""
    global _miss_total
    _miss_total += 1


def deadline_misses() -> int:
    """Deadlines missed in this process so far."""
    return _miss_total


_reject_total = 0


def admission_rejects() -> int:
    """Requests an `AdmissionGate` refused in this process so far."""
    return _reject_total


class AdmissionGate:
    """Queue-admission backpressure: at most `max_inflight` requests
    execute; a further request waits up to `queue_timeout_s` for a slot
    and is then refused with the typed `Overloaded` error (never an
    unbounded hang)."""

    def __init__(self, max_inflight: int = 1, queue_timeout_s: float = 0.0):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = int(max_inflight)
        self.queue_timeout_s = float(queue_timeout_s)
        self._sem = threading.BoundedSemaphore(self.max_inflight)

    def try_acquire(self, timeout_s: Optional[float] = None) -> bool:
        t = self.queue_timeout_s if timeout_s is None else float(timeout_s)
        if t > 0:
            return self._sem.acquire(timeout=t)
        return self._sem.acquire(blocking=False)

    def release(self) -> None:
        self._sem.release()

    @contextlib.contextmanager
    def admit(self, timeout_s: Optional[float] = None):
        global _reject_total
        if not self.try_acquire(timeout_s):
            _reject_total += 1
            wait = self.queue_timeout_s if timeout_s is None else timeout_s
            raise Overloaded(
                f"admission gate full ({self.max_inflight} inflight); "
                f"queue wait exceeded {wait:.3f}s")
        try:
            yield self
        finally:
            self.release()
