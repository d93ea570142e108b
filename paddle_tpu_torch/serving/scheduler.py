"""In-flight (continuous-batching) request scheduler (counterpart of
paddle_tpu/serving/scheduler.py, without the request-tracing stamps).

Pure host-side state machine — the engine (engine.py) owns the device
work and drives this scheduler once per `step()`:

  - FCFS admission into a FIXED number of decode slots;
  - admission backpressure: `max_inflight` bounds admitted requests, and
    with `queue_timeout_s == 0` a submit that cannot be admitted is
    refused with `resilience.Overloaded` at the door; with a positive
    timeout requests may queue and are expired with an `Overloaded`
    result once they wait longer;
  - per-request deadlines produce falsy `resilience.TimeoutResult`
    partial results, never hangs;
  - priority / fair-share classes: `Request(priority=..., tenant=...)`
    plus per-tenant in-flight token budgets (`tenant_budgets`). With the
    defaults — every request at priority 0, no budgets — admission is
    exactly FCFS head-of-line, so seeded traces stay deterministic;
  - preemption bookkeeping (`pick_victim`, `preempt`): a DECODE-state
    victim of strictly lower priority re-queues with its pages intact.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional

import numpy as np

from .. import resilience as _res

__all__ = ["Request", "Scheduler",
           "WAITING", "PREFILL", "DECODE", "FINISHED"]

WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"

_ids = itertools.count()


class Request:
    """One generation request. `tokens` accumulates greedy output ids;
    after FINISHED, `result` is an int32 array padded to max_new_tokens
    with pad_token_id, a falsy `resilience.TimeoutResult` carrying the
    partial tokens on a deadline miss, or a `resilience.Overloaded`
    instance if the request timed out of the admission queue."""

    def __init__(self, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0,
                 deadline_s: Optional[float] = None,
                 request_id=None,
                 priority: int = 0,
                 tenant: Optional[str] = None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.deadline_s = deadline_s
        self.request_id = request_id if request_id is not None \
            else next(_ids)
        self.state = WAITING
        self.slot: Optional[int] = None
        self.tokens: List[int] = []
        self.result = None
        self.pending: Optional[int] = None   # last sampled, not yet fed
        self.prefill_pos = 0                 # prompt tokens in cache
        self.shared_tokens = 0               # prefix tokens riding a donor
        self.priority = int(priority)        # higher = more urgent
        self.tenant = tenant                 # fair-share accounting key
        self.preempted = False               # mid-decode, pages intact
        self._seq: int = 0                   # submit order (set by submit)
        self._deadline: Optional[_res.Deadline] = None
        self._enqueued_at: Optional[float] = None

    @property
    def total_tokens(self) -> int:
        return int(self.prompt.size) + self.max_new_tokens

    def start_deadline(self) -> None:
        if self.deadline_s:
            self._deadline = _res.Deadline(self.deadline_s)

    def deadline_expired(self) -> bool:
        return self._deadline is not None and self._deadline.expired()

    def finalize(self) -> None:
        """Pad tokens to max_new_tokens."""
        out = np.full(self.max_new_tokens, self.pad_token_id, np.int32)
        out[:len(self.tokens)] = self.tokens
        if self._deadline is not None and self._deadline.expired():
            _res.deadline_miss()
            self.result = _res.TimeoutResult(
                kind="serving_engine", budget_s=self._deadline.budget_s,
                elapsed_s=self._deadline.elapsed_s,
                completed=len(self.tokens), partial=out)
        else:
            self.result = out

    def __repr__(self):
        return (f"Request(id={self.request_id}, state={self.state}, "
                f"prompt={self.prompt.size}, out={len(self.tokens)}/"
                f"{self.max_new_tokens})")


class Scheduler:
    """Continuous-batching scheduler over `max_slots` decode slots:
    FCFS within a priority class, per-tenant token budgets across
    classes."""

    def __init__(self, max_slots: int, max_inflight: Optional[int] = None,
                 queue_timeout_s: float = 0.0,
                 tenant_budgets: Optional[dict] = None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = int(max_slots)
        self.max_inflight = min(int(max_inflight), self.max_slots) \
            if max_inflight else self.max_slots
        self.backpressure = max_inflight is not None
        self.queue_timeout_s = float(queue_timeout_s)
        # tenant -> max in-flight total_tokens. A tenant at zero usage
        # always gets one request through even if it alone exceeds the
        # budget (progress guarantee — budgets shape, never starve).
        self.tenant_budgets = dict(tenant_budgets or {})
        self._tenant_tokens: dict = {}
        # graduated load shedding: requests with priority <
        # shed_below_priority are refused at the door with `Shed`
        self.shed_below_priority: Optional[int] = None
        self.shed_measurement: dict = {}
        self.waiting: deque = deque()
        self.slots: List[Optional[Request]] = [None] * self.max_slots
        self.finished: List[Request] = []
        self._submit_seq = itertools.count()

    # ------------------------------------------------------------- queries
    @property
    def inflight(self) -> int:
        return sum(r is not None for r in self.slots)

    def active(self, state: Optional[str] = None):
        """(slot, request) pairs, optionally filtered by state."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and (state is None or r.state == state)]

    def has_work(self) -> bool:
        return bool(self.waiting) or self.inflight > 0

    # ----------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> Request:
        """Enqueue FCFS. With backpressure and queue_timeout_s == 0, a
        request that cannot be admitted right now is refused with
        `Overloaded`; below the shed floor it is refused with `Shed`."""
        if self.shed_below_priority is not None \
                and req.priority < self.shed_below_priority:
            raise _res.Shed(
                f"priority {req.priority} < shed floor "
                f"{self.shed_below_priority}",
                measurement=self.shed_measurement)
        if self.backpressure and self.queue_timeout_s <= 0 \
                and self.inflight + len(self.waiting) >= self.max_inflight:
            raise _res.Overloaded(
                f"admission gate full ({self.max_inflight} inflight)")
        req.state = WAITING
        req._seq = next(self._submit_seq)
        req._enqueued_at = time.monotonic()
        req.start_deadline()
        self.waiting.append(req)
        return req

    def expire_waiting(self) -> List[Request]:
        """Cull queued requests past the admission timeout (and queued
        requests whose own deadline already expired): they finish with
        an Overloaded / TimeoutResult result without touching a slot."""
        expired = []
        keep = deque()
        now = time.monotonic()
        for req in self.waiting:
            # preempted requests were already admitted once: the
            # admission-queue timeout no longer applies (their deadline
            # still does, producing a partial TimeoutResult)
            timed_out = (not req.preempted
                         and self.backpressure and self.queue_timeout_s > 0
                         and now - req._enqueued_at > self.queue_timeout_s)
            if timed_out:
                req.state = FINISHED
                req.result = _res.Overloaded(
                    f"request {req.request_id} waited "
                    f"{now - req._enqueued_at:.3f}s > queue_timeout_s="
                    f"{self.queue_timeout_s}")
                expired.append(req)
            elif req.deadline_expired():
                req.state = FINISHED
                req.finalize()
                expired.append(req)
            else:
                keep.append(req)
        self.waiting = keep
        self.finished.extend(expired)
        return expired

    def _budget_ok(self, req: Request) -> bool:
        budget = self.tenant_budgets.get(req.tenant)
        if budget is None:
            return True
        used = self._tenant_tokens.get(req.tenant, 0)
        return used == 0 or used + req.total_tokens <= budget

    def next_candidate(self) -> Optional[Request]:
        """Highest-priority, oldest budget-eligible waiting request —
        ignoring slot availability."""
        best = None
        for req in self.waiting:
            if not self._budget_ok(req):
                continue
            if best is None or (req.priority, -req._seq) \
                    > (best.priority, -best._seq):
                best = req
        return best

    def next_admittable(self) -> Optional[Request]:
        """The request `admit()` would take if a slot and an inflight
        credit are free; None otherwise."""
        if not self.waiting or self.inflight >= self.max_inflight \
                or all(r is not None for r in self.slots):
            return None
        return self.next_candidate()

    def admit(self, req: Request) -> int:
        """Bind the chosen waiting request to the lowest free slot. A
        preempted request resumes straight into DECODE."""
        self.waiting.remove(req)
        slot = next(i for i, r in enumerate(self.slots) if r is None)
        req.state = DECODE if req.preempted else PREFILL
        req.slot = slot
        self.slots[slot] = req
        if req.tenant is not None:
            self._tenant_tokens[req.tenant] = \
                self._tenant_tokens.get(req.tenant, 0) + req.total_tokens
        req.preempted = False
        return slot

    def pick_victim(self, priority: int) -> Optional[Request]:
        """Lowest-priority DECODE-state request strictly below
        `priority` (youngest on ties). PREFILL requests are never
        preempted (their chunk bookkeeping is mid-flight)."""
        victim = None
        for _, req in self.active(DECODE):
            if req.priority >= priority:
                continue
            if victim is None or (req.priority, -req._seq) \
                    < (victim.priority, -victim._seq):
                victim = req
        return victim

    def preempt(self, req: Request) -> None:
        """Re-queue a running decode with its allocator sequence intact.
        Only the slot is given up; `admit()` later resumes it."""
        if req.slot is None or req.state != DECODE:
            raise ValueError(f"cannot preempt {req!r}: not decoding")
        self.slots[req.slot] = None
        req.slot = None
        req.state = WAITING
        req.preempted = True
        if req.tenant is not None:
            self._tenant_tokens[req.tenant] = \
                self._tenant_tokens.get(req.tenant, 0) - req.total_tokens
        self.waiting.append(req)

    def detach(self, req: Request) -> None:
        """Unbind an in-flight (or preempted-waiting) request from this
        scheduler entirely; it does NOT re-enter the waiting queue."""
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
            if req.tenant is not None:
                self._tenant_tokens[req.tenant] = \
                    self._tenant_tokens.get(req.tenant, 0) \
                    - req.total_tokens
        elif req in self.waiting:
            self.waiting.remove(req)

    def release(self, req: Request) -> None:
        """Free the slot the instant a request finishes — the next
        step() can admit into it (no drain barrier)."""
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
            if req.tenant is not None:
                self._tenant_tokens[req.tenant] = \
                    self._tenant_tokens.get(req.tenant, 0) \
                    - req.total_tokens
        req.state = FINISHED
        self.finished.append(req)

    def drain_finished(self) -> List[Request]:
        done, self.finished = self.finished, []
        return done
