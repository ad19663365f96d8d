"""Continuous-batching request scheduler.

Open-loop admission control over the fixed slot array: requests queue
FIFO; at every DECODE-STEP BOUNDARY the engine asks the scheduler to
(1) admit queued requests into free slots (prefill hand-off) and
(2) evict finished ones (slot + page recycling).  Mid-sequence the
decode step is never perturbed — admission changes only the host-side
slot tables (positions, current tokens, sampling vectors) that are
passed into the SAME decode step each step, which is what makes the
batching "continuous": one step function serves a ragged, ever-changing
mix of requests.

Counterpart of ``torchpruner_tpu/serve/scheduler.py``: the FIFO and QoS
admission, preemption and eviction, copied without the telemetry calls
(obs, reqtrace).  The queue bound, the chunked-prefill budget and the
drain path are not ported yet.

Thread-safety: ``submit`` may be called from other threads while the
engine loop runs; the queue is guarded by a lock.  Everything else is
engine-loop-only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from torchpruner_tpu_torch.serve.allocator import KVCacheAllocator
from torchpruner_tpu_torch.serve.qos import QoS
from torchpruner_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    SHED,
    Request,
)


class Scheduler:
    """Priority-class FIFO queues + slot-table bookkeeping (see module
    docstring).  An empty QoS table makes it a plain FIFO."""

    def __init__(self, allocator: KVCacheAllocator,
                 qos: Optional[QoS] = None):
        self.allocator = allocator
        #: multi-tenant QoS table (serve.qos) — an empty table makes
        #: every path below behave exactly like the pre-QoS FIFO
        self.qos = qos if qos is not None else QoS()
        #: priority class -> FIFO of waiting requests; admission serves
        #: ascending class numbers, FIFO (head-of-line) within a class
        self._queues: Dict[int, Deque[Request]] = {}
        self._lock = threading.Lock()
        #: slot -> active request
        self.running: Dict[int, Request] = {}
        self.admitted_total = 0
        self.completed_total = 0
        self.shed_total = 0
        #: requests preempted back to the queue by a higher-priority
        #: admission (progress restarts on re-admit)
        self.preempted_total = 0

    # -- submission side ----------------------------------------------------

    def submit(self, request: Request,
               arrival_s: Optional[float] = None) -> Request:
        """Enqueue a request (thread-safe), or SHED it when its tenant's
        token bucket is empty.  ``arrival_s`` lets an open-loop traffic
        generator backdate the arrival to its SCHEDULED time, so queueing
        delay counts into TTFT the way it would for a real caller."""
        request.arrival_s = (time.perf_counter() if arrival_s is None
                             else arrival_s)
        pol = self.qos.policy(request.tenant)
        with self._lock:
            if not self.qos.admit_now(request.tenant):
                request.state = SHED
                self.shed_total += 1
                return request
            request.state = QUEUED
            self._queues.setdefault(pol.priority, deque()).append(request)
        return request

    # -- engine side (step boundaries only) ---------------------------------

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def has_work(self) -> bool:
        return bool(self.running) or self.queue_depth > 0

    def _head_locked(self):
        """Highest-priority non-empty queue and its head request."""
        for prio in sorted(self._queues):
            q = self._queues[prio]
            if q:
                return q, q[0]
        return None, None

    def _pick_victim_locked(self, priority: int) -> Optional[Request]:
        """The preemption victim for an admission at ``priority``: the
        YOUNGEST active request of a strictly lower (larger-number)
        preemptible class — last in, first preempted, so long-running
        batch work accumulates the least wasted progress."""
        victim: Optional[Request] = None
        for req in self.running.values():
            pol = self.qos.policy(req.tenant)
            if pol.priority <= priority or not pol.preemptible:
                continue
            if req.state != ACTIVE or req.slot is None:
                continue
            if victim is None or (req.admitted_s or 0.0) \
                    > (victim.admitted_s or 0.0):
                victim = req
        return victim

    def _preempt_locked(self, victim: Request) -> None:
        """Evict an ACTIVE request back to the FRONT of its class
        queue, releasing slot + pages and resetting generation progress
        (tokens restart from the prompt on re-admission).  Called only
        from :meth:`admit` — i.e. only at a decode-step boundary, so
        the decode step never observes a half-evicted slot."""
        slot = victim.slot
        if slot is not None and self.running.get(slot) is victim:
            del self.running[slot]
            self.allocator.release(slot)
        victim.slot = None
        victim.state = QUEUED
        victim.tokens.clear()
        victim.token_gaps_s.clear()
        victim.first_token_s = None
        victim.prefill_s = None
        victim.admitted_s = None
        victim.done_s = None
        victim.prefilled_tokens = 0
        victim.preemptions += 1
        self.preempted_total += 1
        pol = self.qos.policy(victim.tenant)
        self._queues.setdefault(pol.priority, deque()).appendleft(victim)

    def admit(self) -> List[Request]:
        """Pop queued requests while a slot (and KV pages) are free;
        returns the newly-admitted batch for the engine to prefill.
        Admission serves priority classes in ascending order, FIFO
        head-of-line WITHIN a class: a too-long request at the head
        blocks its queue rather than being overtaken (no starvation).
        When the head is blocked on capacity and a strictly lower
        (preemptible) class holds slots, the youngest such active
        request is preempted — here and only here, so preemption is
        step-boundary-exact by construction.  An over-quota head is
        SHED instead of blocking: its footprint is the tenant's own
        doing."""
        out: List[Request] = []
        while True:
            with self._lock:
                q, head = self._head_locked()
                if head is None:
                    break
                pol = self.qos.policy(head.tenant)
                if self.allocator.exceeds_quota(
                        head.tenant, head.total_len, pol.page_quota):
                    q.popleft()
                    head.state = SHED
                    self.shed_total += 1
                    continue
                lease = self.allocator.allocate(
                    head.id, head.total_len, tenant=head.tenant)
                if lease is None:
                    victim = self._pick_victim_locked(pol.priority)
                    if victim is None:
                        break
                    self._preempt_locked(victim)
                    continue
                q.popleft()
                head.slot = lease.slot
                head.state = ACTIVE
                head.admitted_s = time.perf_counter()
                self.running[lease.slot] = head
            self.admitted_total += 1
            out.append(head)
        return out

    def evict(self, request: Request, state: str = DONE) -> None:
        """Release a finished request's slot + pages (step boundary)."""
        slot = request.slot
        request.state = state
        request.done_s = time.perf_counter()
        if slot is not None and self.running.get(slot) is request:
            del self.running[slot]
            self.allocator.release(slot)
        request.slot = None
        self.completed_total += 1
