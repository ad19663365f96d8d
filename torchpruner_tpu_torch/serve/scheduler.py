"""Continuous-batching request scheduler — counterpart of
``torchpruner_tpu/serve/scheduler.py``, with its telemetry calls (obs
counters, gauges and request-trace stages, no-ops without a session);
the shed, drain and rejection counts are also kept on the host
(``rejected``, ``tenant_shed``) for ``summary()`` and ``/stats``.

Open-loop admission control over the fixed slot array: requests queue
FIFO; at every DECODE-STEP BOUNDARY the engine asks the scheduler to
(1) admit queued requests into free slots (prefill hand-off) and
(2) evict finished ones (slot + page recycling).  Mid-sequence the
decode step is never perturbed — admission changes only the host-side
slot tables (positions, current tokens, sampling vectors) that are
passed into the SAME decode step each step, which is what makes the
batching "continuous": one step function serves a ragged, ever-changing
mix of requests.

Thread-safety: ``submit`` may be called from frontend threads (HTTP
handlers) while the engine loop runs; the queue is guarded by a lock.
Everything else is engine-loop-only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.obs import reqtrace
from torchpruner_tpu_torch.serve.allocator import KVCacheAllocator
from torchpruner_tpu_torch.serve.qos import QoS
from torchpruner_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    DRAINED,
    QUEUED,
    SHED,
    Request,
)

_REJECTED_HELP = ("submissions rejected (per-reason twins: "
                  "serve_rejected_<reason>_total)")


class Scheduler:
    """FIFO queue + slot-table bookkeeping (see module docstring).

    ``queue_bound > 0`` bounds the waiting queue: a submission landing
    on a full queue is SHED immediately (state ``shed``, event set)
    instead of queueing unboundedly — the HTTP front end turns that
    into 503 + Retry-After, and the fleet router reuses the same bound
    as its per-replica backpressure signal."""

    def __init__(self, allocator: KVCacheAllocator,
                 queue_bound: int = 0, prefill_token_cap: int = 0,
                 qos: Optional[QoS] = None):
        self.allocator = allocator
        self.queue_bound = int(queue_bound)
        #: per-engine-step prefill-token budget (chunked prefill): a
        #: long prompt spends at most this much prefill work per step,
        #: so decode cadence for resident requests is bounded below.
        #: 0 = uncapped.
        self.prefill_token_cap = int(prefill_token_cap)
        #: multi-tenant QoS table (serve.qos) — an empty table makes
        #: every path below behave exactly like the pre-QoS FIFO
        self.qos = qos if qos is not None else QoS()
        #: priority class -> FIFO of waiting requests; admission serves
        #: ascending class numbers, FIFO (head-of-line) within a class
        self._queues: Dict[int, Deque[Request]] = {}
        self._lock = threading.Lock()
        #: recent queue-age-at-admission samples (seconds) — the LIVE
        #: p50/p99 the /stats endpoint serves; the full distribution
        #: rides the serve_queue_wait_seconds histogram
        self._queue_waits: Deque[float] = deque(maxlen=512)
        #: optional per-admission queue-age callback — the engine wires
        #: this to ``SLOMonitor.on_queue`` so queue age joins the
        #: burn-rate evaluation (serve/slo.py)
        self.on_queue_wait = None
        #: slot -> active request
        self.running: Dict[int, Request] = {}
        self.admitted_total = 0
        self.completed_total = 0
        self.shed_total = 0
        #: requests preempted back to the queue by a higher-priority
        #: admission (progress restarts on re-admit)
        self.preempted_total = 0
        #: engine-installed guard: ``guard(slot) -> bool`` answers
        #: whether that slot may be preempted RIGHT NOW (the engine
        #: refuses slots mid-chunked-prefill); None = any active slot
        self.preempt_guard = None
        #: set when a drain begins: later submissions are REJECTED
        #: (marked drained, event set) instead of queueing forever —
        #: an HTTP client racing a SIGTERM gets an immediate "resubmit
        #: elsewhere" answer, and the drain loop can still terminate
        self.closed = False
        #: rejected submissions by reason (drain, throttle,
        #: backpressure, quota) and per (tenant, reason)
        self.rejected: Dict[str, int] = {}
        self.tenant_shed: Dict[str, int] = {}

    # -- frontend side ------------------------------------------------------

    def submit(self, request: Request,
               arrival_s: Optional[float] = None) -> Request:
        """Enqueue a request (thread-safe).  ``arrival_s`` lets an
        open-loop traffic generator backdate the arrival to its
        SCHEDULED time, so queueing delay counts into TTFT the way it
        would for a real caller."""
        request.arrival_s = (time.perf_counter() if arrival_s is None
                             else arrival_s)
        pol = self.qos.policy(request.tenant)
        with self._lock:
            # the closed check shares the queue lock with drain_queue:
            # checked outside it, a submission racing the drain could
            # append AFTER the drain swept the queue — a permanently
            # QUEUED request that keeps has_work() true and spins the
            # SIGTERM'd loop forever
            if self.closed:
                request.state = DRAINED
                request._event.set()
                self.rejected["drain"] = self.rejected.get("drain", 0) + 1
                obs.inc("serve_rejected_total", help=_REJECTED_HELP)
                obs.inc("serve_rejected_drain_total",
                        help="submissions rejected after a drain began")
                return request
            if not self.qos.admit_now(request.tenant):
                request.state = SHED
                request._event.set()
                self.shed_total += 1
                obs.inc("serve_rejected_total", help=_REJECTED_HELP)
                obs.inc("serve_rejected_throttle_total",
                        help="submissions shed by a tenant's token "
                             "bucket (rate throttling)")
                self._tenant_shed(request.tenant, "throttle")
                return request
            if self.queue_bound and self._depth_locked() >= self.queue_bound:
                request.state = SHED
                request._event.set()
                self.shed_total += 1
                obs.inc("serve_rejected_total", help=_REJECTED_HELP)
                obs.inc("serve_rejected_backpressure_total",
                        help="submissions shed by the queue bound "
                             "(503 + Retry-After backpressure)")
                self._tenant_shed(request.tenant, "backpressure")
                return request
            request.state = QUEUED
            self._queues.setdefault(pol.priority, deque()).append(request)
            # under the queue lock: HTTP handler threads submit
            # concurrently, and a counter's increment is not atomic
            obs.inc("serve_requests_total", help="requests submitted")
        return request

    def _tenant_shed(self, tenant: Optional[str], reason: str) -> None:
        """Count a shed by reason, and per tenant (the JAX package's
        serve_rejected_* / tenant_*_shed_* counters); called under the
        queue lock."""
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        if tenant:
            key = f"{tenant}:{reason}"
            self.tenant_shed[key] = self.tenant_shed.get(key, 0) + 1
            obs.inc(f"tenant_{tenant}_shed_total",
                    help="this tenant's shed submissions (all reasons)")
            obs.inc(f"tenant_{tenant}_shed_{reason}_total",
                    help=f"this tenant's submissions shed by {reason}")

    def close(self) -> None:
        """Begin a drain: flip ``closed`` under the queue lock.  Set
        bare (``scheduler.closed = True``) a submission racing the
        drain could observe ``closed == False``, pass the gate, and
        append after the drain swept the queue — the same permanently
        QUEUED hang the ``submit`` gate exists to prevent."""
        with self._lock:
            self.closed = True

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
        batch work accumulates the least wasted progress.  The engine's
        ``preempt_guard`` vetoes slots mid-chunked-prefill."""
        victim: Optional[Request] = None
        for req in self.running.values():
            pol = self.qos.policy(req.tenant)
            if pol.priority <= priority or not pol.preemptible:
                continue
            if req.state != ACTIVE or req.slot is None:
                continue
            if self.preempt_guard is not None \
                    and not self.preempt_guard(req.slot):
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
        victim.prefix_hit_tokens = 0
        victim.prefilled_tokens = 0
        victim.served_by = None
        victim.preemptions += 1
        self.preempted_total += 1
        obs.inc("serve_preempted_total",
                help="active requests preempted back to the queue by a "
                     "higher-priority admission (step boundary only)")
        if victim.tenant:
            obs.inc(f"tenant_{victim.tenant}_preempted_total",
                    help="this tenant's requests preempted by a "
                         "higher-priority admission")
        reqtrace.stage(victim.trace_id, "preempted", request=victim.id,
                       preemptions=victim.preemptions)
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
        SHED (``rejected["quota"]``) instead of blocking: its
        footprint is the tenant's own doing."""
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
                    head._event.set()
                    self.shed_total += 1
                    obs.inc("serve_rejected_total", help=_REJECTED_HELP)
                    obs.inc("serve_rejected_quota_total",
                            help="admissions shed because the tenant "
                                 "would exceed its KV-page quota")
                    self._tenant_shed(head.tenant, "quota")
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
            # queue age is recorded AT ADMISSION, not at completion —
            # the wait is visible in /stats and the reqtrace budget
            # while the request is still decoding
            head.admitted_s = time.perf_counter()
            if head.arrival_s is not None:
                wait = max(0.0, head.admitted_s - head.arrival_s)
                with self._lock:
                    # /stats handler threads sort this deque live — an
                    # unlocked append could fault their iteration
                    self._queue_waits.append(wait)
                obs.observe("serve_queue_wait_seconds", wait,
                            help="request submit -> slot admission "
                                 "(queue age at admit time)")
                if self.on_queue_wait is not None:
                    self.on_queue_wait(wait)
                reqtrace.stage(head.trace_id, "replica_queue",
                               dur_s=wait, request=head.id)
            with self._lock:
                # /stats and preemption scans read running under the
                # lock — publish the slot assignment the same way
                self.running[lease.slot] = head
            self.admitted_total += 1
            out.append(head)
        if out:
            obs.inc("serve_admits_total", n=len(out),
                    help="requests admitted into a decode slot")
        self._gauges()
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
        obs.inc("serve_evictions_total",
                help="slot evictions (request completion or early stop)")
        if state == DONE:
            obs.inc("serve_completed_total", help="requests completed")
        request._event.set()
        self._gauges()

    def prefill_budget(self, chunk: int) -> int:
        """The step's prefill-token budget, floored at one chunk —
        a cap below the chunk width would deadlock the prefill, so the
        floor IS the enforced cap (engine.max_prefill_tokens_step is
        gated against this value, not the raw knob)."""
        if self.prefill_token_cap <= 0:
            return 1 << 30
        return max(self.prefill_token_cap, int(chunk))

    def queue_wait_ms(self) -> Dict[str, float]:
        """Live queue-age percentiles over the recent-admissions window
        (ms) — empty dict before the first admission.  Thread-safe
        (called from /stats handler threads while the engine admits)."""
        with self._lock:
            xs = sorted(self._queue_waits)
        if not xs:
            return {}

        def pct(q: float) -> float:
            i = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
            return round(1e3 * xs[int(i)], 3)

        return {"p50": pct(0.50), "p99": pct(0.99)}

    def drain_queue(self) -> List[Request]:
        """Remove and return every not-yet-started request — the
        preemption path: in-flight requests finish, queued ones are
        snapshotted for resubmission."""
        with self._lock:
            out = [r for prio in sorted(self._queues)
                   for r in self._queues[prio]]
            for q in self._queues.values():
                q.clear()
        self._gauges()
        return out

    def _gauges(self) -> None:
        alloc = self.allocator
        obs.gauge_set("serve_queue_depth", self.queue_depth,
                      help="requests waiting for a slot")
        obs.gauge_set("serve_active_slots", alloc.active_slots,
                      help="slots currently decoding")
        obs.gauge_set("serve_kv_pages_in_use", alloc.pages_in_use,
                      help="KV-cache pages leased to active requests")
        obs.gauge_set("serve_kv_page_occupancy",
                      alloc.pages_in_use / max(1, alloc.page_budget),
                      help="leased KV pages / page budget (0..1)")
        obs.gauge_set("serve_slot_utilization",
                      alloc.active_slots / max(1, alloc.n_slots),
                      help="active decode slots / slot-array width "
                           "(0..1)")
        if alloc.prefix_enabled:
            # emitted ONLY with sharing on, so sharing-off runs carry no
            # serve_prefix_*/shared scalars at all
            obs.gauge_set("serve_kv_pages_shared", alloc.shared_pages,
                          help="prefix-pool pages pinned by at least "
                               "one resident request")
            obs.gauge_set("serve_prefix_pool_used",
                          alloc.prefix_pool_used,
                          help="prefix-pool pages holding published "
                               "K/V (out of prefix_pages)")
