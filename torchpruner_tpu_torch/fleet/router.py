"""The fleet router: health-checked least-loaded dispatch + failover.
(A copy of ``torchpruner_tpu/fleet/router.py``, imports renamed.)

One router process fronts N serve replicas and makes replica death a
non-event:

- **Health view** — every ``health_every_s`` the router probes each
  replica's ``/healthz`` (liveness split from readiness: ``draining`` /
  ``staging_swap`` / ``slo_breach`` answer 503) and scrapes the live
  ``kv_page_occupancy`` / ``slot_utilization`` / ``queue_depth`` gauges
  from ``/stats``.  A live→dead transition is a FAILOVER: the dead
  replica's journaled in-flight records are hedge-re-dispatched to
  survivors immediately (``fleet_failover_total`` /
  ``fleet_redrive_total``) — the worker still blocked on the corpse's
  socket discovers the death itself and its late result, if any, is
  dropped idempotently.
- **Dispatch** — pending plane records go to the least-loaded READY
  replica (scraped occupancy + queue depth + the router's own in-flight
  count); each record's attempt loop is
  ``resilience.retry.with_retries``: bounded attempts, per-attempt
  timeout clamped by the record's deadline budget, deterministic-jitter
  exponential backoff, pinned exhaustion-vs-deadline ordering.  When no
  replica is ready the attempt fails retryably — survivor recovery and
  backoff, not a crash.
- **Degraded-mode admission** — :meth:`FleetRouter.submit` sheds by
  policy instead of collapsing: a bounded pending queue
  (``queue_bound``), tightened to ``degraded_queue_factor`` of itself
  while the fleet is degraded (a majority of live replicas in
  ``slo_breach``, or fewer ready replicas than ``min_ready``), and a
  loud 503-shaped shed (``fleet_shed_*_total`` + Retry-After hint)
  when the bound is hit or nothing is live.
- **Fleet upgrade as a loop** — :meth:`rolling_swap` stages the
  engine's background checkpoint hot-swap on one replica at a time, waiting for
  each swap to land (readiness flips through ``staging_swap`` and the
  router routes around it) before touching the next.
- **Prefix affinity** (Serve v2) — requests carrying a ``session_id``,
  or whose prompt starts with a previously-seen leading chunk, PREFER
  the replica that served that key last (:class:`PrefixAffinity`):
  landing them together compounds that replica's prefix-cache hits
  (``--prefix-pages``), turning the per-replica radix cache into a
  fleet-wide one without any cross-replica KV traffic.  Affinity is a
  ROUTING HINT, never a correctness constraint: an unusable preferred
  replica falls back to least-loaded, and a failover forgets every key
  pointing at the corpse.  ``fleet_affinity_*`` counters/gauges feed
  the time-series plane.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.obs import reqtrace
from torchpruner_tpu_torch.fleet.plane import PlaneRecord, RequestPlane
from torchpruner_tpu_torch.fleet.replica import (
    ReplicaBusy,
    ReplicaClient,
    ReplicaError,
)
from torchpruner_tpu_torch.resilience.retry import (
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    with_retries,
)


@dataclass(frozen=True)
class RouterPolicy:
    """Every budget/bound in one place (CLI-overridable)."""

    #: pending-queue bound; submissions past it shed (0 = unbounded)
    queue_bound: int = 64
    #: bound multiplier while the fleet is degraded (SLO-breach
    #: majority / not enough ready replicas) — admission tightening
    degraded_queue_factor: float = 0.25
    #: live replicas in slo_breach at/above this fraction = degraded
    degraded_breach_fraction: float = 0.5
    #: fewer READY replicas than this = degraded
    min_ready: int = 1
    #: dispatch attempts per record (first try included) — generous:
    #: a capacity crunch ("no usable replica") consumes attempts too,
    #: and an accepted record failed on attempts is accepted-request
    #: loss, the thing the drill exists to forbid
    max_attempts: int = 10
    #: per-attempt transport timeout (clamped by the record deadline)
    attempt_timeout_s: float = 90.0
    #: deadline budget stamped on records submitted without one
    default_deadline_s: float = 300.0
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    #: deterministic-jitter seed (resilience.retry)
    seed: int = 0
    health_every_s: float = 0.5
    health_timeout_s: float = 2.0
    #: concurrent in-flight dispatches per replica (≈ slots + a margin
    #: that keeps the replica's bounded queue warm without flooding it)
    max_inflight_per_replica: int = 4
    #: rolling_swap's swap-counter poll cadence (was a hardcoded sleep)
    swap_poll_s: float = 0.25
    #: run_until_drained's default tick sleep (drills override per call)
    drain_poll_s: float = 0.02
    #: leading prompt tokens hashed into the prefix-affinity key (a
    #: prompt shorter than this registers no prefix key); 0 disables
    #: prefix-affinity routing entirely (session keys included)
    affinity_prefix_tokens: int = 16
    #: affinity-registry bound (LRU past it) — a long-running endpoint
    #: must not grow router memory with lifetime session count
    affinity_max_keys: int = 4096

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(
            tries=self.max_attempts, base_delay_s=self.base_backoff_s,
            max_delay_s=self.max_backoff_s, seed=self.seed)


class PrefixAffinity:
    """Affinity-key → replica-name registry (see module docstring).

    Two key kinds per request, strongest first: ``("s", session_id)``
    (caller-asserted session) and ``("p", hash(leading tokens))`` (the
    first ``prefix_tokens`` prompt ids — the same leading chunk the
    replica's radix trie would match).  :meth:`note` registers both at
    completion; :meth:`preferred` answers the longest-signal match;
    :meth:`forget` drops every key pointing at a dead replica.  LRU-
    bounded at ``max_keys``.  Not thread-safe — callers hold the
    router's lock."""

    def __init__(self, prefix_tokens: int, max_keys: int = 4096):
        self.prefix_tokens = int(prefix_tokens)
        self.max_keys = int(max_keys)
        from collections import OrderedDict
        self._map: "OrderedDict[tuple, str]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    def keys_of(self, payload: dict) -> List[tuple]:
        """The request's affinity keys, strongest first."""
        if self.prefix_tokens <= 0:
            return []
        keys: List[tuple] = []
        sid = payload.get("session_id")
        if sid:
            keys.append(("s", str(sid)))
        ids = payload.get("prompt_ids") or []
        if len(ids) >= self.prefix_tokens:
            keys.append(
                ("p", hash(tuple(ids[:self.prefix_tokens]))))
        return keys

    def preferred(self, payload: dict) -> Optional[str]:
        for key in self.keys_of(payload):
            name = self._map.get(key)
            if name is not None:
                self._map.move_to_end(key)
                return name
        return None

    def note(self, payload: dict, replica: str) -> None:
        for key in self.keys_of(payload):
            self._map[key] = replica
            self._map.move_to_end(key)
        while len(self._map) > self.max_keys:
            self._map.popitem(last=False)

    def forget(self, replica: str) -> int:
        """Drop every key routed at ``replica`` (failover); returns how
        many were dropped — stale affinity to a corpse would fight the
        exclude/least-loaded fallback on every subsequent request."""
        dead = [k for k, v in self._map.items() if v == replica]
        for k in dead:
            del self._map[k]
        return len(dead)


@dataclass
class ReplicaView:
    """The router's last-probed view of one replica."""

    client: ReplicaClient
    live: bool = False
    ready: bool = False
    state: str = "unknown"
    occupancy: float = 0.0
    slot_utilization: float = 0.0
    queue_depth: int = 0
    swaps: int = 0
    probed_at: float = 0.0
    #: estimated clock offset (replica wall clock − router wall clock,
    #: seconds) from the health probe's request/response timestamps —
    #: the alignment the cross-process trace assembly uses.  The kept
    #: sample is the lowest-RTT one seen recently (NTP-style: a slow
    #: probe bounds the offset loosely)
    clock_offset: Optional[float] = None
    offset_rtt: Optional[float] = None
    offset_at: float = 0.0
    offset_emitted: Optional[float] = None
    #: set once the death was failed over (so one death = one failover)
    failover_done: bool = False
    dispatched_total: int = 0
    inflight: int = 0
    #: scale-down victim: never picked for NEW dispatches, but still
    #: probed/live while its in-flight work drains (the supervisor's
    #: drain-then-remove contract)
    retiring: bool = False
    extra: dict = field(default_factory=dict)


class FleetRouter:
    """See module docstring.  Thread model: front ends call
    :meth:`submit` from any thread; :meth:`tick` runs on the owner's
    loop (the drill's loop or the HTTP server's pump thread); dispatch
    attempts run on an internal executor, one worker per in-flight
    record."""

    def __init__(self, plane: RequestPlane,
                 replicas: List[ReplicaClient],
                 policy: RouterPolicy = RouterPolicy()):
        self.plane = plane
        self.policy = policy
        self.views: Dict[str, ReplicaView] = {
            r.name: ReplicaView(client=r) for r in replicas}
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, policy.max_inflight_per_replica
                            * len(replicas)),
            thread_name_prefix="fleet-dispatch")
        #: records checked out of the plane whose dispatch worker has
        #: not finished — the pump()'s capacity gate
        self._workers_out = 0
        self._last_health = 0.0
        self.failovers_total = 0
        self.shed_total = 0
        self.dispatched_total = 0
        self.affinity = PrefixAffinity(
            policy.affinity_prefix_tokens,
            max_keys=policy.affinity_max_keys)
        #: records that carried a usable affinity preference / of those,
        #: how many actually landed on the preferred replica
        self.affinity_preferred_total = 0
        self.affinity_hits_total = 0
        #: tenants currently load-shed at admission (the degradation
        #: ladder's first rung: the supervisor sheds the batch tier
        #: here before touching interactive traffic) — mutated under
        #: the router lock, reversible
        self.shed_tenants: set = set()
        #: supervisor-forced admission tightening (degradation-ladder
        #: rung 2): degraded() answers True while set, shrinking the
        #: effective queue bound by degraded_queue_factor
        self.force_degraded = False
        #: tenant -> live counters + recent latency samples (the
        #: per-tenant SLO breakdown the drill summary / obs report
        #: render); guarded by the router lock
        self._tenants: Dict[str, dict] = {}
        self._closed = False

    # -- per-tenant accounting ----------------------------------------------

    def _tenant_entry_locked(self, tenant: str) -> dict:
        ent = self._tenants.get(tenant)
        if ent is None:
            ent = {"accepted": 0, "completed": 0, "shed": 0,
                   "deadline_exceeded": 0,
                   "ttft_s": deque(maxlen=4096),
                   "e2e_s": deque(maxlen=4096)}
            self._tenants[tenant] = ent
        return ent

    def _tenant_note(self, tenant: Optional[str], event: str,
                     ttft_s: Optional[float] = None,
                     e2e_s: Optional[float] = None) -> None:
        if not tenant:
            return
        with self._lock:
            ent = self._tenant_entry_locked(tenant)
            ent[event] = ent.get(event, 0) + 1
            if ttft_s is not None:
                ent["ttft_s"].append(float(ttft_s))
            if e2e_s is not None:
                ent["e2e_s"].append(float(e2e_s))

    def tenant_summary(self) -> Dict[str, dict]:
        """Per-tenant counters + latency percentiles, and the
        ``tenant_<name>_*`` gauges obs report's per-tenant SLO table is
        built from (exported here, at read-out time, so the scalars
        carry final percentiles rather than a racing snapshot)."""
        def pct(xs, q):
            if not xs:
                return None
            xs = sorted(xs)
            return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]

        with self._lock:
            tenants = {t: dict(ent, ttft_s=list(ent["ttft_s"]),
                               e2e_s=list(ent["e2e_s"]))
                       for t, ent in self._tenants.items()}
        out: Dict[str, dict] = {}
        for t, ent in sorted(tenants.items()):
            row = {"accepted": ent["accepted"],
                   "completed": ent["completed"],
                   "shed": ent["shed"],
                   "deadline_exceeded": ent["deadline_exceeded"],
                   "ttft_p50_s": pct(ent["ttft_s"], 0.50),
                   "ttft_p99_s": pct(ent["ttft_s"], 0.99),
                   "e2e_p50_s": pct(ent["e2e_s"], 0.50),
                   "e2e_p99_s": pct(ent["e2e_s"], 0.99)}
            out[t] = row
            for k in ("accepted", "completed", "shed",
                      "deadline_exceeded"):
                obs.gauge_set(f"tenant_{t}_{k}_fleet",
                              row[k],
                              help=f"router-observed {k} count for "
                                   f"this tenant")
            for k in ("ttft_p50_s", "ttft_p99_s", "e2e_p50_s",
                      "e2e_p99_s"):
                if row[k] is not None:
                    obs.gauge_set(
                        f"tenant_{t}_{k}", round(row[k], 6),
                        help="router-observed per-tenant latency "
                             "percentile (TTFT from replica results, "
                             "e2e accept -> complete)")
        return out

    # -- admission -----------------------------------------------------------

    def degraded(self) -> bool:
        """Admission tightening trigger: not enough ready replicas, or
        a majority of the live ones sitting in an SLO-breach episode
        (the rolling SLOMonitor p99s, scraped via /healthz state).
        ``force_degraded`` is the supervisor's degradation-ladder rung:
        the same tightened bound, entered deliberately."""
        with self._lock:
            if self.force_degraded:
                return True
            live = [v for v in self.views.values() if v.live]
            ready = [v for v in live if v.ready]
            if len(ready) < self.policy.min_ready:
                return True
            breached = [v for v in live if v.state == "slo_breach"]
            return bool(live) and (
                len(breached) / len(live)
                >= self.policy.degraded_breach_fraction)

    def effective_queue_bound(self) -> int:
        bound = self.policy.queue_bound
        if bound and self.degraded():
            bound = max(1, int(bound * self.policy.degraded_queue_factor))
        return bound

    def admission(self) -> dict:
        """One consolidated verdict for front ends: ``accepting`` plus
        the shed reason / Retry-After hint when not."""
        with self._lock:
            # membership is elastic now (supervisor add/remove):
            # snapshot under the lock so a resize mid-iteration can't
            # fault a submitting frontend thread
            live = [v for v in self.views.values() if v.live]
        if self._closed:
            return {"accepting": False, "reason": "closing",
                    "retry_after_s": 5, "code": 503}
        if not live:
            return {"accepting": False, "reason": "no_live_replica",
                    "retry_after_s": 5, "code": 503}
        bound = self.effective_queue_bound()
        depth = self.plane.pending_depth
        if bound and depth >= bound:
            reason = ("degraded" if bound < self.policy.queue_bound
                      else "backpressure")
            return {"accepting": False, "reason": reason,
                    "retry_after_s": max(1, depth // max(1, len(live))),
                    "code": 429}
        return {"accepting": True, "reason": "", "retry_after_s": 0,
                "code": 200}

    def submit(self, payload: dict,
               deadline_s: Optional[float] = None
               ) -> Optional[PlaneRecord]:
        """Admit one request into the plane, or shed it (``None``) by
        the current policy — bounded queue, tighter while degraded,
        immediate when nothing is live."""
        if self._last_health == 0.0:
            # first contact: an unprobed fleet must not read as dead
            self.check_health(force=True)
        tenant = payload.get("tenant")
        verdict = self.admission()
        if verdict["accepting"] and tenant is not None:
            with self._lock:
                tier_shed = tenant in self.shed_tenants
            if tier_shed:
                # degradation-ladder rung 1: this tenant's tier is
                # load-shed while the supervisor buys capacity back —
                # 503 + Retry-After, reversible, interactive untouched
                verdict = {"accepting": False, "reason": "tier",
                           "retry_after_s": 2, "code": 503}
        if not verdict["accepting"]:
            self.shed_total += 1
            self.plane.note_shed()
            obs.inc("fleet_shed_total",
                    help="requests shed at fleet admission (per-reason "
                         "twins: fleet_shed_<reason>_total)")
            obs.inc(f"fleet_shed_{verdict['reason']}_total",
                    help=f"fleet admission sheds ({verdict['reason']})")
            self._tenant_note(tenant, "shed")
            # a shed request never enters the plane; the refusal always
            # counts into the aggregate stage counters, and its trace
            # events reach the stream eagerly (drills) or 1-in-N by the
            # sampling hash (a sustained-overload endpoint must not
            # write a line per shed)
            tid = reqtrace.mint_trace_id("shed")
            reqtrace.stage(tid, "shed", reason=verdict["reason"])
            reqtrace.finish(tid, outcome="shed",
                            reason=verdict["reason"])
            return None
        rec = self.plane.accept(
            payload, deadline_s if deadline_s is not None
            else self.policy.default_deadline_s)
        self._tenant_note(tenant, "accepted")
        return rec

    # -- health --------------------------------------------------------------

    def check_health(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_health \
                < self.policy.health_every_s:
            return
        self._last_health = now
        for view in list(self.views.values()):
            t0 = time.perf_counter()
            h = view.client.healthz(timeout=self.policy.health_timeout_s)
            was_live = view.live
            view.live, view.ready = h["live"], h["ready"]
            view.state = h["state"]
            view.probed_at = now
            self._note_clock_offset(view, h)
            if view.live:
                view.failover_done = False
                try:
                    s = view.client.stats(
                        timeout=self.policy.health_timeout_s)
                    view.occupancy = float(
                        s.get("kv_page_occupancy", 0.0))
                    view.slot_utilization = float(
                        s.get("slot_utilization", 0.0))
                    view.queue_depth = int(s.get("queue_depth", 0))
                    view.swaps = int(s.get("swaps",
                                           s.get("hot_swaps", 0)) or 0)
                    view.extra = {k: s.get(k) for k in (
                        "slo", "decode_steps", "gen_tokens")}
                except ReplicaError:
                    pass
            elif was_live or not view.failover_done:
                self._failover(view)
            # scrape history: RTT into a histogram, the scraped view
            # into per-replica gauges — which the router's own
            # time-series recorder snapshots every window, giving the
            # fleet a per-replica occupancy/queue-depth HISTORY (the
            # autoscaler's sensor input; obs.timeseries)
            self._record_scrape(view, time.perf_counter() - t0)
        with self._lock:
            live = sum(v.live for v in self.views.values())
            ready = sum(v.ready for v in self.views.values())
        obs.gauge_set("fleet_replicas_live", live,
                      help="replicas answering their health probe")
        obs.gauge_set("fleet_replicas_ready", ready,
                      help="replicas in the ready routing set")
        obs.gauge_set("fleet_pending_depth", self.plane.pending_depth,
                      help="plane records awaiting dispatch")
        # age, not just depth: one starved record aging toward its
        # deadline is invisible to a depth gauge — this is the
        # autoscaling supervisor's primary scale-up signal
        obs.gauge_set("fleet_queue_age_seconds",
                      round(self.plane.oldest_pending_age_s(), 6),
                      help="age of the OLDEST plane record awaiting "
                           "dispatch (0 when none pending)")

    #: replica state → the numeric code the per-replica state gauge
    #: carries (a time-series sample must be a scalar)
    STATE_CODES = {"ready": 0, "draining": 1, "staging_swap": 2,
                   "slo_breach": 3}

    def _record_scrape(self, view: ReplicaView, rtt_s: float) -> None:
        """One health-scrape's telemetry: RTT observation + the
        scraped per-replica gauges (`fleet_replica_<name>_*`)."""
        obs.observe("fleet_scrape_seconds", rtt_s,
                    help="router health-scrape round trip "
                         "(healthz + stats) per replica")
        name = "".join(c if c.isalnum() else "_"
                       for c in view.client.name)
        prefix = f"fleet_replica_{name}"
        code = (self.STATE_CODES.get(view.state, -1)
                if view.live else -1)
        obs.gauge_set(f"{prefix}_state_code", code,
                      help="scraped replica state (0 ready, 1 draining,"
                           " 2 staging_swap, 3 slo_breach, -1 dead)")
        obs.gauge_set(f"{prefix}_scrape_rtt_s", round(rtt_s, 6),
                      help="last health-scrape RTT for this replica")
        if view.live:
            obs.gauge_set(f"{prefix}_occupancy", view.occupancy,
                          help="scraped KV-page occupancy")
            obs.gauge_set(f"{prefix}_queue_depth", view.queue_depth,
                          help="scraped scheduler queue depth")

    def _note_clock_offset(self, view: ReplicaView, h: dict) -> None:
        """Keep the best (lowest-RTT) clock-offset sample the health
        probe produced and emit it into the event stream (rate-limited
        to real changes) — the per-replica alignment
        ``fleet.report.collect_streams`` shifts that replica's
        ``events.jsonl`` by when assembling the cross-process trace."""
        off, rtt = h.get("clock_offset_s"), h.get("rtt_s")
        if off is None:
            return
        rtt = float(rtt or 0.0)
        now = time.monotonic()
        # NTP-style: keep the lowest-RTT sample (a slower probe bounds
        # the offset more loosely) — offset and rtt travel as one pair.
        # A stale best sample (>60 s) is replaced regardless, so a slow
        # clock drift is still tracked.
        if view.offset_rtt is not None and rtt > view.offset_rtt \
                and now - view.offset_at < 60.0:
            return
        view.clock_offset = float(off)
        view.offset_rtt = rtt
        view.offset_at = now
        if view.offset_emitted is None \
                or abs(view.clock_offset - view.offset_emitted) > 5e-4:
            view.offset_emitted = view.clock_offset
            obs.emit_event({
                "event": "clock_offset", "ts": time.time(),
                "replica": view.client.name,
                "offset_s": round(view.clock_offset, 6),
                "rtt_s": round(rtt, 6),
            })

    def _failover(self, view: ReplicaView) -> None:
        """A replica left the live set: count the failover once and
        hedge-re-dispatch its journaled in-flight records to survivors
        (their original workers are still blocked on the corpse's
        socket — first completion wins, duplicates drop)."""
        with self._lock:
            # dispatch workers probe health concurrently with the tick
            # loop: exactly ONE of them owns this death
            if view.failover_done:
                return
            view.failover_done = True
            self.failovers_total += 1
        obs.inc("fleet_failover_total",
                help="replica deaths observed by the health monitor")
        with self._lock:
            dropped = self.affinity.forget(view.client.name)
        if dropped:
            obs.inc("fleet_affinity_forgotten_total", n=dropped,
                    help="affinity keys dropped because their replica "
                         "left the live set")
        rids = self.plane.assigned_to(view.client.name)
        print(f"[fleet] replica {view.client.name} is gone "
              f"({len(rids)} in-flight record(s) redriven)",
              file=sys.stderr, flush=True)
        for rid in rids:
            if self.plane.release(rid, redrive=True):
                self._spawn_dispatch()

    # -- dispatch ------------------------------------------------------------

    # -- elastic membership (the autoscaling supervisor's verbs) -------------

    def add_replica(self, client: ReplicaClient) -> ReplicaView:
        """Join a freshly-launched replica to the routing set (scale
        up).  The view starts unprobed; the next health tick flips it
        live/ready and it begins taking dispatches."""
        with self._lock:
            if client.name in self.views:
                raise ValueError(f"replica {client.name!r} already "
                                 f"routed")
            view = ReplicaView(client=client)
            self.views[client.name] = view
            # grow the dispatch pool ceiling with membership — the
            # executor spawns workers lazily, so raising the bound here
            # is safe (shrinking happens naturally via idle workers)
            self._pool._max_workers = max(
                self._pool._max_workers,
                self.policy.max_inflight_per_replica * len(self.views))
        obs.inc("fleet_replicas_added_total",
                help="replicas joined to the routing set (scale-up)")
        return view

    def begin_retire(self, name: str) -> bool:
        """Mark a replica as a scale-down victim: it stops receiving
        NEW dispatches immediately but keeps its in-flight work (and
        its health probes).  Reversible via :meth:`cancel_retire`."""
        with self._lock:
            view = self.views.get(name)
            if view is None:
                return False
            view.retiring = True
        return True

    def cancel_retire(self, name: str) -> bool:
        with self._lock:
            view = self.views.get(name)
            if view is None:
                return False
            view.retiring = False
        return True

    def retired_idle(self, name: str) -> bool:
        """True when a retiring replica holds no router in-flight work
        AND no plane record is assigned to it — the drain-then-remove
        gate (accepted requests are never lost to a scale-down)."""
        with self._lock:
            view = self.views.get(name)
            if view is None:
                return True
            if not view.retiring or view.inflight > 0:
                return False
        return not self.plane.assigned_to(name)

    def remove_replica(self, name: str) -> bool:
        """Drop a drained, retiring replica from the routing set.
        Refuses (returns False) while work is still assigned — callers
        must pass the :meth:`retired_idle` gate first."""
        if not self.retired_idle(name):
            return False
        with self._lock:
            view = self.views.pop(name, None)
            if view is None:
                return False
            n = self.affinity.forget(name)
        if n:
            obs.inc("fleet_affinity_forgotten_total", n=n,
                    help="affinity keys dropped because their replica "
                         "left the fleet")
        obs.inc("fleet_replicas_removed_total",
                help="replicas removed from the routing set after a "
                     "drain (scale-down)")
        return True

    def _pick(self, exclude: Optional[str] = None,
              prefer: Optional[str] = None) -> Optional[ReplicaView]:
        """Least-loaded routing over the scraped gauges: READY replicas
        first (excluding the just-failed one when another exists), by
        (router in-flight fraction + scraped occupancy + queue depth,
        with a tiny dispatched-count bias that round-robins exact
        ties); degraded-but-live replicas (slo_breach / staging_swap)
        are the fallback so a fully-degraded fleet still serves — only
        draining and dead replicas are never picked.  ``prefer`` names
        the prefix-affinity replica: taken when usable-and-ready (its
        warm prefix cache beats a small load delta), otherwise the
        least-loaded fallback — a hint, never a constraint.  The
        winner's in-flight slot is RESERVED under the lock (the caller
        must release it), so concurrent picks see each other's load."""
        with self._lock:
            cap = self.policy.max_inflight_per_replica

            def load(v: ReplicaView) -> float:
                return (v.inflight / max(1, cap) + v.occupancy
                        + v.slot_utilization + 0.25 * v.queue_depth
                        + 1e-3 * v.dispatched_total)

            def usable(v: ReplicaView, ready_only: bool) -> bool:
                if not v.live or v.state == "draining" or v.retiring:
                    return False
                if v.inflight >= cap:
                    return False
                return v.ready if ready_only else True

            if prefer is not None and prefer != exclude:
                v = self.views.get(prefer)
                if v is not None and usable(v, ready_only=True):
                    v.inflight += 1
                    v.dispatched_total += 1
                    return v

            for ready_only in (True, False):
                pool = [v for v in self.views.values()
                        if usable(v, ready_only)
                        and v.client.name != exclude]
                if not pool and exclude is not None:
                    pool = [v for v in self.views.values()
                            if usable(v, ready_only)]
                if pool:
                    view = min(pool, key=load)
                    view.inflight += 1
                    view.dispatched_total += 1
                    return view
            return None

    def pump(self) -> int:
        """Move pending plane records onto dispatch workers; returns
        how many were started.  Checkout is CAPACITY-GATED: a record
        leaves the plane only while some non-retiring live replica has
        a free in-flight slot, so saturation backs up in the plane's
        FIFO — where queue age (`oldest_pending_age_s`, the autoscale
        signal), the queue-bound backpressure and the redrive machinery
        all live — instead of hiding in the dispatch pool's internal
        queue.  Two escape valves keep pending work terminal anyway:
        an EXPIRED record is checked out regardless (its worker fails
        it loudly at the deadline), and a worker that loses the
        capacity race still waits deadline-bounded inside dispatch."""
        n = 0
        while self._spawn_dispatch():
            n += 1
        return n

    def _dispatch_capacity(self) -> bool:
        """Could the fleet absorb one more dispatch worker right now?
        Gated on OUTSTANDING WORKERS (not per-view ``inflight``, which
        a worker only bumps once it wins a ``_pick`` — gating on it
        would let one pump() drain the whole backlog into the pool
        during that window)."""
        with self._lock:
            cap = self.policy.max_inflight_per_replica
            usable = sum(1 for v in self.views.values()
                         if v.live and not v.retiring
                         and v.state != "draining")
            return self._workers_out < cap * usable

    def _spawn_dispatch(self) -> bool:
        rec = self.plane.checkout() if self._dispatch_capacity() \
            else self.plane.checkout_expired()
        if rec is None:
            return False
        with self._lock:
            self._workers_out += 1
        self.dispatched_total += 1
        obs.inc("fleet_dispatch_total",
                help="plane records handed to a dispatch worker")
        self._pool.submit(self._dispatch_entry, rec)
        return True

    def _dispatch_entry(self, rec: PlaneRecord) -> None:
        try:
            self._dispatch(rec)
        finally:
            with self._lock:
                self._workers_out -= 1

    def _dispatch(self, rec: PlaneRecord) -> None:
        deadline = Deadline.after(rec.remaining_s())
        last_failed: Optional[str] = None
        # affinity preference resolved ONCE per record (counted once,
        # however many attempts follow); a retry excludes the failed
        # replica, which _pick already ranks above the preference
        with self._lock:
            prefer = self.affinity.preferred(rec.payload)
        if prefer is not None:
            with self._lock:
                self.affinity_preferred_total += 1
            obs.inc("fleet_affinity_preferred_total",
                    help="dispatches that carried a session/prefix "
                         "affinity preference")
        hit_counted = [False]

        def attempt(timeout_s: Optional[float]):
            nonlocal last_failed
            # capacity/availability waits ride the DEADLINE, not the
            # attempt budget: attempts are for transport failures, so a
            # saturated-but-healthy fleet queues work instead of
            # burning retries into a spurious loss
            t_wait = time.perf_counter()
            swap_stall = False
            view = self._pick(exclude=last_failed, prefer=prefer)
            while view is None:
                with self._lock:
                    staging = any(v.live and v.state == "staging_swap"
                                  for v in self.views.values())
                if staging:
                    # the capacity crunch is (at least partly) a hot-
                    # swap taking replicas out of the routing set
                    swap_stall = True
                if deadline.expired:
                    raise DeadlineExceeded(
                        f"{rec.rid}: no usable replica before the "
                        f"deadline ({deadline.budget_s:.1f}s)")
                time.sleep(min(0.05, max(0.001,
                                         self.policy.health_every_s)))
                self.check_health()
                view = self._pick(exclude=last_failed, prefer=prefer)
            name = view.client.name
            if prefer is not None and name == prefer \
                    and not hit_counted[0]:
                # once per RECORD, like the preferred counter — a
                # failed-then-retried landing must not double-count
                hit_counted[0] = True
                with self._lock:
                    self.affinity_hits_total += 1
                obs.inc("fleet_affinity_hits_total",
                        help="preferred dispatches that landed on "
                             "their affinity replica")
            attempt_no = rec.attempts + 1
            wait_s = time.perf_counter() - t_wait
            # the latency cost of WAITING for a usable replica — the
            # invisible half of a retried dispatch (the retry counter
            # alone says nothing about time spent)
            obs.observe("fleet_dispatch_wait_seconds", wait_s,
                        help="per-attempt wait for a usable replica "
                             "plus retry backoff sleeps (dispatch "
                             "latency cost, not counted in transport)")
            reqtrace.stage(rec.trace_id,
                           "swap_stall" if swap_stall
                           else "dispatch_wait",
                           dur_s=wait_s, rid=rec.rid,
                           attempt=attempt_no, replica=name,
                           kind="capacity")
            self.plane.assign(rec.rid, name)
            try:
                # trace propagation: the replica parses trace_id out of
                # the wire payload and joins its serving stages onto
                # this request's waterfall (the journal keeps the
                # ORIGINAL payload — redrive/verify replay unchanged)
                payload = rec.payload
                if rec.trace_id:
                    payload = {**payload, "trace_id": rec.trace_id}
                out = view.client.generate(payload, timeout=timeout_s)
            except ReplicaError:
                last_failed = name
                # probe NOW so a death is seen (and its other records
                # hedge) before the backoff sleep finishes
                self.check_health(force=True)
                raise
            finally:
                with self._lock:
                    view.inflight -= 1  # release the _pick reservation
            return name, out

        policy = self.policy.retry_policy()

        def on_retry(attempt_no: int, exc: BaseException) -> None:
            # the backoff sleep with_retries is ABOUT to take (same
            # deterministic-jitter formula) — the other invisible
            # latency cost of a retried dispatch.  with_retries raises
            # WITHOUT sleeping when the backoff would cross the
            # deadline; don't record a phantom wait on that path.
            delay = policy.delay(attempt_no)
            if delay >= deadline.remaining():
                return
            obs.observe("fleet_dispatch_wait_seconds", delay,
                        help="per-attempt wait for a usable replica "
                             "plus retry backoff sleeps (dispatch "
                             "latency cost, not counted in transport)")
            reqtrace.stage(rec.trace_id, "dispatch_wait", dur_s=delay,
                           t_start=time.time(), rid=rec.rid,
                           attempt=attempt_no, kind="backoff",
                           error=type(exc).__name__)

        try:
            name, out = with_retries(
                attempt, policy=policy,
                deadline=deadline,
                attempt_timeout_s=self.policy.attempt_timeout_s,
                retry_on=(ReplicaError,), label="fleet_dispatch",
                on_retry=on_retry)
        except DeadlineExceeded as e:
            obs.inc("fleet_deadline_exceeded_total",
                    help="records failed by deadline expiry")
            tenant = rec.payload.get("tenant")
            if tenant:
                obs.inc(f"tenant_{tenant}_deadline_exceeded_total",
                        help="this tenant's records failed by deadline "
                             "expiry")
            self._tenant_note(tenant, "deadline_exceeded")
            self.plane.fail(rec.rid, f"deadline: {e}")
            return
        except ReplicaError as e:
            self.plane.fail(rec.rid, f"attempts exhausted: {e}")
            return
        except Exception as e:  # noqa: BLE001 - worker must not die silent
            self.plane.fail(rec.rid, f"{type(e).__name__}: {e}")
            return
        self.plane.complete(rec.rid, out.get("tokens", []), name)
        tenant = rec.payload.get("tenant")
        if tenant:
            # the replica's result carries its measured TTFT; e2e is
            # router-observed accept -> complete — together the
            # per-tenant SLO breakdown
            self._tenant_note(
                tenant, "completed", ttft_s=out.get("ttft_s"),
                e2e_s=max(0.0, time.time() - rec.accepted_epoch_s))
        # the request's keys now point at the replica whose radix cache
        # holds its prefix — the signal the NEXT request of the session
        # / shared system prompt routes on
        with self._lock:
            self.affinity.note(rec.payload, name)
            preferred = self.affinity_preferred_total
            hits = self.affinity_hits_total
            keys = len(self.affinity)
        obs.gauge_set("fleet_affinity_hit_rate",
                      round(hits / max(1, preferred), 4),
                      help="preferred dispatches landed on their "
                           "affinity replica / dispatches with a "
                           "preference (0..1)")
        obs.gauge_set("fleet_affinity_keys", keys,
                      help="session/prefix keys in the affinity "
                           "registry (LRU-bounded)")

    # -- the loop ------------------------------------------------------------

    def tick(self) -> None:
        """One router heartbeat: health (rate-limited) + dispatch."""
        self.check_health()
        self.pump()
        # the router loop is the fleet process's clock for the windowed
        # time-series (no record_step flows here)
        obs.timeseries_tick()

    def run_until_drained(self, *, poll_s: Optional[float] = None,
                          timeout_s: Optional[float] = None,
                          stop_event: Optional[threading.Event] = None,
                          on_tick=None) -> None:
        """Drive ticks until every accepted record is terminal (the
        drill loop); ``on_tick`` is the drill's chaos hook.  ``poll_s``
        defaults to the policy's ``drain_poll_s``."""
        if poll_s is None:
            poll_s = self.policy.drain_poll_s
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while True:
            self.tick()
            if on_tick is not None:
                on_tick(self)
            if self.plane.all_terminal() \
                    and self.plane.pending_depth == 0:
                return
            if stop_event is not None and stop_event.is_set():
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet router: records still pending after "
                    f"{timeout_s:.0f}s: {self.plane.counts()}")
            time.sleep(poll_s)

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=True)

    # -- fleet upgrade -------------------------------------------------------

    def rolling_swap(self, checkpoint: str, *, wait_s: float = 600.0,
                     only: Optional[List[str]] = None) -> int:
        """Staggered checkpoint hot-swap: one replica at a time, POST
        /swap then wait for its swap counter to tick (readiness passes
        through ``staging_swap`` and the router routes around it), then
        the next — the zero-downtime fleet upgrade loop.  Returns how
        many replicas swapped.  ``only`` restricts the pass to named
        replicas (the degradation ladder's pruned-checkpoint rung swaps
        just the batch tier)."""
        swapped = 0
        with self._lock:
            views = list(self.views.values())
        for view in views:
            if not view.live:
                continue
            if only is not None and view.client.name not in only:
                continue
            c = view.client
            before = int(c.stats(timeout=5.0).get("swaps", 0) or 0)
            c.swap(checkpoint)
            obs.inc("fleet_swaps_staged_total",
                    help="rolling-upgrade swap stagings issued")
            deadline = time.monotonic() + wait_s
            while time.monotonic() < deadline:
                try:
                    if int(c.stats(timeout=5.0).get("swaps", 0) or 0) \
                            > before:
                        swapped += 1
                        break
                except ReplicaError:
                    pass
                time.sleep(self.policy.swap_poll_s)
            else:
                raise TimeoutError(
                    f"rolling swap: {c.name} did not land its swap "
                    f"inside {wait_s:.0f}s")
        return swapped

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            reps = {
                name: {
                    "live": v.live, "ready": v.ready, "state": v.state,
                    "occupancy": v.occupancy,
                    "slot_utilization": v.slot_utilization,
                    "queue_depth": v.queue_depth,
                    "inflight": v.inflight,
                    "dispatched_total": v.dispatched_total,
                } for name, v in self.views.items()}
        return {
            "replicas": reps,
            "plane": self.plane.counts(),
            "degraded": self.degraded(),
            "queue_bound": self.policy.queue_bound,
            "effective_queue_bound": self.effective_queue_bound(),
            "failovers_total": self.failovers_total,
            "shed_total": self.shed_total,
            "dispatched_total": self.dispatched_total,
            "affinity": {
                "preferred": self.affinity_preferred_total,
                "hits": self.affinity_hits_total,
                "hit_rate": round(
                    self.affinity_hits_total
                    / max(1, self.affinity_preferred_total), 4),
                "keys": len(self.affinity),
            },
        }


def summary_json(router: FleetRouter) -> str:
    return json.dumps(router.snapshot())
