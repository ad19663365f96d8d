"""Deterministic scenario workloads: the fleet's committed traffic
library.  (A copy of ``torchpruner_tpu/fleet/workload.py``, imports
renamed: the same numpy draws, so a committed scenario gives the JAX
package's schedule and digest.)

A **scenario** is a named, committed JSON spec (``results/scenarios/``)
describing production-shaped traffic as composable pieces:

- **phases** — back-to-back time windows, each with an arrival ``rate``
  (requests/s; a ``[r0, r1]`` pair ramps linearly across the phase —
  diurnal ramps and 10× flash crowds are both just phases) and a
  ``mix`` of traffic classes.
- **classes** — request shapes: heavy-tail prompt/output length lists
  (cycled deterministically), optional session reuse (``sessions`` →
  round-robin session ids, the router's prefix-affinity signal), each
  bound to a QoS **tenant**.
- **tenants** — the ``serve.qos.TenantPolicy`` table the replicas run
  (priority class, token bucket, KV-page quota) — committed WITH the
  traffic so a scenario is one reproducible contract, not two halves.

Determinism is the point: ``build_schedule`` derives every arrival
time (non-homogeneous Poisson via thinning), class pick, prompt id and
session id from ONE ``numpy`` generator seeded by the spec, and the
spec commits a sha256 **digest** of the resulting schedule.  Replay
asserts the digest, so every serving PR is benched against bit-equal
traffic — the apples-to-apples comparator next to the reqtrace
budgets and the steady-state windows.

The **replayer** drives a :class:`~torchpruner_tpu_torch.fleet.router.
FleetRouter` open-loop (arrivals never wait for completions) with
hedged retries that HONOR Retry-After: a shed submission is re-tried
after ``max(Retry-After, deterministic backoff)`` up to a bounded
attempt count, never sooner — the well-behaved-client contract the
router's 429/503 + Retry-After admission is designed for.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.serve.qos import TenantPolicy

SCENARIO_VERSION = 1

_SPEC_KEYS = {"version", "name", "seed", "vocab", "digest", "tenants",
              "classes", "phases", "retry", "notes"}
_CLASS_KEYS = {"tenant", "prompt_lens", "max_new", "sessions",
               "temperature"}
_PHASE_KEYS = {"name", "duration_s", "rate", "mix"}
_RETRY_KEYS = {"max_attempts", "base_delay_s", "max_delay_s",
               "hedge_after_s"}


def load_scenario(path: str) -> dict:
    """Read + validate a committed scenario spec (unknown keys rejected
    — the config-typo guard every other committed config here uses)."""
    with open(path) as f:
        spec = json.load(f)
    return validate_scenario(spec)


def validate_scenario(spec: dict) -> dict:
    unknown = set(spec) - _SPEC_KEYS
    if unknown:
        raise ValueError(f"unknown scenario key(s): {sorted(unknown)}")
    if int(spec.get("version", 0)) != SCENARIO_VERSION:
        raise ValueError(f"scenario version {spec.get('version')!r} != "
                         f"{SCENARIO_VERSION}")
    for req in ("name", "seed", "vocab", "classes", "phases"):
        if req not in spec:
            raise ValueError(f"scenario missing {req!r}")
    for name, cfg in (spec.get("tenants") or {}).items():
        TenantPolicy.from_dict(name, cfg)  # raises on bad policy
    for cname, c in spec["classes"].items():
        unknown = set(c) - _CLASS_KEYS
        if unknown:
            raise ValueError(f"class {cname!r}: unknown key(s) "
                             f"{sorted(unknown)}")
        if not c.get("prompt_lens") or not c.get("max_new"):
            raise ValueError(f"class {cname!r}: prompt_lens and "
                             f"max_new must be non-empty lists")
        tenant = c.get("tenant")
        if tenant is not None and tenant not in (spec.get("tenants")
                                                 or {}):
            raise ValueError(f"class {cname!r}: unknown tenant "
                             f"{tenant!r}")
    for i, p in enumerate(spec["phases"]):
        unknown = set(p) - _PHASE_KEYS
        if unknown:
            raise ValueError(f"phase {i}: unknown key(s) "
                             f"{sorted(unknown)}")
        if float(p.get("duration_s", 0)) <= 0:
            raise ValueError(f"phase {i}: duration_s must be > 0")
        for cname in (p.get("mix") or {}):
            if cname not in spec["classes"]:
                raise ValueError(f"phase {i}: mix names unknown class "
                                 f"{cname!r}")
    unknown = set(spec.get("retry") or {}) - _RETRY_KEYS
    if unknown:
        raise ValueError(f"retry: unknown key(s) {sorted(unknown)}")
    return spec


def _phase_rates(phase: dict) -> tuple:
    r = phase["rate"]
    if isinstance(r, (list, tuple)):
        r0, r1 = float(r[0]), float(r[1])
    else:
        r0 = r1 = float(r)
    if r0 < 0 or r1 < 0 or (r0 == 0 and r1 == 0):
        raise ValueError(f"phase rate {r!r} must be positive")
    return r0, r1


@dataclass(frozen=True)
class ScheduledRequest:
    """One planned arrival: offset from scenario start + the wire
    payload (``request_from_dict`` schema, tenant included)."""

    t: float
    cls: str
    tenant: Optional[str]
    payload: dict


def build_schedule(spec: dict) -> List[ScheduledRequest]:
    """Expand a scenario into its concrete arrival schedule.  Pure
    function of the spec: one seeded generator drives phase thinning,
    class picks and prompt ids in a FIXED visitation order, so the
    same spec always yields the same schedule (the digest contract)."""
    rng = np.random.default_rng(int(spec["seed"]))
    vocab = int(spec["vocab"])
    classes = spec["classes"]
    out: List[ScheduledRequest] = []
    t_base = 0.0
    counters = {c: 0 for c in classes}  # per-class cycling index
    for phase in spec["phases"]:
        dur = float(phase["duration_s"])
        r0, r1 = _phase_rates(phase)
        mix = phase.get("mix") or {}
        names = sorted(mix)
        weights = np.asarray([float(mix[n]) for n in names], float)
        if not names or weights.sum() <= 0:
            raise ValueError(f"phase {phase.get('name')!r}: empty mix")
        weights = weights / weights.sum()
        # non-homogeneous Poisson via thinning at the phase's peak rate
        rmax = max(r0, r1)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rmax))
            if t >= dur:
                break
            rate_t = r0 + (r1 - r0) * (t / dur)
            if float(rng.uniform()) > rate_t / rmax:
                continue
            cname = names[int(rng.choice(len(names), p=weights))]
            c = classes[cname]
            i = counters[cname]
            counters[cname] = i + 1
            plen = int(c["prompt_lens"][i % len(c["prompt_lens"])])
            ids = rng.integers(0, vocab, size=plen)
            sessions = int(c.get("sessions", 0))
            payload = {
                "prompt_ids": [int(x) for x in ids],
                "max_new": int(c["max_new"][i % len(c["max_new"])]),
                "temperature": float(c.get("temperature", 0.0)),
                "seed": int(spec["seed"]) + len(out),
            }
            if c.get("tenant") is not None:
                payload["tenant"] = c["tenant"]
            if sessions:
                payload["session_id"] = f"{cname}-s{i % sessions}"
            out.append(ScheduledRequest(
                t=round(t_base + t, 9), cls=cname,
                tenant=c.get("tenant"), payload=payload))
        t_base += dur
    out.sort(key=lambda s: s.t)
    return out


def schedule_digest(schedule: List[ScheduledRequest]) -> str:
    """sha256 over the schedule's canonical JSON — arrival times,
    classes and full payloads — the replay-determinism assertion."""
    canon = [[s.t, s.cls, s.tenant,
              {k: s.payload[k] for k in sorted(s.payload)}]
             for s in schedule]
    raw = json.dumps(canon, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(raw.encode()).hexdigest()


def verify_schedule(spec: dict,
                    schedule: List[ScheduledRequest]) -> str:
    """Assert the built schedule matches the spec's committed digest
    (when present) and return the digest.  A mismatch means the
    generator or the spec changed — either way cross-PR comparisons
    just broke, loudly."""
    digest = schedule_digest(schedule)
    want = spec.get("digest")
    if want and want != digest:
        raise ValueError(
            f"scenario {spec.get('name')!r}: schedule digest {digest} "
            f"!= committed {want} (same spec + seed must replay the "
            f"same traffic)")
    return digest


@dataclass
class ReplaySummary:
    """What the replayer observed (the drill summary's workload half)."""

    scenario: str = ""
    digest: str = ""
    planned: int = 0
    submitted: int = 0
    accepted: int = 0
    shed: int = 0
    retries: int = 0
    hedges: int = 0
    abandoned: int = 0
    wall_s: float = 0.0
    by_tenant: Dict[str, int] = field(default_factory=dict)
    #: tenant ("" = untenanted) -> abandoned count; the drill verdict
    #: tolerates batch-tier abandonment (shedding that tier IS the
    #: degradation ladder working) but fails on any other tenant's
    abandoned_by_tenant: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return dict(self.__dict__)


class WorkloadReplayer:
    """Open-loop scenario replay against a fleet router.

    Arrival times come from the schedule (never from completions).  A
    shed submission retries after ``max(Retry-After, deterministic
    backoff)`` for up to ``max_attempts`` total tries, then counts as
    abandoned (``workload_abandoned_total`` — the operator's signal
    that admission control turned clients away for good).  With
    ``hedge_after_s > 0``, an accepted record still non-terminal after
    that long gets ONE duplicate submission (the plane's idempotent
    completion drops whichever result lands second).
    """

    def __init__(self, router, schedule: List[ScheduledRequest], *,
                 deadline_s: float = 60.0, max_attempts: int = 4,
                 base_delay_s: float = 0.05, max_delay_s: float = 2.0,
                 hedge_after_s: float = 0.0, seed: int = 0):
        self.router = router
        self.schedule = schedule
        self.deadline_s = float(deadline_s)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.hedge_after_s = float(hedge_after_s)
        self._rng = np.random.default_rng(seed)
        self.summary = ReplaySummary(planned=len(schedule))
        #: (due_t, tiebreak, attempt_no, ScheduledRequest) retry heap
        self._retries: List[tuple] = []
        self._tie = 0
        #: accepted records still eligible for one hedge:
        #: [(accepted_rel_t, rec, sched)]
        self._hedgeable: List[tuple] = []

    @classmethod
    def from_spec(cls, router, spec: dict, *,
                  deadline_s: float = 60.0) -> "WorkloadReplayer":
        schedule = build_schedule(spec)
        digest = verify_schedule(spec, schedule)
        r = spec.get("retry") or {}
        rep = cls(router, schedule, deadline_s=deadline_s,
                  max_attempts=int(r.get("max_attempts", 4)),
                  base_delay_s=float(r.get("base_delay_s", 0.05)),
                  max_delay_s=float(r.get("max_delay_s", 2.0)),
                  hedge_after_s=float(r.get("hedge_after_s", 0.0)),
                  seed=int(spec["seed"]) ^ 0x5EED)
        rep.summary.scenario = str(spec.get("name", ""))
        rep.summary.digest = digest
        return rep

    # -- submission ----------------------------------------------------------

    def _backoff_s(self, attempt_no: int) -> float:
        base = min(self.max_delay_s,
                   self.base_delay_s * (2 ** (attempt_no - 1)))
        return base * (0.5 + float(self._rng.uniform()))

    def _try_submit(self, sched: ScheduledRequest, attempt_no: int,
                    now: float, *, hedge: bool = False) -> None:
        self.summary.submitted += 1
        obs.inc("workload_submitted_total",
                help="scenario submissions offered to the router "
                     "(retries and hedges included)")
        rec = self.router.submit(sched.payload,
                                 deadline_s=self.deadline_s)
        if rec is not None:
            self.summary.accepted += 1
            if sched.tenant:
                self.summary.by_tenant[sched.tenant] = \
                    self.summary.by_tenant.get(sched.tenant, 0) + 1
            if self.hedge_after_s > 0 and not hedge:
                self._hedgeable.append((now, rec, sched))
            return
        self.summary.shed += 1
        obs.inc("workload_shed_total",
                help="scenario submissions the router shed (hedged "
                     "retry follows while attempts remain)")
        if hedge:
            return  # a hedge is opportunistic — never retried
        if attempt_no >= self.max_attempts:
            self.summary.abandoned += 1
            key = sched.tenant or ""
            self.summary.abandoned_by_tenant[key] = \
                self.summary.abandoned_by_tenant.get(key, 0) + 1
            obs.inc("workload_abandoned_total",
                    help="scenario requests abandoned after exhausting "
                         "their hedged-retry budget")
            return
        # honor Retry-After: never knock again sooner than the router
        # asked, plus deterministic jittered backoff
        verdict = self.router.admission()
        delay = max(float(verdict.get("retry_after_s", 0)),
                    self._backoff_s(attempt_no))
        self.summary.retries += 1
        obs.inc("workload_retries_total",
                help="hedged retries of shed submissions (delayed by "
                     "max(Retry-After, jittered backoff))")
        self._tie += 1
        heapq.heappush(self._retries,
                       (now + delay, self._tie, attempt_no + 1, sched))

    def _pump_hedges(self, now: float) -> None:
        if self.hedge_after_s <= 0 or not self._hedgeable:
            return
        keep = []
        for t_acc, rec, sched in self._hedgeable:
            if rec.terminal():
                continue
            if now - t_acc >= self.hedge_after_s:
                self.summary.hedges += 1
                obs.inc("workload_hedges_total",
                        help="duplicate submissions of slow accepted "
                             "requests (idempotent completion keeps "
                             "exactly one result)")
                self._try_submit(sched, self.max_attempts, now,
                                 hedge=True)
            else:
                keep.append((t_acc, rec, sched))
        self._hedgeable = keep

    # -- the loop ------------------------------------------------------------

    def run(self, *, timeout_s: float = 300.0,
            on_tick: Optional[Callable[[], None]] = None,
            poll_s: float = 0.01,
            drain: bool = True) -> ReplaySummary:
        """Replay the whole schedule.  ``on_tick`` runs once per loop
        (the drill wires ``router.tick`` + ``supervisor.tick`` here);
        with ``drain`` the loop also waits for every accepted record
        to reach a terminal state before returning."""
        obs.inc("workload_requests_total", n=len(self.schedule),
                help="scenario arrivals planned (the committed "
                     "schedule's size)")
        t0 = time.monotonic()
        i, n = 0, len(self.schedule)
        while True:
            now = time.monotonic() - t0
            while i < n and self.schedule[i].t <= now:
                self._try_submit(self.schedule[i], 1, now)
                i += 1
            while self._retries and self._retries[0][0] <= now:
                _, _, attempt_no, sched = heapq.heappop(self._retries)
                self._try_submit(sched, attempt_no, now)
            self._pump_hedges(now)
            if on_tick is not None:
                on_tick()
            done_feeding = i >= n and not self._retries \
                and not self._hedgeable
            if done_feeding and (not drain
                                 or (self.router.plane.all_terminal()
                                     and self.router.plane.pending_depth
                                     == 0)):
                break
            if now > timeout_s:
                break
            time.sleep(poll_s)
        self.summary.wall_s = round(time.monotonic() - t0, 3)
        return self.summary
