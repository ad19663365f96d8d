"""Multi-tenant QoS primitives for the serving plane.

Counterpart of ``torchpruner_tpu/serve/qos.py``, copied without the
HTTP Retry-After hint and the telemetry counters.

A **tenant** is a traffic class sharing one engine/fleet: "interactive"
chat traffic, "batch" offline jobs, a named customer — anything whose
overload must not starve the others.  Policy is three orthogonal knobs
per tenant (:class:`TenantPolicy`):

- **priority class** — admission order at the step boundary.  Lower
  numbers admit first; an interactive head-of-queue may PREEMPT an
  active lower-priority request (scheduler.admit, and only there — the
  engine already confines every slot-table mutation to step
  boundaries, so "interactive preempts batch strictly at step
  boundaries" is structural, not a timing promise).
- **token bucket** — submission-rate throttling (:class:`TokenBucket`):
  ``rate`` requests/s sustained with ``burst`` headroom.  An empty
  bucket SHEDS at submit, so one tenant's flood never occupies queue
  slots the others need.
- **KV-page quota** — a ceiling on the tenant's simultaneous KV-cache
  pages (enforced in the allocator): an over-quota admission is shed
  instead of blocking the FIFO head,
  so a long-context tenant cannot squat the whole page budget.

Buckets use an injected monotonic clock (``now``) so refill/burst math
is unit-testable without sleeping; in production callers pass nothing
and get ``time.monotonic()``.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

#: canonical priority classes (lower admits first)
INTERACTIVE = 0
BATCH = 1

_PRIORITY_NAMES = {"interactive": INTERACTIVE, "batch": BATCH}
#: tenant names become obs scalar segments (``tenant_<name>_*``) — keep
#: them parseable
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's QoS contract.  ``rate == 0`` disables throttling;
    ``page_quota == 0`` disables the KV quota; ``priority`` defaults to
    interactive (the unthrottled default tenant behaves exactly like
    the pre-QoS scheduler)."""

    name: str
    priority: int = INTERACTIVE
    #: sustained submissions/s through the token bucket (0 = unlimited)
    rate: float = 0.0
    #: bucket capacity — how far above ``rate`` a burst may spike
    burst: float = 1.0
    #: max simultaneous KV-cache pages leased to this tenant (0 = none)
    page_quota: int = 0
    #: preemptible: an active request of this tenant may be evicted at
    #: a step boundary to admit a higher-priority head-of-queue
    preemptible: bool = False

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(
                f"tenant name {self.name!r} must match {_NAME_RE.pattern}"
                " (it becomes an obs scalar segment)")
        if self.rate < 0 or self.burst < 0:
            raise ValueError(f"rate/burst must be >= 0 for {self.name!r}")

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "TenantPolicy":
        """Parse the wire/scenario form: ``{"priority": "batch"|int,
        "rate": 5.0, "burst": 10, "page_quota": 8, "preemptible":
        true}`` — unknown keys rejected (config-typo guard, the
        ``FleetChaos.from_any`` discipline)."""
        unknown = set(d) - {"priority", "rate", "burst", "page_quota",
                            "preemptible"}
        if unknown:
            raise ValueError(f"unknown tenant policy key(s) for "
                             f"{name!r}: {sorted(unknown)}")
        prio = d.get("priority", INTERACTIVE)
        if isinstance(prio, str):
            if prio not in _PRIORITY_NAMES:
                raise ValueError(f"unknown priority class {prio!r} "
                                 f"(want {sorted(_PRIORITY_NAMES)})")
            prio = _PRIORITY_NAMES[prio]
        return cls(name=name, priority=int(prio),
                   rate=float(d.get("rate", 0.0)),
                   burst=float(d.get("burst", 1.0)),
                   page_quota=int(d.get("page_quota", 0)),
                   preemptible=bool(d.get("preemptible",
                                          int(prio) > INTERACTIVE)))


class TokenBucket:
    """Classic leaky-bucket admission meter.  ``level`` refills at
    ``rate`` tokens/s up to ``burst``; :meth:`take` spends one token or
    refuses.  Thread-safe: requests may be submitted from other threads
    while the engine loop runs."""

    def __init__(self, rate: float, burst: float = 1.0,
                 now: Optional[float] = None):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._level = self.burst
        self._t = time.monotonic() if now is None else float(now)
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        dt = max(0.0, now - self._t)
        self._t = now
        self._level = min(self.burst, self._level + dt * self.rate)

    def take(self, now: Optional[float] = None) -> bool:
        """Spend one token; ``False`` = throttled (shed)."""
        if self.rate <= 0:
            return True
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._refill_locked(now)
            if self._level >= 1.0:
                self._level -= 1.0
                return True
            return False


class QoS:
    """Per-tenant policy table + live token buckets.  ``None`` tenants
    (every pre-QoS caller) get :attr:`default` — unthrottled,
    interactive, no quota — so a scheduler with an empty table behaves
    bit-for-bit like the FIFO it replaced."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 now: Optional[float] = None):
        self.policies: Dict[str, TenantPolicy] = dict(policies or {})
        self.default = TenantPolicy(name="default")
        self._buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(p.rate, p.burst, now=now)
            for name, p in self.policies.items() if p.rate > 0}

    @classmethod
    def from_dict(cls, d: Optional[dict],
                  now: Optional[float] = None) -> "QoS":
        return cls({name: TenantPolicy.from_dict(name, cfg)
                    for name, cfg in (d or {}).items()}, now=now)

    def policy(self, tenant: Optional[str]) -> TenantPolicy:
        if tenant is None:
            return self.default
        return self.policies.get(tenant, self.default)

    def bucket(self, tenant: Optional[str]) -> Optional[TokenBucket]:
        return self._buckets.get(tenant) if tenant else None

    def admit_now(self, tenant: Optional[str],
                  now: Optional[float] = None) -> bool:
        """Token-bucket gate for one submission (True = pass)."""
        b = self.bucket(tenant)
        return True if b is None else b.take(now=now)
