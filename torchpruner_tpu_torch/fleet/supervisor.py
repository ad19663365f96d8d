"""SLO-driven autoscaling supervisor with a graceful-degradation ladder.
(A copy of ``torchpruner_tpu/fleet/supervisor.py``, imports renamed,
but for :func:`predict_replica_capacity`, which has no cost model to
ask here and returns ``None``.)

Closes the scale loop over the fleet: rolling queue-age / SLO signals
in, ledgered membership changes out.  Design contracts (each one a
robustness property the chaos drill asserts):

- **Decision BEFORE effect** — every decision is journaled to the run
  ledger (``obs.record_serve(kind="scale_decision", ...)``) with its
  triggering signals *before* any process is spawned or retired (the
  search loop's decide-then-act discipline): a crash mid-action
  leaves a ledger that explains the intent.
- **Predict before launch** — every scale-up record carries the
  per-replica capacity estimate the caller passed (``capacity``); the
  JAX package fills it from its XLA cost model, which the port does not
  have, so here it is ``None`` (:func:`predict_replica_capacity`).
- **Drain-then-remove** — scale-down marks the victim ``retiring``
  (``FleetRouter.begin_retire``: no new dispatches), waits until the
  router holds no in-flight work for it and no plane record is
  assigned to it, THEN SIGTERM-drains the process and drops the view.
  An accepted request can therefore never be lost to a scale-down.
- **Hysteresis** — scale signals must persist for ``up_ticks`` /
  ``down_ticks`` consecutive evaluations and respect a post-action
  cooldown, so a noisy p99 cannot flap the fleet (pinned by a unit
  test driving the evaluator with alternating signals).
- **Degradation ladder** — when the fleet is at ``max_replicas`` and
  still drowning, capacity is bought back in ledgered, reversible
  rungs: (1) shed the batch tier at admission
  (``router.shed_tenants``), (2) tighten admission
  (``router.force_degraded`` → the existing degraded-mode queue
  factor), (3) optionally rolling-swap replicas to a PRUNED checkpoint
  (the engine's hot-swap) — the lever only this repo has: the pruner
  manufactures the cheaper model the ladder degrades to.  Recovery
  steps back down the same rungs in reverse order.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.fleet.router import FleetRouter

#: ladder rungs in escalation order (index == severity)
RUNGS = ("none", "shed_batch", "tighten_admission", "pruned_swap")


@dataclass(frozen=True)
class ScalePolicy:
    """The supervisor's knobs.  Defaults are drill-scaled (seconds);
    production would stretch the windows, not the structure."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: scale up when the oldest pending record is older than this
    queue_age_up_s: float = 1.5
    #: eligible to scale down only when queue age is below this
    queue_age_down_s: float = 0.25
    #: ... and when at least this fraction of live replicas sit in an
    #: SLO-breach episode (either signal scales up)
    breach_frac_up: float = 0.5
    #: consecutive signalled evaluations before acting (hysteresis)
    up_ticks: int = 3
    down_ticks: int = 12
    #: post-action quiet period (also hysteresis: an action's effect
    #: needs time to show up in the signals it changes)
    cooldown_s: float = 3.0
    #: extra consecutive up-signals while already at max_replicas
    #: before climbing a degradation rung
    degrade_ticks: int = 3
    #: drain-then-remove budget; an overrunning drain is cancelled
    #: (victim returns to service) and ledgered as scale_error
    drain_timeout_s: float = 120.0
    #: tenants sheddable at rung 1 (the batch tier)
    shed_tenants: tuple = ()
    #: rung 3: pruned checkpoint to rolling-swap toward (None skips
    #: the rung), and the checkpoint to swap back on recovery
    pruned_checkpoint: Optional[str] = None
    restore_checkpoint: Optional[str] = None


@dataclass
class ScaleEvent:
    """One applied decision (the drill summary's scale log)."""

    t_s: float
    action: str
    trigger: dict
    detail: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"t_s": round(self.t_s, 3), "action": self.action,
                "trigger": self.trigger, **self.detail}


class Supervisor:
    """See module docstring.  ``launcher`` abstracts process control:

    - ``launcher.launch() -> ReplicaClient`` — spawn one replica,
      block until it listens, return its client (runs on a background
      thread; the traffic loop never stalls on a model load).
    - ``launcher.retire(name) -> None`` — SIGTERM-drain and reap the
      named replica's process (called only after the router-side drain
      gate passed).

    ``capacity`` is the capacity estimate attached to every scale-up
    record; pass :func:`predict_replica_capacity`'s result.  ``now`` injects a
    clock for the hysteresis unit tests."""

    def __init__(self, router: FleetRouter, policy: ScalePolicy, *,
                 launcher=None, capacity: Optional[dict] = None,
                 now: Optional[Callable[[], float]] = None):
        self.router = router
        self.policy = policy
        self.launcher = launcher
        self.capacity = capacity
        self._now = now or time.monotonic
        self._t0 = self._now()
        self._up = 0
        self._down = 0
        self._at_max = 0
        self._last_action_t = -1e9
        self.rung = 0
        self.events: List[ScaleEvent] = []
        self._op: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.errors: List[str] = []

    # -- signals -------------------------------------------------------------

    def signals(self) -> dict:
        """One evaluation's sensor readings (all router-side: queue
        age from the plane, breach fraction and membership from the
        health views)."""
        r = self.router
        with r._lock:
            views = list(r.views.values())
            live = [v for v in views if v.live]
            breached = [v for v in live if v.state == "slo_breach"]
            retiring = sum(1 for v in views if v.retiring)
        return {
            "queue_age_s": round(r.plane.oldest_pending_age_s(), 3),
            "pending": r.plane.pending_depth,
            "replicas": len(views),
            "live": len(live),
            "breach_frac": (len(breached) / len(live)) if live else 0.0,
            "retiring": retiring,
            "rung": RUNGS[self.rung],
        }

    # -- the decision core (pure w.r.t. the router; unit-testable) ----------

    def evaluate(self, sig: dict,
                 now: Optional[float] = None) -> Optional[str]:
        """Fold one signal sample into the hysteresis counters and
        return the action to take, if any: ``scale_up`` /
        ``scale_down`` / ``degrade`` / ``recover``.  Consecutive-tick
        counters + cooldown mean a flapping signal yields NO action —
        the no-flap property the tests pin."""
        p = self.policy
        now = self._now() if now is None else now
        up = (sig["queue_age_s"] >= p.queue_age_up_s
              or sig["breach_frac"] >= p.breach_frac_up)
        down = (sig["queue_age_s"] <= p.queue_age_down_s
                and sig["pending"] == 0 and not up)
        self._up = self._up + 1 if up else 0
        self._down = self._down + 1 if down else 0
        at_max = sig["replicas"] - sig["retiring"] >= p.max_replicas
        self._at_max = self._at_max + 1 if (up and at_max) else 0
        if now - self._last_action_t < p.cooldown_s:
            return None
        if self._up >= p.up_ticks:
            if not at_max:
                return "scale_up"
            if self._at_max >= p.degrade_ticks \
                    and self.rung < len(RUNGS) - 1:
                return "degrade"
            return None
        if self._down >= p.down_ticks:
            if self.rung > 0:
                return "recover"
            if sig["replicas"] - sig["retiring"] > p.min_replicas:
                return "scale_down"
        return None

    # -- actuation -----------------------------------------------------------

    def _ledger(self, action: str, sig: dict, **detail) -> None:
        """Journal the decision (ledger + counters) BEFORE its effect.
        Every record carries ``correlation_id`` — the incident/anomaly
        in effect when the decision was taken (or null) — so a
        postmortem links decision→signal without timestamp guessing,
        and the incident correlator ranks the decision as a suspect
        with the link already in the evidence (obs.incident)."""
        rec = {"action": action, "trigger": sig,
               "correlation_id": obs.active_incident_id(), **detail}
        obs.record_serve(kind="scale_decision", t_s=round(
            self._now() - self._t0, 3), **rec)
        obs.inc(f"scale_{action}_total",
                help=f"supervisor {action} decisions (ledgered before "
                     f"effect)")
        obs.inc("scale_decisions_total",
                help="supervisor scale/degrade decisions of any kind")
        self.events.append(ScaleEvent(
            t_s=self._now() - self._t0, action=action, trigger=sig,
            detail=detail))

    def _busy(self) -> bool:
        with self._lock:
            return self._op is not None and self._op.is_alive()

    def _start_op(self, target, name: str) -> None:
        with self._lock:
            self._op = threading.Thread(target=target, name=name,
                                        daemon=True)
            self._op.start()

    def tick(self) -> None:
        """One supervision step: read signals, maybe act.  Actions run
        on a background thread (model loads take seconds; the traffic
        loop must not stall), one at a time — which is itself a flap
        guard: no second decision while the first is still landing."""
        sig = self.signals()
        obs.gauge_set("scale_replicas", sig["replicas"],
                      help="replicas in the routing set (supervisor "
                           "view)")
        obs.gauge_set("scale_rung", self.rung,
                      help="degradation-ladder rung (0 = none)")
        if self._busy():
            return
        action = self.evaluate(sig)
        if action is None:
            return
        self._last_action_t = self._now()
        self._up = self._down = self._at_max = 0
        if action == "scale_up":
            self._scale_up(sig)
        elif action == "scale_down":
            self._scale_down(sig)
        elif action == "degrade":
            self._climb(sig)
        elif action == "recover":
            self._descend(sig)

    # each rung / scale verb: ledger first, then act

    def _scale_up(self, sig: dict) -> None:
        if self.launcher is None:
            self.errors.append("scale_up: no launcher")
            return
        self._ledger("scale_up", sig, capacity=self.capacity)

        def op():
            try:
                client = self.launcher.launch()
                self.router.add_replica(client)
                self.router.check_health(force=True)
            except Exception as e:  # noqa: BLE001 - supervisor must survive
                self.errors.append(f"scale_up: {type(e).__name__}: {e}")
                obs.inc("scale_errors_total",
                        help="supervisor actions that failed to land")
        self._start_op(op, "supervisor-scale-up")

    def _pick_victim(self) -> Optional[str]:
        """Newest non-retiring replica (LIFO: the scale-up surge
        capacity leaves first, the seed replicas keep their warm
        prefix caches)."""
        with self.router._lock:
            names = [n for n, v in self.router.views.items()
                     if not v.retiring]
        return names[-1] if len(names) > self.policy.min_replicas \
            else None

    def _scale_down(self, sig: dict) -> None:
        victim = self._pick_victim()
        if victim is None or self.launcher is None:
            return
        self._ledger("scale_down", sig, replica=victim)
        self.router.begin_retire(victim)

        def op():
            deadline = self._now() + self.policy.drain_timeout_s
            while self._now() < deadline:
                if self.router.retired_idle(victim):
                    try:
                        self.launcher.retire(victim)
                    except Exception as e:  # noqa: BLE001
                        self.errors.append(
                            f"retire {victim}: {type(e).__name__}: {e}")
                    self.router.remove_replica(victim)
                    return
                time.sleep(0.05)
            # overran the drain budget: put the victim back in service
            # (losing the scale-down beats losing a request)
            self.router.cancel_retire(victim)
            self.errors.append(f"scale_down: drain of {victim} "
                               f"overran {self.policy.drain_timeout_s}s")
            obs.inc("scale_errors_total",
                    help="supervisor actions that failed to land")
        self._start_op(op, "supervisor-scale-down")

    def _climb(self, sig: dict) -> None:
        rung = self.rung + 1
        if rung == 3 and self.policy.pruned_checkpoint is None:
            return  # optional rung not configured
        self._ledger("degrade", sig, rung=RUNGS[rung])
        self.rung = rung
        if rung == 1:
            with self.router._lock:
                self.router.shed_tenants |= set(
                    self.policy.shed_tenants)
        elif rung == 2:
            with self.router._lock:
                self.router.force_degraded = True
        elif rung == 3:
            ckpt = self.policy.pruned_checkpoint

            def op():
                try:
                    self.router.rolling_swap(ckpt)
                except Exception as e:  # noqa: BLE001
                    self.errors.append(
                        f"pruned_swap: {type(e).__name__}: {e}")
                    obs.inc("scale_errors_total",
                            help="supervisor actions that failed to "
                                 "land")
            self._start_op(op, "supervisor-pruned-swap")

    def _descend(self, sig: dict) -> None:
        rung = self.rung
        self._ledger("recover", sig, rung=RUNGS[rung])
        if rung == 1:
            with self.router._lock:
                self.router.shed_tenants -= set(
                    self.policy.shed_tenants)
        elif rung == 2:
            with self.router._lock:
                self.router.force_degraded = False
        elif rung == 3 and self.policy.restore_checkpoint:
            ckpt = self.policy.restore_checkpoint

            def op():
                try:
                    self.router.rolling_swap(ckpt)
                except Exception as e:  # noqa: BLE001
                    self.errors.append(
                        f"restore_swap: {type(e).__name__}: {e}")
            self._start_op(op, "supervisor-restore-swap")
        self.rung = rung - 1

    # -- teardown / reporting ------------------------------------------------

    def join(self, timeout_s: float = 120.0) -> None:
        """Wait for any in-flight scale operation to land."""
        with self._lock:
            op = self._op
        if op is not None:
            op.join(timeout_s)

    def summary(self) -> dict:
        return {
            "events": [e.to_json() for e in self.events],
            "scale_ups": sum(e.action == "scale_up"
                             for e in self.events),
            "scale_downs": sum(e.action == "scale_down"
                               for e in self.events),
            "degrades": sum(e.action == "degrade" for e in self.events),
            "recovers": sum(e.action == "recover" for e in self.events),
            "rung": RUNGS[self.rung],
            "errors": list(self.errors),
        }


def predict_replica_capacity(model, *, n_slots: int, max_len: int,
                             cache_dtype=None) -> Optional[dict]:
    """Capacity estimate for ONE replica at the serving geometry, taken
    before any launch and attached to every scale-up ledger record.  The
    JAX package compiles an XLA twin of the slot-decode step through its
    cost model and returns ``None`` where that model has no answer; the
    port has no such cost model (there is no XLA program to price), so
    it returns ``None`` always and the records carry that."""
    return None
