"""Live SLO monitoring for the serving engine — counterpart of
``torchpruner_tpu/serve/slo.py``: the same rolling windows, p99s, breach
episodes and multi-window burn rates, and the same :meth:`snapshot`,
exported as the JAX package exports them (no-ops without an obs
session):

- ``serve_ttft_p99_rolling_s`` / ``serve_token_p99_rolling_s`` gauges
  stay current on every check, so ``GET /metrics`` shows the live tail;
- a breach bumps ``serve_slo_breach_total`` (and the per-metric
  ``serve_slo_breach_<metric>_total``) and ledgers a
  ``serve``/``slo_breach`` record;
- a burn alert bumps ``slo_burn_alerts_total``, exports the
  ``slo_burn_<metric>_fast`` / ``_slow`` gauges and ledgers a
  ``serve``/``slo_burn`` record, which opens an incident
  (``obs.incident``); an episode's duration is observed into
  ``slo_burn_episode_seconds`` at re-arm.

:class:`SLOMonitor` keeps bounded rolling windows of the engine's TTFT,
per-token latency and queue-age observations and re-computes the
rolling p99s every ``check_every_steps`` step boundaries.  Breaches
count *episodes*, not checks: a sustained breach increments once on
entry and re-arms only after the metric recovers below threshold.
Timestamped observations give, per gated metric, the fraction of
observations over threshold within a FAST window (default 15 s) and a
SLOW window (default 120 s), each divided by the error budget (default
1%).  When BOTH sit at or over ``burn_threshold`` (default 10x budget) a
burn alert fires, once per episode, re-arming when the fast burn
recovers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from torchpruner_tpu_torch import obs

#: burn-rate defaults — windows sized so a CI-scale drill (tens of
#: seconds) spans both; production callers pass their own
BURN_FAST_WINDOW_S = 15.0
BURN_SLOW_WINDOW_S = 120.0
BURN_BUDGET = 0.01
BURN_THRESHOLD = 10.0


class SLOMonitor:
    """See module docstring.  Thresholds are seconds; ``None`` disables
    that metric's gate (the rolling p99 is still computed)."""

    METRICS = ("ttft", "token", "queue")

    def __init__(self, ttft_p99_s: Optional[float] = None,
                 token_p99_s: Optional[float] = None,
                 queue_p99_s: Optional[float] = None,
                 window: int = 256, check_every_steps: int = 8,
                 min_samples: int = 8,
                 burn_fast_window_s: float = BURN_FAST_WINDOW_S,
                 burn_slow_window_s: float = BURN_SLOW_WINDOW_S,
                 burn_budget: float = BURN_BUDGET,
                 burn_threshold: float = BURN_THRESHOLD):
        self.thresholds: Dict[str, Optional[float]] = {
            "ttft": ttft_p99_s, "token": token_p99_s,
            "queue": queue_p99_s}
        self.window = int(window)
        self.check_every_steps = max(1, int(check_every_steps))
        self.min_samples = max(1, int(min_samples))
        self.burn_fast_window_s = float(burn_fast_window_s)
        self.burn_slow_window_s = float(burn_slow_window_s)
        self.burn_budget = max(1e-6, float(burn_budget))
        self.burn_threshold = float(burn_threshold)
        #: observations are (wall-clock ts, seconds) pairs — the burn
        #: windows are TIME windows, not count windows, so the math
        #: stays true when traffic is bursty
        self._obs: Dict[str, deque] = {
            m: deque(maxlen=self.window) for m in self.METRICS}
        self._in_breach: Dict[str, bool] = {
            m: False for m in self.METRICS}
        self._in_burn: Dict[str, bool] = {
            m: False for m in self.METRICS}
        #: wall-clock start of the current burn episode per metric —
        #: observed into ``slo_burn_episode_seconds`` at re-arm
        self._burn_started: Dict[str, Optional[float]] = {
            m: None for m in self.METRICS}
        self._last_check_step = -1
        #: check() runs on the engine thread (maybe_check) AND may run
        #: on HTTP handler threads, while on_ttft/on_token append from
        #: the engine thread — the lock covers BOTH the episode
        #: accounting (an incident double-counted, a recovery consumed)
        #: and the deque iteration (append mid-iteration raises)
        self._lock = threading.Lock()
        self.breaches_total = 0
        self.burn_alerts_total = 0
        self.rolling: Dict[str, Optional[float]] = {
            m: None for m in self.METRICS}

    # -- engine hooks -------------------------------------------------------

    def on_ttft(self, seconds: float, ts: Optional[float] = None) -> None:
        self._observe("ttft", seconds, ts)

    def on_token(self, seconds: float, ts: Optional[float] = None) -> None:
        self._observe("token", seconds, ts)

    def on_queue(self, seconds: float, ts: Optional[float] = None) -> None:
        """Queue age at admission (scheduler hook)."""
        self._observe("queue", seconds, ts)

    def _observe(self, metric: str, seconds: float,
                 ts: Optional[float]) -> None:
        t = time.time() if ts is None else float(ts)
        with self._lock:
            self._obs[metric].append((t, float(seconds)))

    def maybe_check(self, step: int) -> None:
        """Called at engine step boundaries; cheap no-op between check
        intervals."""
        if step - self._last_check_step < self.check_every_steps:
            return
        self._last_check_step = step
        self.check(step)

    # -- the check ----------------------------------------------------------

    def check(self, step: int = 0, now: Optional[float] = None
              ) -> Dict[str, Optional[float]]:
        """Recompute rolling p99s, count breach and burn episodes
        (thread-safe).  Returns the rolling values.  ``now`` anchors
        the burn windows (defaults to wall clock; tests pass it with
        synthetic observation timestamps)."""
        with self._lock:
            return self._check_locked(step, now)

    def _check_locked(self, step: int, now: Optional[float] = None
                      ) -> Dict[str, Optional[float]]:
        if now is None:
            now = time.time()
        for metric, samples in self._obs.items():
            if not samples:
                continue
            values = np.asarray([v for _, v in samples])
            p99 = float(np.percentile(values, 99))
            self.rolling[metric] = p99
            obs.gauge_set(
                f"serve_{metric}_p99_rolling_s", p99,
                help=f"rolling p99 of serve {metric} latency over the "
                     f"last {self.window} observations")
            limit = self.thresholds.get(metric)
            if limit is None or len(samples) < self.min_samples:
                continue
            if p99 > limit and not self._in_breach[metric]:
                self._in_breach[metric] = True
                self.breaches_total += 1
                obs.inc("serve_slo_breach_total",
                        help="SLO breach episodes (rolling p99 crossed "
                             "its threshold; re-arms on recovery)")
                obs.inc(f"serve_slo_breach_{metric}_total")
                obs.record_serve(
                    kind="slo_breach", metric=metric, p99_s=p99,
                    threshold_s=limit, window=len(samples), step=step)
            elif p99 <= limit:
                self._in_breach[metric] = False
            self._burn_locked(metric, samples, limit, now, step)
        obs.gauge_set(
            "slo_burn_active", float(sum(self._in_burn.values())),
            help="gated metrics currently inside a burn episode "
                 "(0 = healthy; rides obs diff and the watch board)")
        return dict(self.rolling)

    def _burn_locked(self, metric: str, samples, limit: float,
                     now: float, step: int) -> None:
        """Multi-window burn-rate evaluation for one gated metric —
        caller holds the lock and has already verified a threshold."""
        burns: Dict[str, Optional[float]] = {}
        counts: Dict[str, int] = {}
        for which, win_s in (("fast", self.burn_fast_window_s),
                             ("slow", self.burn_slow_window_s)):
            sub = [v for ts, v in samples if ts >= now - win_s]
            counts[which] = len(sub)
            if not sub:
                burns[which] = 0.0
                continue
            bad = sum(1 for v in sub if v > limit)
            burns[which] = (bad / len(sub)) / self.burn_budget
            obs.gauge_set(
                f"slo_burn_{metric}_{which}", burns[which],
                help=f"{metric} error-budget burn rate over the "
                     f"{which} window ({win_s:.0f}s; alert at "
                     f"{self.burn_threshold:g}×)")
        firing = (counts["fast"] >= self.min_samples
                  and burns["fast"] >= self.burn_threshold
                  and burns["slow"] >= self.burn_threshold)
        if firing and not self._in_burn[metric]:
            self._in_burn[metric] = True
            self._burn_started[metric] = now
            self.burn_alerts_total += 1
            obs.inc("slo_burn_alerts_total",
                    help="multi-window burn-rate alert episodes (fast "
                         "AND slow burn over threshold; re-arms when "
                         "the fast burn recovers)")
            obs.record_serve(
                kind="slo_burn", metric=metric,
                burn_fast=round(burns["fast"], 3),
                burn_slow=round(burns["slow"], 3),
                budget=self.burn_budget,
                burn_threshold=self.burn_threshold,
                fast_window_s=self.burn_fast_window_s,
                slow_window_s=self.burn_slow_window_s,
                threshold_s=limit, step=step,
                # the trigger instant: the incident correlator anchors
                # its lookback here (obs.incident)
                burn_ts=round(now, 6))
        elif (burns["fast"] or 0.0) < self.burn_threshold:
            if self._in_burn[metric]:
                started = self._burn_started.get(metric)
                if started is not None:
                    obs.observe(
                        "slo_burn_episode_seconds",
                        max(0.0, now - started),
                        help="burn-episode duration: alert fire → fast-"
                             "window recovery (observed at re-arm)")
                self._burn_started[metric] = None
            self._in_burn[metric] = False

    def in_breach_any(self) -> bool:
        """True while ANY gated metric's rolling p99 sits over its
        threshold — the readiness-degradation signal ``/healthz``
        (and through it the fleet router) keys off."""
        with self._lock:
            return any(self._in_breach.values())

    def snapshot(self) -> Dict[str, object]:
        """The ``/stats`` block: rolling values, thresholds, breach
        count, in-breach flags (shape kept stable for clients; the
        burn fields are additive)."""
        return {
            "ttft_p99_rolling_ms": (round(self.rolling["ttft"] * 1e3, 3)
                                    if self.rolling["ttft"] is not None
                                    else None),
            "token_p99_rolling_ms": (round(self.rolling["token"] * 1e3, 3)
                                     if self.rolling["token"] is not None
                                     else None),
            "thresholds_ms": {
                k: (round(v * 1e3, 3) if v is not None else None)
                for k, v in self.thresholds.items()},
            "breaches_total": self.breaches_total,
            "in_breach": dict(self._in_breach),
            "burn_alerts_total": self.burn_alerts_total,
            "in_burn": dict(self._in_burn),
        }
