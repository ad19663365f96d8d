"""Changepoint detection over the windowed time-series.
(A copy of ``torchpruner_tpu/obs/anomaly.py``, imports renamed.)

The PR 17 delta windows (``obs.timeseries``) give every process a
per-interval history of its registry: counter deltas, gauge samples,
histogram bucket deltas.  This module turns that history into *openable
facts*: per-metric rolling **median/MAD z-scores** with hysteresis — K
consecutive deviant windows open an anomaly, K recovered windows close
it — so a single noisy window never pages anyone and a sustained shift
is one anomaly, not one per window.

Two entry points, same math:

- **Online**: :class:`AnomalyDetector` rides the recorder's window
  emission (``TimeseriesRecorder.on_window``).  The per-step hot path is
  untouched — detection runs only when a window is actually emitted
  (once per interval), walks the window's signals, and is bounded by
  registry size, inside the existing <10 ms tick budget.  Opened
  anomalies are ledgered (``event: "anomaly"``) and handed to the
  incident correlator (``obs.incident``) as triggers.
- **Offline**: :func:`detect_anomalies` replays ``metrics_ts.jsonl`` /
  ``metrics_ts_fleet.jsonl`` (per-process series separated before
  scoring, warmup excluded via ``split_warmup``) — the reconstruction
  path ``obs incident DIR`` uses on a kill -9'd run's artifacts.

Signals per window (:func:`window_signals`): every histogram's
per-window p99 (``<name>_p99``), and the per-second rate of counters on
the spike watchlist (``<name>_rate`` — deadline expiries, sheds, SLO
breach/burn counts: the "fleet deadline/shed spike" trigger class).
Gauges are deliberately *not* scored by default (scraped gauges are
evidence for the correlator, not alert inputs) — opt in per-run via
``TORCHPRUNER_ANOMALY_GAUGES`` (comma-separated prefixes).

Tuning knobs (all env-overridable): ``TORCHPRUNER_ANOMALY_Z`` (deviance
threshold, default 8 robust-z), ``TORCHPRUNER_ANOMALY_K`` (hysteresis,
default 3 windows), ``TORCHPRUNER_ANOMALY_MIN_HISTORY`` (windows before
a signal is scored, default 8 — the online warmup exclusion).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchpruner_tpu_torch.obs.timeseries import (
    TS_FLEET_FILENAME,
    WARMUP_FRAC,
    _quantile_from_buckets,
    load_series,
    split_warmup,
)

#: robust-z deviance threshold (MAD-scaled; 8 ≈ "way outside anything
#: the baseline produced", chosen so CPU-smoke jitter never trips it)
Z_THRESHOLD = 8.0
#: hysteresis: K consecutive deviant windows open, K recovered close
HYSTERESIS_K = 3
#: windows of history a signal needs before it is scored at all — the
#: online warmup exclusion (offline additionally drops split_warmup's
#: first quarter)
MIN_HISTORY = 8
#: rolling-baseline bound per signal
HISTORY = 64
#: recovered means back inside this fraction of the open threshold
#: (an anomaly must not flap shut on a value barely under the line)
RECOVER_FRAC = 0.5

Z_ENV = "TORCHPRUNER_ANOMALY_Z"
K_ENV = "TORCHPRUNER_ANOMALY_K"
MIN_HISTORY_ENV = "TORCHPRUNER_ANOMALY_MIN_HISTORY"
GAUGES_ENV = "TORCHPRUNER_ANOMALY_GAUGES"

#: counters whose per-window rate is a spike signal (prefix match) —
#: the "fleet deadline/shed spike" trigger class plus the serve-side
#: breach/burn counts
WATCH_COUNTER_PREFIXES = (
    "fleet_deadline_exceeded", "fleet_shed", "fleet_failover",
    "serve_slo_breach", "slo_burn_alerts",
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def window_signals(window: Dict[str, Any],
                   gauge_prefixes: Tuple[str, ...] = ()
                   ) -> Dict[str, float]:
    """Flatten one ``ts_window`` into the scalar signals the detector
    scores: histogram per-window p99s, watchlist counter rates, and
    (opt-in) gauge samples."""
    out: Dict[str, float] = {}
    dur = window.get("dur_s") or 0.0
    for name, h in (window.get("hist") or {}).items():
        if "le" not in h:
            continue
        q = _quantile_from_buckets(h["le"], h.get("c") or [], 0.99)
        if q is not None:
            out[f"{name}_p99"] = q
    if dur > 0:
        for name, v in (window.get("counters") or {}).items():
            if name.startswith(WATCH_COUNTER_PREFIXES):
                out[f"{name}_rate"] = v / dur
    if gauge_prefixes:
        for name, v in (window.get("gauges") or {}).items():
            if name.startswith(gauge_prefixes):
                out[name] = float(v)
    return out


class RollingMAD:
    """Rolling median/MAD robust z-score for one signal."""

    __slots__ = ("values", "min_history", "median", "mad")

    def __init__(self, history: int = HISTORY,
                 min_history: int = MIN_HISTORY):
        self.values: deque = deque(maxlen=history)
        self.min_history = max(2, int(min_history))
        self.median: Optional[float] = None
        self.mad: Optional[float] = None

    def push(self, v: float) -> Optional[float]:
        """Score ``v`` against the history (``None`` while warming up),
        THEN admit it — a spike must not absorb itself into its own
        baseline.  The MAD is floored at 5% of |median| so a perfectly
        flat baseline doesn't turn every epsilon into infinity."""
        z = None
        if len(self.values) >= self.min_history:
            xs = sorted(self.values)
            n = len(xs)
            m = (xs[n // 2] if n % 2
                 else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))
            devs = sorted(abs(x - m) for x in xs)
            mad = (devs[n // 2] if n % 2
                   else 0.5 * (devs[n // 2 - 1] + devs[n // 2]))
            scale = max(1.4826 * mad, 0.05 * abs(m), 1e-9)
            self.median, self.mad = m, mad
            z = (v - m) / scale
        self.values.append(float(v))
        return z


class AnomalyDetector:
    """Hysteresis changepoint detector over emitted windows (module
    docstring).  One per process, owned by ``ObsSession``; every mutable
    field is written under ``self._lock`` (``observe_window`` is called
    from the recorder's tick AND the offline replay).  ``on_open`` /
    ``on_close`` callbacks run OUTSIDE the lock."""

    def __init__(self, *, z_threshold: Optional[float] = None,
                 k: Optional[int] = None,
                 min_history: Optional[int] = None,
                 history: int = HISTORY,
                 gauge_prefixes: Optional[Tuple[str, ...]] = None,
                 proc: Optional[str] = None,
                 on_open: Optional[Callable[[dict], None]] = None,
                 on_close: Optional[Callable[[dict], None]] = None):
        if z_threshold is None:
            z_threshold = _env_float(Z_ENV, Z_THRESHOLD)
        if k is None:
            k = int(_env_float(K_ENV, HYSTERESIS_K))
        if min_history is None:
            min_history = int(_env_float(MIN_HISTORY_ENV, MIN_HISTORY))
        if gauge_prefixes is None:
            raw = os.environ.get(GAUGES_ENV, "")
            gauge_prefixes = tuple(
                p.strip() for p in raw.split(",") if p.strip())
        self.z_threshold = float(z_threshold)
        self.k = max(1, int(k))
        self.min_history = max(2, int(min_history))
        self.history = int(history)
        self.gauge_prefixes = gauge_prefixes
        self.proc = proc
        self.on_open = on_open
        self.on_close = on_close
        self._lock = threading.Lock()
        self._trackers: Dict[str, RollingMAD] = {}
        self._deviant: Dict[str, int] = {}
        self._recovered: Dict[str, int] = {}
        self._open: Dict[str, dict] = {}
        #: every anomaly ever opened (open ones mutate in place on close)
        self.anomalies: List[dict] = []
        self._seq = 0
        #: bounded (ts, gauges) history — the correlator's before/after
        #: gauge-delta evidence source (router scrape history rides the
        #: router process's windows)
        self.gauge_history: deque = deque(maxlen=256)

    # -- the per-window pass -------------------------------------------------

    def observe_window(self, window: Dict[str, Any]) -> List[dict]:
        """Score one emitted window; returns the anomalies it opened or
        closed (already applied to detector state)."""
        signals = window_signals(window, self.gauge_prefixes)
        ts = window.get("ts") or 0.0
        seq = window.get("seq")
        opened: List[dict] = []
        closed: List[dict] = []
        with self._lock:
            if window.get("gauges"):
                self.gauge_history.append((ts, dict(window["gauges"])))
            for name, v in signals.items():
                tr = self._trackers.get(name)
                if tr is None:
                    tr = self._trackers[name] = RollingMAD(
                        self.history, self.min_history)
                z = tr.push(v)
                if z is None:
                    continue
                if abs(z) >= self.z_threshold:
                    self._recovered[name] = 0
                    n = self._deviant.get(name, 0) + 1
                    self._deviant[name] = n
                    if name not in self._open and n >= self.k:
                        self._seq += 1
                        a = {
                            "event": "anomaly",
                            "anomaly_id": "anom-%s%d" % (
                                (self.proc + "-") if self.proc else "",
                                self._seq),
                            "metric": name,
                            "state": "open",
                            "opened_ts": round(ts, 6),
                            "opened_seq": seq,
                            "z": round(z, 3),
                            "value": round(v, 9),
                            "baseline_median": tr.median,
                            "baseline_mad": tr.mad,
                            "windows_deviant": n,
                        }
                        if self.proc:
                            a["proc"] = self.proc
                        self._open[name] = a
                        self.anomalies.append(a)
                        opened.append(a)
                elif abs(z) <= self.z_threshold * RECOVER_FRAC:
                    self._deviant[name] = 0
                    a = self._open.get(name)
                    if a is not None:
                        r = self._recovered.get(name, 0) + 1
                        self._recovered[name] = r
                        if r >= self.k:
                            a["state"] = "closed"
                            a["closed_ts"] = round(ts, 6)
                            a["closed_seq"] = seq
                            del self._open[name]
                            closed.append(a)
                else:
                    # the dead band between recover and open thresholds
                    # feeds neither streak — hysteresis must not flap
                    self._deviant[name] = 0
                    self._recovered[name] = 0
        for a in opened:
            if self.on_open is not None:
                try:
                    self.on_open(a)
                except Exception:
                    pass
        for a in closed:
            if self.on_close is not None:
                try:
                    self.on_close(a)
                except Exception:
                    pass
        return opened + closed

    # -- views ---------------------------------------------------------------

    def open_anomalies(self) -> List[dict]:
        with self._lock:
            return list(self._open.values())

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"opened": len(self.anomalies),
                    "open": len(self._open)}

    def gauges_between(self, t0: float, t1: float
                       ) -> List[Tuple[float, Dict[str, float]]]:
        """Gauge snapshots with ``t0 <= ts <= t1`` (correlator input)."""
        with self._lock:
            return [(ts, g) for ts, g in self.gauge_history
                    if t0 <= ts <= t1]


# -- offline -----------------------------------------------------------------


def detect_series(windows: List[Dict[str, Any]], *,
                  proc: Optional[str] = None,
                  warmup_frac: float = WARMUP_FRAC,
                  **kw) -> List[dict]:
    """Replay one process's windows through a fresh detector, warmup
    excluded the same way ``series_summary`` splits it."""
    _, steady = split_warmup(windows, warmup_frac)
    det = AnomalyDetector(proc=proc, **kw)
    for w in steady:
        det.observe_window(w)
    return det.anomalies


def detect_anomalies(run_dir: str, *, warmup_frac: float = WARMUP_FRAC,
                     **kw) -> List[dict]:
    """Offline changepoint pass over a run dir: the fleet-merged stream
    when present (``metrics_ts_fleet.jsonl``, already on the router
    clock — per-process series are separated before scoring so one
    replica's shift never pollutes another's baseline), else the
    process-local ``metrics_ts.jsonl``."""
    out: List[dict] = []
    fleet = os.path.join(run_dir, TS_FLEET_FILENAME)
    if os.path.exists(fleet):
        _, windows = load_series(fleet)
        by_proc: Dict[str, List[dict]] = {}
        for w in windows:
            by_proc.setdefault(str(w.get("proc") or "proc0"),
                               []).append(w)
        for proc in sorted(by_proc):
            out.extend(detect_series(by_proc[proc], proc=proc,
                                     warmup_frac=warmup_frac, **kw))
    else:
        _, windows = load_series(run_dir)
        out.extend(detect_series(windows, warmup_frac=warmup_frac, **kw))
    out.sort(key=lambda a: (a.get("opened_ts") or 0.0,
                            a.get("anomaly_id") or ""))
    return out
