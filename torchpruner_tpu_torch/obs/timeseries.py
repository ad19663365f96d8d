"""Windowed metric time-series: the registry over *time*, on disk.
(A copy of ``torchpruner_tpu/obs/timeseries.py``, imports renamed.)

Everything in ``obs.metrics`` is cumulative — one number per run,
exported at close.  Autoscaling decisions (ROADMAP 2c), burn-rate
alerting, and warmup-vs-steady-state analysis all need the *history*:
what was the p99 in THIS 1-second window, what was the queue depth 30
seconds ago.  :class:`TimeseriesRecorder` provides it without a second
instrumentation surface: on an interval cadence it walks the existing
registry and appends one **delta snapshot** per window to
``metrics_ts.jsonl``:

- counters as per-window deltas (zero deltas omitted — idle counters
  cost nothing on disk);
- gauges as point-in-time samples;
- histograms as **bucket-count deltas** plus sum/count deltas, so a
  reader can reconstruct per-window p50/p99 with the same estimator
  the cumulative ``Histogram.quantile`` uses.  Bucket bounds (``le``)
  ship once per histogram, on first appearance.

Durability contract (the PR 16 host lint's): the stream is append-only
through ``JsonlWriter`` (open-once, flush-per-line, size-bounded
rotation to ``metrics_ts.jsonl.1`` …), so a ``kill -9`` mid-run leaves
a parseable prefix — :func:`load_series` skips a torn final line the
way ``obs.ledger.load_ledger`` does.

The hot-path cost is one clock read + compare per ``maybe_tick`` call
(the per-step hook); the actual registry walk runs once per interval
and is bounded by registry size, not step rate — the tests pin both
(<1% of a 1 Hz window per tick, like the PR 2 <100 µs/step guard).

Readers: :func:`load_series` (rotation-aware, torn-line-tolerant),
:func:`aggregate_windows` / :func:`window_quantile` (per-window or
per-segment percentiles from bucket deltas), :func:`series_summary`
(the warmup-vs-steady-state split ``obs report`` renders and bench's
serve/fleet legs report steady-state numbers from), and
:func:`format_watch` / :func:`watch` — the ``obs watch DIR`` live
terminal view.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from torchpruner_tpu_torch.obs.exporters import JsonlWriter
from torchpruner_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

TS_FILENAME = "metrics_ts.jsonl"
#: the fleet-merged stream (fleet/report.py:merge_timeseries) — every
#: process's windows on the router clock, stamped with proc/pid
TS_FLEET_FILENAME = "metrics_ts_fleet.jsonl"

#: env overrides: window cadence in seconds (0 disables the recorder)
#: and the per-file rotation cap in bytes
TS_INTERVAL_ENV = "TORCHPRUNER_TS_INTERVAL_S"
TS_ROTATE_ENV = "TORCHPRUNER_TS_ROTATE_BYTES"

#: default rotation cap: ~4 MiB/file × (1 live + 3 backups) bounds a
#: week-long 1 Hz recording to ~16 MiB per process
DEFAULT_ROTATE_BYTES = 4 * 2 ** 20

#: fraction of a run's windows treated as warmup by the summary split
#: (compile + cache-fill dominated; the steady-state segment is what
#: bench reports and regressions gate on)
WARMUP_FRAC = 0.25


class TimeseriesRecorder:
    """See module docstring.  One per process, owned by ``ObsSession``;
    every mutable field is written under ``self._lock`` (torn windows
    from concurrent tickers would corrupt the delta baselines)."""

    def __init__(self, registry: MetricsRegistry, obs_dir: str,
                 interval_s: float = 1.0,
                 rotate_bytes: int = DEFAULT_ROTATE_BYTES,
                 backups: int = 3):
        self.registry = registry
        self.path = os.path.join(obs_dir, TS_FILENAME)
        self.interval_s = max(0.05, float(interval_s))
        self._lock = threading.Lock()
        self._writer = JsonlWriter(self.path, rotate_bytes=rotate_bytes,
                                   backups=backups)
        self._seq = 0
        self._closed = False
        #: optional per-window hook (the anomaly detector's
        #: ``observe_window``) — invoked OUTSIDE the lock with the
        #: just-emitted window record, exceptions swallowed; not fired
        #: for the forced final window at close (its partial span skews
        #: rate signals)
        self.on_window = None
        self._last_window: Optional[Dict[str, Any]] = None
        #: delta baselines: counter values / histogram (counts, sum,
        #: count) as of the last emitted window
        self._prev_counters: Dict[str, float] = {}
        self._prev_hist: Dict[str, Tuple[List[int], float, int]] = {}
        self._le_emitted: set = set()
        t0 = time.time()
        self._last_ts = t0
        #: read UNLOCKED on the per-step hot path (maybe_tick); written
        #: only in __init__ and under the lock in _tick_locked
        self._next_due = t0 + self.interval_s
        self._writer({"kind": "ts_meta", "v": 1, "pid": os.getpid(),
                      "t0": round(t0, 6),
                      "interval_s": self.interval_s})

    # -- hot path ------------------------------------------------------------

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """The per-step / per-loop-iteration hook: one clock read and a
        compare when no window is due (the 99.9% case)."""
        t = time.time() if now is None else now
        if t < self._next_due:
            return False
        with self._lock:
            # re-check under the lock: two threads racing past the
            # unlocked gate must not emit two near-empty windows
            if t < self._next_due or self._closed:
                return False
            emitted = self._tick_locked(t)
        self._fire_on_window()
        return emitted

    def tick(self, now: Optional[float] = None) -> bool:
        """Force a window now (the final flush at session close)."""
        t = time.time() if now is None else now
        with self._lock:
            if self._closed:
                return False
            emitted = self._tick_locked(t)
        self._fire_on_window()
        return emitted

    def _fire_on_window(self) -> None:
        cb, rec = self.on_window, self._last_window
        if cb is None or rec is None:
            return
        try:
            cb(rec)
        except Exception:
            pass  # a broken detector must never kill the recorder

    # -- the window ----------------------------------------------------------

    def _tick_locked(self, t: float) -> bool:
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for m in self.registry:
            if isinstance(m, Counter):
                d = m.value - self._prev_counters.get(m.name, 0.0)
                if d:
                    counters[m.name] = round(d, 9)
                    self._prev_counters[m.name] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None and math.isfinite(m.value):
                    gauges[m.name] = round(m.value, 9)
            elif isinstance(m, Histogram):
                # snapshot the mutable fields once; concurrent observes
                # may tear count-vs-counts within a window, but the
                # stored baseline is exactly what was emitted, so the
                # deltas telescope back to the truth next window
                counts = list(m.counts)
                h_sum, h_count = m.sum, m.count
                pc, ps, pn = self._prev_hist.get(
                    m.name, ([0] * len(counts), 0.0, 0))
                dn = h_count - pn
                if dn <= 0:
                    continue
                entry: Dict[str, Any] = {
                    "n": dn,
                    "sum": round(h_sum - ps, 9),
                    "c": [a - b for a, b in zip(counts, pc)],
                }
                if m.name not in self._le_emitted:
                    entry["le"] = list(m.buckets)
                    self._le_emitted.add(m.name)
                hists[m.name] = entry
                self._prev_hist[m.name] = (counts, h_sum, h_count)
        self._seq += 1
        rec: Dict[str, Any] = {
            "kind": "ts_window", "seq": self._seq,
            "ts": round(t, 6),
            "dur_s": round(max(0.0, t - self._last_ts), 6),
        }
        if counters:
            rec["counters"] = counters
        if gauges:
            rec["gauges"] = gauges
        if hists:
            rec["hist"] = hists
        self._writer(rec)
        self._last_window = rec
        self._last_ts = t
        self._next_due = t + self.interval_s
        return True

    # -- teardown ------------------------------------------------------------

    @property
    def windows_total(self) -> int:
        return self._seq

    def close(self) -> None:
        """Final forced window, ``ts_*`` gauges into the registry (they
        ride the metric shard into report.json and ``obs diff``), file
        closed.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._tick_locked(time.time())
            self._closed = True
            self._writer.close()
        self.registry.gauge(
            "ts_windows_total",
            "time-series windows recorded (obs/timeseries.py)"
        ).set(float(self._seq))
        self.registry.gauge(
            "ts_interval_s", "time-series window cadence (seconds)"
        ).set(self.interval_s)


# -- readers -----------------------------------------------------------------


def series_paths(path: str) -> List[str]:
    """The rotation set oldest-first: ``path.N`` … ``path.1``, ``path``."""
    out = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        i += 1
    for j in range(i - 1, 0, -1):
        out.append(f"{path}.{j}")
    if os.path.exists(path):
        out.append(path)
    return out


def load_series(run_dir_or_path: str
                ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """``(meta, windows)`` from an obs dir (or a ``metrics_ts.jsonl``
    path directly), walking rotated files oldest-first.  A torn final
    line (kill -9 mid-write) is skipped, like ``load_ledger``; the
    bucket bounds each histogram shipped once are re-attached to every
    window's entry so consumers never chase the first occurrence."""
    path = run_dir_or_path
    if os.path.isdir(path):
        path = os.path.join(path, TS_FILENAME)
    meta: Dict[str, Any] = {}
    windows: List[Dict[str, Any]] = []
    le: Dict[str, List[float]] = {}
    for p in series_paths(path):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn write at a kill point
                    if not isinstance(rec, dict):
                        continue
                    kind = rec.get("kind")
                    if kind == "ts_meta":
                        meta = rec
                    elif kind == "ts_window":
                        for name, h in (rec.get("hist") or {}).items():
                            if "le" in h:
                                le[name] = h["le"]
                            elif name in le:
                                h["le"] = le[name]
                        windows.append(rec)
        except OSError:
            continue
    return meta, windows


def _quantile_from_buckets(bounds: List[float], counts: List[int],
                           q: float) -> Optional[float]:
    """The ``Histogram.quantile`` estimator over a window's bucket
    deltas (no min/max clamp — per-window extremes aren't recorded, so
    the lower bound of the first bucket is taken as 0)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    prev = 0.0
    for i, b in enumerate(bounds):
        c = counts[i] if i < len(counts) else 0
        if cum + c >= target:
            if c:
                return float(prev + (target - cum) / c * (b - prev))
            return float(b)
        cum += c
        prev = b
    return float(bounds[-1]) if bounds else None


def window_quantile(window: Dict[str, Any], name: str,
                    q: float) -> Optional[float]:
    """Estimated q-quantile of histogram ``name`` within one window."""
    h = (window.get("hist") or {}).get(name)
    if not h or "le" not in h:
        return None
    return _quantile_from_buckets(h["le"], h.get("c") or [], q)


def aggregate_windows(windows: List[Dict[str, Any]], name: str
                      ) -> Optional[Dict[str, Any]]:
    """Sum histogram ``name``'s bucket deltas across ``windows`` —
    ``{"le", "c", "n", "sum"}`` — so a segment (e.g. the steady-state
    half of a run) gets one percentile estimate, not a mean of
    per-window estimates."""
    bounds: Optional[List[float]] = None
    counts: Optional[List[int]] = None
    n = 0
    total = 0.0
    for w in windows:
        h = (w.get("hist") or {}).get(name)
        if not h:
            continue
        if bounds is None and "le" in h:
            bounds = h["le"]
            counts = [0] * (len(bounds) + 1)
        if counts is None:
            continue
        for i, c in enumerate(h.get("c") or []):
            if i < len(counts):
                counts[i] += c
        n += h.get("n") or 0
        total += h.get("sum") or 0.0
    if bounds is None or not n:
        return None
    return {"le": bounds, "c": counts, "n": n, "sum": total}


def segment_percentiles(windows: List[Dict[str, Any]], name: str
                        ) -> Optional[Dict[str, Optional[float]]]:
    """p50/p99/mean of histogram ``name`` over a window segment."""
    agg = aggregate_windows(windows, name)
    if agg is None:
        return None
    return {
        "p50": _quantile_from_buckets(agg["le"], agg["c"], 0.50),
        "p99": _quantile_from_buckets(agg["le"], agg["c"], 0.99),
        "mean": (agg["sum"] / agg["n"] if agg["n"] else None),
        "n": agg["n"],
    }


def split_warmup(windows: List[Dict[str, Any]],
                 warmup_frac: float = WARMUP_FRAC
                 ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """``(warmup, steady)`` — the first ``warmup_frac`` of windows
    (at least one, when there are ≥2) vs the rest."""
    if len(windows) < 2:
        return [], list(windows)
    k = max(1, int(len(windows) * warmup_frac))
    if k >= len(windows):
        k = len(windows) - 1
    return windows[:k], windows[k:]


def series_summary(windows: List[Dict[str, Any]],
                   warmup_frac: float = WARMUP_FRAC) -> Dict[str, Any]:
    """The warmup-vs-steady-state table ``obs report`` renders: per
    recorded histogram, p50/p99/mean for each segment, plus segment
    wall spans and counter rates over the steady segment."""
    warm, steady = split_warmup(windows, warmup_frac)
    names: List[str] = []
    for w in windows:
        for name in (w.get("hist") or {}):
            if name not in names:
                names.append(name)
    rows = []
    for name in names:
        rows.append({
            "name": name,
            "warmup": segment_percentiles(warm, name),
            "steady": segment_percentiles(steady, name),
        })

    def span(ws):
        return round(sum(w.get("dur_s") or 0.0 for w in ws), 3)

    rates: Dict[str, float] = {}
    steady_span = span(steady)
    if steady_span > 0:
        totals: Dict[str, float] = {}
        for w in steady:
            for k, v in (w.get("counters") or {}).items():
                totals[k] = totals.get(k, 0.0) + v
        rates = {k: round(v / steady_span, 6) for k, v in totals.items()}
    return {
        "windows": len(windows),
        "warmup_windows": len(warm),
        "steady_windows": len(steady),
        "warmup_span_s": span(warm),
        "steady_span_s": span(steady),
        "hist": rows,
        "steady_rates_per_s": rates,
    }


def steady_state_percentiles(run_dir: str, name: str,
                             min_windows: int = 3
                             ) -> Optional[Dict[str, Optional[float]]]:
    """Steady-state-segment p50/p99/mean of one histogram, straight
    from a run dir — what bench's serve/fleet legs report instead of
    whole-run means.  ``None`` when the run recorded too few windows
    for the split to mean anything (bench then falls back)."""
    _, windows = load_series(run_dir)
    if len(windows) < min_windows:
        return None
    _, steady = split_warmup(windows)
    return segment_percentiles(steady, name)


# -- obs watch ---------------------------------------------------------------


def format_watch(run_dir: str, tail: int = 1) -> str:
    """One refresh of the live view: the newest window's gauge board,
    counter rates, and per-window histogram percentiles."""
    try:
        meta, windows = load_series(run_dir)
    except Exception:
        windows = []
        meta = {}
    if not windows:
        return (f"obs watch — {run_dir}\n"
                f"(no {TS_FILENAME} windows yet)")
    w = windows[-1]
    age = time.time() - (w.get("ts") or 0.0)
    dur = w.get("dur_s") or 0.0
    lines = [
        f"obs watch — {run_dir}",
        f"window #{w.get('seq')}  age {age:.1f}s  span {dur:.2f}s"
        f"  ({len(windows)} windows, pid {meta.get('pid', '?')})",
        "",
    ]
    hists = w.get("hist") or {}
    if hists:
        lines.append(f"{'histogram':<32}{'n':>8}{'p50 ms':>12}"
                     f"{'p99 ms':>12}{'mean ms':>12}")
        for name in sorted(hists):
            h = hists[name]
            p50 = window_quantile(w, name, 0.50)
            p99 = window_quantile(w, name, 0.99)
            mean = (h["sum"] / h["n"]) if h.get("n") else None

            def ms(v):
                return f"{1e3 * v:.3f}" if v is not None else "-"

            lines.append(f"{name:<32}{h.get('n', 0):>8}"
                         f"{ms(p50):>12}{ms(p99):>12}{ms(mean):>12}")
        lines.append("")
    counters = w.get("counters") or {}
    if counters and dur > 0:
        lines.append(f"{'counter':<44}{'Δ':>10}{'rate/s':>12}")
        for name in sorted(counters):
            lines.append(f"{name:<44}{counters[name]:>10.6g}"
                         f"{counters[name] / dur:>12.2f}")
        lines.append("")
    gauges = w.get("gauges") or {}
    if gauges:
        lines.append(f"{'gauge':<44}{'value':>22}")
        for name in sorted(gauges):
            lines.append(f"{name:<44}{gauges[name]:>22.6g}")
    alert_lines = _watch_alerts(run_dir)
    if alert_lines:
        lines.append("")
        lines.extend(alert_lines)
    return "\n".join(lines)


def _watch_alerts(run_dir: str, tail: int = 6) -> List[str]:
    """The live incidents/alerts pane: the ledger tail's anomaly /
    incident / burn-alert records (the ledger flushes per line, so the
    pane is current to the last event even mid-run)."""
    if not os.path.isdir(run_dir):
        return []
    from torchpruner_tpu_torch.obs.ledger import LEDGER_FILENAME, load_ledger

    try:
        led = load_ledger(os.path.join(run_dir, LEDGER_FILENAME))
    except Exception:
        return []
    alerts = [r for r in led
              if r.get("event") in ("anomaly", "incident")
              or (r.get("event") == "serve"
                  and r.get("kind") == "slo_burn")]
    if not alerts:
        return []
    lines = [f"incidents / alerts ({len(alerts)} total, last {tail})"]
    for r in alerts[-tail:]:
        ev = r.get("event")
        if ev == "incident":
            top = r.get("top_suspect") or {}
            lines.append(
                f"  INCIDENT {r.get('incident_id')} ({r.get('kind')})"
                f"  top suspect: {top.get('class', '?')}"
                f" on {top.get('replica') or 'fleet'}"
                f" score {top.get('score', 0.0):.3f}")
        elif ev == "anomaly":
            z = r.get("z")
            lines.append(
                f"  ANOMALY  {r.get('anomaly_id')} {r.get('state')}"
                f"  {r.get('metric')}"
                + (f" z={z:.1f}" if isinstance(z, (int, float)) else ""))
        else:
            lines.append(
                f"  BURN     {r.get('replica') or ''}:{r.get('metric')}"
                f"  fast {r.get('burn_fast')}x"
                f" slow {r.get('burn_slow')}x")
    return lines


def watch(run_dir: str, interval_s: float = 2.0,
          once: bool = False, out=None) -> int:
    """The ``obs watch DIR`` loop: redraw every ``interval_s`` until
    interrupted.  ``once`` renders a single frame (CI smoke)."""
    import sys

    out = out or sys.stdout
    try:
        while True:
            frame = format_watch(run_dir)
            if not once:
                out.write("\x1b[2J\x1b[H")  # clear + home
            out.write(frame + "\n")
            out.flush()
            if once:
                return 0
            time.sleep(max(0.2, interval_s))
    except KeyboardInterrupt:
        return 0
