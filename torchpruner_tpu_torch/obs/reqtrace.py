"""Fleet-wide per-request tracing: stages, exemplars, latency budget.
(A copy of ``torchpruner_tpu/obs/reqtrace.py``, imports renamed.)

The obs stack measures tail latency (``serve_ttft_seconds`` /
``serve_token_seconds`` histograms); this module explains it.  Every
accepted request carries one ``trace_id`` minted by the router at
acceptance, propagated to the serving replica inside the dispatch
payload, and every hop records **stage events** against it::

    accept → journal_flush → dispatch_wait (per attempt, incl. backoff)
           → replica_queue → admission → prefill → first_token
           → decode → complete
    (+ failover stages: redrive, swap_stall, shed)

Stages land in two places:

- **always** — per-stage aggregate histograms
  (``reqtrace_stage_<stage>_seconds``), which ride the ordinary metric
  shards, merge across replicas, and feed :func:`latency_budget` — the
  per-stage p50/p99 contributions to TTFT and E2E that reconcile
  against the measured serving histograms;
- **for exemplars only** — full-detail ``req_stage`` events in the
  session's ``events.jsonl``, later assembled into per-request
  cross-process waterfalls (``obs.trace_export`` /
  ``fleet.report.write_fleet_trace``).

Overhead is bounded by the exemplar policy: with
``sample_every > 1`` a request's stage events are BUFFERED in memory
and only flushed when the request is (a) a deterministic 1-in-N sample
(stable hash of the trace id, so every process in the fleet flushes
the SAME requests) or (b) among the slowest-K completions of its
window; everything else contributes to the aggregate histograms only.
``sample_every <= 1`` (the failover drill, short CI runs) switches to
EAGER emission — each stage event is written as it happens, so a
``kill -9``'d replica's partial trace survives on disk and the
assembled waterfall shows the dead attempt next to the redrive.

Everything degrades to (near) no-ops without an active obs session.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from torchpruner_tpu_torch import obs

#: flush full detail for 1 request in N (deterministic on the trace id;
#: <=1 = eager emission of every stage event)
DEFAULT_SAMPLE_EVERY = 16
#: per window, additionally flush the K slowest completions
DEFAULT_SLOWEST_K = 8
#: completions per slowest-K window
DEFAULT_WINDOW = 64
#: open-trace buffer cap — a leaked/never-finished trace must not grow
#: memory without bound (evictions are counted, oldest first)
MAX_OPEN_TRACES = 4096

#: env overrides (the serve/fleet CLIs also expose --trace-sample-every)
SAMPLE_EVERY_ENV = "TORCHPRUNER_REQTRACE_SAMPLE_EVERY"
SLOWEST_K_ENV = "TORCHPRUNER_REQTRACE_SLOWEST_K"
WINDOW_ENV = "TORCHPRUNER_REQTRACE_WINDOW"

#: replica-side stages whose durations sum to the measured TTFT
#: (``serve_ttft_seconds`` = arrival → first token on the replica):
#: queue wait, admit-batch bookkeeping, and the prefill program
TTFT_STAGES = ("replica_queue", "admission", "prefill")
#: stages whose durations are charged against the router-side E2E
#: (``reqtrace_e2e_seconds`` = accept → completion); the remainder is
#: reported as ``unattributed`` (transport, failed attempts on a dead
#: replica whose shard never shipped, scheduling gaps)
E2E_STAGES = ("journal_flush", "dispatch_wait", "swap_stall",
              "replica_queue", "admission", "prefill", "decode")

_ids = itertools.count()


def mint_trace_id(tag: str = "r") -> str:
    """A fleet-unique trace id: os pid + monotonic counter keeps ids
    from colliding across router restarts sharing a journal; ``tag``
    (usually the plane rid) keeps them greppable."""
    return f"tr-{tag}-{os.getpid():x}-{next(_ids):04x}"


def is_sampled(trace_id: str, sample_every: int) -> bool:
    """Deterministic 1-in-N exemplar membership — a stable hash of the
    trace id, so the router and every replica flush the SAME subset
    without coordination."""
    if sample_every <= 1:
        return True
    return zlib.crc32(trace_id.encode()) % int(sample_every) == 0


class ReqTraceRecorder:
    """Per-process stage recorder (see module docstring).  Thread-safe:
    stages arrive from the engine loop, HTTP handler threads, and the
    router's dispatch workers."""

    def __init__(self, sample_every: Optional[int] = None,
                 slowest_k: Optional[int] = None,
                 window: Optional[int] = None):
        def env_int(name, default):
            try:
                return int(os.environ.get(name, "") or default)
            except ValueError:
                return default

        self.sample_every = (env_int(SAMPLE_EVERY_ENV, DEFAULT_SAMPLE_EVERY)
                             if sample_every is None else int(sample_every))
        self.slowest_k = (env_int(SLOWEST_K_ENV, DEFAULT_SLOWEST_K)
                          if slowest_k is None else int(slowest_k))
        self.window = (env_int(WINDOW_ENV, DEFAULT_WINDOW)
                       if window is None else int(window))
        self._lock = threading.Lock()
        #: trace id -> buffered req_stage event dicts (sampled mode)
        self._open: Dict[str, List[dict]] = {}
        #: current slowest-K window: (e2e_s, trace_id, events, summary)
        self._window: List[tuple] = []
        self.evictions = 0

    @property
    def eager(self) -> bool:
        return self.sample_every <= 1

    def configure(self, *, sample_every: Optional[int] = None,
                  slowest_k: Optional[int] = None,
                  window: Optional[int] = None) -> None:
        # under the lock: recording threads consult these knobs while
        # mutating the slowest-K heap, so a reconfigure must not
        # interleave with an in-flight finish()
        with self._lock:
            if sample_every is not None:
                self.sample_every = int(sample_every)
            if slowest_k is not None:
                self.slowest_k = int(slowest_k)
            if window is not None:
                self.window = int(window)

    # -- recording -----------------------------------------------------------

    def stage(self, trace_id: Optional[str], stage: str,
              dur_s: float = 0.0, t_start: Optional[float] = None,
              **meta) -> None:
        """Record one stage against a trace.  ``dur_s`` feeds the
        always-on aggregate histogram (instant stages — dur 0 — feed a
        ``_total`` counter instead); the full event is emitted (eager)
        or buffered (sampled) for the waterfall.  No-op trace id = the
        request is untraced (single-replica serving without a fleet in
        front) — aggregates still record."""
        dur_s = float(dur_s or 0.0)
        if dur_s > 0.0:
            obs.observe(f"reqtrace_stage_{stage}_seconds", dur_s,
                        help=f"per-request {stage} stage duration "
                             "(reqtrace latency budget)")
        else:
            obs.inc(f"reqtrace_stage_{stage}_total",
                    help=f"per-request {stage} stage events (instant)")
        if not trace_id:
            return
        ev = {
            "event": "req_stage", "trace": trace_id, "stage": stage,
            "ts": (time.time() - dur_s) if t_start is None
            else float(t_start),
            "dur_s": round(dur_s, 9), "pid": os.getpid(),
            **meta,
        }
        if self.eager:
            obs.emit_event(ev)
            return
        with self._lock:
            buf = self._open.get(trace_id)
            if buf is None:
                if len(self._open) >= MAX_OPEN_TRACES:
                    self._open.pop(next(iter(self._open)))
                    self.evictions += 1
                    obs.inc("reqtrace_buffer_evictions_total",
                            help="open request traces evicted at the "
                                 "buffer cap (never finished)")
                buf = self._open[trace_id] = []
            buf.append(ev)

    def finish(self, trace_id: Optional[str], outcome: str = "complete",
               **meta) -> None:
        """Terminal transition for a trace: emits the ``req_trace``
        summary event and applies the exemplar policy to the buffered
        stage events.  ``meta`` usually carries ``e2e_s`` (router side)
        or ``ttft_s`` (replica side)."""
        obs.inc("reqtrace_requests_total",
                help="requests reaching a traced terminal state")
        if outcome != "complete":
            obs.inc(f"reqtrace_{outcome}_total",
                    help=f"traced requests ending {outcome}")
        if not trace_id:
            return
        summary = {
            "event": "req_trace", "trace": trace_id, "outcome": outcome,
            "ts": time.time(), "pid": os.getpid(), **meta,
        }
        if self.eager:
            obs.emit_event(summary)
            obs.inc("reqtrace_exemplars_total",
                    help="requests whose full stage detail was flushed "
                         "to the event stream")
            return
        with self._lock:
            buf = self._open.pop(trace_id, [])
        if is_sampled(trace_id, self.sample_every):
            self._flush_one(buf, summary, kind="sample")
            return
        rank = meta.get("e2e_s")
        if rank is None:
            rank = meta.get("ttft_s")  # slowest-K still ranks somehow
        if outcome == "complete" and rank is not None:
            with self._lock:
                self._window.append((float(rank), trace_id, buf,
                                     summary))
                full = len(self._window) >= self.window
            if full:
                self.flush_window()
            return
        # non-complete, unsampled: aggregates only
        obs.inc("reqtrace_agg_only_total",
                help="requests kept as aggregate histograms only "
                     "(not exemplars)")

    def _flush_one(self, buf: List[dict], summary: dict,
                   kind: str) -> None:
        for ev in buf:
            obs.emit_event(ev)
        obs.emit_event({**summary, "exemplar": kind})
        obs.inc("reqtrace_exemplars_total",
                help="requests whose full stage detail was flushed "
                     "to the event stream")

    def flush_window(self) -> int:
        """Close the current slowest-K window: flush the K slowest
        completions' full detail, drop the rest to aggregates-only.
        Returns how many exemplars were flushed."""
        with self._lock:
            window, self._window = self._window, []
        if not window:
            return 0
        window.sort(key=lambda t: -t[0])
        slow, rest = window[:self.slowest_k], window[self.slowest_k:]
        for e2e, _tid, buf, summary in slow:
            self._flush_one(buf, summary, kind="slow")
        if rest:
            obs.inc("reqtrace_agg_only_total", n=len(rest),
                    help="requests kept as aggregate histograms only "
                         "(not exemplars)")
        return len(slow)

    def close(self) -> None:
        """End-of-session flush: the partial window's slowest-K still
        become exemplars (a short run must not report zero)."""
        self.flush_window()
        with self._lock:
            self._open.clear()


_REC = ReqTraceRecorder()


def recorder() -> ReqTraceRecorder:
    return _REC


def configure(**kw) -> None:
    _REC.configure(**kw)


def stage(trace_id: Optional[str], name: str, dur_s: float = 0.0,
          t_start: Optional[float] = None, **meta) -> None:
    _REC.stage(trace_id, name, dur_s=dur_s, t_start=t_start, **meta)


def finish(trace_id: Optional[str], outcome: str = "complete",
           **meta) -> None:
    _REC.finish(trace_id, outcome=outcome, **meta)


def session_flush() -> None:
    """Flush pending exemplars (called by ``ObsSession.close`` before
    the event stream closes, and by drivers before trace assembly)."""
    _REC.close()


def reset(**kw) -> None:
    """Fresh recorder (tests)."""
    global _REC
    _REC = ReqTraceRecorder(**kw)


# -- the latency budget ------------------------------------------------------


def _hist_row(metrics: Dict[str, Any], stage: str) -> Optional[dict]:
    base = f"reqtrace_stage_{stage}_seconds"
    count = metrics.get(base + "_count")
    if not count:
        return None
    s = float(metrics.get(base + "_sum") or 0.0)
    row = {
        "stage": stage,
        "count": int(count),
        "sum_s": s,
        "mean_ms": 1e3 * s / count,
    }
    for q in ("p50", "p99"):
        v = metrics.get(f"{base}_{q}")
        if v is not None:
            row[f"{q}_ms"] = 1e3 * float(v)
    return row


def latency_budget(metrics: Dict[str, Any]) -> Optional[dict]:
    """Per-stage TTFT and E2E attribution from the (merged) metric
    snapshot — pure aggregate math, so it covers EVERY request, not
    just the flushed exemplars.

    - **TTFT budget**: ``replica_queue + admission + prefill`` stage
      sums against the measured ``serve_ttft_seconds`` histogram;
      ``recon_pct`` is the signed % gap between the budget sum and the
      measurement (the ≤10% reconciliation contract).
    - **E2E budget**: router + replica stage sums against the
      router-observed ``reqtrace_e2e_seconds``; the remainder
      (transport, attempts on a replica whose shard died with it) is
      the ``unattributed_pct`` row.

    ``None`` when the snapshot holds no stage histograms (an untraced
    run)."""
    ttft_rows = [r for r in (_hist_row(metrics, s) for s in TTFT_STAGES)
                 if r is not None]
    e2e_rows = [r for r in (_hist_row(metrics, s) for s in E2E_STAGES)
                if r is not None]
    if not ttft_rows and not e2e_rows:
        return None

    def block(rows, measured_sum, measured_count):
        out: Dict[str, Any] = {"stages": rows}
        budget_sum = sum(r["sum_s"] for r in rows)
        measured_mean = (measured_sum / measured_count
                         if measured_count else None)
        out["budget_mean_ms"] = (
            1e3 * budget_sum / max(r["count"] for r in rows)
            if rows else None)
        out["measured_mean_ms"] = (1e3 * measured_mean
                                   if measured_mean is not None else None)
        if measured_sum:
            for r in rows:
                r["pct"] = 100.0 * r["sum_s"] / measured_sum
            out["recon_pct"] = 100.0 * (budget_sum - measured_sum) \
                / measured_sum
        return out

    ttft = block(ttft_rows,
                 float(metrics.get("serve_ttft_seconds_sum") or 0.0),
                 int(metrics.get("serve_ttft_seconds_count") or 0))
    e2e = block(e2e_rows,
                float(metrics.get("reqtrace_e2e_seconds_sum") or 0.0),
                int(metrics.get("reqtrace_e2e_seconds_count") or 0))
    if e2e.get("recon_pct") is not None:
        # stage sums can only undershoot an E2E that includes transport:
        # report the gap as the unattributed share of the budget
        e2e["unattributed_pct"] = max(0.0, -e2e["recon_pct"])
    return {"ttft": ttft, "e2e": e2e}


def install_budget_gauges(budget: Optional[dict]) -> None:
    """Land the budget as gauges on the active session so ``obs diff``
    gates them (``ttft_stage_<stage>_pct`` / ``reqtrace_*``)."""
    if not budget:
        return
    ttft = budget.get("ttft") or {}
    for row in ttft.get("stages") or []:
        if row.get("pct") is not None:
            obs.gauge_set(f"ttft_stage_{row['stage']}_pct", row["pct"],
                          help=f"{row['stage']} share of measured TTFT "
                               "(reqtrace latency budget)")
    if ttft.get("recon_pct") is not None:
        obs.gauge_set("reqtrace_ttft_recon_pct", ttft["recon_pct"],
                      help="signed % gap between the TTFT stage-budget "
                           "sum and the measured TTFT histogram")
    e2e = budget.get("e2e") or {}
    if e2e.get("unattributed_pct") is not None:
        obs.gauge_set("reqtrace_e2e_unattributed_pct",
                      e2e["unattributed_pct"],
                      help="share of router-observed E2E not claimed by "
                           "any recorded stage")
