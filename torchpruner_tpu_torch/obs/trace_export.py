"""Perfetto / Chrome-trace export of the obs span stream — a copy of
``torchpruner_tpu/obs/trace_export.py``; the profiler merge reads the
port's ``torch.profiler`` capture windows.

Converts ``events.jsonl`` span begin/end events into the Trace Event
Format (the JSON schema both ``chrome://tracing`` and
``ui.perfetto.dev`` open natively), so a run's runtime phases can be
inspected on one timeline with the kernels of its capture windows —
the ``retrain`` / ``capture_fill`` / ``serve_prefill`` spans line up
against the device stream.

Mapping:

- ``span_begin`` → a ``"ph": "B"`` event, ``span_end`` → ``"ph": "E"``
  (duration events; nesting reconstructs the flame from B/E pairing).
- ``ts`` is microseconds.  Begin uses the event's wall-clock ``ts``;
  end uses ``begin + dur_s`` (the monotonic duration) when available,
  so NTP steps between begin and end cannot produce a negative slice.
  Timestamps are additionally clamped monotonic per track — the format
  requires it, and a torn stream must still open.
- ``pid`` is the process index (from the session's ``obs_init``
  marker), ``tid`` the OS thread id the span ran on (span events carry
  ``tid``; streams from before that field land on tid 0).
- A ``span_begin`` with no matching ``span_end`` (SIGKILL mid-phase)
  gets a synthetic ``E`` at the last seen timestamp of its track, so
  the B/E pairing always balances.
- span metadata (``target``, ``method``, …) rides in ``args``.

**Profiler merge**: when the run holds capture windows
(``obs.profile``), their op events (``utils.trace_analysis``: the
kernels, memcpys and memsets on CUDA, ``cat`` ``device_op``) are merged
onto dedicated
tracks (one tid per window, offset at :data:`PROFILE_TID_BASE` so span
tids can never collide) as complete ``X`` events.  The profiler's
internal clock is unrelated to wall time, so each window's ops are
shifted onto the window's recorded wall start — the kernel slices line
up under the runtime span that contained the window, one timeline for
"which phase" and "which op".
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

TRACE_FILENAME = "trace.json"

#: profiler-derived op tracks start here (span tids are OS thread ids,
#: which Linux caps well below this)
PROFILE_TID_BASE = 1 << 30

#: per-request waterfall tracks start here (one tid per assembled
#: request trace; below PROFILE_TID_BASE, far above OS thread ids)
REQTRACE_TID_BASE = 1 << 29

_CORE_KEYS = frozenset({
    "event", "span", "name", "parent", "depth", "ts", "dur_s", "tid",
    "compile_count", "compile_s", "trace_count",
})


def trace_events_from_spans(events: List[dict],
                            pid_override: Optional[int] = None,
                            process_label: Optional[str] = None,
                            shift_s: float = 0.0) -> List[dict]:
    """Trace Event Format list from parsed obs events (the output of
    ``utils.profiling.load_span_events``).

    Cross-process merge hooks (``fleet.report.write_fleet_trace``):
    ``pid_override``/``process_label`` place this stream on its own
    named pid row (a fleet trace holds router + N replica streams, so
    the obs_init-derived index — every replica is its own process 0 —
    cannot be the pid), and ``shift_s`` is added to every wall-clock
    timestamp (the clock-offset alignment estimated from the health
    monitor's request/response timestamps)."""
    out: List[dict] = []
    pid = 0
    host = None
    for ev in events:
        if ev.get("event") == "obs_init":
            pid = int(ev.get("process_index", 0) or 0)
            host = ev.get("pid")
            break
    if pid_override is not None:
        pid = int(pid_override)
    label = process_label or f"torchpruner process {pid}"
    out.append({
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": label + (f" (os pid {host})" if host else "")},
    })

    last_ts: Dict[int, float] = {}   # per-tid monotonic clamp (µs)
    open_spans: Dict[str, dict] = {}  # span id -> emitted B event

    def clamp(tid: int, ts_us: float) -> float:
        ts_us = max(ts_us, last_ts.get(tid, 0.0))
        last_ts[tid] = ts_us
        return ts_us

    def args_of(ev: dict) -> Dict[str, Any]:
        extra = {k: v for k, v in ev.items() if k not in _CORE_KEYS}
        for k in ("compile_count", "compile_s", "trace_count"):
            if ev.get(k):
                extra[k] = ev[k]
        extra["span"] = ev.get("span")
        return extra

    for ev in events:
        kind = ev.get("event")
        if kind not in ("span_begin", "span_end"):
            continue
        tid = int(ev.get("tid", 0) or 0)
        name = str(ev.get("name", "?"))
        sid = ev.get("span")
        if kind == "span_begin":
            b = {
                "ph": "B", "name": name, "cat": "obs",
                "pid": pid, "tid": tid,
                "ts": clamp(tid, (float(ev.get("ts", 0.0)) + shift_s)
                            * 1e6),
                "args": args_of(ev),
            }
            out.append(b)
            if sid is not None:
                open_spans[sid] = b
        else:
            b = open_spans.pop(sid, None)
            if b is None:
                continue  # end without begin (rotated-away) — skip
            dur_s = ev.get("dur_s")
            ts_us = (b["ts"] + float(dur_s) * 1e6 if dur_s is not None
                     else (float(ev.get("ts", 0.0)) + shift_s) * 1e6)
            out.append({
                "ph": "E", "name": name, "cat": "obs",
                "pid": pid, "tid": b["tid"],
                "ts": clamp(b["tid"], ts_us),
                "args": args_of(ev),
            })
    # close any span the run never closed (kill mid-phase), innermost
    # first so the B/E nesting stays balanced per track
    for sid, b in sorted(open_spans.items(), reverse=True):
        out.append({
            "ph": "E", "name": b["name"], "cat": "obs",
            "pid": pid, "tid": b["tid"],
            "ts": clamp(b["tid"], b["ts"]),
            "args": {"span": sid, "torn": True},
        })
    return out


def profile_trace_events(profile_dir: str, pid: int = 0) -> List[dict]:
    """Profiler-derived op events for the Perfetto merge: each capture
    window's filtered op events (``trace_analysis.file_op_events``) as
    complete ``X`` events on its own stable tid
    (``PROFILE_TID_BASE + window index``), time-shifted so the window's
    first op lands at the window's recorded wall start — aligning the
    profiler's internal clock with the span stream's wall clock.
    Timestamps are clamped monotonic per track (the schema contract).
    Empty (never raises) without windows."""
    from torchpruner_tpu_torch.obs.profile.capture import scan_windows
    from torchpruner_tpu_torch.utils.trace_analysis import (
        file_op_events,
        find_trace_files,
    )

    out: List[dict] = []
    try:
        windows = scan_windows(profile_dir)
    except Exception:
        return out
    for w in windows:
        try:
            files = find_trace_files(w["dir"], latest_run=True)
            ops: List[dict] = []
            for f in files:
                ops.extend(file_op_events(f))
        except Exception:
            continue
        if not ops:
            continue
        tid = PROFILE_TID_BASE + int(w.get("index", 0))
        out.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"device ops (profile window "
                             f"{int(w.get('index', 0))})"},
        })
        t0_trace = min(op["ts"] for op in ops)
        t0_wall_us = float(w.get("t_start_unix") or 0.0) * 1e6
        last = 0.0
        for op in sorted(ops, key=lambda o: o["ts"]):
            ts = t0_wall_us + (op["ts"] - t0_trace)
            ts = max(ts, last)
            last = ts
            out.append({
                "ph": "X", "name": op["name"], "cat": "device_op",
                "pid": pid, "tid": tid, "ts": ts, "dur": op["dur"],
                "args": {"window": int(w.get("index", 0))},
            })
    return out


# -- cross-process assembly (the fleet's merged trace) -----------------------
#
# A "stream" is one process's parsed event list plus its placement:
#   {"name": "replica0", "pid": 1, "events": [...], "shift_s": -0.0012}
# ``shift_s`` maps the stream's wall clock onto the reference (router)
# clock — estimated from the health monitor's request/response
# timestamps (fleet.report.collect_streams).


def merged_trace_events(streams: List[dict]) -> List[dict]:
    """Span B/E events of every stream on one timeline, each stream on
    its own pid.  B/E pairing is per-stream (span ids never cross a
    process), so duplicate span names across pids cannot mis-pair; a
    stream torn by a SIGKILL gets its open spans closed synthetically
    (the per-stream contract of :func:`trace_events_from_spans`);
    timestamps stay monotonic per (pid, tid) after the clock shift."""
    out: List[dict] = []
    for st in streams:
        out.extend(trace_events_from_spans(
            st.get("events") or [],
            pid_override=st.get("pid"),
            process_label=st.get("name"),
            shift_s=float(st.get("shift_s") or 0.0)))
    return out


def assemble_request_traces(streams: List[dict]) -> Dict[str, dict]:
    """Group ``req_stage`` / ``req_trace`` events from every stream into
    per-request traces on the reference clock::

        {trace_id: {"stages": [{"stage", "ts", "dur_s", "pid", ...}],
                    "pids": [...], "outcome": str|None,
                    "e2e_s": float|None, "ttft_s": float|None,
                    "attempts": int, "redrive": bool, "torn": bool}}

    Stages are sorted by aligned start time; a trace with stage events
    but no terminal ``req_trace`` summary from ANY process (the request
    died with its replica before redrive completed it elsewhere) is
    marked ``torn``.  When several processes report a summary, any
    ``complete`` wins the outcome and the LONGEST ``e2e_s`` is kept
    (the router's accept→complete subsumes a replica's local
    submit→done)."""
    traces: Dict[str, dict] = {}

    def entry(tid: str) -> dict:
        t = traces.get(tid)
        if t is None:
            t = traces[tid] = {
                "stages": [], "pids": set(), "outcome": None,
                "e2e_s": None, "ttft_s": None, "attempts": 0,
                "redrive": False, "torn": True,
            }
        return t

    for st in streams:
        pid = int(st.get("pid") or 0)
        shift = float(st.get("shift_s") or 0.0)
        for ev in st.get("events") or []:
            kind = ev.get("event")
            if kind == "req_stage":
                t = entry(str(ev.get("trace")))
                stage = {k: v for k, v in ev.items()
                         if k not in ("event", "trace")}
                stage["ts"] = float(ev.get("ts") or 0.0) + shift
                stage["pid"] = pid
                t["stages"].append(stage)
                t["pids"].add(pid)
                if ev.get("attempt"):
                    t["attempts"] = max(t["attempts"],
                                        int(ev["attempt"]))
                if ev.get("stage") == "redrive":
                    t["redrive"] = True
            elif kind == "req_trace":
                t = entry(str(ev.get("trace")))
                t["pids"].add(pid)
                # any process's "complete" wins the outcome; the e2e is
                # the LONGEST reported span (the router's accept ->
                # complete subsumes a replica's local submit -> done)
                if t["outcome"] is None or ev.get("outcome") == "complete":
                    t["outcome"] = ev.get("outcome")
                if ev.get("e2e_s") is not None:
                    t["e2e_s"] = max(t["e2e_s"] or 0.0,
                                     float(ev["e2e_s"]))
                if ev.get("ttft_s") is not None:
                    # earliest-finishing summary wins the TTFT: on a
                    # redrive/hedge the plane keeps the FIRST
                    # completion, so a later (abandoned) attempt's
                    # slower ttft must not overwrite the served one
                    ts = float(ev.get("ts") or 0.0) + shift
                    if t.get("_ttft_ts") is None or ts < t["_ttft_ts"]:
                        t["ttft_s"] = float(ev["ttft_s"])
                        t["_ttft_ts"] = ts
                t["torn"] = False
    for t in traces.values():
        t["stages"].sort(key=lambda s: s["ts"])
        t["pids"] = sorted(t["pids"])
        t.pop("_ttft_ts", None)
    return traces


def reqtrace_trace_events(traces: Dict[str, dict]) -> List[dict]:
    """Per-request waterfall tracks for the merged Perfetto trace: one
    tid per assembled request (``REQTRACE_TID_BASE`` + index, ordered
    by first stage time), each stage a complete ``X`` slice (instant
    stages become ``i`` markers) ON THE PID OF THE PROCESS THAT
    RECORDED IT — so one request's row visibly hops router → replica
    (→ survivor, on a redrive).  Start times are clamped monotonic per
    (pid, tid), the format contract."""
    out: List[dict] = []
    order = sorted(traces.items(),
                   key=lambda kv: (kv[1]["stages"][0]["ts"]
                                   if kv[1]["stages"] else 0.0, kv[0]))
    last_ts: Dict[tuple, float] = {}
    for i, (trace_id, t) in enumerate(order):
        tid = REQTRACE_TID_BASE + i
        for pid in t["pids"]:
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid,
                "args": {"name": f"req {trace_id}"
                                 + (" [torn]" if t.get("torn") else "")},
            })
        for s in t["stages"]:
            pid = s["pid"]
            ts_us = float(s["ts"]) * 1e6
            key = (pid, tid)
            ts_us = max(ts_us, last_ts.get(key, 0.0))
            last_ts[key] = ts_us
            dur_us = float(s.get("dur_s") or 0.0) * 1e6
            args = {k: v for k, v in s.items()
                    if k not in ("ts", "dur_s", "pid")}
            args["trace"] = trace_id
            base = {"name": str(s.get("stage", "?")), "cat": "reqtrace",
                    "pid": pid, "tid": tid, "ts": ts_us, "args": args}
            if dur_us > 0:
                out.append({**base, "ph": "X", "dur": dur_us})
            else:
                out.append({**base, "ph": "i", "s": "t"})
    return out


def write_merged_trace(streams: List[dict], out_path: str,
                       traces: Optional[Dict[str, dict]] = None) -> str:
    """ONE ``trace.json`` for a multi-process run: every stream's span
    flame on its own pid plus (when ``traces`` is given) the assembled
    per-request waterfall tracks.  Returns the written path."""
    from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

    events = merged_trace_events(streams)
    if traces is None:
        traces = assemble_request_traces(streams)
    events.extend(reqtrace_trace_events(traces))
    atomic_write_json(out_path, {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }, indent=None)
    return out_path


def write_trace(events_jsonl: str, out_path: Optional[str] = None,
                profile_dir: Optional[str] = None) -> str:
    """Convert an ``events.jsonl`` (rotation-aware, latest session only —
    ``load_span_events``'s contract) into ``trace.json`` next to it (or
    at ``out_path``), merging profiler capture windows from
    ``profile_dir`` when present.  Returns the written path."""
    from torchpruner_tpu_torch.utils.profiling import load_span_events

    events = load_span_events(events_jsonl)
    if out_path is None:
        out_path = os.path.join(os.path.dirname(events_jsonl) or ".",
                                TRACE_FILENAME)
    from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

    trace_events = trace_events_from_spans(events)
    if profile_dir and os.path.isdir(profile_dir):
        pid = 0
        for ev in events:
            if ev.get("event") == "obs_init":
                pid = int(ev.get("process_index", 0) or 0)
                break
        trace_events.extend(profile_trace_events(profile_dir, pid=pid))
    payload = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
    }
    atomic_write_json(out_path, payload, indent=None)
    return out_path
