"""Fleet-wide observability: shard merging + full trace assembly.
(A copy of ``torchpruner_tpu/fleet/report.py``, imports renamed.)

Each replica is its own process with its own obs dir, so each writes a
``metrics.shard0.json`` at close (the obs plane's cross-host aggregation
path — there, process index distinguishes shards; here every replica is
a process 0 of its own little world).  The fleet's router process
re-homes those shards into ITS obs dir under distinct indices before its
own session closes, so the ordinary ``obs.aggregate`` merge produces
ONE fleet-wide ``metrics.prom`` / ``report.json``: serve histograms
bucket-merged across replicas, counters summed, gauges
max-with-min-companion — plus the router's own ``fleet_*`` counters
riding the same registry.

A ``kill -9``'d replica never reaches its session close and therefore
ships no shard; the merge reports it missing instead of failing — the
fleet report is the SURVIVORS' merged view plus the router's account of
the death (``fleet_failover_total`` / ``fleet_redrive_total``).

On top of the metric shards, this module assembles the fleet's
**distributed request traces**: every process's ``events.jsonl`` —
including the kill -9'd replica's, which flushed per line and so keeps
every stage event up to the SIGKILL — is aligned onto the router's
clock (offsets estimated from the health monitor's request/response
timestamps, emitted as ``clock_offset`` events) and merged into ONE
Perfetto ``trace.json``: the span flame of each process on its own pid
plus per-request waterfall tracks whose rows hop router → replica
(→ survivor on a redrive).  :func:`trace_summary` is the drill's
contiguity verdict (every completed request cross-process, redriven
requests showing both attempts) and :func:`slowest_exemplars` feeds
``obs report``'s exemplar waterfalls.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from torchpruner_tpu_torch.obs import trace_export
from torchpruner_tpu_torch.obs.aggregate import shard_path
from torchpruner_tpu_torch.resilience.manifest import atomic_write_json


def merge_replica_shards(fleet_obs_dir: str,
                         replica_obs_dirs: List[str]) -> Dict[str, bool]:
    """Re-home each replica's ``metrics.shard0.json`` into
    ``fleet_obs_dir`` as ``metrics.shard<i+1>.json`` (index 0 is the
    fleet session's own registry).  Returns ``{replica_dir: present}``
    — call BEFORE ``obs.shutdown()`` so the fleet session's close
    merges what landed."""
    out: Dict[str, bool] = {}
    for i, rep_dir in enumerate(replica_obs_dirs):
        src = shard_path(rep_dir, 0)
        present = os.path.exists(src)
        out[rep_dir] = present
        if not present:  # a kill -9'd replica writes no shard
            continue
        try:
            with open(src) as f:
                shard = json.load(f)
        except (OSError, json.JSONDecodeError):
            out[rep_dir] = False
            continue
        shard["process_index"] = i + 1
        atomic_write_json(shard_path(fleet_obs_dir, i + 1), shard,
                          indent=None)
    return out


def clock_offsets_of(router_events: List[dict]) -> Dict[str, float]:
    """Per-replica clock offsets (replica clock − router clock) from
    the ``clock_offset`` events the router's health monitor emitted —
    LAST wins (the monitor re-emits on real changes, so the last is the
    freshest estimate)."""
    offsets: Dict[str, float] = {}
    for ev in router_events:
        if ev.get("event") == "clock_offset" and ev.get("replica"):
            offsets[str(ev["replica"])] = float(ev.get("offset_s") or 0.0)
    return offsets


# -- distributed trace assembly ----------------------------------------------


def replica_obs_dirs_of(fleet_obs_dir: str) -> List[str]:
    """The per-replica obs dirs the fleet's router process spawned under
    its own obs dir (``replica<i>/``), in SPAWN order — numeric on the index
    suffix, so ``replica10`` sorts after ``replica9`` and the stream
    pids keep matching the re-homed metric-shard indices."""

    def index_of(d: str) -> int:
        tail = os.path.basename(os.path.normpath(d))[len("replica"):]
        try:
            return int(tail)
        except ValueError:
            return 1 << 30

    return sorted(
        (d for d in glob.glob(os.path.join(fleet_obs_dir, "replica*"))
         if os.path.isdir(d)),
        key=lambda d: (index_of(d), d))


def collect_streams(fleet_obs_dir: str,
                    replica_obs_dirs: Optional[List[str]] = None
                    ) -> List[dict]:
    """Every fleet process's parsed event stream with its trace
    placement: the router (the fleet session itself) on pid 0, each
    replica on pid i+1 (matching its re-homed metric-shard index), each
    replica's clock shifted onto the router's by the LAST offset the
    health monitor estimated for it (``clock_offset`` events in the
    router stream; 0 when none landed — e.g. a replica that died before
    its first probe answered)."""
    from torchpruner_tpu_torch.utils.profiling import load_span_events

    if replica_obs_dirs is None:
        replica_obs_dirs = replica_obs_dirs_of(fleet_obs_dir)
    router_path = os.path.join(fleet_obs_dir, "events.jsonl")
    router_events = (load_span_events(router_path)
                     if os.path.exists(router_path) else [])
    offsets = clock_offsets_of(router_events)
    streams = [{"name": "router", "pid": 0, "events": router_events,
                "shift_s": 0.0}]
    for i, rep_dir in enumerate(replica_obs_dirs):
        name = os.path.basename(os.path.normpath(rep_dir))
        path = os.path.join(rep_dir, "events.jsonl")
        events = load_span_events(path) if os.path.exists(path) else []
        streams.append({
            "name": name, "pid": i + 1, "events": events,
            # offset = replica_clock - router_clock, so subtracting it
            # maps the replica's timestamps onto the router timeline
            "shift_s": -offsets.get(name, 0.0),
        })
    return streams


def assemble_fleet_traces(fleet_obs_dir: str,
                          replica_obs_dirs: Optional[List[str]] = None
                          ) -> Dict[str, dict]:
    """Cross-process per-request traces on the router clock (see
    ``obs.trace_export.assemble_request_traces``)."""
    return trace_export.assemble_request_traces(
        collect_streams(fleet_obs_dir, replica_obs_dirs))


def trace_summary(traces: Dict[str, dict]) -> Dict[str, int]:
    """The drill's contiguity verdict over assembled traces:

    - ``assembled`` — traces with any stage/summary event;
    - ``completed`` — traces whose terminal outcome is ``complete``;
    - ``cross_process`` — completed traces whose waterfall spans BOTH a
      router pid and a replica pid and shows the replica-side serving
      stages (prefill/first_token) — the router accept → replica decode
      → completion contiguity the drill asserts for EVERY completed
      request;
    - ``redriven_cross_process`` — cross-process traces that carry a
      redrive stage or a second dispatch attempt (both attempts
      visible);
    - ``torn`` — traces with stage events but no terminal summary (a
      request that died with its replica AND never completed anywhere).
    """
    out = {"assembled": len(traces), "completed": 0, "cross_process": 0,
           "redriven_cross_process": 0, "torn": 0}
    for t in traces.values():
        names = {s.get("stage") for s in t["stages"]}
        if t.get("torn"):
            out["torn"] += 1
        if t.get("outcome") != "complete":
            continue
        out["completed"] += 1
        cross = (len(t["pids"]) >= 2 and 0 in t["pids"]
                 and ("prefill" in names or "first_token" in names))
        if cross:
            out["cross_process"] += 1
            if t.get("redrive") or t.get("attempts", 0) >= 2:
                out["redriven_cross_process"] += 1
    return out


def slowest_exemplars(traces: Dict[str, dict], k: int = 8) -> List[dict]:
    """The K slowest completed traces as compact waterfall records for
    the ledger / ``obs report`` (stage name + start offset + duration,
    ms, relative to the trace's first stage)."""
    done = [(tid, t) for tid, t in traces.items()
            if t.get("outcome") == "complete" and t["stages"]]
    done.sort(key=lambda kv: -(kv[1].get("e2e_s") or 0.0))
    out = []
    for tid, t in done[:k]:
        t0 = t["stages"][0]["ts"]
        out.append({
            "trace": tid,
            "e2e_ms": (round(1e3 * t["e2e_s"], 3)
                       if t.get("e2e_s") is not None else None),
            "ttft_ms": (round(1e3 * t["ttft_s"], 3)
                        if t.get("ttft_s") is not None else None),
            "attempts": t.get("attempts", 0),
            "redrive": bool(t.get("redrive")),
            "stages": [{
                "stage": s.get("stage"),
                "at_ms": round(1e3 * (s["ts"] - t0), 3),
                "dur_ms": round(1e3 * float(s.get("dur_s") or 0.0), 3),
                "pid": s.get("pid"),
            } for s in t["stages"]],
        })
    return out


def write_fleet_trace(fleet_obs_dir: str,
                      replica_obs_dirs: Optional[List[str]] = None,
                      out_path: Optional[str] = None) -> str:
    """The ONE merged ``trace.json``: router + replica span flames on
    distinct pids plus the per-request waterfall tracks.  Overwrites the
    fleet session's own (router-only) export — call after
    ``obs.shutdown()``.  Returns the written path."""
    streams = collect_streams(fleet_obs_dir, replica_obs_dirs)
    traces = trace_export.assemble_request_traces(streams)
    if out_path is None:
        out_path = os.path.join(fleet_obs_dir,
                                trace_export.TRACE_FILENAME)
    return trace_export.write_merged_trace(streams, out_path,
                                           traces=traces)


def merge_timeseries(fleet_obs_dir: str,
                     replica_obs_dirs: Optional[List[str]] = None
                     ) -> Dict[str, int]:
    """Merge every fleet process's windowed metric time-series
    (``metrics_ts.jsonl`` — obs.timeseries) into ONE
    ``metrics_ts_fleet.jsonl`` on the **router clock**: each window
    record is stamped with its process (``proc``/``pid``, matching the
    trace-assembly placement — router pid 0, replica<i> pid i+1) and
    its ``ts`` shifted by that replica's estimated clock offset (same
    ``clock_offset`` machinery :func:`collect_streams` uses).  Records
    are emitted in shifted-time order, so the merged stream reads as
    one fleet-wide timeline — per-replica occupancy/queue-depth history
    next to the router's own scraped gauges.

    Returns ``{"streams": ..., "windows": ...}``.  A kill -9'd replica
    contributes its readable prefix (the recorder flushes per line)."""
    from torchpruner_tpu_torch.obs.timeseries import (
        TS_FLEET_FILENAME,
        load_series,
    )
    from torchpruner_tpu_torch.utils.profiling import load_span_events

    if replica_obs_dirs is None:
        replica_obs_dirs = replica_obs_dirs_of(fleet_obs_dir)
    router_path = os.path.join(fleet_obs_dir, "events.jsonl")
    offsets = clock_offsets_of(
        load_span_events(router_path)
        if os.path.exists(router_path) else [])
    sources = [("router", 0, fleet_obs_dir, 0.0)]
    for i, rep_dir in enumerate(replica_obs_dirs):
        name = os.path.basename(os.path.normpath(rep_dir))
        # offset = replica_clock - router_clock → subtract to re-home
        sources.append((name, i + 1, rep_dir, -offsets.get(name, 0.0)))
    merged: List[dict] = []
    streams = 0
    for name, pid, run_dir, shift_s in sources:
        _, windows = load_series(run_dir)
        if not windows:
            continue
        streams += 1
        for w in windows:
            rec = dict(w)
            rec["proc"] = name
            rec["pid"] = pid
            rec["ts"] = round(float(w.get("ts") or 0.0) + shift_s, 6)
            if shift_s:
                rec["shift_s"] = round(shift_s, 6)
            merged.append(rec)
    merged.sort(key=lambda r: r["ts"])
    out_path = os.path.join(fleet_obs_dir, TS_FLEET_FILENAME)
    # a derived, regenerable artifact (not a durable log): plain
    # write-and-close, re-run to rebuild
    with open(out_path, "w") as f:
        for rec in merged:
            f.write(json.dumps(rec) + "\n")
    return {"streams": streams, "windows": len(merged)}


def assemble_fleet_incidents(fleet_obs_dir: str,
                             lookback_s: Optional[float] = None
                             ) -> Dict[str, object]:
    """Offline fleet-merged incident assembly **on the router clock**
    (the ``obs incident DIR`` reconstruction path for fleet dirs): the
    fleet ledger's burn alerts (re-homed with their original
    ``burn_ts``) plus per-process offline anomaly detection over
    ``metrics_ts_fleet.jsonl`` become triggers; suspects come from the
    fleet ledger (chaos injections, scale decisions, swaps); gauge
    deltas from the router process's windows (the scrape history —
    ``fleet_replica_*`` gauges); exemplars from the ledgered reqtrace
    record.  Same coalescing as the online correlator, so a kill -9'd
    drill reconstructs the same postmortem.  Returns
    ``{"incidents", "anomalies", "burns", "records"}``."""
    from torchpruner_tpu_torch.obs import incident
    from torchpruner_tpu_torch.obs.anomaly import detect_anomalies
    from torchpruner_tpu_torch.obs.ledger import LEDGER_FILENAME, load_ledger
    from torchpruner_tpu_torch.obs.timeseries import (
        TS_FLEET_FILENAME,
        load_series,
    )

    path = os.path.join(fleet_obs_dir, LEDGER_FILENAME)
    records = load_ledger(path) if os.path.exists(path) else []
    try:
        anomalies = detect_anomalies(fleet_obs_dir)
    except Exception:
        anomalies = []
    try:
        _, windows = load_series(
            os.path.join(fleet_obs_dir, TS_FLEET_FILENAME))
    except Exception:
        windows = []
    router_windows = [w for w in windows
                      if (w.get("proc") or "router") == "router"]
    gauge_history = [(w.get("ts") or 0.0, w["gauges"])
                     for w in router_windows if w.get("gauges")]
    exemplars = None
    for rec in reversed(records):
        if rec.get("event") == "reqtrace" and rec.get("exemplars"):
            exemplars = rec["exemplars"]
            break
    tenants: List[str] = []
    if gauge_history:
        try:
            tenants = incident.affected_tenants(gauge_history[-1][1])
        except Exception:
            tenants = []
    burns = [r for r in records
             if r.get("event") == "serve" and r.get("kind") == "slo_burn"]
    incidents = incident.correlate(
        incident.triggers_of(records, anomalies), records,
        lookback_s=lookback_s, gauge_history=gauge_history,
        exemplars=exemplars, tenants=tenants or None)
    return {"incidents": incidents, "anomalies": anomalies,
            "burns": burns, "records": records}


def replica_summary_line(log_path: str) -> Optional[dict]:
    """The last JSON line a serve front end printed (its run summary),
    scraped from the replica's captured output — best-effort."""
    try:
        with open(log_path, "rb") as f:
            lines = f.read().decode(errors="replace").splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None
