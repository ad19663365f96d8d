"""Automated root-cause correlation: triggers → ranked incidents.
(A copy of ``torchpruner_tpu/obs/incident.py``, imports renamed.)

The telemetry plane measures everything (windowed time-series, burn-rate
alerts, request traces, a ledger of every consequential action) but the
join — "the SLO burned at t; what *changed*?" — was a human's job.  This
module automates it.  On any trigger:

- a **burn alert** from ``serve/slo.py`` (routed through the
  ``obs.record_serve`` hook, so serve AND fleet frontends get it for
  free whenever ``--obs-dir`` is set),
- an **anomaly open** from ``obs.anomaly`` (which also covers the
  fleet deadline/shed **counter spikes** — those are watchlist rate
  signals),

the correlator assembles an ``incident`` ledger record: the triggering
window span, every candidate-cause ledger event inside a ±lookback
horizon (swap, scale decision, rung climb, preemption, chaos injection,
checkpoint restore), per-replica gauge deltas from the router scrape
history (the ``fleet_replica_*`` gauges riding the router's windows),
the slowest-K reqtrace exemplars, and the affected tenants.  Each
candidate is **ranked** by a deterministic score::

    score = temporal_proximity × event_class_prior × replica_match

so the top suspect is an auditable claim — the three factors are in the
record, reproducible from the same artifacts.  Triggers landing within
the lookback of an existing incident are ABSORBED into it (one fault,
one incident — not one per symptom).

Offline, :func:`assemble_run_incidents` rebuilds the same incidents
from a run dir's artifacts alone (ledger + time-series + reqtrace
record) — the ``python -m torchpruner_tpu_torch obs incident DIR`` path,
which works on a kill -9'd run because every input flushes per line.
Fleet dirs (``metrics_ts_fleet.jsonl`` present) route through
``fleet.report.assemble_fleet_incidents`` so the assembly happens on
the router clock.

Tuning: ``TORCHPRUNER_INCIDENT_LOOKBACK_S`` (default 120 s — matched to
the slow burn window, so a fault old enough to still be burning the
slow budget is still in the horizon).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: ± candidate horizon around a trigger; also the absorb window.
#: Matches serve/slo.py's SLOW_WINDOW_S: a cause old enough to have
#: aged out of the slow burn window has aged out of suspicion too.
LOOKBACK_S = 120.0
LOOKBACK_ENV = "TORCHPRUNER_INCIDENT_LOOKBACK_S"

#: ledger kinds that OPEN incidents when they ride obs.record_serve
TRIGGER_KINDS = ("slo_burn",)

#: event-class priors: how plausible a cause this class of event is,
#: before looking at timing or placement.  A planted fault (chaos) is
#: the strongest claim; a burn alert is usually the symptom, not the
#: cause, so it ranks last.
EVENT_PRIORS = {
    "chaos_injection": 1.0,
    "hot_swap": 0.9,
    "scale_decision": 0.8,
    "preemption": 0.7,
    "restore": 0.65,
    "checkpoint_restore": 0.65,
    "anomaly": 0.5,
    "slo_breach": 0.35,
    "slo_burn": 0.3,
}
DEFAULT_PRIOR = 0.4

#: ledger records that are never causes (summaries / render payloads /
#: training-loop records)
_EXCLUDE_EVENTS = frozenset((
    "incident", "reqtrace", "round", "epoch", "sweep", "score",
    "prune", "trial", "frontier", "plan", "clock_offset",
))
_EXCLUDE_KINDS = frozenset(("fleet_drill", "scenario_drill", "summary"))

#: suspect-detail fields worth carrying into the evidence line
_EVIDENCE_FIELDS = ("action", "rung", "metric", "checkpoint",
                    "slow_steps_ms", "slow_replica_ms", "chaos",
                    "at_dispatch", "burn_fast", "burn_slow", "reason",
                    "correlation_id", "step")


def default_lookback_s() -> float:
    try:
        return float(os.environ.get(LOOKBACK_ENV, "") or LOOKBACK_S)
    except ValueError:
        return LOOKBACK_S


def classify(rec: Dict[str, Any]) -> str:
    """Event class of a ledger record for the prior table."""
    if rec.get("event") == "serve":
        return str(rec.get("kind") or "serve")
    return str(rec.get("event") or "unknown")


def replica_of(rec: Dict[str, Any]) -> Optional[str]:
    for key in ("replica", "name", "proc"):
        v = rec.get(key)
        if isinstance(v, str) and v:
            return v
    return None


def replica_hint(metric: str) -> Optional[str]:
    """``fleet_replica_<name>_<gauge>`` → ``<name>`` (the router's
    sanitized per-replica gauge naming) — lets an anomaly on a scraped
    gauge carry a replica for the match factor."""
    prefix = "fleet_replica_"
    if not metric.startswith(prefix):
        return None
    tail = metric[len(prefix):]
    for suffix in ("_state_code", "_scrape_rtt_s", "_occupancy",
                   "_queue_depth"):
        if tail.endswith(suffix):
            return tail[:-len(suffix)] or None
    return None


def score_candidate(rec: Dict[str, Any], trigger_ts: float,
                    trigger_replica: Optional[str],
                    lookback_s: float) -> Optional[Tuple[float, dict]]:
    """``None`` outside the horizon, else ``(score, factors)`` — the
    factors ride the suspect record so the rank is auditable."""
    ts = rec.get("ts")
    if ts is None:
        return None
    dt = float(ts) - trigger_ts
    if abs(dt) > lookback_s:
        return None
    proximity = max(0.05, 1.0 - abs(dt) / lookback_s)
    prior = EVENT_PRIORS.get(classify(rec), DEFAULT_PRIOR)
    rep = replica_of(rec)
    if trigger_replica and rep:
        match = 1.0 if rep == trigger_replica else 0.25
    else:
        match = 0.5
    score = proximity * prior * match
    return round(score, 6), {"proximity": round(proximity, 4),
                             "prior": prior, "replica_match": match,
                             "dt_s": round(dt, 3)}


def _evidence_line(rec: Dict[str, Any], cls: str, dt: float) -> str:
    rep = replica_of(rec) or "fleet"
    bits = []
    for f in _EVIDENCE_FIELDS:
        v = rec.get(f)
        if v is not None and not isinstance(v, (dict, list)):
            s = str(v)
            bits.append(f"{f}={s[:48]}")
    detail = (": " + ", ".join(bits)) if bits else ""
    return f"{cls} on {rep} at {dt:+.1f}s{detail}"


def _is_trigger_echo(rec: Dict[str, Any], trigger: Dict[str, Any]) -> bool:
    """The trigger's own ledger record (and its fleet re-record) must
    not rank as its own cause."""
    if classify(rec) != trigger.get("kind"):
        return False
    if trigger.get("replica") and replica_of(rec) \
            and replica_of(rec) != trigger["replica"]:
        return False
    ts, tts = rec.get("ts"), trigger.get("ts")
    # re-records are stamped later (drill epilogue); match on the
    # carried-over original timestamp too
    for cand in (ts, rec.get("burn_ts")):
        if cand is not None and tts is not None \
                and abs(float(cand) - float(tts)) <= 2.0:
            return True
    return classify(rec) == "slo_burn" and trigger.get("kind") == "slo_burn"


def rank_suspects(records: List[dict], trigger: Dict[str, Any],
                  lookback_s: float, cap: int = 12) -> List[dict]:
    """Every candidate-cause ledger event in the horizon, scored and
    ranked — deterministic (ties broken by time then class)."""
    trigger_ts = float(trigger.get("ts") or 0.0)
    trigger_replica = trigger.get("replica")
    out: List[dict] = []
    for rec in records:
        if rec.get("event") in _EXCLUDE_EVENTS \
                or rec.get("kind") in _EXCLUDE_KINDS:
            continue
        if _is_trigger_echo(rec, trigger):
            continue
        scored = score_candidate(rec, trigger_ts, trigger_replica,
                                 lookback_s)
        if scored is None:
            continue
        score, factors = scored
        cls = classify(rec)
        out.append({
            "score": score,
            "class": cls,
            "replica": replica_of(rec),
            "ts": round(float(rec["ts"]), 6),
            "factors": factors,
            "evidence": _evidence_line(rec, cls, factors["dt_s"]),
        })
    out.sort(key=lambda s: (-s["score"], s["ts"], s["class"]))
    for i, s in enumerate(out[:cap]):
        s["rank"] = i + 1
    return out[:cap]


def gauge_deltas(history: List[Tuple[float, Dict[str, float]]],
                 trigger_ts: float, lookback_s: float,
                 prefixes: Tuple[str, ...] = ("fleet_replica_",),
                 cap: int = 16) -> Dict[str, dict]:
    """Per-replica gauge deltas from the scrape history: median of each
    ``fleet_replica_*`` gauge before vs after the trigger, largest
    relative movers first."""
    before: Dict[str, List[float]] = {}
    after: Dict[str, List[float]] = {}
    for ts, gauges in history:
        if not (trigger_ts - lookback_s <= ts <= trigger_ts + lookback_s):
            continue
        dst = before if ts < trigger_ts else after
        for name, v in gauges.items():
            if name.startswith(prefixes):
                dst.setdefault(name, []).append(float(v))

    def med(xs: List[float]) -> float:
        xs = sorted(xs)
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1]
                                               + xs[n // 2])

    out: Dict[str, dict] = {}
    for name in before:
        if name not in after:
            continue
        b, a = med(before[name]), med(after[name])
        delta = a - b
        if abs(delta) <= max(1e-9, 0.02 * abs(b)):
            continue
        out[name] = {"before": round(b, 6), "after": round(a, 6),
                     "delta": round(delta, 6)}
    ranked = sorted(out.items(),
                    key=lambda kv: -abs(kv[1]["delta"])
                    / max(1e-9, abs(kv[1]["before"])))
    return dict(ranked[:cap])


def affected_tenants(metrics: Dict[str, Any]) -> List[str]:
    """Tenants with sheds / deadline expiries / preemptions in the
    per-tenant breakdown gauges (``tenant_<name>_<field>``)."""
    from torchpruner_tpu_torch.obs.report import _tenant_table

    out = []
    for name, row in _tenant_table(metrics):
        if (row.get("shed_fleet") or row.get("shed_total")
                or row.get("deadline_exceeded_fleet")
                or row.get("preempted_total")):
            out.append(name)
    return out


def assemble_incident(trigger: Dict[str, Any], records: List[dict], *,
                      incident_id: str,
                      lookback_s: Optional[float] = None,
                      gauge_history: Optional[List[Tuple[float, dict]]]
                      = None,
                      exemplars: Optional[List[dict]] = None,
                      tenants: Optional[List[str]] = None,
                      anomalies: Optional[List[str]] = None
                      ) -> Dict[str, Any]:
    """One trigger + the run's evidence → one incident record (the
    ledger schema ``obs incident`` / ``obs report`` render)."""
    if lookback_s is None:
        lookback_s = default_lookback_s()
    ts = float(trigger.get("ts") or 0.0)
    suspects = rank_suspects(records, trigger, lookback_s)
    inc: Dict[str, Any] = {
        "event": "incident",
        "incident_id": incident_id,
        "ts": round(ts, 6),
        "kind": trigger.get("kind"),
        "trigger": {k: v for k, v in trigger.items()
                    if not isinstance(v, (dict, list))},
        "span": {"t0": round(ts - lookback_s, 6),
                 "t1": round(ts + lookback_s, 6)},
        "lookback_s": lookback_s,
        "suspects": suspects,
        "triggers_absorbed": 0,
    }
    if suspects:
        top = suspects[0]
        inc["top_suspect"] = {"class": top["class"],
                              "replica": top["replica"],
                              "score": top["score"]}
    if gauge_history:
        deltas = gauge_deltas(gauge_history, ts, lookback_s)
        if deltas:
            inc["gauge_deltas"] = deltas
    if exemplars:
        inc["exemplars"] = exemplars[:4]
    if tenants:
        inc["tenants"] = tenants
    if anomalies:
        inc["anomalies"] = anomalies
    return inc


class IncidentCorrelator:
    """The online half: owned by ``ObsSession``, fed by the
    ``record_serve`` hook (burn alerts) and the anomaly detector's
    ``on_open``.  All mutable state under ``self._lock``; evidence
    reads (ledger records, detector history, registry snapshot) happen
    outside it."""

    def __init__(self, *, ledger=None, registry=None, detector=None,
                 lookback_s: Optional[float] = None,
                 proc: Optional[str] = None):
        self.ledger = ledger
        self.registry = registry
        self.detector = detector
        self.lookback_s = (default_lookback_s() if lookback_s is None
                           else float(lookback_s))
        self.proc = proc
        self._lock = threading.Lock()
        self.incidents: List[dict] = []
        self._seq = 0

    def trigger(self, *, kind: str, ts: Optional[float] = None,
                metric: Optional[str] = None,
                replica: Optional[str] = None,
                anomaly_id: Optional[str] = None,
                **detail) -> Optional[dict]:
        """Open (or absorb into) an incident.  Returns the new incident
        record, or ``None`` when the trigger was absorbed."""
        ts = float(ts) if ts is not None else time.time()
        with self._lock:
            last = self.incidents[-1] if self.incidents else None
            if last is not None \
                    and abs(ts - last["ts"]) <= self.lookback_s:
                last["triggers_absorbed"] += 1
                if anomaly_id:
                    last.setdefault("anomalies", [])
                    if anomaly_id not in last["anomalies"]:
                        last["anomalies"].append(anomaly_id)
                return None
            self._seq += 1
            iid = "inc-%s%d" % ((self.proc + "-") if self.proc else "",
                                self._seq)
        trig = {"kind": kind, "ts": ts, "metric": metric,
                "replica": replica,
                **{k: v for k, v in detail.items()
                   if not isinstance(v, (dict, list))}}
        if replica is None and metric:
            trig["replica"] = replica_hint(metric)
        records = []
        if self.ledger is not None:
            try:
                records = list(self.ledger.records())
            except Exception:
                records = []
        gauge_history = None
        anomalies = None
        if self.detector is not None:
            gauge_history = self.detector.gauges_between(
                ts - self.lookback_s, ts + self.lookback_s)
            anomalies = [a["anomaly_id"] for a in self.detector.anomalies
                         if abs((a.get("opened_ts") or 0.0) - ts)
                         <= self.lookback_s]
            if anomaly_id and anomaly_id not in (anomalies or []):
                (anomalies or []).append(anomaly_id)
        exemplars = None
        for rec in reversed(records):
            if rec.get("event") == "reqtrace" and rec.get("exemplars"):
                exemplars = rec["exemplars"]
                break
        tenants = None
        if self.registry is not None:
            try:
                tenants = affected_tenants(self.registry.snapshot()) \
                    or None
            except Exception:
                tenants = None
        inc = assemble_incident(
            trig, records, incident_id=iid, lookback_s=self.lookback_s,
            gauge_history=gauge_history, exemplars=exemplars,
            tenants=tenants, anomalies=anomalies)
        with self._lock:
            self.incidents.append(inc)
        if self.ledger is not None:
            try:
                self.ledger.record(inc)
            except Exception:
                pass
        return inc

    def active_id(self, now: Optional[float] = None) -> Optional[str]:
        """The correlation id a scale decision should carry: the
        incident still inside its lookback, else the oldest still-open
        anomaly, else ``None``."""
        now = time.time() if now is None else now
        with self._lock:
            if self.incidents \
                    and now - self.incidents[-1]["ts"] <= self.lookback_s:
                return self.incidents[-1]["incident_id"]
        if self.detector is not None:
            opens = self.detector.open_anomalies()
            if opens:
                return opens[0].get("anomaly_id")
        return None

    def finalize(self, registry) -> None:
        """Close-time gauges (before the shard ships): incident /
        anomaly counts ride ``obs diff`` via the ``incident_*`` /
        ``anomaly_*`` dynamic prefixes — always set, so the clean-run
        false-positive gate compares 0 against 0 instead of skipping."""
        with self._lock:
            incidents = list(self.incidents)
        registry.gauge("incident_count",
                       help="incidents opened by the correlator "
                            "(absorbed triggers excluded)"
                       ).set(float(len(incidents)))
        top = max((i.get("top_suspect", {}).get("score") or 0.0
                   for i in incidents), default=0.0)
        registry.gauge("incident_top_suspect_score",
                       help="best suspect score over all incidents "
                            "(0 = none)").set(round(top, 6))
        absorbed = sum(i.get("triggers_absorbed", 0) for i in incidents)
        registry.gauge("incident_absorbed_triggers",
                       help="triggers folded into an existing incident "
                            "instead of opening a new one"
                       ).set(float(absorbed))
        if self.detector is not None:
            c = self.detector.counts()
            registry.gauge("anomaly_count",
                           help="anomalies opened by the changepoint "
                                "detector").set(float(c["opened"]))
            registry.gauge("anomaly_open_count",
                           help="anomalies still open at session close"
                           ).set(float(c["open"]))


# -- offline -----------------------------------------------------------------


def correlate(triggers: List[dict], records: List[dict], *,
              lookback_s: Optional[float] = None,
              gauge_history: Optional[List[Tuple[float, dict]]] = None,
              exemplars: Optional[List[dict]] = None,
              tenants: Optional[List[str]] = None,
              id_prefix: str = "") -> List[dict]:
    """The offline coalescing loop: time-sorted triggers folded into
    incidents exactly like the online correlator would."""
    if lookback_s is None:
        lookback_s = default_lookback_s()
    incidents: List[dict] = []
    for trig in sorted(triggers, key=lambda t: t.get("ts") or 0.0):
        ts = float(trig.get("ts") or 0.0)
        if incidents and abs(ts - incidents[-1]["ts"]) <= lookback_s:
            incidents[-1]["triggers_absorbed"] += 1
            aid = trig.get("anomaly_id")
            if aid:
                incidents[-1].setdefault("anomalies", [])
                if aid not in incidents[-1]["anomalies"]:
                    incidents[-1]["anomalies"].append(aid)
            continue
        iid = f"inc-{id_prefix}{len(incidents) + 1}"
        incidents.append(assemble_incident(
            trig, records, incident_id=iid, lookback_s=lookback_s,
            gauge_history=gauge_history, exemplars=exemplars,
            tenants=tenants,
            anomalies=[trig["anomaly_id"]]
            if trig.get("anomaly_id") else None))
    return incidents


def triggers_of(records: List[dict],
                anomalies: List[dict]) -> List[dict]:
    """Trigger dicts from a run's artifacts: ledgered burn alerts plus
    (offline-detected) anomaly opens."""
    out: List[dict] = []
    for rec in records:
        if rec.get("event") == "serve" and rec.get("kind") == "slo_burn":
            out.append({
                "kind": "slo_burn",
                # re-records carry the original burn time as burn_ts
                "ts": rec.get("burn_ts") or rec.get("ts"),
                "metric": rec.get("metric"),
                "replica": replica_of(rec),
                "burn_fast": rec.get("burn_fast"),
                "burn_slow": rec.get("burn_slow"),
            })
    for a in anomalies:
        out.append({
            "kind": "anomaly",
            "ts": a.get("opened_ts"),
            "metric": a.get("metric"),
            "replica": a.get("proc") if str(a.get("proc") or ""
                                           ).startswith("replica")
            else replica_hint(a.get("metric") or ""),
            "anomaly_id": a.get("anomaly_id"),
            "z": a.get("z"),
        })
    return [t for t in out if t.get("ts") is not None]


def assemble_run_incidents(run_dir: str,
                           lookback_s: Optional[float] = None
                           ) -> Dict[str, Any]:
    """Offline reconstruction for a SINGLE-process run dir (fleet dirs
    are refused by :func:`incident_main`): re-derive
    triggers from the ledger + time-series and correlate.  Returns
    ``{"incidents", "anomalies", "burns", "records"}``."""
    from torchpruner_tpu_torch.obs.anomaly import detect_anomalies
    from torchpruner_tpu_torch.obs.ledger import LEDGER_FILENAME, load_ledger
    from torchpruner_tpu_torch.obs.timeseries import load_series

    path = os.path.join(run_dir, LEDGER_FILENAME)
    records = load_ledger(path) if os.path.exists(path) else []
    try:
        anomalies = detect_anomalies(run_dir)
    except Exception:
        anomalies = []
    try:
        _, windows = load_series(run_dir)
    except Exception:
        windows = []
    gauge_history = [(w.get("ts") or 0.0, w["gauges"])
                     for w in windows if w.get("gauges")]
    exemplars = None
    for rec in reversed(records):
        if rec.get("event") == "reqtrace" and rec.get("exemplars"):
            exemplars = rec["exemplars"]
            break
    tenants = affected_tenants(windows[-1]["gauges"]) \
        if windows and windows[-1].get("gauges") else []
    burns = [r for r in records
             if r.get("event") == "serve" and r.get("kind") == "slo_burn"]
    incidents = correlate(
        triggers_of(records, anomalies), records,
        lookback_s=lookback_s, gauge_history=gauge_history,
        exemplars=exemplars, tenants=tenants or None)
    return {"incidents": incidents, "anomalies": anomalies,
            "burns": burns, "records": records}


# -- postmortem rendering ----------------------------------------------------


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float]) -> str:
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi - lo < 1e-12:
        return _SPARK[0] * len(values)
    return "".join(_SPARK[min(7, int(8 * (v - lo) / (hi - lo)))]
                   for v in values)


def signal_series(windows: List[dict], metric: str,
                  proc: Optional[str] = None,
                  cap: int = 64) -> List[Tuple[float, float]]:
    """``(ts, value)`` series for one detector signal name from raw
    windows (``<hist>_p99`` / ``<counter>_rate`` / gauge name)."""
    from torchpruner_tpu_torch.obs.timeseries import _quantile_from_buckets

    out: List[Tuple[float, float]] = []
    for w in windows:
        if proc is not None and (w.get("proc") or "router") != proc:
            continue
        ts = w.get("ts") or 0.0
        v: Optional[float] = None
        if metric.endswith("_p99"):
            h = (w.get("hist") or {}).get(metric[:-len("_p99")])
            if h and "le" in h:
                v = _quantile_from_buckets(h["le"], h.get("c") or [],
                                           0.99)
        elif metric.endswith("_rate"):
            c = (w.get("counters") or {}).get(metric[:-len("_rate")])
            dur = w.get("dur_s") or 0.0
            if c is not None and dur > 0:
                v = c / dur
        else:
            g = (w.get("gauges") or {}).get(metric)
            if g is not None:
                v = float(g)
        if v is not None:
            out.append((ts, v))
    return out[-cap:]


#: SLO metric key → the window signal that plots it
_SLO_SIGNALS = {"token": "serve_token_seconds_p99",
                "ttft": "serve_ttft_seconds_p99"}


def format_postmortem(incidents: List[dict], *,
                      anomalies: Optional[List[dict]] = None,
                      windows: Optional[List[dict]] = None,
                      title: str = "run",
                      reconstructed: bool = False) -> str:
    """The ``obs incident`` markdown: per incident — trigger, timeline,
    ranked suspects with evidence lines, gauge deltas, anomaly plot
    data, affected tenants, exemplars."""
    lines = [f"# obs incident — {title}", ""]
    lines.append(f"{len(incidents)} incident(s), "
                 f"{len(anomalies or [])} anomal(y/ies)"
                 + (" (reconstructed offline from artifacts)"
                    if reconstructed else ""))
    lines.append("")
    if not incidents:
        lines.append("(no incidents — no burn alert fired and no "
                     "anomaly opened)")
        return "\n".join(lines)
    for inc in incidents:
        trig = inc.get("trigger") or {}
        head = f"## {inc.get('incident_id')} — {inc.get('kind')}"
        if trig.get("metric"):
            head += f" ({trig['metric']})"
        if trig.get("replica"):
            head += f" on {trig['replica']}"
        lines.append(head)
        lines.append("")
        span = inc.get("span") or {}
        lines.append(
            f"- trigger at ts {inc.get('ts')}, window span "
            f"[{span.get('t0')}, {span.get('t1')}] "
            f"(lookback ±{inc.get('lookback_s')}s), "
            f"{inc.get('triggers_absorbed', 0)} trigger(s) absorbed")
        if trig.get("burn_fast") is not None:
            lines.append(f"- burn rates at trigger: fast "
                         f"{trig['burn_fast']}x, slow "
                         f"{trig.get('burn_slow')}x")
        if inc.get("tenants"):
            lines.append("- affected tenants: "
                         + ", ".join(inc["tenants"]))
        if inc.get("anomalies"):
            lines.append("- correlated anomalies: "
                         + ", ".join(inc["anomalies"]))
        lines.append("")
        suspects = inc.get("suspects") or []
        if suspects:
            lines.append("| rank | score | class | replica | Δt s "
                         "| evidence |")
            lines.append("|---|---|---|---|---|---|")
            for s in suspects:
                lines.append(
                    f"| {s.get('rank')} | {s.get('score'):.4f} "
                    f"| {s.get('class')} | {s.get('replica') or ''} "
                    f"| {s['factors'].get('dt_s'):+.1f} "
                    f"| {s.get('evidence')} |")
            lines.append("")
        else:
            lines.append("(no candidate causes in the horizon — "
                         "unexplained)")
            lines.append("")
        deltas = inc.get("gauge_deltas") or {}
        if deltas:
            lines.append("gauge deltas (router scrape history, median "
                         "before → after trigger):")
            for name, d in deltas.items():
                lines.append(f"- {name}: {d['before']} → {d['after']} "
                             f"(Δ{d['delta']:+g})")
            lines.append("")
        # anomaly plot data: the triggering signal's window series
        metric = trig.get("metric")
        signal = _SLO_SIGNALS.get(metric or "", metric)
        if windows and signal:
            series = signal_series(windows, signal,
                                   proc=trig.get("replica"))
            if not series:
                series = signal_series(windows, signal)
            if len(series) >= 2:
                vals = [v for _, v in series]
                lines.append(
                    f"plot {signal}"
                    + (f" ({trig['replica']})" if trig.get("replica")
                       else "")
                    + f": {sparkline(vals)} "
                    f"[min {min(vals):.4g}, max {max(vals):.4g}, "
                    f"{len(vals)} windows]")
                lines.append("")
        exemplars = inc.get("exemplars") or []
        if exemplars:
            lines.append("slowest exemplars overlapping the window:")
            for ex in exemplars:
                lines.append(
                    f"- `{ex.get('trace')}` e2e {ex.get('e2e_ms')} ms, "
                    f"ttft {ex.get('ttft_ms')} ms, "
                    f"{ex.get('attempts', 0)} attempt(s)"
                    + (" [redriven]" if ex.get("redrive") else ""))
            lines.append("")
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------


def incident_main(args) -> int:
    """``obs incident DIR``: render the run's incidents — ledgered ones
    when the session closed cleanly, reconstructed from artifacts
    otherwise.  Exit 1 on an unexplained burn (a burn alert with no
    incident covering it)."""
    from torchpruner_tpu_torch.obs.timeseries import TS_FLEET_FILENAME

    run_dir = args.dir
    lookback = args.lookback if args.lookback > 0 else None
    fleet = os.path.exists(os.path.join(run_dir, TS_FLEET_FILENAME))
    if fleet:
        from torchpruner_tpu_torch.fleet.report import (
            assemble_fleet_incidents,
        )

        out = assemble_fleet_incidents(run_dir, lookback_s=lookback)
    else:
        out = assemble_run_incidents(run_dir, lookback_s=lookback)

    ledgered = [r for r in out["records"]
                if r.get("event") == "incident"]
    reconstructed = not ledgered
    incidents = ledgered or out["incidents"]
    try:
        from torchpruner_tpu_torch.obs.timeseries import load_series

        _, windows = load_series(
            os.path.join(run_dir, TS_FLEET_FILENAME) if fleet
            else run_dir)
    except Exception:
        windows = []
    if args.json:
        print(json.dumps({"incidents": incidents,
                          "anomalies": out["anomalies"],
                          "reconstructed": reconstructed}))
    else:
        print(format_postmortem(
            incidents, anomalies=out["anomalies"], windows=windows,
            title=run_dir, reconstructed=reconstructed))
    # the unexplained-burn contract: every burn alert must fall inside
    # some incident's span
    unexplained = 0
    for b in out["burns"]:
        bts = b.get("burn_ts") or b.get("ts")
        if bts is None:
            continue
        if not any((i.get("span") or {}).get("t0", 1e99) <= bts
                   <= (i.get("span") or {}).get("t1", -1e99)
                   for i in incidents):
            unexplained += 1
    if unexplained:
        print(f"UNEXPLAINED BURN: {unexplained} burn alert(s) outside "
              "every incident window", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="torchpruner_tpu_torch obs incident")
    p.add_argument("dir")
    p.add_argument("--lookback", type=float, default=0.0)
    p.add_argument("--json", action="store_true")
    sys.exit(incident_main(p.parse_args()))
