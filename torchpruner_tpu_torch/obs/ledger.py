"""Pruning provenance: the per-round run ledger.
(A copy of ``torchpruner_tpu/obs/ledger.py``, imports renamed.)

The telemetry PR (obs/) answers *how fast* a run went; this module
answers *what the run decided and what it cost*: which rows each round
pruned, by what score margin, and how accuracy/params/FLOPs moved —
the evidence artifact the attribution→prune→retrain loop needs
(JaxPruner's per-layer sparsity reporting, arXiv:2304.14082; the TPU
structured-pruning study's per-round FLOPs provenance, arXiv:2107.04191).

Two files under the session's ``obs_dir``:

- ``ledger.jsonl`` — one JSON record per line, appended as the run
  progresses (a killed run keeps every committed round).  Record kinds:
  ``round`` (the headline prune-round record), ``scores`` (per-site
  attribution score distributions), ``prune`` (the concrete decision:
  site + dropped rows), ``epoch`` (training trajectory), ``sweep_layer``
  (robustness-sweep panel summaries).
- ``report.json`` — the end-of-run bundle (``ObsSession.close``): all
  ledger records plus derived step metrics, phase summary, compile
  totals, and the (cross-host merged) metric snapshot.  ``obs report`` /
  ``obs diff`` consume this file.

Resume contract: the recorder's CURRENT-RUN view (``records()``, what
``report.json`` bundles) starts empty each session — a fresh run that
happens to reuse an ``--obs-dir`` reports its OWN rounds, never a
predecessor's (the same contract as ``events.jsonl``'s ``obs_init``
markers).  Continuation is explicit: a resumed driver calls
:meth:`backfill_rounds` / :meth:`backfill_epochs` with the PR 4
``RunManifest``'s committed history, and the recorder then ADOPTS the
matching prior-session records from disk (keeping their full payload —
e.g. a staged score distribution — without rewriting them) and writes
plain backfill records only for rounds the obs dir never saw.  Either
way a kill-9 → resume yields one continuous ledger: round records
neither duplicated nor lost (CI-asserted next to the chaos smoke).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

LEDGER_FILENAME = "ledger.jsonl"
REPORT_FILENAME = "report.json"
REPORT_VERSION = 1

#: cap on stored dropped-row indices per prune record — a full LLM FFN
#: round can drop tens of thousands of rows; the ledger keeps the first
#: ROWS_CAP plus the true count (``n_rows``) and a truncation flag
ROWS_CAP = 4096


def score_distribution(scores, drop: Optional[Sequence[int]] = None,
                       tie_frac: float = 0.05) -> Dict[str, Any]:
    """Compact distribution of one round's attribution scores.

    Always: ``n``, ``p1``/``p50``/``p99``, ``mean``/``std``/``min``/``max``.
    With ``drop`` (the pruned indices): ``kept_min`` (lowest surviving
    score), ``pruned_max`` (highest removed score), ``margin`` (their
    gap — negative when the policy removed a unit scoring above a kept
    one, e.g. the all-negative policy with bucketing), and ``near_ties``
    — units within ``tie_frac`` of the score span of the decision
    boundary, the count of rows whose fate a small score perturbation
    would flip (high near-tie counts mean the round's decision is noise-
    sensitive and two runs may legitimately diverge there).
    """
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    if s.size == 0:
        return {"n": 0}
    out: Dict[str, Any] = {
        "n": int(s.size),
        "p1": float(np.percentile(s, 1)),
        "p50": float(np.percentile(s, 50)),
        "p99": float(np.percentile(s, 99)),
        "mean": float(np.mean(s)),
        "std": float(np.std(s)),
        "min": float(np.min(s)),
        "max": float(np.max(s)),
    }
    if drop is None:
        return out
    drop = np.unique(np.asarray(drop, dtype=np.int64).reshape(-1))
    drop = drop[(drop >= 0) & (drop < s.size)]
    keep_mask = np.ones(s.size, dtype=bool)
    keep_mask[drop] = False
    out["n_pruned"] = int(drop.size)
    out["n_kept"] = int(s.size - drop.size)
    if drop.size == 0 or drop.size == s.size:
        return out
    kept_min = float(np.min(s[keep_mask]))
    pruned_max = float(np.max(s[drop]))
    boundary = 0.5 * (kept_min + pruned_max)
    span = out["p99"] - out["p1"]
    eps = tie_frac * span if span > 0 else tie_frac * (abs(boundary) + 1e-12)
    out["kept_min"] = kept_min
    out["pruned_max"] = pruned_max
    out["margin"] = kept_min - pruned_max
    out["near_ties"] = int(np.sum(np.abs(s - boundary) <= eps))
    return out


def _dedup_key(rec: Dict[str, Any]) -> Optional[Tuple]:
    """The identity under which a record is written at most once.
    ``None`` = always write (informational events may legitimately
    repeat, e.g. a re-scored target after a kill before its prune
    anchor).  Records stamped with a ``trial_id`` (campaign trials
    sharing an obs dir) key per trial — concurrent runs' same-named
    rounds must coexist, not dedup each other; un-stamped records keep
    their pre-campaign identity (``trial_id`` is just ``None``)."""
    ev = rec.get("event")
    tid = rec.get("trial_id")
    if ev == "round":
        # round index in the key: iterative schedules prune the SAME
        # layer in several rounds, and each must ledger separately
        return ("round", tid, rec.get("target"), rec.get("round"))
    if ev == "sweep_layer":
        return ("sweep_layer", tid, rec.get("layer"))
    if ev == "epoch":
        return ("epoch", tid, rec.get("epoch"))
    if ev == "trial":
        # one status transition per trial per run view (a resumed driver
        # may re-announce) — keyed on the transition, not the payload
        return ("trial", tid, rec.get("status"))
    return None


def load_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ``ledger.jsonl`` (torn/malformed lines skipped — the tail
    of a SIGKILLed run)."""
    records: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


class ProvenanceRecorder:
    """Appends provenance records to ``obs_dir/ledger.jsonl`` with
    resume-safe dedup (see module docstring).  All ``record_*`` methods
    are crash-tolerant by construction: each record is one flushed line,
    so the ledger always holds every round committed before a kill."""

    def __init__(self, obs_dir: str):
        self.obs_dir = obs_dir
        self.path = os.path.join(obs_dir, LEDGER_FILENAME)
        os.makedirs(obs_dir, exist_ok=True)
        #: stamped onto every subsequent record (``set_context``): the
        #: campaign driver sets ``trial_id``/``campaign_id`` here so a
        #: shared obs dir's records stay groupable per trial
        self.context: Dict[str, Any] = {}
        #: dedup keys of records in THIS run's view
        self._seen: set = set()
        #: this run's records (report.json's source) — starts empty
        self._records: List[Dict[str, Any]] = []
        #: prior sessions' keyed records (last occurrence wins),
        #: available for explicit adoption on resume
        self._prior: Dict[Tuple, Dict[str, Any]] = {}
        for rec in load_ledger(self.path):
            key = _dedup_key(rec)
            if key is not None:
                self._prior[key] = rec
        self._f = open(self.path, "a")

    # -- core --------------------------------------------------------------

    def set_context(self, **fields) -> None:
        """Install fields stamped onto every later record (``None``
        values clear).  The campaign driver's satellite: with
        ``trial_id``/``campaign_id`` stamped, ``obs report`` on a
        shared obs dir groups rounds per trial instead of dedup-mixing
        concurrent runs."""
        for k, v in fields.items():
            if v is None:
                self.context.pop(k, None)
            else:
                self.context[k] = v

    def record(self, rec: Dict[str, Any]) -> bool:
        """Write one record (dedup-checked against THIS run's view).
        Returns False when this run already holds a record of the same
        identity."""
        rec = dict(rec)
        for k, v in self.context.items():
            rec.setdefault(k, v)
        key = _dedup_key(rec)
        if key is not None and key in self._seen:
            return False
        rec.setdefault("ts", time.time())
        try:
            self._f.write(json.dumps(sanitize(rec), default=_jsonable)
                          + "\n")
            self._f.flush()
        except Exception:  # the ledger must never kill the run
            return False
        if key is not None:
            self._seen.add(key)
        self._records.append(rec)
        return True

    def adopt(self, key: Tuple) -> bool:
        """Pull a PRIOR session's record (by dedup key) into this run's
        view — the resume bridge: the record keeps its full payload and
        is NOT rewritten to disk (it is already there)."""
        rec = self._prior.get(key)
        if rec is None or (key in self._seen):
            return False
        self._seen.add(key)
        self._records.append(rec)
        return True

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass

    # -- typed records -----------------------------------------------------

    def record_scores(self, site: str, scores, *, method: str = "",
                      run: int = 0, layer: str = "") -> bool:
        """Per-site attribution score distribution (raw scores are NOT
        stored — only the compact distribution)."""
        return self.record({
            "event": "scores", "site": site, "layer": layer or site,
            "method": method, "run": int(run),
            "dist": score_distribution(scores),
        })

    def record_prune(self, target: str, drop, n_units: int, *,
                     simulate: bool = False) -> bool:
        """The concrete prune decision: site + the dropped row indices."""
        rows = [int(d) for d in np.asarray(drop).reshape(-1)[:ROWS_CAP]]
        n_rows = int(np.asarray(drop).reshape(-1).size)
        return self.record({
            "event": "prune", "target": target, "rows": rows,
            "n_rows": n_rows, "rows_truncated": n_rows > ROWS_CAP,
            "n_units_before": int(n_units),
            "fraction": (n_rows / n_units if n_units else 0.0),
            "simulate": bool(simulate),
        })

    def record_round(self, *, target: str, **fields) -> bool:
        """The headline per-round record (prune_retrain round): decision
        + score distribution + pre/post eval + cost snapshot.  Deduped on
        ``target`` — a resumed run re-reporting a committed round is a
        no-op."""
        return self.record({"event": "round", "target": target, **fields})

    def record_epoch(self, *, epoch: int, **fields) -> bool:
        return self.record({"event": "epoch", "epoch": int(epoch), **fields})

    def record_sweep_layer(self, *, layer: str, **fields) -> bool:
        return self.record({"event": "sweep_layer", "layer": layer,
                            **fields})

    def backfill_rounds(self, records: Sequence[Dict[str, Any]]) -> int:
        """Rehydrate round records from a RunManifest's ``records`` list
        (PruneStepRecord dicts) on resume.  A round the obs dir already
        holds is ADOPTED with its original payload (score distribution
        intact); one committed before the manifest but unseen by this
        obs dir (fresh ``--obs-dir``) is written as a ``backfilled``
        record.  Returns how many landed in this run's view."""
        n = 0
        for i, r in enumerate(records):
            target = r.get("layer") or r.get("target")
            if target is None:
                continue
            if self.adopt(("round", self.context.get("trial_id"),
                           target, i)):
                n += 1
                continue
            wrote = self.record_round(
                target=target, round=i, backfilled=True,
                n_dropped=r.get("n_dropped"),
                pre={"loss": r.get("pre_loss"), "acc": r.get("pre_acc")},
                post={"loss": r.get("post_loss"), "acc": r.get("post_acc")},
                params=r.get("n_params"), widths=r.get("widths"),
                prune_time=r.get("prune_time"),
            )
            n += int(wrote)
        return n

    def backfill_epochs(self, records: Sequence[Dict[str, Any]]) -> int:
        """Same as :meth:`backfill_rounds` for training-epoch history."""
        n = 0
        for r in records:
            if "epoch" not in r:
                continue
            if self.adopt(("epoch", self.context.get("trial_id"),
                           int(r["epoch"]))):
                n += 1
                continue
            n += int(self.record_epoch(backfilled=True, **r))
        return n

    # -- views -------------------------------------------------------------

    def records(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        if event is None:
            return list(self._records)
        return [r for r in self._records if r.get("event") == event]

    def rounds(self) -> List[Dict[str, Any]]:
        return self.records("round")


def build_report(*, run_meta: Optional[Dict[str, Any]] = None,
                 records: Optional[List[Dict[str, Any]]] = None,
                 derived: Optional[Dict[str, Any]] = None,
                 phases: Optional[Dict[str, Any]] = None,
                 compiles: Optional[Dict[str, Any]] = None,
                 metrics: Optional[Dict[str, float]] = None,
                 wall_s: Optional[float] = None,
                 profile: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Assemble the ``report.json`` payload — ONE schema whether built
    live at session close or reconstructed offline by ``obs report``
    from ``ledger.jsonl`` + ``events.jsonl``.  ``profile`` is the
    kernel-profiling payload (obs.profile) minus its bulky raw timeline
    — profile.json keeps the full record."""
    records = records or []

    def picked(ev):
        return [r for r in records if r.get("event") == ev]

    prof = None
    if profile:
        prof = {k: v for k, v in profile.items() if k != "hbm"}
        hbm = profile.get("hbm") or {}
        prof["hbm"] = {k: v for k, v in hbm.items() if k != "timeline"}
    return {
        "version": REPORT_VERSION,
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "run": dict(run_meta or {}),
        "rounds": picked("round"),
        "epochs": picked("epoch"),
        "sweep_layers": picked("sweep_layer"),
        "scores": picked("scores"),
        "prunes": picked("prune"),
        "serve": picked("serve"),
        "plan": picked("plan"),
        "trials": picked("trial"),
        "frontier": picked("frontier"),
        "reqtrace": picked("reqtrace"),
        "incidents": picked("incident"),
        "anomalies": picked("anomaly"),
        "derived": dict(derived or {}),
        "phases": dict(phases or {}),
        "compiles": dict(compiles or {}),
        "metrics": dict(metrics or {}),
        "wall_s": wall_s,
        **({"profile": prof} if prof else {}),
    }


def write_report(report: Dict[str, Any], path: str) -> None:
    """Atomic durable write (the shared tmp + fsync + replace dance):
    ``obs diff`` against a run killed mid-close must see the previous
    complete report or none.  Non-finite floats become ``null`` — the
    file must parse under STRICT JSON (jq, JavaScript), not just
    Python's ``NaN`` extension."""
    from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

    atomic_write_json(path, sanitize(report), indent=1, default=_jsonable)


def sanitize(v):
    """Recursively coerce a record to strict-JSON-safe values: numpy
    scalars/arrays to Python, non-finite floats to ``None``."""
    if isinstance(v, dict):
        return {k: sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [sanitize(x) for x in v]
    if isinstance(v, np.ndarray):
        return sanitize(v.tolist())
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        return f if math.isfinite(f) else None
    return v


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)
