"""Pareto frontier over accuracy-vs-FLOPs trial points, and the
dominance rules the campaign driver early-stops with.
(A copy of ``torchpruner_tpu/search/frontier.py``, imports renamed.)

Conventions (the two objectives):

- **accuracy** — maximize (final test accuracy of the pruned+retrained
  checkpoint);
- **flops** — minimize (forward FLOPs of the pruned model, from the
  same ``utils.flops.model_cost`` every round record carries).

``q`` *dominates* ``p`` at margin ``m`` iff ``q.flops <= p.flops`` and
``q.acc >= p.acc + m``, strictly better in at least one coordinate.
The margin plays two roles:

- the **near-tie margin** of the frontier filter (the same role the
  ledger's ``near_ties`` plays for prune decisions): a point within the
  margin of a better one is a legitimate run-to-run coin flip, so it
  stays on the frontier rather than being knocked off by noise;
- the **confidence margin** of the early-stop rule
  (:func:`curve_dominated`): a running trial is cancelled only when
  EVERY point of its partial curve is beaten by MORE than the margin at
  a MATCHED round index of some completed trial's curve — a trial whose
  later points could come back within the margin is never stopped
  (property-tested in tests/test_torch_port_search.py).

Everything here is pure data → data (order-independent, no torch), so the
dominance logic is testable in isolation and the frontier artifact is a
deterministic function of the campaign outcome: ``frontier_digest``
hashes the deterministic core (points' provenance/accuracy/flops, the
early-stopped and excluded sets, the bucket scalars) and is what the
chaos drill compares between an interrupted-then-resumed campaign and
an uninterrupted one.  Volatile measurements (wall seconds, step-time
means) ride in the artifact but stay out of the digest.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: default dominance margin (absolute accuracy) — the near-tie band
#: within which two points are treated as a tie, mirroring the ledger's
#: tie_frac-of-span convention at typical accuracy spans
DEFAULT_MARGIN = 0.02

Point = Tuple[float, float]  # (flops, acc)


def dominates(q: Point, p: Point, *, margin: float = 0.0) -> bool:
    """True iff ``q`` dominates ``p`` at the accuracy near-tie
    ``margin``.  FLOPs are exact (deterministic shape math), accuracy
    is the noisy axis, so the margin applies to accuracy only:

    - ``q`` beats ``p`` by MORE than ``margin`` accuracy at no more
      FLOPs, or
    - ``q`` matches-or-beats ``p``'s accuracy at strictly fewer FLOPs.

    With ``margin == 0`` this is classic Pareto dominance (exact ties
    dominate nothing); with ``margin > 0`` a point within the margin of
    a same-or-more-FLOPs rival is a legitimate run-to-run coin flip and
    survives.  The early-stop predicate (:func:`curve_dominated`)
    deliberately does NOT use the equal-accuracy branch — only a
    beyond-margin accuracy gap may cancel a running trial."""
    qf, qa = q
    pf, pa = p
    if qf > pf:
        return False
    return qa - pa > margin or (qa >= pa and qf < pf)


def pareto_flags(points: Sequence[Point], *,
                 margin: float = DEFAULT_MARGIN) -> List[bool]:
    """Per-point non-dominated flags (same order as ``points``) — a
    point is knocked off the frontier only when some other point beats
    it by more than the near-tie ``margin`` in accuracy at no more
    FLOPs, or matches its accuracy at strictly fewer FLOPs beyond the
    margin.  Order-independent by construction: each flag is a
    quantifier over the whole set."""
    flags = []
    for i, p in enumerate(points):
        flags.append(not any(
            dominates(q, p, margin=margin)
            for j, q in enumerate(points) if j != i))
    return flags


def curve_dominated(partial: Sequence[Point],
                    curves: Sequence[Sequence[Point]], *,
                    margin: float, min_points: int = 1) -> bool:
    """The early-stop predicate: is this running trial's partial
    accuracy-at-FLOPs curve Pareto-dominated by the completed trials'
    curves past the confidence margin?

    The comparison is **rung-matched** (the successive-halving rule):
    the trial's point after round ``k`` is judged against the completed
    trials' points after their OWN round ``k`` — never against their
    final points.  In an iterative prune-retrain loop accuracy climbs
    with every retrained round, so comparing a round-1 point against a
    fully-retrained final would cull every late-starting trial; at a
    matched rung the comparison is budget-for-budget fair, and a trial
    whose later rounds could catch back up within the margin is never
    stopped (the property the isolation tests pin).

    True only when the trial has at least ``min_points`` committed
    round points and EVERY point ``k`` is beaten by some completed
    curve's point ``k`` by MORE than ``margin`` accuracy at no more
    FLOPs."""
    if len(partial) < max(1, min_points) or not curves:
        return False
    return all(
        any(len(c) > k and c[k][0] <= pf and c[k][1] - pa > margin
            for c in curves)
        for k, (pf, pa) in enumerate(partial))


# ---------------------------------------------------------------------------
# the frontier artifact
# ---------------------------------------------------------------------------


def bucket_scalars(points: Sequence[Dict[str, Any]], dense_flops: float,
                   buckets: Sequence[float]) -> Dict[str, float]:
    """``frontier_best_acc_flops_le_<pct>pct`` — best accuracy among
    points at or under each FLOPs bucket (fractions of the dense
    model's forward FLOPs).  These are the dynamic scalars ``obs diff``
    gates frontier regressions with: 'best accuracy at fixed FLOPs
    buckets' is comparable across campaigns even when the exact trial
    points move."""
    out: Dict[str, float] = {}
    for b in buckets:
        accs = [p["accuracy"] for p in points
                if p.get("accuracy") is not None
                and p.get("flops") is not None
                and p["flops"] <= b * dense_flops]
        if accs:
            out[f"frontier_best_acc_flops_le_{int(round(100 * b))}pct"] = \
                max(accs)
    return out


def build_frontier(*, spec, manifest, results: Dict[str, Dict[str, Any]],
                   dense_flops: Optional[float],
                   margin: float = DEFAULT_MARGIN) -> Dict[str, Any]:
    """Assemble the frontier artifact from completed trial results.

    ``results`` maps trial_id → the worker's ``result.json`` payload
    (accuracy/flops/params + checkpoint digest + ledger run id).  Every
    point carries full provenance; the non-dominated flags and bucket
    scalars derive from the deterministic (accuracy, flops) pairs only,
    so the artifact's digest is invariant to scheduling and to where in
    a trial an early stop landed."""
    points: List[Dict[str, Any]] = []
    for tid in sorted(results):
        r = results[tid]
        st = manifest.trials.get(tid, {})
        points.append({
            "trial_id": tid,
            "config": dict(st.get("overrides") or {}),
            "accuracy": r.get("final_acc"),
            "loss": r.get("final_loss"),
            "flops": r.get("flops"),
            "params": r.get("params"),
            "rounds": r.get("rounds"),
            "checkpoint": r.get("checkpoint"),
            "checkpoint_digest": r.get("checkpoint_digest"),
            "ledger_run_id": r.get("ledger_run_id"),
            "obs_dir": r.get("obs_dir"),
            "predicted_step_ms":
                (st.get("pricing") or {}).get("predicted_step_ms"),
            "predicted_trial_s":
                (st.get("pricing") or {}).get("predicted_trial_s"),
            # volatile (measured) — excluded from the digest
            "measured": {
                "step_time_mean_s": r.get("step_time_mean_s"),
                "wall_s": r.get("wall_s"),
            },
        })
    xy = [(p["flops"], p["accuracy"]) for p in points]
    usable = [i for i, (f, a) in enumerate(xy)
              if f is not None and a is not None]
    flags = pareto_flags([xy[i] for i in usable], margin=margin)
    for i, p in enumerate(points):
        p["non_dominated"] = bool(flags[usable.index(i)]) \
            if i in usable else False

    by_status: Dict[str, List[str]] = {}
    for tid in sorted(manifest.trials):
        by_status.setdefault(
            manifest.trials[tid].get("status", "pending"), []).append(tid)
    excluded = [
        {"trial_id": tid,
         "excluded_by": (manifest.trials[tid].get("pricing") or {})
         .get("excluded_by"),
         "reasons": (manifest.trials[tid].get("pricing") or {})
         .get("reasons", [])}
        for tid in by_status.get("excluded", [])
    ]
    frontier = {
        "version": 1,
        "campaign": spec.name,
        "campaign_id": spec.campaign_id,
        "base": spec.base,
        "margin": margin,
        "dense_flops": dense_flops,
        "points": points,
        "counts": {
            "trials": len(manifest.trials),
            "completed": len(points),
            "non_dominated": sum(1 for p in points if p["non_dominated"]),
            "dominated": sum(1 for p in points if not p["non_dominated"]),
            "early_stopped": len(by_status.get("early_stopped", [])),
            "excluded": len(excluded),
            "failed": len(by_status.get("failed", [])),
        },
        "early_stopped": by_status.get("early_stopped", []),
        "excluded": excluded,
        "buckets": (bucket_scalars(points, dense_flops, spec.flops_buckets)
                    if dense_flops else {}),
    }
    frontier["frontier_digest"] = frontier_digest(frontier)
    return frontier


#: per-point keys outside the digest: measurements are wall-clock
#: volatile, obs_dir is an absolute path, and the checkpoint NAME embeds
#: the commit counter (an interrupted trial commits more often than an
#: uninterrupted one) — its CONTENT digest is what must reproduce
_VOLATILE_POINT_KEYS = ("measured", "obs_dir", "checkpoint")


def frontier_digest(frontier: Dict[str, Any]) -> str:
    """sha256 over the deterministic core — what the chaos drill
    compares.  Drops volatile per-point measurements and any top-level
    timing; everything else (provenance included) must reproduce."""
    core = {
        "campaign_id": frontier["campaign_id"],
        "margin": frontier["margin"],
        "dense_flops": frontier["dense_flops"],
        "points": [
            {k: v for k, v in p.items() if k not in _VOLATILE_POINT_KEYS}
            for p in frontier["points"]
        ],
        "counts": frontier["counts"],
        "early_stopped": frontier["early_stopped"],
        "excluded": frontier["excluded"],
        "buckets": frontier["buckets"],
    }
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def write_frontier(frontier: Dict[str, Any], path: str) -> None:
    from torchpruner_tpu_torch.obs.ledger import sanitize
    from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

    atomic_write_json(path, sanitize(frontier), indent=1)


def record_obs(frontier: Dict[str, Any]) -> None:
    """Campaign telemetry: ``frontier_*`` gauges (dynamic-scalar prefix
    in ``obs diff``) + one ledger ``frontier`` record rendered by
    ``obs report``'s frontier section.  Best-effort by the usual
    contract."""
    try:
        from torchpruner_tpu_torch import obs

        if obs.get() is None:
            return
        c = frontier["counts"]
        obs.gauge_set("frontier_points_total", c["completed"],
                      help="search: completed trial points")
        obs.gauge_set("frontier_nondominated_total", c["non_dominated"],
                      help="search: non-dominated frontier points")
        obs.gauge_set("frontier_early_stopped_total", c["early_stopped"],
                      help="search: trials early-stopped as dominated")
        obs.gauge_set("frontier_excluded_total", c["excluded"],
                      help="search: candidates excluded by pre-pricing")
        accs = [p["accuracy"] for p in frontier["points"]
                if p.get("accuracy") is not None]
        if accs:
            obs.gauge_set("frontier_best_acc", max(accs),
                          help="search: best completed-trial accuracy")
        for name, v in frontier["buckets"].items():
            obs.gauge_set(name, v,
                          help="search: best accuracy at the FLOPs bucket")
        obs.record_frontier(
            campaign=frontier["campaign"],
            campaign_id=frontier["campaign_id"],
            digest=frontier["frontier_digest"],
            counts=dict(c),
            buckets=dict(frontier["buckets"]),
            points=[{k: p.get(k) for k in
                     ("trial_id", "accuracy", "flops", "params",
                      "non_dominated", "checkpoint_digest",
                      "ledger_run_id")}
                    for p in frontier["points"]],
            early_stopped=list(frontier["early_stopped"]),
            excluded=[e["trial_id"] for e in frontier["excluded"]],
        )
    except Exception:  # noqa: BLE001 — telemetry never kills a campaign
        pass


def format_frontier(frontier: Dict[str, Any]) -> str:
    """Markdown rendering: the ranked point table (non-dominated first,
    then by FLOPs), counts, buckets, and the loud exclusion list."""
    c = frontier["counts"]
    lines = [
        f"frontier: {frontier['campaign']} "
        f"({c['completed']} point(s), {c['non_dominated']} non-dominated, "
        f"{c['early_stopped']} early-stopped, {c['excluded']} excluded, "
        f"{c['failed']} failed; digest "
        f"{frontier['frontier_digest'][:12]})",
        "",
    ]
    pts = sorted(frontier["points"],
                 key=lambda p: (not p["non_dominated"],
                                p.get("flops") or 0))
    if pts:
        lines.append("| trial | acc | flops | params | frontier "
                     "| ckpt digest | ledger run |")
        lines.append("|---|---|---|---|---|---|---|")
        for p in pts:
            lines.append(
                f"| `{p['trial_id']}` "
                f"| {_fmt(p.get('accuracy'), '.4f')} "
                f"| {_fmt(p.get('flops'), '.3g')} "
                f"| {_fmt(p.get('params'), 'd')} "
                f"| {'*' if p['non_dominated'] else 'dominated'} "
                f"| {str(p.get('checkpoint_digest') or '')[:12]} "
                f"| {p.get('ledger_run_id') or ''} |")
        lines.append("")
    if frontier["buckets"]:
        lines.append("buckets: " + ", ".join(
            f"{k.replace('frontier_best_acc_flops_le_', '<=')}"
            f"={v:.4f}" for k, v in sorted(frontier["buckets"].items())))
        lines.append("")
    if frontier["early_stopped"]:
        lines.append("early-stopped (dominated): "
                     + ", ".join(f"`{t}`"
                                 for t in frontier["early_stopped"]))
    if frontier["excluded"]:
        lines.append("excluded by pre-pricing:")
        for e in frontier["excluded"]:
            lines.append(f"- `{e['trial_id']}` [{e['excluded_by']}]: "
                         + "; ".join(e["reasons"]))
    return "\n".join(lines).rstrip() + "\n"


def _fmt(v, fmt) -> str:
    if v is None:
        return ""
    try:
        return format(int(v) if fmt == "d" else float(v), fmt)
    except (TypeError, ValueError):
        return str(v)
