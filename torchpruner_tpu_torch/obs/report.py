"""``obs report`` / ``obs diff`` — render, compare, and gate run ledgers.
(A copy of ``torchpruner_tpu/obs/report.py``, imports renamed.)

The CLI the ledger exists for::

    python -m torchpruner_tpu_torch obs report logs/obs
    python -m torchpruner_tpu_torch obs diff logs/obs_a logs/obs_b \
        --gate results/obs_gates_ci.json

``report`` renders one run's ledger (round decisions, score margins,
accuracy/params trajectory, step/MFU/compile summary) as a markdown
table.  ``diff`` compares two runs — runtime scalars (step time, MFU,
compile seconds, step count), per-round accuracy matched by target, and
score-distribution drift — and with ``--gate`` exits non-zero naming
every violated tolerance, which is what turns a bench/CI run into a
regression gate instead of a number someone has to eyeball.

Gate file format (JSON)::

    {
      "step_time_mean_s": {"max_increase_pct": 25},
      "mfu":              {"max_decrease_pct": 10},
      "compile_s":        {"max_increase": 30},
      "steps":            {"max_increase_pct": 50},
      "round_post_acc":   {"max_decrease": 0.05},
      "score_p50_drift":  {"max": 0.25},
      "missing_rounds":   {"max": 0}
    }

Scalar gates read the run-level diff; ``round_*`` and
``score_p50_drift`` apply per matched round (worst round reported);
``missing_rounds`` fires when run B lost rounds run A had.  Unknown
gate names are themselves violations — a typo must not silently
disable a gate.

Per-kernel gates (the profile subsystem, ``obs.profile``) are scalar
gates over dynamic names: ``kernel_<base>_ms`` (ms per step) and
``kernel_<base>_pct`` (share of attributed op time), e.g.
``"kernel_dot_ms": {"max_increase_pct": 60}`` — which fails a run whose
matmul kernel regressed even when the total-step gate stays green.  A
scalar present in only one run renders as an informational "not
comparable" row and is skipped by gates unless the spec sets
``"require": true``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from torchpruner_tpu_torch.obs.ledger import (
    LEDGER_FILENAME,
    REPORT_FILENAME,
    build_report,
    load_ledger,
)

_EPS = 1e-12

#: run-level scalar metrics a diff compares; ``better`` orients the
#: pct sign convention in the rendered table ("higher"/"lower")
_SCALARS = {
    "step_time_mean_s": "lower",
    "step_time_p50_s": "lower",
    "mfu": "higher",
    "examples_per_s": "higher",
    "compile_s": "lower",
    "compile_count": "lower",
    "steps": "same",
    "wall_s": "lower",
    # serving-engine latency/throughput (serve/ runs; absent elsewhere,
    # and gates on absent metrics skip unless they set "require")
    "serve_ttft_p50_s": "lower",
    "serve_ttft_p99_s": "lower",
    "serve_token_p50_s": "lower",
    "serve_token_p99_s": "lower",
    "serve_tokens_per_s": "higher",
    "serve_completed": "same",
}

#: dynamic scalar families: any metric matching one of these prefixes
#: participates in diff/gating even though its exact name depends on
#: the run (per-kernel scalars are named after the compiled ops;
#: ``zero_*`` are the ZeRO weight-update-sharding A/B gauges from
#: experiments.zero_bench / the bench ``zero`` leg; ``predicted_*``
#: are the static cost model's step/comm predictions plus the
#: prediction-vs-measured drift rows computed in ``_scalars_of``)
#: ``plan_*`` are the auto-parallelism planner's candidate/winner
#: gauges (analysis/planner.py); ``frontier_*`` / ``search_*`` are the
#: sparsity-search campaign's frontier scalars (best accuracy at fixed
#: FLOPs buckets, point/early-stop counts — search/frontier.py), the
#: gates CI holds frontier regressions with; ``fleet_*`` are the
#: multi-replica serving plane's failover/redrive/shed counters and
#: replica gauges (fleet/router.py), gated by the CI failover drill
#: (``reqtrace_*`` / ``ttft_stage_*`` are the distributed request
#: tracer's latency-budget and assembly scalars — per-stage TTFT
#: share, budget-vs-measured reconciliation, cross-process waterfall
#: counts; obs/reqtrace.py + fleet/report.py, gated by the CI drill)
#: (``ts_*`` are the windowed time-series recorder's window-count /
#: cadence gauges and ``slo_burn_*`` the multi-window burn-rate
#: gauges — obs/timeseries.py + serve/slo.py, gated by the CI fleet
#: drill)
#: (``serve_prefix_*`` / ``serve_kv_pages_shared*`` are the Serve v2
#: prefix-sharing cache's hit/publish/evict counters and shared-page
#: gauges — serve/allocator.py + serve/engine.py, emitted only with
#: ``--prefix-pages`` on, gated by the CI prefix smoke; the fleet's
#: ``fleet_affinity_*`` ride the existing ``fleet_`` prefix)
#: (``workload_*`` are the scenario replayer's submitted/shed/retry/
#: hedge/abandoned counters — fleet/workload.py; ``tenant_*`` the
#: multi-tenant QoS plane's per-tenant completion/shed/preemption
#: counters and SLO-percentile gauges — serve/scheduler.py +
#: fleet/router.py; ``scale_*`` the autoscaling supervisor's decision
#: counters and replica/rung gauges — fleet/supervisor.py; all three
#: gated by the CI autoscale chaos drill)
#: (``anomaly_*`` / ``incident_*`` are the changepoint detector's and
#: incident correlator's close-time count/score gauges — obs/anomaly.py
#: + obs/incident.py; gated exact-zero on the clean fleet run and
#: exact-one on the planted-cause CI drill)
_DYNAMIC_SCALAR_PREFIXES = ("kernel_", "serve_slo_breach", "zero_",
                            "predicted_", "plan_", "frontier_",
                            "search_", "fleet_", "reqtrace_",
                            "ttft_stage_", "serve_queue_wait",
                            "host_lint_", "ts_", "slo_burn_",
                            "serve_prefix_", "serve_kv_pages_shared",
                            "workload_", "tenant_", "scale_",
                            "anomaly_", "incident_")
_DYNAMIC_EXTRA = ("profile_coverage", "profile_windows_total",
                  "profile_steps_total")


def _dynamic_scalars(metrics: Dict[str, Any]) -> Dict[str, Optional[float]]:
    out: Dict[str, Optional[float]] = {}
    for k, v in (metrics or {}).items():
        if k.startswith(_DYNAMIC_SCALAR_PREFIXES) or k in _DYNAMIC_EXTRA:
            out[k] = _finite(v)
    return out


#: ``tenant_<name>_<field>`` scalar suffixes the per-tenant QoS table
#: regroups (tenant names may themselves contain underscores, so the
#: parse is suffix-anchored, never split-on-underscore)
_TENANT_FIELDS = ("accepted_fleet", "completed_fleet", "shed_fleet",
                  "deadline_exceeded_fleet", "ttft_p50_s", "ttft_p99_s",
                  "e2e_p50_s", "e2e_p99_s", "preempted_total",
                  "completed_total", "shed_total")


def _tenant_table(metrics: Dict[str, Any]) -> List[tuple]:
    """``[(tenant, {field: value})]`` rebuilt from the ``tenant_*``
    scalars — the report's per-tenant SLO breakdown source."""
    rows: Dict[str, Dict[str, float]] = {}
    for k, v in (metrics or {}).items():
        if not k.startswith("tenant_"):
            continue
        for f in _TENANT_FIELDS:
            if k.endswith("_" + f):
                name = k[len("tenant_"):-(len(f) + 1)]
                if name:
                    val = _finite(v)
                    if val is not None:
                        rows.setdefault(name, {})[f] = val
                break
    return sorted(rows.items())


def load_run(run_dir: str) -> Dict[str, Any]:
    """A run's report dict: ``report.json`` when the session closed
    cleanly, otherwise reconstructed from whatever survived
    (``ledger.jsonl`` + ``events.jsonl`` + metric shards) — a SIGKILLed
    run must still be reportable/diffable.  Also accepts a report FILE
    directly (a committed golden ``results/obs_report_*.json``)."""
    if os.path.isfile(run_dir):
        with open(run_dir) as f:
            report = json.load(f)
        report["_dir"] = os.path.dirname(run_dir)
        return report
    path = os.path.join(run_dir, REPORT_FILENAME)
    if os.path.exists(path):
        with open(path) as f:
            report = json.load(f)
        report["_dir"] = run_dir
        return report

    records = _dedupe_last(
        load_ledger(os.path.join(run_dir, LEDGER_FILENAME)))
    phases: Dict[str, Any] = {}
    events_path = os.path.join(run_dir, "events.jsonl")
    if os.path.exists(events_path):
        from torchpruner_tpu_torch.utils.profiling import span_phase_summary

        phases = span_phase_summary(events_path)
    metrics: Dict[str, float] = {}
    from torchpruner_tpu_torch.obs.aggregate import load_shards, merge_shards

    shards = load_shards(run_dir)
    if shards:
        metrics = merge_shards(shards).snapshot()
    derived = {
        "steps": metrics.get("steps_total"),
        "step_time_mean_s": (
            metrics["step_time_seconds_sum"] / metrics["step_time_seconds_count"]
            if metrics.get("step_time_seconds_count") else None),
        "step_time_p50_s": metrics.get("step_time_seconds_p50"),
        "step_time_p95_s": metrics.get("step_time_seconds_p95"),
        "step_time_p99_s": metrics.get("step_time_seconds_p99"),
        "mfu": metrics.get("mfu"),
        "examples_per_s": metrics.get("examples_per_s"),
    }
    compiles = {
        "compile_count": metrics.get("compile_count_total"),
        "compile_s": metrics.get("compile_seconds_total"),
    }
    profile = None
    try:
        from torchpruner_tpu_torch.obs.profile import load_profile

        profile = load_profile(run_dir)
    except Exception:
        profile = None
    report = build_report(records=records, derived=derived, phases=phases,
                          compiles=compiles, metrics=metrics,
                          profile=profile)
    report["run"]["reconstructed"] = True
    report["_dir"] = run_dir
    if not records and not phases and not metrics:
        raise FileNotFoundError(
            f"{run_dir!r} holds no report.json, ledger.jsonl, "
            "events.jsonl, or metric shards — not an obs run directory")
    return report


def _dedupe_last(records):
    """Keyed records (rounds/epochs/sweep layers) deduped keeping the
    LAST occurrence — a multi-session ledger (kill → resume) can hold a
    round twice; the reconstruction must count it once.  Un-keyed
    records pass through."""
    from torchpruner_tpu_torch.obs.ledger import _dedup_key

    out, by_key = [], {}
    for rec in records:
        key = _dedup_key(rec)
        if key is None:
            out.append(rec)
        elif key in by_key:
            by_key[key].clear()
            by_key[key].update(rec)  # replace in place, keep position
        else:
            by_key[key] = dict(rec)
            out.append(by_key[key])
    return out


def _scalars_of(report: Dict[str, Any]) -> Dict[str, Optional[float]]:
    derived = report.get("derived") or {}
    compiles = report.get("compiles") or {}
    metrics = report.get("metrics") or {}
    out = {
        "step_time_mean_s": derived.get("step_time_mean_s"),
        "step_time_p50_s": derived.get("step_time_p50_s"),
        "mfu": _finite(derived.get("mfu")),
        "examples_per_s": derived.get("examples_per_s"),
        "compile_s": compiles.get("compile_s"),
        "compile_count": compiles.get("compile_count"),
        "steps": derived.get("steps"),
        "wall_s": report.get("wall_s"),
        # serving histograms land in the metric snapshot as bucket-
        # estimated percentiles (metrics.Histogram.percentiles)
        "serve_ttft_p50_s": metrics.get("serve_ttft_seconds_p50"),
        "serve_ttft_p99_s": metrics.get("serve_ttft_seconds_p99"),
        "serve_token_p50_s": metrics.get("serve_token_seconds_p50"),
        "serve_token_p99_s": metrics.get("serve_token_seconds_p99"),
        "serve_tokens_per_s": metrics.get("serve_gen_tokens_per_s"),
        "serve_completed": metrics.get("serve_completed_total"),
        # per-kernel profile scalars (kernel_<base>_ms / _pct) ride in
        # dynamically — their names depend on the compiled program
        **_dynamic_scalars(metrics),
    }
    # prediction-vs-measured drift: the static cost model's predicted
    # step/token time against what the run measured, as a signed % —
    # the row `obs diff` renders (and the capture script's staged lint
    # leg gates at <30% on-chip).  Computed here so SIGKILLed runs
    # reconstructed from shards get it too.
    pred = _finite(metrics.get("predicted_step_ms"))
    meas = out.get("step_time_p50_s")
    if pred is not None and meas:
        out["predicted_vs_measured_step_pct"] = (
            100.0 * (pred - 1e3 * meas) / (1e3 * meas))
    pred_d = _finite(metrics.get("predicted_step_ms_decode"))
    meas_d = out.get("serve_token_p50_s")
    if pred_d is not None and meas_d:
        out["predicted_vs_measured_decode_pct"] = (
            100.0 * (pred_d - 1e3 * meas_d) / (1e3 * meas_d))
    # HBM drift: the static watermark prediction against the device
    # HIGH-WATER gauge (peak_bytes_in_use — an instantaneous end-of-run
    # reading has already freed the activation peak and would show a
    # large spurious drift).  TPU/GPU only: memory_stats() is absent on
    # CPU, where the predicted gauge still rides the diff alone.
    pred_h = _finite(metrics.get("predicted_hbm_bytes_per_chip"))
    meas_h = max(
        (v for k, v in (metrics or {}).items()
         if k.startswith("hbm_bytes_peak_device")
         and _finite(v) is not None), default=None)
    if pred_h is not None and meas_h:
        out["predicted_vs_measured_hbm_pct"] = (
            100.0 * (pred_h - meas_h) / meas_h)
    return out


def _finite(v) -> Optional[float]:
    import math

    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) else None


# -- report rendering --------------------------------------------------------


def format_report(report: Dict[str, Any]) -> str:
    """Markdown rendering of one run's ledger."""
    lines: List[str] = []
    run = report.get("run") or {}
    title = run.get("experiment") or run.get("name") or \
        report.get("_dir") or "run"
    lines.append(f"# obs report — {title}")
    lines.append("")
    sc = _scalars_of(report)
    bits = []
    if sc["steps"]:
        bits.append(f"steps {int(sc['steps'])}")
    if sc["step_time_mean_s"]:
        bits.append(f"step {1e3 * sc['step_time_mean_s']:.2f} ms mean")
    d = report.get("derived") or {}
    if d.get("step_time_p50_s") is not None:
        bits.append(
            f"p50/p95/p99 {1e3 * d['step_time_p50_s']:.2f}/"
            f"{1e3 * d['step_time_p95_s']:.2f}/"
            f"{1e3 * d['step_time_p99_s']:.2f} ms")
    if sc["mfu"] is not None:
        bits.append(f"MFU {100 * sc['mfu']:.1f}%")
    if sc["examples_per_s"]:
        bits.append(f"{sc['examples_per_s']:.1f} ex/s")
    if sc["compile_s"] is not None:
        bits.append(f"compile {sc['compile_s']:.2f}s"
                    f"/{int(sc['compile_count'] or 0)}")
    if sc["wall_s"]:
        bits.append(f"wall {sc['wall_s']:.1f}s")
    if bits:
        lines.append("run: " + ", ".join(bits))
        lines.append("")

    # static cost model: predicted vs measured, per program (the train
    # step compares against step-time p50, decode against per-token p50)
    metrics = report.get("metrics") or {}
    preds = []
    for key, label, meas_key, meas_scale in (
        ("predicted_step_ms", "step", "step_time_p50_s", 1e3),
        ("predicted_step_ms_decode", "decode", "serve_token_p50_s", 1e3),
        ("predicted_step_ms_capture", "capture", None, None),
        ("predicted_step_ms_prefill", "prefill", None, None),
    ):
        p = _finite(metrics.get(key))
        if p is None:
            continue
        comm = _finite(metrics.get(key.replace("predicted_step_ms",
                                               "predicted_comm_ms")))
        bit = f"{label} {p:.3f} ms predicted"
        if comm:
            bit += f" ({comm:.3f} ms comm)"
        # the drift itself comes from _scalars_of — ONE formula, shared
        # with the obs-diff scalar the capture script gates on
        m = sc.get(meas_key) if meas_key else None
        drift = sc.get({"step": "predicted_vs_measured_step_pct",
                        "decode": "predicted_vs_measured_decode_pct"}
                       .get(label))
        if m and drift is not None:
            bit += f" vs {meas_scale * m:.3f} ms measured ({drift:+.0f}%)"
        preds.append(bit)
    pred_hbm = _finite(metrics.get("predicted_hbm_bytes_per_chip"))
    if pred_hbm is not None:
        bit = f"hbm {pred_hbm / 2**30:.3f} GiB/chip predicted"
        if sc.get("predicted_vs_measured_hbm_pct") is not None:
            bit += f" ({sc['predicted_vs_measured_hbm_pct']:+.0f}% " \
                   f"vs peak watermark)"
        preds.append(bit)
    if preds:
        lines.append("cost model: " + ", ".join(preds))
        lines.append("")

    # auto-parallelism planner (analysis/planner.py): the chosen config,
    # its predicted margins, and the winner's probe drift
    plans = report.get("plan") or []
    if plans:
        p = plans[-1]
        bits = []
        if p.get("winner"):
            bits.append(f"winner `{p['winner']}`")
        if p.get("margin_over_runner_up_pct") is not None:
            bits.append(
                f"{p['margin_over_runner_up_pct']:+.1f}% over runner-up")
        if p.get("margin_over_baseline_pct") is not None:
            bits.append(f"{p['margin_over_baseline_pct']:+.1f}% over "
                        f"baseline `{p.get('baseline')}`")
        if p.get("feasible") is not None:
            bits.append(f"{p['feasible']}/{p.get('candidates')} "
                        f"candidates feasible")
        wp = p.get("winner_predicted") or {}
        if wp.get("step_ms") is not None:
            bits.append(f"predicted {wp['step_ms']:.3f} ms/step "
                        f"({wp.get('bound', '?')}-bound)")
        probe = p.get("winner_probe") or {}
        if probe.get("drift_pct") is not None:
            bits.append(f"probe drift {probe['drift_pct']:+.0f}%"
                        + (" GATED" if probe.get("gated") else ""))
        lines.append("plan: " + ", ".join(bits))
        lines.append("")

    # sparsity-search campaign frontier (search/frontier.py): the non-
    # dominated point table with dominated / early-stopped / excluded
    # counts — the section `obs report` renders for a campaign obs dir
    fronts = report.get("frontier") or []
    if fronts:
        fr = fronts[-1]
        c = fr.get("counts") or {}
        lines.append(
            f"frontier: {c.get('completed', 0)} point(s), "
            f"{c.get('non_dominated', 0)} non-dominated, "
            f"{c.get('dominated', 0)} dominated, "
            f"{c.get('early_stopped', 0)} early-stopped, "
            f"{c.get('excluded', 0)} excluded"
            + (f" (digest {str(fr.get('digest') or '')[:12]})"
               if fr.get("digest") else ""))
        nd = [p for p in (fr.get("points") or [])
              if p.get("non_dominated")]
        if nd:
            lines.append("")
            lines.append("| trial | acc | flops | params | ckpt digest "
                         "| ledger run |")
            lines.append("|---|---|---|---|---|---|")
            for p in sorted(nd, key=lambda p: p.get("flops") or 0):
                lines.append(
                    f"| `{p.get('trial_id')}` | {_f(p.get('accuracy'))} "
                    f"| {_f(p.get('flops'), '.3g')} "
                    f"| {_i(p.get('params'))} "
                    f"| {str(p.get('checkpoint_digest') or '')[:12]} "
                    f"| {p.get('ledger_run_id') or ''} |")
        buckets = fr.get("buckets") or {}
        if buckets:
            lines.append("")
            lines.append("buckets: " + ", ".join(
                f"{k.replace('frontier_best_acc_flops_le_', '<=')}"
                f"={_f(v)}" for k, v in sorted(buckets.items())))
        lines.append("")

    rounds = report.get("rounds") or []
    if rounds:
        # rounds stamped with trial ids (a campaign's shared obs dir)
        # group per trial — the column only appears when it means
        # something
        trialed = any(r.get("trial_id") for r in rounds)
        trial_col = "| trial " if trialed else ""
        lines.append(f"{trial_col}| round | target | method | dropped "
                     "| pre acc | post acc | Δacc | params | margin "
                     "| near ties |")
        lines.append("|---" * (10 + int(trialed)) + "|")
        if trialed:
            rounds = sorted(
                rounds, key=lambda r: (str(r.get("trial_id") or ""),
                                       r.get("round") or 0))
        for i, r in enumerate(rounds):
            pre = (r.get("pre") or {})
            post = (r.get("post") or {})
            sd = r.get("score_dist") or {}
            dacc = (post.get("acc") - pre.get("acc")
                    if post.get("acc") is not None
                    and pre.get("acc") is not None else None)
            tcell = f"| `{r.get('trial_id') or ''}` " if trialed else ""
            lines.append(
                f"{tcell}| {r.get('round', i)} | {r.get('target')} "
                f"| {r.get('method', '')} | {_i(r.get('n_dropped'))} "
                f"| {_f(pre.get('acc'))} | {_f(post.get('acc'))} "
                f"| {_f(dacc, '+.4f')} | {_i(r.get('params'))} "
                f"| {_f(sd.get('margin'))} | {_i(sd.get('near_ties'))} |")
        lines.append("")

    epochs = report.get("epochs") or []
    if epochs:
        last = epochs[-1]
        lines.append(
            f"epochs: {len(epochs)} "
            f"(final test acc {_f(last.get('test_acc'))}, "
            f"loss {_f(last.get('test_loss'))})")
        lines.append("")

    serve = report.get("serve") or []
    sc_serve = {k: v for k, v in sc.items()
                if k.startswith("serve_") and v is not None}
    if serve or sc_serve:
        bits = []
        if sc.get("serve_completed") is not None:
            bits.append(f"requests {int(sc['serve_completed'])}")
        if sc.get("serve_tokens_per_s") is not None:
            bits.append(f"{sc['serve_tokens_per_s']:.1f} gen tok/s")
        if sc.get("serve_ttft_p50_s") is not None:
            bits.append(
                f"TTFT p50/p99 {1e3 * sc['serve_ttft_p50_s']:.2f}/"
                f"{1e3 * (sc.get('serve_ttft_p99_s') or 0):.2f} ms")
        if sc.get("serve_token_p50_s") is not None:
            bits.append(
                f"per-token p50/p99 {1e3 * sc['serve_token_p50_s']:.2f}/"
                f"{1e3 * (sc.get('serve_token_p99_s') or 0):.2f} ms")
        lines.append("serve: " + (", ".join(bits) if bits
                                  else "(no latency metrics)"))
        swaps = [r for r in serve if r.get("kind") == "hot_swap"]
        for r in swaps:
            lines.append(
                f"- hot-swap at step {_i(r.get('at_step'))}: "
                f"{r.get('checkpoint') or ''} "
                f"(digest {str(r.get('new_digest') or '')[:12]})")
        summaries = [r for r in serve if r.get("kind") == "summary"]
        if summaries:
            s = summaries[-1]
            lines.append(
                f"- admits {_i(s.get('admits'))}, evictions "
                f"{_i(s.get('evictions'))}, drained "
                f"{_i(s.get('requests_drained'))}, swaps "
                f"{_i(s.get('swaps'))}, checkpoint digest "
                f"{str(s.get('checkpoint_digest') or '')[:12]}")
        lines.append("")

    # per-tenant QoS / SLO breakdown (serve/scheduler.py +
    # fleet/router.py): the `tenant_<name>_*` scalars regrouped into
    # one table per tenant — completions, sheds (throttle / quota /
    # tier), preemptions, and the router-observed latency percentiles
    tenant_rows = _tenant_table(metrics)
    if tenant_rows:
        lines.append("tenants (QoS breakdown, fleet-observed):")
        lines.append("")
        lines.append("| tenant | accepted | completed | shed "
                     "| preempted | deadline | TTFT p50/p99 ms "
                     "| e2e p50/p99 ms |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for t, row in tenant_rows:
            def ms(key):
                v = row.get(key)
                return f"{1e3 * v:.1f}" if v is not None else ""
            done = row.get("completed_fleet", row.get("completed_total"))
            shed = row.get("shed_fleet", row.get("shed_total"))
            lines.append(
                f"| {t} | {_i(row.get('accepted_fleet'))} "
                f"| {_i(done)} | {_i(shed)} "
                f"| {_i(row.get('preempted_total'))} "
                f"| {_i(row.get('deadline_exceeded_fleet'))} "
                f"| {ms('ttft_p50_s')}/{ms('ttft_p99_s')} "
                f"| {ms('e2e_p50_s')}/{ms('e2e_p99_s')} |")
        lines.append("")

    # autoscaling supervisor (fleet/supervisor.py): every ledgered
    # scale decision with its triggering signal — decision BEFORE
    # effect, so this table exists even for a run that died mid-action
    decisions = [r for r in serve
                 if r.get("kind") == "scale_decision"]
    if decisions:
        ups = sum(r.get("action") == "scale_up" for r in decisions)
        downs = sum(r.get("action") == "scale_down" for r in decisions)
        degrades = sum(r.get("action") == "degrade" for r in decisions)
        recovers = sum(r.get("action") == "recover" for r in decisions)
        lines.append(f"autoscale: {len(decisions)} decision(s) — "
                     f"{ups} up, {downs} down, {degrades} degrade, "
                     f"{recovers} recover")
        for r in decisions[:12]:
            trig = r.get("trigger") or {}
            bit = (f"- t+{_f(r.get('t_s'), '.1f')}s "
                   f"**{r.get('action')}**")
            if r.get("rung"):
                bit += f" → rung `{r['rung']}`"
            if r.get("replica"):
                bit += f" ({r['replica']})"
            bit += (f": queue age {_f(trig.get('queue_age_s'), '.2f')}s,"
                    f" pending {_i(trig.get('pending'))}, "
                    f"{_i(trig.get('live'))}/{_i(trig.get('replicas'))}"
                    f" live, breach {_f(trig.get('breach_frac'), '.2f')}")
            cap = r.get("capacity") or {}
            if cap.get("predicted_tok_s") is not None:
                bit += (f" (predicted +{_f(cap['predicted_tok_s'], '.0f')}"
                        f" tok/s per replica)")
            if r.get("correlation_id"):
                bit += f" [corr {r['correlation_id']}]"
            lines.append(bit)
        lines.append("")

    # incidents (obs/incident.py): every ledgered incident with its
    # trigger and top-ranked suspect — the postmortem headline; the
    # full evidence table is `obs incident DIR`
    incidents = report.get("incidents") or []
    anomalies = report.get("anomalies") or []
    if incidents or anomalies:
        opened = [a for a in anomalies if a.get("state") == "open"]
        lines.append(f"incidents: {len(incidents)} — "
                     f"{len(anomalies)} anomaly record(s), "
                     f"{len(opened)} still open at close")
        for inc in incidents[:8]:
            trig = inc.get("trigger") or {}
            bit = (f"- **{inc.get('incident_id')}** {inc.get('kind')}"
                   + (f" ({trig.get('metric')})" if trig.get("metric")
                      else "")
                   + (f" on {trig.get('replica')}"
                      if trig.get("replica") else ""))
            top = inc.get("top_suspect") or {}
            if top:
                bit += (f" → top suspect `{top.get('class')}`"
                        + (f" on {top.get('replica')}"
                           if top.get("replica") else "")
                        + f" (score {_f(top.get('score'), '.3f')})")
            absorbed = inc.get("triggers_absorbed") or 0
            if absorbed:
                bit += f", {absorbed} trigger(s) absorbed"
            if inc.get("tenants"):
                bit += f", tenants: {', '.join(inc['tenants'])}"
            lines.append(bit)
        lines.append("")

    # request-trace latency budget (obs/reqtrace.py): per-stage TTFT /
    # E2E attribution that reconciles against the measured histograms.
    # Preferred source is the ledger `reqtrace` record (the fleet drill
    # writes budget + exemplars); without one the budget is recomputed
    # from the metric snapshot, so a plain serve run renders it too.
    rt_records = report.get("reqtrace") or []
    budget = (rt_records[-1].get("budget") if rt_records else None)
    if budget is None:
        from torchpruner_tpu_torch.obs.reqtrace import latency_budget

        budget = latency_budget(metrics)
    if budget:
        ttft = budget.get("ttft") or {}
        e2e = budget.get("e2e") or {}
        bits = []
        if ttft.get("measured_mean_ms") is not None:
            bits.append(f"TTFT measured {ttft['measured_mean_ms']:.2f} "
                        f"ms mean")
        if ttft.get("recon_pct") is not None:
            bits.append(f"stage budget reconciles {ttft['recon_pct']:+.1f}%")
        if e2e.get("unattributed_pct") is not None:
            bits.append(f"E2E unattributed "
                        f"{e2e['unattributed_pct']:.1f}%")
        lines.append("latency budget: " + (", ".join(bits) or "(stages)"))
        lines.append("")
        lines.append("| stage | p50 ms | p99 ms | mean ms | % TTFT "
                     "| % E2E |")
        lines.append("|---|---|---|---|---|---|")
        e2e_pct = {r["stage"]: r.get("pct")
                   for r in e2e.get("stages") or []}
        ttft_pct = {r["stage"]: r.get("pct")
                    for r in ttft.get("stages") or []}
        seen = []
        for r in (ttft.get("stages") or []) + (e2e.get("stages") or []):
            if r["stage"] in seen:
                continue
            seen.append(r["stage"])
            lines.append(
                f"| {r['stage']} | {_f(r.get('p50_ms'), '.3f')} "
                f"| {_f(r.get('p99_ms'), '.3f')} "
                f"| {_f(r.get('mean_ms'), '.3f')} "
                f"| {_f(ttft_pct.get(r['stage']), '.1f')} "
                f"| {_f(e2e_pct.get(r['stage']), '.1f')} |")
        lines.append("")
    exemplars = (rt_records[-1].get("exemplars") if rt_records else None)
    if exemplars:
        lines.append(f"slowest-{len(exemplars)} exemplar waterfalls "
                     "(cross-process; pid 0 = router):")
        for ex in exemplars:
            flow = " → ".join(
                f"{s['stage']}"
                + (f" {s['dur_ms']:.1f}ms" if s.get("dur_ms") else "")
                + (f"@p{s['pid']}" if s.get("pid") is not None else "")
                for s in ex.get("stages") or [])
            lines.append(
                f"- `{ex.get('trace')}` e2e {_f(ex.get('e2e_ms'), '.1f')}"
                f" ms, ttft {_f(ex.get('ttft_ms'), '.1f')} ms, "
                f"{ex.get('attempts', 0)} attempt(s)"
                + (" [redriven]" if ex.get("redrive") else "")
                + f": {flow}")
        lines.append("")

    # timeline: the windowed time-series' warmup-vs-steady-state split
    # (obs/timeseries.py) — read from the run dir next to the ledger;
    # committed golden report FILES have no series and skip the section
    run_dir = report.get("_dir")
    if run_dir and os.path.isdir(run_dir):
        from torchpruner_tpu_torch.obs import timeseries as ts_mod

        try:
            _, windows = ts_mod.load_series(run_dir)
        except Exception:
            windows = []
        if len(windows) >= 2:
            tsum = ts_mod.series_summary(windows)
            lines.append(
                f"timeline: {tsum['windows']} window(s) "
                f"({tsum['warmup_windows']} warmup / "
                f"{tsum['steady_windows']} steady-state; steady span "
                f"{tsum['steady_span_s']:.1f}s)")
            rows = [r for r in tsum["hist"]
                    if r.get("warmup") or r.get("steady")]
            if rows:
                lines.append("")
                lines.append("| histogram | warmup p50/p99 ms "
                             "| steady p50/p99 ms | steady mean ms "
                             "| steady n |")
                lines.append("|---|---|---|---|---|")

                def _pp(seg):
                    if not seg:
                        return ""
                    return (f"{_f(1e3 * seg['p50'], '.3f')}/"
                            f"{_f(1e3 * seg['p99'], '.3f')}"
                            if seg.get("p50") is not None else "")

                for r in rows:
                    st = r.get("steady") or {}
                    lines.append(
                        f"| {r['name']} | {_pp(r.get('warmup'))} "
                        f"| {_pp(st)} "
                        f"| {_f(1e3 * st['mean'], '.3f') if st.get('mean') is not None else ''} "
                        f"| {_i(st.get('n'))} |")
            rates = tsum.get("steady_rates_per_s") or {}
            if rates:
                top = sorted(rates.items(), key=lambda kv: -kv[1])[:6]
                lines.append("")
                lines.append("steady-state rates: " + ", ".join(
                    f"{k} {v:.2f}/s" for k, v in top))
            lines.append("")

    profile = report.get("profile") or {}
    kernels = profile.get("kernels") or []
    if kernels:
        lines.append(
            f"profile: {len(profile.get('windows') or [])} capture "
            f"window(s), {profile.get('steps_profiled') or 0} steps"
            + (f", coverage {100 * profile['coverage']:.0f}%"
               if profile.get("coverage") is not None else ""))
        lines.append("")
        lines.append("| kernel | category | ms/step | % step | bound |")
        lines.append("|---|---|---|---|---|")
        for k in kernels[:8]:
            rf = k.get("roofline") or {}
            lines.append(
                f"| `{k.get('kernel')}` | {k.get('category')} "
                f"| {_f(k.get('ms_per_step'))} "
                f"| {_f(k.get('pct_of_step'), '.1f')} "
                f"| {rf.get('bound', '')} |")
        lines.append("")

    top_compilers = (report.get("compiles") or {}).get("by_executable")
    if top_compilers:
        lines.append("| top compilers (executable) | compiles | s |")
        lines.append("|---|---|---|")
        for c in top_compilers:
            lines.append(f"| `{c.get('name')}` | {_i(c.get('count'))} "
                         f"| {_f(c.get('seconds'), '.3f')} |")
        lines.append("")

    sweeps = report.get("sweep_layers") or []
    if sweeps:
        lines.append("| sweep layer | methods | best method | best auc |")
        lines.append("|---|---|---|---|")
        for s in sweeps:
            methods = s.get("methods") or {}
            best = None
            if methods:
                best = min(methods.items(),
                           key=lambda kv: kv[1].get("auc_mean", float("inf")))
            lines.append(
                f"| {s.get('layer')} | {len(methods)} "
                f"| {best[0] if best else ''} "
                f"| {_f(best[1].get('auc_mean')) if best else ''} |")
        lines.append("")
    if not rounds and not epochs and not sweeps and not serve \
            and not sc_serve and not kernels and not fronts:
        lines.append("(no ledger records)")
    return "\n".join(lines)


def _f(v, fmt: str = ".4f") -> str:
    if v is None:
        return ""
    try:
        return format(float(v), fmt)
    except (TypeError, ValueError):
        return str(v)


def _i(v) -> str:
    return "" if v is None else str(int(v))


# -- diff --------------------------------------------------------------------


def _rounds_by_label(report: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Rounds keyed by a stable label: the target name, with a ``#k``
    suffix from the second occurrence on (iterative schedules), and a
    ``<trial_id>/`` prefix when the record carries a campaign trial
    stamp — concurrent trials' same-named rounds in one shared obs dir
    must diff trial-for-trial, never cross-match."""
    out: Dict[str, Dict[str, Any]] = {}
    seen: Dict[str, int] = {}
    for r in (report.get("rounds") or []):
        target = str(r.get("target"))
        if r.get("trial_id"):
            target = f"{r['trial_id']}/{target}"
        k = seen.get(target, 0)
        seen[target] = k + 1
        out[target if k == 0 else f"{target}#{k}"] = r
    return out


def diff_runs(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Structured diff of two run reports: run-level scalar deltas,
    per-round deltas matched by target, and round-set changes."""
    sa, sb = _scalars_of(a), _scalars_of(b)
    scalars: Dict[str, Any] = {}
    dynamic = [k for k in {**sa, **sb} if k not in _SCALARS]
    for name in list(_SCALARS) + sorted(dynamic):
        va, vb = sa.get(name), sb.get(name)
        if va is None and vb is None:
            continue
        entry: Dict[str, Any] = {"a": va, "b": vb}
        if va is not None and vb is not None:
            entry["delta"] = vb - va
            entry["pct"] = (100.0 * (vb - va) / abs(va)
                            if abs(va) > _EPS else None)
        else:
            # present in only one run (a pre-kernel-era baseline, a
            # train run diffed against a serve run): informational, not
            # an error — gates on it skip unless they set "require"
            entry["note"] = ("not comparable (only in "
                             + ("A" if vb is None else "B") + ")")
        scalars[name] = entry

    # rounds matched by target AND per-target occurrence order, so an
    # iterative schedule (same layer pruned in several rounds) pairs
    # round-for-round; labels stay the bare target for the common
    # one-round-per-layer case and gain a #k suffix on repeats
    ra = _rounds_by_label(a)
    rb = _rounds_by_label(b)
    rounds: Dict[str, Any] = {}
    for target in ra:
        if target not in rb:
            continue
        pa, pb = ra[target], rb[target]
        entry = {}
        for which in ("pre", "post"):
            aa = (pa.get(which) or {}).get("acc")
            bb = (pb.get(which) or {}).get("acc")
            if aa is not None and bb is not None:
                entry[f"{which}_acc_delta"] = bb - aa
        for key in ("n_dropped", "params"):
            if pa.get(key) is not None and pb.get(key) is not None:
                entry[f"{key}_delta"] = pb[key] - pa[key]
        da = pa.get("score_dist") or {}
        db = pb.get("score_dist") or {}
        if da.get("p50") is not None and db.get("p50") is not None:
            span = abs(da.get("p99", 0) - da.get("p1", 0))
            entry["score_p50_drift"] = (
                abs(db["p50"] - da["p50"]) / (span + _EPS))
        if da.get("margin") is not None and db.get("margin") is not None:
            entry["margin_delta"] = db["margin"] - da["margin"]
        rounds[target] = entry
    return {
        "scalars": scalars,
        "rounds": rounds,
        "missing_rounds": sorted(t for t in ra if t not in rb),
        "added_rounds": sorted(t for t in rb if t not in ra),
    }


def format_diff(d: Dict[str, Any]) -> str:
    lines = ["# obs diff (B vs A)", ""]
    if d["scalars"]:
        lines.append("| metric | A | B | Δ | Δ% |")
        lines.append("|---|---|---|---|---|")
        for name, e in d["scalars"].items():
            pct = e.get("pct")
            delta = _f(e.get("delta"), "+.6g") \
                if e.get("delta") is not None else (e.get("note") or "")
            lines.append(
                f"| {name} | {_f(e.get('a'), '.6g')} "
                f"| {_f(e.get('b'), '.6g')} "
                f"| {delta} "
                f"| {_f(pct, '+.1f') + '%' if pct is not None else ''} |")
        lines.append("")
    if d["rounds"]:
        lines.append("| round target | Δpre acc | Δpost acc "
                     "| Δdropped | p50 drift |")
        lines.append("|---|---|---|---|---|")
        for target, e in d["rounds"].items():
            lines.append(
                f"| {target} | {_f(e.get('pre_acc_delta'), '+.4f')} "
                f"| {_f(e.get('post_acc_delta'), '+.4f')} "
                f"| {_i(e.get('n_dropped_delta')) or '0'} "
                f"| {_f(e.get('score_p50_drift'), '.3f')} |")
        lines.append("")
    if d["missing_rounds"]:
        lines.append(f"rounds missing in B: {', '.join(d['missing_rounds'])}")
    if d["added_rounds"]:
        lines.append(f"rounds only in B: {', '.join(d['added_rounds'])}")
    return "\n".join(lines)


# -- gates -------------------------------------------------------------------


def check_gates(d: Dict[str, Any],
                gates: Dict[str, Dict[str, float]]) -> List[Dict[str, Any]]:
    """Evaluate a gate file against a diff; returns violation dicts
    (empty = pass).  See module docstring for the format."""
    violations: List[Dict[str, Any]] = []

    def fail(gate, detail, value=None, limit=None):
        violations.append({"gate": gate, "detail": detail,
                           "value": value, "limit": limit})

    for gate, spec in gates.items():
        if not isinstance(spec, dict):
            fail(gate, f"malformed gate spec {spec!r}")
            continue
        if gate in _SCALARS or gate.startswith(_DYNAMIC_SCALAR_PREFIXES) \
                or gate in _DYNAMIC_EXTRA:
            e = d["scalars"].get(gate)
            if e is None or e.get("delta") is None:
                # absent on one side: only fail when the gate demands
                # presence (a CPU run has no MFU; gating it would make
                # every CPU diff red)
                if spec.get("require", False):
                    fail(gate, "metric absent from one or both runs")
                elif e is None and gate not in _SCALARS \
                        and not spec.get("optional", False):
                    # a DYNAMIC gate naming a metric NEITHER run has is
                    # almost certainly a typo (kernel_dto_ms) — the
                    # unknown-gate invariant must hold for these too;
                    # "optional": true opts a speculative gate out
                    fail(gate, "names a metric absent from both runs "
                               "(typo? set \"optional\": true if this "
                               "kernel may legitimately be missing)")
                continue
            delta, pct = e["delta"], e.get("pct")
            if "max_increase" in spec and delta > spec["max_increase"]:
                fail(gate, f"increased by {delta:.6g} "
                           f"(limit {spec['max_increase']:.6g})",
                     delta, spec["max_increase"])
            if "max_decrease" in spec and -delta > spec["max_decrease"]:
                fail(gate, f"decreased by {-delta:.6g} "
                           f"(limit {spec['max_decrease']:.6g})",
                     -delta, spec["max_decrease"])
            if "max_increase_pct" in spec and pct is not None \
                    and pct > spec["max_increase_pct"]:
                fail(gate, f"increased {pct:.1f}% "
                           f"(limit {spec['max_increase_pct']:.1f}%)",
                     pct, spec["max_increase_pct"])
            if "max_decrease_pct" in spec and pct is not None \
                    and -pct > spec["max_decrease_pct"]:
                fail(gate, f"decreased {-pct:.1f}% "
                           f"(limit {spec['max_decrease_pct']:.1f}%)",
                     -pct, spec["max_decrease_pct"])
        elif gate in ("round_pre_acc", "round_post_acc"):
            key = gate.replace("round_", "") + "_delta"
            lim = spec.get("max_decrease")
            for target, e in d["rounds"].items():
                delta = e.get(key)
                if lim is not None and delta is not None and -delta > lim:
                    fail(gate, f"{target}: accuracy fell {-delta:.4f} "
                               f"(limit {lim:.4f})", -delta, lim)
        elif gate == "score_p50_drift":
            lim = spec.get("max")
            for target, e in d["rounds"].items():
                drift = e.get("score_p50_drift")
                if lim is not None and drift is not None and drift > lim:
                    fail(gate, f"{target}: score p50 drifted "
                               f"{drift:.3f}× the A-run score span "
                               f"(limit {lim})", drift, lim)
        elif gate in ("missing_rounds", "added_rounds"):
            lim = spec.get("max", 0)
            n = len(d[gate])
            if n > lim:
                fail(gate, f"{n} {gate.replace('_', ' ')} "
                           f"({', '.join(d[gate])}; limit {lim})", n, lim)
        else:
            fail(gate, "unknown gate name (typos must not silently "
                       "disable a gate)")
    return violations


# -- CLI ---------------------------------------------------------------------


def obs_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch obs",
        description="render / diff / gate run ledgers (obs report, "
                    "obs diff)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("report", help="render one run's ledger")
    pr.add_argument("dir", help="obs dir (report.json / ledger.jsonl) "
                                "or a report.json file")
    pr.add_argument("--json", action="store_true",
                    help="emit the raw report JSON instead of markdown")
    pr.add_argument("--md", metavar="PATH",
                    help="additionally write the markdown table to PATH")
    pd = sub.add_parser("diff", help="diff two runs (B vs A)")
    pd.add_argument("dir_a")
    pd.add_argument("dir_b")
    pd.add_argument("--gate", metavar="PATH",
                    help="tolerances JSON; exit 1 naming each violated "
                         "gate")
    pd.add_argument("--json", action="store_true",
                    help="emit the raw diff JSON instead of markdown")
    pp = sub.add_parser(
        "profile",
        help="render a run's per-kernel profile (capture windows -> "
             "ranked op table, roofline positions, HBM watermarks)")
    pp.add_argument("dir", help="obs dir (profile.json / profile/ "
                                "windows) or a profile.json/report.json "
                                "file")
    pp.add_argument("--top", type=int, default=25)
    pp.add_argument("--json", action="store_true",
                    help="emit the raw profile JSON instead of markdown")
    pw = sub.add_parser(
        "watch",
        help="live terminal view of a run's windowed metric "
             "time-series (metrics_ts.jsonl — obs.timeseries): newest "
             "window's histogram percentiles, counter rates, gauges")
    pw.add_argument("dir", help="obs dir being written by a live run "
                                "(or a finished one)")
    pw.add_argument("--interval", type=float, default=2.0,
                    help="redraw cadence, seconds")
    pw.add_argument("--once", action="store_true",
                    help="render one frame and exit (CI smoke)")
    pi = sub.add_parser(
        "incident",
        help="postmortem timeline: ledgered (or offline-reconstructed) "
             "incidents with ranked root-cause suspects, anomaly "
             "windows, gauge deltas, and slowest-request exemplars "
             "(obs.anomaly + obs.incident; exits 1 on an unexplained "
             "SLO burn)")
    pi.add_argument("dir", help="obs dir (single run or fleet router "
                                "dir with metrics_ts_fleet.jsonl)")
    pi.add_argument("--lookback", type=float, default=0.0,
                    help="correlation horizon in seconds (default: "
                         "TORCHPRUNER_INCIDENT_LOOKBACK_S or 120)")
    pi.add_argument("--json", action="store_true",
                    help="emit the raw incident/anomaly JSON instead "
                         "of the markdown postmortem")
    args = p.parse_args(argv)

    if args.cmd == "incident":
        from torchpruner_tpu_torch.obs.incident import incident_main

        return incident_main(args)

    if args.cmd == "watch":
        from torchpruner_tpu_torch.obs.timeseries import watch as ts_watch

        return ts_watch(args.dir, interval_s=args.interval,
                        once=args.once)

    if args.cmd == "profile":
        from torchpruner_tpu_torch.obs.profile import format_profile, load_profile

        profile = load_profile(args.dir)
        if profile is None:
            print(f"{args.dir!r} holds no profile.json and no "
                  "profile/window_* captures — run with "
                  "--profile-every/--profile-steps (or POST /profile "
                  "on the serve frontend) to capture one",
                  file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(profile))
        else:
            print(format_profile(profile, top=args.top))
        return 0

    if args.cmd == "report":
        try:
            report = load_run(args.dir)
        except FileNotFoundError as e:
            print(str(e), file=sys.stderr)
            return 2
        text = format_report(report)
        if args.json:
            report.pop("_dir", None)
            print(json.dumps(report))
        else:
            print(text)
        if args.md:
            with open(args.md, "w") as f:
                f.write(text + "\n")
        return 0

    try:
        a, b = load_run(args.dir_a), load_run(args.dir_b)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    d = diff_runs(a, b)
    if args.json:
        print(json.dumps(d))
    else:
        print(format_diff(d))
    if args.gate:
        with open(args.gate) as f:
            gates = json.load(f)
        violations = check_gates(d, gates)
        for v in violations:
            print(f"GATE VIOLATION [{v['gate']}]: {v['detail']}",
                  file=sys.stderr)
        if violations:
            return 1
        print(f"gates OK ({len(gates)} checked)", file=sys.stderr)
    return 0


def newest_report(results_dir: str, match: str = "") -> Optional[str]:
    """Newest committed ``obs_report_*<match>*.json`` in ``results_dir``
    by name order (names embed dates, and mtime is meaningless after a
    checkout) — what bench auto-diffs a fresh run against."""
    import glob as _glob

    pattern = os.path.join(results_dir, f"obs_report_*{match}*.json")
    candidates = sorted(_glob.glob(pattern))
    return candidates[-1] if candidates else None


if __name__ == "__main__":
    sys.exit(obs_main())
