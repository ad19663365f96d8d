"""Pre-pricing: staged static gates over a campaign's trial candidates.
(The port of ``torchpruner_tpu/search/pricing.py``: the same stages,
gates, reasons and queue-order inputs; the cost stage's step time is a
roofline from the port's own counts.)

Price every candidate before running anything, cheapest check first,
and make every exclusion loud — an excluded candidate stays in the
campaign manifest and the frontier artifact with its reasons, never
silently dropped.

Stages (each fills the candidate's pricing record and may exclude):

1. ``config`` — pure validation: the overrides must build a valid
   ``ExperimentConfig``; fractions must be in ``[0, 1)``; every
   ``layer_fractions`` key must match a prunable target.
2. ``hbm`` — pure shape math: the predicted per-device memory watermark
   (``utils.flops.predicted_hbm_bytes_per_chip`` — the dense model, an
   upper bound for every later round) against ``hbm_headroom`` of
   ``utils.flops.hbm_capacity()`` (``TORCHPRUNER_PLAN_HBM_BYTES``
   overrides).
3. ``cost`` — a train-step roofline per DISTINCT program shape (shared
   across every trial that differs only in method / fraction / LR):
   ``3 x`` the forward FLOPs ``model_cost`` counts at the trial's
   per-device batch over the FLOP rate, against the bytes
   ``training_memory`` plans for the step over the bandwidth
   (``utils.flops.train_step_roofline``), at the chip-less
   ``CPU_COST_DEFAULTS`` (the driver holds no device).  Predicted step
   time x steps/epoch x finetune epochs x prune rounds = the predicted
   trial wall, gated absolutely (``max_trial_predicted_s``) and
   relative to the candidate set's median (``max_trial_cost_ratio``).
   The JAX package reads the same number off XLA's cost analysis of a
   compiled train step; the port's milliseconds differ from XLA's, its
   decisions (which candidate, which stage, which reason, which queue
   order) do not (ROADMAP C2z).

The surviving candidates' ``predicted_step_ms`` / ``predicted_trial_s``
also seed the driver's deterministic queue order (cheapest first) and
land as gauges in each trial's report.json.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional, Tuple

from torchpruner_tpu_torch.search.grid import CampaignSpec, TrialSpec

#: shared predictions across the candidate set, keyed by the fields that
#: change the train step's shape/placement (method/fraction/LR don't)
_PROGRAM_KEY_FIELDS = ("model", "batch_size", "accum_steps", "partition",
                       "zero", "compute_dtype", "remat", "optimizer")

#: the largest model whose forward FLOPs pricing counts on the host (the
#: count runs one forward on the CPU); above it the cost stage records a
#: note and skips, as the JAX package's compile budget does
PRICING_PARAM_BUDGET = 2 ** 28


def _program_key(cfg) -> Tuple:
    return tuple(getattr(cfg, f) for f in _PROGRAM_KEY_FIELDS) \
        + (tuple(sorted((cfg.mesh or {}).items())),)


def _batch_per_chip(cfg) -> int:
    data = max(1, (cfg.mesh or {}).get("data", 1))
    return max(1, cfg.batch_size // data // max(1, cfg.accum_steps))


def _predict_step_ms(cfg, model, watermark: int,
                     cache: Dict[Tuple, Any]) -> Optional[Dict]:
    """Roofline prediction for the trial's train step (cached across
    candidates sharing the program shape).  A model over the pricing
    budget, or a forward that fails to count, gives ``{"error"}`` — the
    gate then skips rather than excludes (absence of a prediction is
    not evidence of cost)."""
    key = _program_key(cfg)
    if key in cache:
        return cache[key]
    try:
        from torchpruner_tpu_torch.core.segment import init_model
        from torchpruner_tpu_torch.utils.flops import (
            model_cost,
            train_step_roofline,
        )

        n = sum(_numel(v) for v in model.param_shapes().values())
        if n > PRICING_PARAM_BUDGET:
            raise ValueError(f"{n} params exceed the pricing budget "
                             f"({PRICING_PARAM_BUDGET})")
        params, state = init_model(model, seed=0, device="cpu")
        _, flops = model_cost(model, params, state,
                              batch_size=_batch_per_chip(cfg))
        if not flops:
            raise ValueError("the forward counted no FLOPs")
        p = train_step_roofline(flops, watermark)
        pred = {"step_ms": p["step_ms"], "comm_ms": p["comm_ms"],
                "bound": p["bound"], "device_kind": p["device_kind"]}
    except Exception as e:  # noqa: BLE001 — fault-isolated pricing
        pred = {"error": f"{type(e).__name__}: {e}"}
    cache[key] = pred
    return pred


def _numel(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_numel(v) for v in shapes.values())
    n = 1
    for d in shapes:
        n *= int(d)
    return n


def _steps_per_epoch(cfg, cache: Dict[str, int]) -> int:
    """Optimizer steps per retrain epoch — dataset length over batch
    (dataset lengths cached; the campaign's trials share a base)."""
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        MODEL_REGISTRY,
    )

    ds = cfg.dataset if cfg.dataset != "synthetic" \
        else MODEL_REGISTRY[cfg.model][1]
    if ds not in cache:
        from torchpruner_tpu_torch.data import load_dataset

        cache[ds] = len(load_dataset(ds, "train", seed=cfg.seed))
    return max(1, cache[ds] // max(1, cfg.batch_size))


def price_campaign(spec: CampaignSpec, trials: List[TrialSpec],
                   campaign_dir: str) -> Dict[str, Dict[str, Any]]:
    """Run the staged gates over every trial; returns
    ``{trial_id: pricing}`` where pricing carries ``feasible``,
    ``excluded_by`` (None | "config" | "hbm" | "cost"), ``reasons``,
    and the predicted numbers the driver's queue order and the trial
    workers' gauges reuse."""
    import os

    from torchpruner_tpu_torch.core.graph import pruning_graph
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        MODEL_REGISTRY,
        compute_dtype,
        filter_targets,
        make_optimizer,
    )
    from torchpruner_tpu_torch.utils.flops import (
        hbm_capacity,
        predicted_hbm_bytes_per_chip,
    )

    out: Dict[str, Dict[str, Any]] = {}
    base = spec.base_config()
    model = MODEL_REGISTRY[base.model][0]()
    all_targets = [g.target for g in pruning_graph(model)]
    hbm_budget = hbm_capacity()
    program_cache: Dict[Tuple, Any] = {}
    spe_cache: Dict[str, int] = {}

    for trial in trials:
        pricing: Dict[str, Any] = {"feasible": False, "excluded_by": None,
                                   "reasons": []}
        out[trial.trial_id] = pricing

        def exclude(stage: str, reason: str, p=pricing):
            p["excluded_by"] = p["excluded_by"] or stage
            p["reasons"].append(reason)

        # -- stage 1: config validity -----------------------------------
        try:
            cfg = spec.trial_config(
                trial, os.path.join(campaign_dir, "trials",
                                    trial.trial_id))
        except Exception as e:  # noqa: BLE001 — invalid override = data
            exclude("config", f"invalid config: {type(e).__name__}: {e}")
            continue
        targets = filter_targets(all_targets, cfg)
        if not targets:
            exclude("config",
                    f"target_filter {cfg.target_filter} matches no "
                    f"prunable target of {cfg.model} ({all_targets})")
            continue
        # layer_fractions are validated by ExperimentConfig itself; the
        # bare `fraction` field is not, and a null/non-numeric override
        # must exclude THIS candidate loudly, never crash the campaign
        try:
            fracs = {"fraction": cfg.fraction, **cfg.layer_fractions}
            bad = {k: v for k, v in fracs.items()
                   if not 0.0 <= float(v) < 1.0}
        except (TypeError, ValueError):
            exclude("config",
                    f"non-numeric prune fraction: {cfg.fraction!r}")
            continue
        if bad and cfg.policy == "fraction":
            exclude("config",
                    f"prune fraction(s) outside [0, 1): {bad}")
            continue
        dead = [k for k in cfg.layer_fractions
                if not any(k in t for t in targets)]
        if dead:
            exclude("config",
                    f"layer_fractions key(s) {dead} match no prunable "
                    f"target ({targets}) — the override would never "
                    f"apply")
            continue
        pricing["n_rounds"] = len(targets)

        # -- stage 2: predicted memory watermark (pure shape math) -------
        try:
            watermark = predicted_hbm_bytes_per_chip(
                model, cfg.mesh or {},
                partition=cfg.partition, zero=cfg.zero,
                tx=make_optimizer(cfg),
                batch_per_chip=_batch_per_chip(cfg),
                compute_dtype=compute_dtype(cfg.compute_dtype),
                remat=cfg.remat,
            )
            pricing["predicted_hbm_bytes_per_chip"] = int(watermark)
            pricing["hbm_budget_bytes"] = int(hbm_budget)
            if watermark > hbm_budget * spec.hbm_headroom:
                exclude(
                    "hbm",
                    f"predicted HBM watermark "
                    f"{watermark / 2**30:.3f} GiB/chip exceeds "
                    f"{100 * spec.hbm_headroom:.0f}% of the "
                    f"{hbm_budget / 2**30:.2f} GiB budget")
                continue
        except Exception as e:  # noqa: BLE001
            exclude("hbm", f"HBM pricing failed: {type(e).__name__}: {e}")
            continue

        # -- stage 3a: roofline step time (shared across the set) --------
        pred = _predict_step_ms(cfg, model, watermark, program_cache)
        if pred and "step_ms" in pred:
            spe = _steps_per_epoch(cfg, spe_cache)
            pricing.update({
                "predicted_step_ms": pred["step_ms"],
                "predicted_comm_ms": pred["comm_ms"],
                "bound": pred["bound"],
                "steps_per_epoch": spe,
                "predicted_trial_s": (
                    pred["step_ms"] / 1e3 * spe
                    * max(1, cfg.finetune_epochs) * len(targets)),
            })
        elif pred and "error" in pred:
            pricing["cost_note"] = pred["error"]
        pricing["feasible"] = True  # provisional: the ratio gate below
        # still sees the whole candidate set

    # -- stage 3b: trial-cost gates (need the whole set for the median) --
    costs = [p["predicted_trial_s"] for p in out.values()
             if p.get("predicted_trial_s") is not None]
    median = statistics.median(costs) if costs else None
    for tid, pricing in out.items():
        if pricing["excluded_by"] or "predicted_trial_s" not in pricing:
            continue
        cost = pricing["predicted_trial_s"]
        if spec.max_trial_predicted_s is not None \
                and cost > spec.max_trial_predicted_s:
            pricing["feasible"] = False
            pricing["excluded_by"] = "cost"
            pricing["reasons"].append(
                f"predicted trial wall {cost:.1f}s exceeds the "
                f"{spec.max_trial_predicted_s:.1f}s budget "
                f"(predicted {pricing['predicted_step_ms']:.3f} ms/step "
                f"x {pricing['steps_per_epoch']} steps/epoch x "
                f"{pricing['n_rounds']} round(s))")
        if spec.max_trial_cost_ratio is not None and median \
                and cost > spec.max_trial_cost_ratio * median:
            pricing["feasible"] = False
            pricing["excluded_by"] = pricing["excluded_by"] or "cost"
            pricing["reasons"].append(
                f"predicted trial wall {cost:.1f}s is "
                f"{cost / median:.0f}x the candidate-set median "
                f"({median:.1f}s; limit "
                f"{spec.max_trial_cost_ratio:.0f}x)")
    return out


def format_exclusions(pricing: Dict[str, Dict[str, Any]]) -> str:
    """The loud per-candidate exclusion list — printed by the driver."""
    lines = []
    for tid, p in pricing.items():
        if p["excluded_by"]:
            lines.append(f"- `{tid}` [{p['excluded_by']}]: "
                         + "; ".join(p["reasons"]))
    return "\n".join(lines)
