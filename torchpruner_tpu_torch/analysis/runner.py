"""The static analyzer's driver: run every pass the port has over one
experiment config.
(The port of ``torchpruner_tpu/analysis/runner.py``.)

``lint_config`` resolves the config's model from the experiment
registry and runs

1. **plan lint** over every prune group the static graph derives
   (``analysis/plan_lint.py``),
2. **sharding lint** for configs with a mesh — the config's own
   mesh/partition/fraction/bucket, simulated over the config's filtered
   targets (``analysis/sharding_lint.py``); explicit ``plans`` are
   matched back to their graph groups and linted under the same mesh,
6. **host lint** — the AST scan of the port's threaded host code
   (``analysis/host_lint.py``),

merges the findings under the active severity config, and returns a
:class:`~torchpruner_tpu_torch.analysis.findings.LintReport`.  Passes 1
and 2 are shape arithmetic over ``meta`` trees (no parameter byte, no
device).  The JAX package's passes 3-5 (jaxpr hazards, collective
contracts, the cost model) read XLA programs the port does not build;
``lint_config`` has no switch for them (ROADMAP §C).
"""

from __future__ import annotations

from torchpruner_tpu_torch.analysis.findings import LintReport, merge_reports
from torchpruner_tpu_torch.analysis.plan_lint import (
    abstract_trees,
    lint_model_plans,
    lint_plan,
)
from torchpruner_tpu_torch.analysis.sharding_lint import lint_sharding
from torchpruner_tpu_torch.utils.config import ExperimentConfig


def _match_plan_targets(model, plans) -> tuple:
    """``(matched_targets, unmatched_count)`` — each explicit plan
    matched back to the graph group that produces it (PrunePlan equality
    against ``plan_for_group``), so the sharding pass can simulate the
    prune the plan actually describes."""
    from torchpruner_tpu_torch.core.graph import pruning_graph
    from torchpruner_tpu_torch.core.pruner import plan_for_group

    by_plan = {}
    for g in pruning_graph(model):
        try:
            by_plan[plan_for_group(model, g)] = g.target
        except Exception:  # noqa: BLE001 — unmatchable group, skip
            continue
    matched = [by_plan[p] for p in plans if p in by_plan]
    return matched, len(plans) - len(matched)


def lint_config(
    cfg: ExperimentConfig,
    *,
    model=None,
    plans=None,
    host: bool = True,
) -> LintReport:
    """The lint run for one config.

    ``model`` may be injected (tests / custom zoos); ``plans`` (explicit
    :class:`~torchpruner_tpu_torch.core.plan.PrunePlan` objects) are
    linted INSTEAD of the graph-derived groups when given — the entry
    point for validating hand-written or deserialized plans.  The
    sharding pass simulates the CONFIG's sweep (its targets / fraction /
    bucket); with explicit ``plans`` it simulates exactly the plans' own
    targets (matched back to their graph groups) under the config mesh.
    It is skipped when the plan pass already found errors (a broken
    plan cannot be simulated).  ``host=False`` skips pass 6.
    """
    from torchpruner_tpu_torch.core.graph import pruning_graph
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        MODEL_REGISTRY,
        compute_dtype,
        filter_targets,
        make_optimizer,
    )

    if model is None:
        model_fn, _ = MODEL_REGISTRY[cfg.model]
        model = model_fn()

    findings: list = []

    # -- pass 1: plan lint ------------------------------------------------
    if plans is not None:
        params, state = abstract_trees(model)
        for plan in plans:
            findings += lint_plan(plan, params, state)
    else:
        findings += lint_model_plans(model)

    # -- pass 2: sharding lint (mesh configs only; skipped when the plan
    # pass already errored — a broken plan cannot be simulated) -----------
    plan_errors = any(f.severity == "error" for f in findings)
    if cfg.mesh and not plan_errors:
        from torchpruner_tpu_torch.analysis.findings import Finding

        if plans is None:
            targets = filter_targets(
                [g.target for g in pruning_graph(model)], cfg
            )
        else:
            targets, unmatched = _match_plan_targets(model, plans)
            if unmatched:
                findings.append(Finding(
                    "info", "sharding", "sharding/plan-unmatched",
                    "<plans>",
                    f"{unmatched} explicit plan(s) match no current "
                    f"graph group (stale serialization or a custom "
                    f"surgery path) — the sharding pass simulates only "
                    f"the {len(targets)} matched target(s)",
                ))
        fraction = cfg.fraction if cfg.policy == "fraction" else 0.5
        if cfg.policy != "fraction":
            findings.append(Finding(
                "info", "sharding", "sharding/fraction-stand-in",
                "<policy>",
                f"policy {cfg.policy!r} picks drop counts from scores "
                f"at runtime, which abstract evaluation cannot know — "
                f"the sharding pass simulates a fraction={fraction} "
                f"stand-in prune; divisibility findings below describe "
                f"THAT width, not necessarily the runtime one",
            ))
        if targets:
            data = cfg.mesh.get("data", 1)
            findings += lint_sharding(
                model, dict(cfg.mesh), partition=cfg.partition,
                targets=targets, fraction=fraction, bucket=cfg.bucket,
                tx=make_optimizer(cfg),
                batch_per_chip=max(1, cfg.batch_size // max(1, data)),
                compute_dtype=compute_dtype(cfg.compute_dtype),
                remat=cfg.remat, zero=cfg.zero,
            )

    # -- pass 6: host-side concurrency & durability lint (pure AST over
    # the serving-plane packages; mtime-cached) ---------------------------
    if host:
        from torchpruner_tpu_torch.analysis import host_lint

        hfindings = host_lint.lint_host(plant=host_lint.env_plant())
        host_lint.record_gauges(hfindings)
        findings += hfindings

    return merge_reports(cfg.name, findings)


def lint_preset(name: str, smoke: bool = False, **kw) -> LintReport:
    """``lint_config`` over a named preset."""
    from torchpruner_tpu_torch.experiments.presets import get_preset

    return lint_config(get_preset(name, smoke=smoke), **kw)
