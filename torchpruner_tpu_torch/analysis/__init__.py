"""Static analysis for prune plans, sharding specs and the host code —
the port of ``torchpruner_tpu/analysis/``, the passes that have a torch
meaning.

Every pass here is decidable from shapes alone or from the source text:

- pass 1, plan lint (``plan_lint.py``): a plan checked against ``meta``
  tensor trees built from the model's shapes — zero parameter bytes;
- pass 2, sharding lint (``sharding_lint.py``): the real ``apply_plan``
  over ``meta`` trees and the real placement rules
  (``parallel/sharding.py``) over a ``{axis: size}`` mesh, then the
  per-rank memory plan (``parallel/memory.py``);
- pass 6, host lint (``host_lint.py``): a pure-stdlib AST scan of the
  threaded host code for unlocked shared writes, blocking work under a
  lock, lock-order cycles, torn durable writes, daemon leaks and wall
  clocks in digests, with a committed reason-carrying waiver file.

The JAX package's passes 3-5 (jaxpr hazards, collective contracts, the
cost model) and its placement planner read XLA programs; the port
builds none, so they are not here (ROADMAP §C).

The analyzer runs as a library (:func:`lint_config` /
:func:`lint_preset`), from the CLI (``python -m torchpruner_tpu_torch
--lint PRESET``, ``lint-host``), and as a pre-flight inside
``core.plan.apply_plan`` (raising ``PlanError`` on error findings).
Findings are :class:`Finding` records with an error/warning/info split,
re-gradeable per check through :data:`severity_config`.
"""

from torchpruner_tpu_torch.analysis.findings import (
    Finding,
    LintReport,
    SeverityConfig,
    active_severity,
    merge_reports,
    severity_config,
)
from torchpruner_tpu_torch.analysis.host_lint import (
    host_lint_default_paths,
    lint_host,
    scan_source,
)
from torchpruner_tpu_torch.analysis.plan_lint import (
    abstract_trees,
    lint_group,
    lint_model_plans,
    lint_plan,
)
from torchpruner_tpu_torch.analysis.runner import lint_config, lint_preset
from torchpruner_tpu_torch.analysis.sharding_lint import (
    lint_sharding,
    simulate_prune,
)

__all__ = [
    "Finding", "LintReport", "SeverityConfig", "severity_config",
    "active_severity", "merge_reports",
    "lint_plan", "lint_group", "lint_model_plans", "abstract_trees",
    "lint_sharding", "simulate_prune",
    "lint_host", "host_lint_default_paths", "scan_source",
    "lint_config", "lint_preset",
]
