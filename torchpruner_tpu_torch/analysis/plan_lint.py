"""Pass 1 — plan lint: validate PruneGroups/PrunePlans against the real
tree shapes, without materializing a parameter.
(The port of ``torchpruner_tpu/analysis/plan_lint.py``: the same checks,
severities and messages.)

The param/state trees a plan is checked against are ``meta`` tensors
built from the model's own shapes (``SegmentedModel.param_shapes`` and
``core.layers.state_shapes``) — no bytes and no generator draw,
where the JAX package runs ``model.init`` under ``jax.eval_shape``.
Checks, per slice:

- the tree path resolves in the named collection (missing optional
  slices — a bias under ``use_bias=False`` — are legitimate and skipped);
- the axis is in range for the resolved tensor's rank;
- ``fan_out`` divides the axis length;
- the surviving-unit count implied by the axis (``shape[axis] / fan_out``)
  equals the plan's ``n_units``;
- no two slices claim the same ``(collection, path, axis)``.

Group-level lint additionally resolves the group's layer names against
the model spec (unknown layer / unprunable target) before the plan is
even built.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Set, Tuple

import torch

from torchpruner_tpu_torch.analysis.findings import Finding
from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.plan import Path, PruneGroup, PrunePlan

PASS = "plan"

META = torch.device("meta")


def path_str(path: Path) -> str:
    return "/".join(str(k) for k in path)


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(tuple(shapes), device=META)


def abstract_trees(model) -> Tuple[Any, Any]:
    """``(params, state)`` as ``meta`` tensor trees — the shapes a plan
    is validated against, without a byte of parameter or a generator
    draw."""
    params = _meta_tree(model.param_shapes())
    state = {}
    for spec, (in_shape, _) in zip(model.layers, model.shapes):
        s = L.state_shapes(spec, in_shape)
        if s:
            state[spec.name] = _meta_tree(s)
    return params, state


def _resolve(tree, path: Path):
    node = tree
    for k in path:
        node = node[k]
    return node


def lint_plan(plan: PrunePlan, params, state=None) -> List[Finding]:
    """Findings for one resolved plan against params/state trees (real
    or ``meta`` tensors — only ``.shape`` is read)."""
    findings: List[Finding] = []
    seen: Set[Tuple[str, Tuple[str, ...], int]] = set()
    if plan.n_units <= 0:
        findings.append(Finding(
            "error", PASS, "plan/empty-plan", "<plan>",
            f"plan has n_units={plan.n_units}; nothing can be pruned",
        ))
        return findings

    for s in plan.slices:
        p = path_str(s.path)
        tree = params if s.collection == "params" else state
        if tree is None:
            if not s.optional:
                findings.append(Finding(
                    "error", PASS, "plan/missing-collection", p,
                    f"slice targets collection {s.collection!r}, but no "
                    f"such tree was provided",
                ))
            continue
        try:
            arr = _resolve(tree, s.path)
            shape = tuple(arr.shape)
        except (KeyError, IndexError, TypeError, AttributeError):
            if not s.optional:
                findings.append(Finding(
                    "error", PASS, "plan/missing-path", p,
                    f"path does not resolve in the {s.collection} tree",
                ))
            continue
        if not 0 <= s.axis < len(shape):
            findings.append(Finding(
                "error", PASS, "plan/axis-out-of-range", p,
                f"axis {s.axis} out of range for shape {shape}",
            ))
            continue
        key = (s.collection, tuple(str(k) for k in s.path), s.axis)
        if key in seen:
            findings.append(Finding(
                "error", PASS, "plan/overlapping-slices", p,
                f"two slices claim axis {s.axis} of the same array — "
                f"they would double-slice",
            ))
            continue
        seen.add(key)
        if s.fan_out <= 0 or shape[s.axis] % s.fan_out:
            findings.append(Finding(
                "error", PASS, "plan/fanout-indivisible", p,
                f"fan_out {s.fan_out} does not divide axis {s.axis} of "
                f"length {shape[s.axis]}",
            ))
            continue
        implied = shape[s.axis] // s.fan_out
        if implied != plan.n_units:
            findings.append(Finding(
                "error", PASS, "plan/unit-count-mismatch", p,
                f"axis {s.axis} of length {shape[s.axis]} / fan_out "
                f"{s.fan_out} implies {implied} units, but the plan "
                f"prunes a {plan.n_units}-unit producer",
            ))
    return findings


def lint_group(
    model, group: PruneGroup, params=None, state=None
) -> List[Finding]:
    """Resolve one group's layer names against the model, then lint the
    plan it implies.  ``params``/``state`` default to abstract trees."""
    from torchpruner_tpu_torch.core.pruner import plan_for_group

    findings: List[Finding] = []
    names = [("target", group.target)]
    names += [("attached norm", bn.layer) for bn in group.attached_bn]
    names += [("attached dropout", d) for d in group.attached_dropout]
    names += [("consumer", c.layer) for c in group.consumers]
    resolvable = True
    for role, name in names:
        try:
            model.layer(name)
        except KeyError:
            findings.append(Finding(
                "error", PASS, "plan/unknown-layer", name,
                f"group {role} names a layer the model does not have",
            ))
            resolvable = False
    if resolvable:
        try:
            L.n_units(model.layer(group.target))
        except TypeError:
            findings.append(Finding(
                "error", PASS, "plan/not-prunable", group.target,
                f"group target is a "
                f"{type(model.layer(group.target)).__name__}, which has "
                f"no prunable units",
            ))
            resolvable = False
    if not resolvable:
        return findings

    if params is None:
        params, state = abstract_trees(model)
    try:
        plan = plan_for_group(model, group)
    except (TypeError, KeyError) as e:
        findings.append(Finding(
            "error", PASS, "plan/unresolvable-group", group.target,
            f"group does not resolve to a plan: {e}",
        ))
        return findings
    return lint_plan(plan, params, state)


def lint_model_plans(
    model, targets: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Lint every prune group the static graph derives for ``model``
    (``targets`` restricts to those layer paths) — the per-model half of
    the preset sweep."""
    from torchpruner_tpu_torch.core.graph import pruning_graph

    params, state = abstract_trees(model)
    findings: List[Finding] = []
    wanted = set(targets) if targets is not None else None
    for g in pruning_graph(model, include_output=True):
        if wanted is not None and g.target not in wanted:
            continue
        findings += lint_group(model, g, params, state)
    return findings
