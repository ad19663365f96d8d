"""Pruning plans — declarative descriptions of structural surgery.

Counterpart of ``torchpruner_tpu/core/plan.py``:

- a :class:`ParamSlice` names one tensor (by tree path), the axis
  holding the unit dimension, and a ``fan_out`` factor for flattened
  consumers;
- a :class:`PruneGroup` bundles the slices implied by pruning one
  producer layer: its own out-params, attached norms/Dropout, and
  consumer in-params;
- :func:`apply_plan` executes the slices functionally (``index_select``)
  over nested-dict trees: params, the model state (BatchNorm running
  statistics, ``collection="state"``), and any optimizer state whose
  leaves mirror the params tree.  It first runs the plan-lint pass
  (``analysis/plan_lint.py``) over the given trees and raises
  :class:`PlanError` before a tensor is touched.

The axes mean the same thing as in the JAX package, so a plan applies
to either package's trees, and :func:`plan_to_dict` /
:func:`plan_from_dict` write and read the JAX package's JSON schema.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[Any, ...]  # keys into a nested-dict tree


class PlanError(ValueError):
    """A plan does not fit the trees it is being applied to.

    Raised by :func:`apply_plan`'s pre-flight — the plan-lint pass
    (``analysis/plan_lint.py``) run over the actual trees — so the
    message names the offending tree path, axis and check.
    ``findings`` carries the structured records."""

    def __init__(self, findings):
        self.findings = tuple(findings)
        super().__init__(
            "plan does not fit the provided trees:\n"
            + "\n".join("  " + f.format() for f in self.findings))


@dataclass(frozen=True)
class ParamSlice:
    """Slice one tensor along ``axis``, keeping the rows of surviving
    units.  ``fan_out > 1``: each producer unit ``u`` owns the strided
    positions ``{p * n_units + u}`` along the axis (a channels-last
    flatten).  ``collection`` selects the tree (``"params"`` or
    ``"state"``); an ``optional`` slice whose path is absent (a bias with
    ``use_bias=False``) is skipped."""

    path: Path
    axis: int
    fan_out: int = 1
    collection: str = "params"
    optional: bool = False


@dataclass(frozen=True)
class Consumer:
    """A downstream layer whose *input* units cascade from the target."""

    layer: str
    param: str = "w"
    axis: int = 0
    fan_out: int = 1


@dataclass(frozen=True)
class AttachedNorm:
    """A normalization layer sliced alongside the target."""

    layer: str
    fan_out: int = 1


@dataclass(frozen=True)
class PruneGroup:
    """Everything that must change when units of ``target`` are pruned."""

    target: str
    attached_bn: Tuple[AttachedNorm, ...] = ()
    attached_dropout: Tuple[str, ...] = ()
    consumers: Tuple[Consumer, ...] = ()


@dataclass(frozen=True)
class PrunePlan:
    """A fully-resolved set of slices for one prune step; ``slices`` all
    refer to unit indices in ``range(n_units)``."""

    n_units: int
    slices: Tuple[ParamSlice, ...]


def keep_indices(n_units: int, drop: Sequence[int]) -> np.ndarray:
    """Complement of ``drop`` in ``range(n_units)`` (sorted)."""
    mask = np.ones(n_units, dtype=bool)
    drop = np.unique(np.asarray(drop, dtype=np.int64))
    if drop.size:
        if drop.min() < 0 or drop.max() >= n_units:
            raise IndexError(
                f"drop indices out of range [0, {n_units}): {drop}")
        mask[drop] = False
    return np.arange(n_units)[mask]


def expand_keep(keep: np.ndarray, n_units: int, fan_out: int) -> np.ndarray:
    """Expand unit keep-indices through a fan-out map: kept positions are
    ``{p * n_units + u : p in range(fan_out), u in keep}``, ascending."""
    if fan_out == 1:
        return keep
    return (np.arange(fan_out)[:, None] * n_units
            + keep[None, :]).reshape(-1)


def _get_path(tree, path: Path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _set_path(tree, path: Path, value):
    """Functional set: a copy of ``tree`` with ``tree[path] = value``
    (nested dicts / lists / tuples; untouched leaves are shared)."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(tree, dict):
        new = dict(tree)
        new[k] = _set_path(tree[k], rest, value)
        return new
    if isinstance(tree, (list, tuple)):
        seq = list(tree)
        seq[k] = _set_path(seq[k], rest, value)
        return seq if isinstance(tree, list) else type(tree)(seq)
    raise TypeError(f"cannot set path {path} in {type(tree)}")


def _take(t: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    return t.index_select(axis, torch.as_tensor(idx, device=t.device))


def apply_plan(plan: PrunePlan, drop: Sequence[int], params, state=None,
               opt_state=None):
    """Execute a plan: slice every listed tensor, plus every optimizer
    state leaf that mirrors a sliced param (momentum, Adam moments).
    Returns ``(params', state', opt_state')``.

    Pre-flight: the plan-lint pass runs over the given trees first (it
    reads shapes only: no launch, no device synchronization), and any
    error-severity finding raises :class:`PlanError` naming the path,
    axis and check — before a single tensor is touched.  Severities
    follow ``analysis.severity_config``: a check downgraded below error
    (or ignored) there no longer raises here either."""
    from torchpruner_tpu_torch.analysis.findings import active_severity
    from torchpruner_tpu_torch.analysis.plan_lint import lint_plan

    problems = [f for f in lint_plan(plan, params, state)
                if active_severity(f.check, f.severity) == "error"]
    if problems:
        raise PlanError(problems)
    keep = keep_indices(plan.n_units, drop)
    # param path -> (axis, expanded keep, old shape), for the optimizer
    param_slices: Dict[Tuple[str, ...], Tuple[int, np.ndarray,
                                              Tuple[int, ...]]] = {}
    new_params, new_state = params, state
    for s in plan.slices:
        tree = new_params if s.collection == "params" else new_state
        if tree is None:
            continue  # optional slice (lint guarantees non-optional exist)
        try:
            arr = _get_path(tree, s.path)
        except (KeyError, IndexError, TypeError):
            continue  # e.g. bias absent (use_bias=False): optional
        idx = expand_keep(keep, plan.n_units, s.fan_out)
        sliced = _take(arr, idx, s.axis)
        if s.collection == "params":
            param_slices[tuple(str(k) for k in s.path)] = (
                s.axis, idx, tuple(arr.shape))
            new_params = _set_path(new_params, s.path, sliced)
        else:
            new_state = _set_path(new_state, s.path, sliced)
    new_opt_state = opt_state
    if opt_state is not None:
        new_opt_state = _slice_opt_state(opt_state, param_slices)
    return new_params, new_state, new_opt_state


def plan_to_dict(plan: PrunePlan) -> dict:
    """JSON-safe dict form of a plan (CLI ``--lint-plan`` files), the JAX
    package's schema."""
    return {
        "n_units": plan.n_units,
        "slices": [
            {
                "path": list(s.path),
                "axis": s.axis,
                "fan_out": s.fan_out,
                "collection": s.collection,
                "optional": s.optional,
            }
            for s in plan.slices
        ],
    }


def plan_from_dict(d: dict) -> PrunePlan:
    """Inverse of :func:`plan_to_dict`; tree path keys come back as the
    JSON types (strings / ints)."""
    return PrunePlan(
        n_units=int(d["n_units"]),
        slices=tuple(
            ParamSlice(
                path=tuple(s["path"]),
                axis=int(s["axis"]),
                fan_out=int(s.get("fan_out", 1)),
                collection=s.get("collection", "params"),
                optional=bool(s.get("optional", False)),
            )
            for s in d["slices"]
        ),
    )


def _slice_opt_state(opt_state, param_slices, path=()):
    """Slice every optimizer-state leaf whose tree path *ends with* a
    pruned parameter's path and whose shape matches the pre-slice
    parameter shape.  The port's optimizer states hold param-shaped
    trees (``{"mu": params-like, ...}``), so suffix matching plus the
    shape check finds exactly those leaves; scalars like Adam's
    ``count`` pass through."""
    if isinstance(opt_state, dict):
        return {k: _slice_opt_state(v, param_slices, path + (str(k),))
                for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        out = [_slice_opt_state(v, param_slices, path + (str(i),))
               for i, v in enumerate(opt_state)]
        return out if isinstance(opt_state, list) else type(opt_state)(out)
    if isinstance(opt_state, torch.Tensor):
        for ppath, (axis, idx, old_shape) in param_slices.items():
            if (len(path) >= len(ppath) and path[-len(ppath):] == ppath
                    and tuple(opt_state.shape) == old_shape):
                return _take(opt_state, idx, axis)
    return opt_state
