"""Functional pruner — counterpart of ``torchpruner_tpu/core/pruner.py``:
``prune`` maps (model, params, state, opt_state) to new, smaller trees
plus an updated static model spec.  The score-to-indices policy math
stays in numpy, as in the JAX package, so both packages drop the same
units for the same scores.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Sequence, Union

import numpy as np

from torchpruner_tpu_torch.core import graph as G
from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.plan import (
    ParamSlice,
    PruneGroup,
    PrunePlan,
    apply_plan,
)
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.ops.quant import QTensor
from torchpruner_tpu_torch.utils.tree import tree_leaves


@dataclass
class PruneResult:
    model: SegmentedModel
    params: Any
    state: Any = None
    opt_state: Any = None

    def __iter__(self):  # allow tuple-unpacking
        return iter((self.model, self.params, self.state, self.opt_state))


def plan_for_group(model: SegmentedModel, group: PruneGroup) -> PrunePlan:
    """Resolve a PruneGroup against a model into a concrete plan: the
    target's out-slices (Dense ``w`` axis 1 / ``b`` axis 0; Conv ``w``
    axis 3 (HWIO) / ``b`` axis 0; GatedDense
    ``wg``/``wu`` axis 1; attention query heads ``wq`` axis 1, ``wo``
    axis 0, ``bq`` axis 0, plus ``wk``/``wv``/``bk``/``bv`` when KV heads
    match query heads), attached norms (axis 0; a BatchNorm's running
    ``mean`` / ``var`` in the state tree) and consumer in-slices."""
    target = model.layer(group.target)
    tpath = L.parse_path(group.target)
    n = L.n_units(target)
    slices = []
    if isinstance(target, L.Dense):
        slices += [ParamSlice(tpath + ("w",), axis=1),
                   ParamSlice(tpath + ("b",), axis=0, optional=True)]
    elif isinstance(target, L.Conv):
        slices += [ParamSlice(tpath + ("w",), axis=3),
                   ParamSlice(tpath + ("b",), axis=0, optional=True)]
    elif isinstance(target, L.GatedDense):
        slices += [ParamSlice(tpath + ("wg",), axis=1),
                   ParamSlice(tpath + ("wu",), axis=1),
                   ParamSlice(tpath + ("bg",), axis=0, optional=True),
                   ParamSlice(tpath + ("bu",), axis=0, optional=True)]
    elif isinstance(target, L.MultiHeadAttention):
        slices += [ParamSlice(tpath + ("wq",), axis=1),
                   ParamSlice(tpath + ("wo",), axis=0),
                   ParamSlice(tpath + ("bq",), axis=0, optional=True)]
        if target.kv_heads == target.num_heads and target.kv_group is None:
            slices += [ParamSlice(tpath + ("wk",), axis=1),
                       ParamSlice(tpath + ("wv",), axis=1),
                       ParamSlice(tpath + ("bk",), axis=0, optional=True),
                       ParamSlice(tpath + ("bv",), axis=0, optional=True)]
    else:
        raise TypeError(
            f"cannot out-prune {type(target).__name__} {group.target!r}")
    for bn in group.attached_bn:
        f = bn.fan_out
        npath = L.parse_path(bn.layer)
        spec = model.layer(bn.layer)
        if isinstance(spec, L.BatchNorm):
            slices += [ParamSlice(npath + (p,), axis=0, fan_out=f)
                       for p in ("scale", "bias")]
            slices += [ParamSlice(npath + (p,), axis=0, fan_out=f,
                                  collection="state")
                       for p in ("mean", "var")]
        elif isinstance(spec, L.LayerNorm):
            slices += [ParamSlice(npath + ("scale",), axis=0, fan_out=f),
                       ParamSlice(npath + ("bias",), axis=0, fan_out=f,
                                  optional=True)]
        elif isinstance(spec, L.RMSNorm):
            slices.append(ParamSlice(npath + ("scale",), axis=0, fan_out=f))
        else:
            raise TypeError(
                f"unknown attached norm {type(spec).__name__} {bn.layer!r}")
    for c in group.consumers:
        slices.append(ParamSlice(L.parse_path(c.layer) + (c.param,),
                                 axis=c.axis, fan_out=c.fan_out))
    return PrunePlan(n_units=n, slices=tuple(slices))


def prune(model: SegmentedModel, params, layer: Union[str, PruneGroup],
          drop: Sequence[int], *, state=None, opt_state=None
          ) -> PruneResult:
    """Prune units ``drop`` from prunable layer ``layer`` (or an explicit
    group), cascading into attached norms/Dropout and consumer layers,
    and slicing every param-shaped optimizer-state leaf in step.  Leaves
    the plan does not touch are shared with the input trees."""
    if any(isinstance(leaf, QTensor) for leaf in tree_leaves(params)):
        raise ValueError(
            "params contain quantized QTensor weights — prune BEFORE "
            "quantizing (prune → fine-tune → quantize)")
    group = layer if isinstance(layer, PruneGroup) \
        else G.group_for(model, layer)
    drop = np.unique(np.asarray(drop, dtype=np.int64).reshape(-1))
    plan = plan_for_group(model, group)
    new_params, new_state, new_opt = apply_plan(
        plan, drop, params, state=state, opt_state=opt_state)
    return PruneResult(pruned_model_spec(model, group, drop), new_params,
                       new_state, new_opt)


def pruned_model_spec(model: SegmentedModel, group: PruneGroup,
                      drop: Sequence[int]) -> SegmentedModel:
    """The static model spec after pruning ``drop`` units of ``group``:
    smaller target width, rescaled dropout rates (the expected number of
    active units is preserved)."""
    target = model.layer(group.target)
    dropped = set(int(d) for d in np.asarray(drop).reshape(-1).tolist())
    keep = [u for u in range(L.n_units(target)) if u not in dropped]
    new_model = model.replace_layer(group.target, L.pruned_spec(target, keep))
    for d_name in group.attached_dropout:
        d = model.layer(d_name)
        new_rate = d.rate * (1.0 - len(dropped) / L.n_units(target))
        new_model = new_model.replace_layer(
            d_name, dataclasses.replace(d, rate=new_rate))
    return new_model


def bucket_drop(scores: np.ndarray, drop: np.ndarray, bucket: int
                ) -> np.ndarray:
    """Shrink ``drop`` so the KEPT unit count is a multiple of ``bucket``,
    un-dropping the highest-scoring dropped units first."""
    if bucket <= 1:
        return drop
    n = len(scores)
    keep_n = n - len(drop)
    target_keep = min(n, -(-max(keep_n, 1) // bucket) * bucket)
    n_undrop = target_keep - keep_n
    if n_undrop <= 0:
        return drop
    order = np.argsort(scores[drop])  # ascending score over dropped units
    keep_back = drop[order[len(drop) - n_undrop:]]
    return np.setdiff1d(drop, keep_back)


def score_drop_indices(
    scores: np.ndarray,
    *,
    policy: Union[str, Callable[[np.ndarray], np.ndarray]] = "negative",
    fraction: float = 0.5,
    bucket: int = 1,
    granularity: int = 1,
) -> np.ndarray:
    """Scores → drop indices: ``"negative"`` drops every unit scoring
    below 0, ``"fraction"`` the lowest ``fraction`` of units, a callable
    returns the indices itself; ``bucket`` rounds the kept width up;
    ``granularity > 1`` ranks consecutive blocks of that many units by
    their mean score and drops whole blocks."""
    scores = np.asarray(scores)
    if granularity > 1:
        n = len(scores)
        if n % granularity:
            raise ValueError(f"granularity {granularity} does not divide "
                             f"the {n}-unit axis")
        if bucket > 1 and granularity % bucket:
            raise ValueError(
                f"bucket {bucket} does not divide granularity "
                f"{granularity}: block-structured drops keep widths in "
                f"multiples of the granularity, which cannot honor this "
                f"bucket")
        block_scores = scores.reshape(-1, granularity).mean(axis=1)
        bdrop = score_drop_indices(block_scores, policy=policy,
                                   fraction=fraction, bucket=1)
        return np.sort((bdrop[:, None] * granularity
                        + np.arange(granularity)[None, :]).reshape(-1)
                       ).astype(np.int64)
    if callable(policy):
        drop = np.unique(np.asarray(policy(scores), dtype=np.int64))
    elif policy == "negative":
        drop = np.argwhere(scores < 0).flatten()
    elif policy == "fraction":
        k = int(len(scores) * fraction)
        drop = np.argsort(scores)[:k]
    else:
        raise ValueError(f"unknown policy {policy!r}")
    if len(drop) >= len(scores):
        drop = drop[: len(scores) - 1]  # never remove a whole layer
    return bucket_drop(scores, np.asarray(drop, dtype=np.int64), bucket)
