"""Mask-based (simulated) pruning — the fixed-shape complement to
structural surgery.  Counterpart of ``torchpruner_tpu/core/masking.py``.

Structural pruning (``core/pruner.py``) changes shapes.  This module
keeps them: the SAME slices a structural prune would remove (derived
from the same ``PrunePlan``) are held at zero by masking the parameters
and, during training, the optimizer updates
(:func:`masked_update`, chained after the inner optimizer).  One final
:func:`~torchpruner_tpu_torch.core.pruner.prune` with the same indices
materializes the mask into genuinely smaller tensors.

Forward equivalence with real pruning holds exactly in eval mode: masked
units produce zero activations, masked consumer rows null their
contributions, masked norm scale/bias zero the channel.

:func:`blocksparse_params` turns block-aligned masks into work saved:
it wraps the masked 2-D matmul weights in
:class:`~torchpruner_tpu_torch.ops.blocksparse.BlockSparseWeight`, so
the Dense/GatedDense sites run the block-sparse kernels.  The recipe::

    drop = score_drop_indices(scores, policy="fraction", fraction=0.5,
                              granularity=128)
    drops = {"block1_mlp/fc1": drop}
    masks, _ = drop_masks(model, params, drops)
    params = apply_masks(params, masks)          # zero once up front
    tx = chain(adam(1e-4), masked_update(masks))
    trainer = Trainer.create(
        model, tx, loss_fn, params=params,
        param_transform=blocksparse_transform(model, drops))
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchpruner_tpu_torch.core import graph as G
from torchpruner_tpu_torch.core.plan import PruneGroup, _set_path
from torchpruner_tpu_torch.core.pruner import plan_for_group
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.ops.blocksparse import (
    DEFAULT_BLOCK,
    BlockSparseWeight,
    keep_blocks_from_drop,
)
from torchpruner_tpu_torch.train.optim import GradientTransformation
from torchpruner_tpu_torch.utils.tree import tree_map

Drops = Dict[Union[str, PruneGroup], Sequence[int]]
#: param path -> {"in_keep" / "out_keep": kept-block tuple}
Sites = Dict[Tuple[str, ...], Dict[str, Tuple[int, ...]]]


def _get_path(tree, path: Tuple[str, ...]):
    for k in path:
        if tree is None or k not in tree:
            return None
        tree = tree[k]
    return tree


def _plans(model: SegmentedModel, drops: Drops):
    """``(plan, sorted unique drop indices)`` per entry of ``drops``."""
    for layer, drop in drops.items():
        group = layer if isinstance(layer, PruneGroup) \
            else G.group_for(model, layer)
        yield (plan_for_group(model, group),
               np.unique(np.asarray(drop, dtype=np.int64).reshape(-1)))


def drop_masks(model: SegmentedModel, params, drops: Drops, *, state=None):
    """Binary (1.0 = keep) masks for the exact parameter/state slices a
    structural prune of ``drops`` (``{layer: unit indices}``) would
    remove.

    Returns ``(param_masks, state_masks)`` shaped like ``params`` /
    ``state`` (missing optional entries skipped; ``state_masks`` is None
    without a ``state``).  Fan-out and attached-norm slices come from the
    same ``PrunePlan`` as real surgery, so the two stay in lockstep by
    construction."""
    param_masks = tree_map(torch.ones_like, params)
    state_masks = tree_map(torch.ones_like, state) \
        if state is not None else None
    for plan, drop in _plans(model, drops):
        for s in plan.slices:
            tree, masks = ((params, param_masks) if s.collection == "params"
                           else (state, state_masks))
            leaf = _get_path(tree, s.path)
            if leaf is None:
                if s.optional:
                    continue
                raise KeyError(f"missing {'/'.join(s.path)}")
            # fan_out positions are STRIDED {p * n_units + u} (the
            # channels-last flatten map of plan.ParamSlice)
            idx = (np.concatenate([p * plan.n_units + drop
                                   for p in range(s.fan_out)])
                   if s.fan_out > 1 else drop)
            _get_path(masks, s.path).index_fill_(
                s.axis, torch.as_tensor(idx, device=leaf.device), 0.0)
    return param_masks, state_masks


def apply_masks(tree, masks):
    """``tree * masks`` leafwise (masks=None is the identity)."""
    if masks is None:
        return tree
    return tree_map(lambda t, m: t * m.to(t.dtype), tree, masks)


def blocksparse_sites(model: SegmentedModel, params, drops: Drops, *,
                      block: int = DEFAULT_BLOCK) -> Sites:
    """The 2-D matmul weights a masked prune of ``drops`` zeroes whole
    ``block``-blocks of, by param path, each with the kept blocks of its
    input and/or output axis.  Slices whose drop pattern is not
    block-aligned (``score_drop_indices(granularity=block)`` makes it
    so), weights that are not 2-D (attention), weights whose other axis
    ``block`` does not divide (the kernels tile both) and fan-out slices
    keep plain mask semantics and are left out."""
    sites: Sites = {}
    for plan, drop in _plans(model, drops):
        keep = keep_blocks_from_drop(plan.n_units, drop, block)
        if keep is None or len(keep) * block == plan.n_units:
            continue  # unaligned pattern or nothing dropped
        for s in plan.slices:
            if s.collection != "params" or s.fan_out > 1 or s.axis > 1:
                continue
            leaf = _get_path(params, s.path)
            if leaf is None or leaf.dim() != 2 \
                    or leaf.shape[s.axis] != plan.n_units \
                    or leaf.shape[1 - s.axis] % block:
                continue
            sites.setdefault(tuple(s.path), {})[
                "out_keep" if s.axis == 1 else "in_keep"] = keep
    return sites


def wrap_sites(params, sites: Sites, block: int = DEFAULT_BLOCK):
    """``params`` with the weight at every path of ``sites`` wrapped in a
    :class:`BlockSparseWeight` (the same buffers; other leaves shared)."""
    out = params
    for path, kw in sites.items():
        leaf = _get_path(out, path)
        if isinstance(leaf, BlockSparseWeight):
            continue
        out = _set_path(out, path, BlockSparseWeight(
            leaf, kw.get("in_keep"), kw.get("out_keep"), block))
    return out


def blocksparse_params(model: SegmentedModel, params, drops: Drops, *,
                       block: int = DEFAULT_BLOCK):
    """Wrap the 2-D matmul weights a masked prune of ``drops`` zeroes in
    :class:`BlockSparseWeight`, so the Dense/GatedDense sites
    (``quant.qdot``) run the block-sparse kernels — dropped blocks
    neither read nor multiplied, forward and backward — instead of
    dense-multiplying zeros.  Call on ALREADY-MASKED params
    (:func:`apply_masks` first).  Returns new params; the wrapping is
    metadata only.  Inside a training step use
    :func:`blocksparse_transform`, which resolves the plans once."""
    return wrap_sites(params, blocksparse_sites(model, params, drops,
                                                block=block), block)


def blocksparse_transform(model: SegmentedModel, drops: Drops, *,
                          block: int = DEFAULT_BLOCK) -> Callable:
    """:func:`blocksparse_params` as a ``param_transform`` for the
    training step (``train.loop``): the site table is resolved from the
    first params it sees, and every later call only re-wraps the current
    tensors.  (The JAX package resolves it once per trace; the port runs
    eagerly, so walking the plans in every step would be host work per
    step.)"""
    cache: Dict[str, Optional[Sites]] = {"sites": None}

    def transform(params):
        if cache["sites"] is None:
            cache["sites"] = blocksparse_sites(model, params, drops,
                                               block=block)
        return wrap_sites(params, cache["sites"], block)

    return transform


def masked_update(param_masks) -> GradientTransformation:
    """A gradient transformation pinning masked parameters at zero through
    training: chain it AFTER the inner optimizer so each step's update is
    masked — with the parameters masked once at the start, masked entries
    then stay exactly zero under any first-order update (masked gradients
    and moments can flow, but the masked update never moves the
    parameter)."""

    def init(params):
        return {}

    def update(updates, opt_state, params=None):
        return apply_masks(updates, param_masks), opt_state

    return GradientTransformation(init, update)
