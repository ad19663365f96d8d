"""Pruning-graph inference — counterpart of ``torchpruner_tpu/core/graph.py``.

The graph is derived statically from the model spec, recursing into
composite blocks:

- a ``Residual`` body is walked like a sequential model; a producer
  whose consumer lies within the same chain is prunable, while a
  producer whose output reaches the residual sum has its width pinned by
  the skip connection and is excluded;
- attention heads, GLU channels and MoE experts form groups whose
  surgery stays inside the layer/block, so they are always prunable; a
  producer feeding MoE (whose output width follows its input width) is
  width-pinned;
- a ``Reshape`` that folds channels, and a ``ClsToken`` or ``PosEmbed``
  (whose params share the producer's width but are not sliced with
  it), end a producer's unit identity: the ViT patchify conv forms no
  group;
- norms (BatchNorm, LayerNorm, RMSNorm) attach to the open group, Pool
  and GlobalPool are transparent, and a ``Flatten`` multiplies the
  group's fan-out by the spatial size it folds;
- a producer feeding a projection-shortcut Residual (a ResNet stem conv)
  cascades into the first prunable layer of both chains.

:func:`nan_cascade_oracle` finds the same cascade indices empirically,
by NaN propagation on flat models: a check of the static graph.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.plan import AttachedNorm, Consumer, PruneGroup
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.utils.tree import device_of

#: activations that evaluation-point shifting may skip over (the JAX
#: package's set)
SHIFTABLE_ACTIVATIONS = frozenset(
    {"relu", "relu6", "leaky_relu", "sigmoid", "softplus", "tanh"})

#: width-changing prunable producers (attention heads and MoE experts
#: leave the layer's output width unchanged)
_CHANNEL_PRODUCERS = (L.Dense, L.Conv, L.GatedDense)
_NORMS = (L.BatchNorm, L.LayerNorm, L.RMSNorm)


def find_best_evaluation_layer(model: SegmentedModel, name: str) -> str:
    """Walk forward from ``name`` while the next layer is a norm or a
    shiftable activation; return the last such layer (inside Residual
    bodies too).  Attention/GLU/MoE targets are their own evaluation
    site."""
    path = L.parse_path(name)
    spec = model.layer(name)
    if isinstance(spec, (L.MultiHeadAttention, L.GatedDense, L.MoE)):
        return name
    if len(path) == 1:
        siblings = model.layers
    else:
        parent = model.layer("/".join(path[:-1]))
        siblings = parent.body if any(
            l.name == path[-1] for l in parent.body) else parent.shortcut
    idx = next(i for i, l in enumerate(siblings) if l.name == path[-1])
    best = path[-1]
    for nxt in siblings[idx + 1:]:
        if isinstance(nxt, _NORMS) or (
                isinstance(nxt, L.Activation)
                and nxt.fn in SHIFTABLE_ACTIVATIONS):
            best = nxt.name
        else:
            break
    return "/".join(path[:-1] + (best,))


def pruning_graph(model: SegmentedModel, include_output: bool = False
                  ) -> Tuple[PruneGroup, ...]:
    """The prune groups of a model, in forward order, recursing into
    composite blocks.  ``include_output=False`` drops the final
    top-level group (the classifier head is never pruned)."""
    groups: List[PruneGroup] = []
    open_group = _walk(model.layers, (), tuple(model.input_shape), groups)
    if include_output and open_group is not None:
        groups.append(_close(open_group))
    return tuple(groups)


def group_for(model: SegmentedModel, layer: str) -> PruneGroup:
    """The prune group whose target is ``layer`` (output layer included)."""
    for g in pruning_graph(model, include_output=True):
        if g.target == layer:
            return g
    raise KeyError(f"{layer!r} is not a prunable layer of this model")


def _join(prefix: Tuple[str, ...], name: str) -> str:
    return "/".join(prefix + (name,))


def _consumer_entries(spec: L.LayerSpec, path: str, fan_out: int):
    """Consumer slices when ``spec``'s input width shrinks, or ``None``
    when its output width follows its input width (attention with
    ``out_features=None``; MoE, whose output is ``wo``'s last axis): the
    producer is then width-pinned."""
    if isinstance(spec, L.Dense):
        return [Consumer(path, "w", axis=0, fan_out=fan_out)]
    if isinstance(spec, L.Conv):  # HWIO: the in-channel axis
        return [Consumer(path, "w", axis=2, fan_out=fan_out)]
    if isinstance(spec, L.GatedDense):
        return [Consumer(path, "wg", axis=0, fan_out=fan_out),
                Consumer(path, "wu", axis=0, fan_out=fan_out)]
    if isinstance(spec, L.MultiHeadAttention):
        if spec.out_features is None:
            return None
        return [Consumer(path, p, axis=0, fan_out=fan_out)
                for p in ("wq", "wk", "wv")]
    if isinstance(spec, L.MoE):
        return None
    raise TypeError(f"{type(spec).__name__} cannot consume")


def _walk(layers, prefix: Tuple[str, ...], in_shape: Tuple[int, ...],
          groups: List[PruneGroup]) -> Optional[dict]:
    """Walk one sequential scope; append closed groups to ``groups``;
    return the group still open at scope end, or None."""
    current: Optional[dict] = None
    for spec, (i_shape, o_shape) in zip(layers,
                                        L.seq_shapes(layers, in_shape)):
        path = _join(prefix, spec.name)
        if isinstance(spec, (L.MultiHeadAttention, L.MoE)):
            if current is not None:
                entries = _consumer_entries(spec, path, current["fan_out"])
                if entries is not None:
                    current["consumers"] += entries
                    groups.append(_close(current))
                current = None
            groups.append(PruneGroup(target=path))
        elif isinstance(spec, _CHANNEL_PRODUCERS):
            if current is not None:
                current["consumers"] += _consumer_entries(
                    spec, path, current["fan_out"])
                groups.append(_close(current))
            current = {"target": path, "bn": [], "dropout": [],
                       "consumers": [], "fan_out": 1}
        elif isinstance(spec, L.Residual):
            if current is not None and _consume_into_residual(
                    spec, prefix + (spec.name,), current):
                groups.append(_close(current))
            # else: the output feeds an identity skip — width pinned
            current = None
            _walk(spec.body, prefix + (spec.name,), i_shape, groups)
            if spec.shortcut:
                _walk(spec.shortcut, prefix + (spec.name,), i_shape, groups)
        elif current is not None:
            if isinstance(spec, _NORMS):
                current["bn"].append(
                    AttachedNorm(path, fan_out=current["fan_out"]))
            elif isinstance(spec, L.Dropout):
                current["dropout"].append(path)
            elif isinstance(spec, L.Flatten):
                current["fan_out"] *= math.prod(i_shape[:-1])
            elif isinstance(spec, L.Reshape):
                if o_shape[-1] != i_shape[-1]:
                    current = None  # channels folded: unit identity lost
            elif isinstance(spec, (L.Embedding, L.PosEmbed, L.ClsToken)):
                current = None  # unit identity lost
            # Activation / Pool / GlobalPool: transparent for unit identity
    return current


def _consume_into_residual(res: L.Residual, res_prefix: Tuple[str, ...],
                           group: dict) -> bool:
    """Cascade an open producer group into a Residual block it feeds:
    possible only with a projection shortcut, when both chains begin
    with (norms/transparent layers, then) a prunable consumer.  Mutates
    ``group`` on success."""
    if not res.shortcut:
        return False
    bn, consumers = [], []
    for chain in (res.body, res.shortcut):
        found = False
        for spec in chain:
            path = _join(res_prefix, spec.name)
            if isinstance(spec, _NORMS):
                bn.append(AttachedNorm(path, fan_out=group["fan_out"]))
            elif isinstance(spec, (L.Activation, L.Pool, L.GlobalPool)):
                pass  # transparent
            elif isinstance(spec, _CHANNEL_PRODUCERS
                            + (L.MultiHeadAttention, L.MoE)):
                entries = _consumer_entries(spec, path, group["fan_out"])
                if entries is None:
                    return False
                consumers += entries
                found = True
                break
            else:
                return False
        if not found:
            return False
    group["bn"] += bn
    group["consumers"] += consumers
    return True


def _close(build: dict) -> PruneGroup:
    return PruneGroup(target=build["target"],
                      attached_bn=tuple(build["bn"]),
                      attached_dropout=tuple(build["dropout"]),
                      consumers=tuple(build["consumers"]))


# ---------------------------------------------------------------------------
# NaN oracle (a check of the static graph)
# ---------------------------------------------------------------------------


@torch.no_grad()
def nan_cascade_oracle(model: SegmentedModel, params, state, target: str,
                       drop: Sequence[int], batch: int = 2, seed: int = 0
                       ) -> Dict[str, Tuple[np.ndarray, int]]:
    """Cascade indices found by NaN propagation, on flat top-level models
    (composite models are checked by prune-versus-mask equality
    instead).  NaN goes into the dropped unit positions of ``target``'s
    output, the model runs in eval mode on a seeded normal batch on the
    params' device, and every later Dense, Conv, BatchNorm and Dropout
    reports the NaN-tainted positions of its input's unit axis:
    ``{layer: (in_indices, original_len)}``."""
    dev = device_of(params)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    x = torch.randn((batch,) + tuple(model.input_shape),
                    generator=gen).to(dev)
    drop = torch.as_tensor(np.asarray(drop, dtype=np.int64), device=dev)
    report: Dict[str, Tuple[np.ndarray, int]] = {}
    ti = model.index(target)
    detect_types = (L.Dense, L.Conv, L.BatchNorm, L.Dropout)
    for i, spec in enumerate(model.layers):
        if i > ti and isinstance(spec, detect_types):
            # sum out batch and spatial axes, keep the trailing unit axis
            summed = x.reshape(-1, x.shape[-1]).sum(dim=0)
            nan_idx = torch.nonzero(torch.isnan(summed))[:, 0].cpu().numpy()
            if nan_idx.size:
                report[spec.name] = (nan_idx, int(summed.shape[0]))
        p = params.get(spec.name, {})
        s = state.get(spec.name, {}) if state else {}
        x, _ = L.apply_layer(spec, p, s, x, train=False)
        if i == ti and drop.numel():
            x = x.clone()
            x[..., drop] = float("nan")
    return report
