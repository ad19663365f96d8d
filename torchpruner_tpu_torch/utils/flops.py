"""Parameter and FLOPs accounting — counterpart of ``model_cost`` and
``prefix_flops_estimate`` in ``torchpruner_tpu/utils/flops.py``.  The JAX package reads XLA's cost
analysis of the compiled forward; the port counts the forward's
operations with ``torch.utils.flop_counter.FlopCounterMode``.  Like XLA's
cost analysis of a custom call, neither sees inside a hand-written
kernel: on CUDA the flash-attention kernels add no FLOPs to the count.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.utils.tree import device_of, tree_leaves


def param_count(params) -> int:
    """Exact number of parameter elements in the tree."""
    return int(sum(t.numel() for t in tree_leaves(params)))


@torch.no_grad()
def model_cost(model: SegmentedModel, params, state=None,
               batch_size: int = 2) -> Tuple[int, Optional[float]]:
    """``(n_params, forward_flops)`` for a ``batch_size`` forward on a
    random input, on the params' device (``None`` FLOPs when the counter
    saw no operation)."""
    x = model.example_input(batch_size, device=device_of(params))
    counter = FlopCounterMode(display=False)
    with counter:
        model.apply(params, x, state=state, train=False)
    flops = float(counter.get_total_flops())
    return param_count(params), flops or None


def prefix_flops_estimate(model: SegmentedModel, params, eval_layer: str,
                          batch_size: int = 1) -> float:
    """Analytic forward FLOPs of the prefix from the input through
    ``eval_layer``'s top-level layer, what the capture engine saves per
    cache hit (``attributions.base.ActivationCache``): every weight of
    two or more axes costs ``2 x positions x its size`` at each of its
    layer's output positions (exact for Dense, Conv and the attention
    projections; attention's S**2 scores and elementwise ops are left
    out, so it errs low).  Embedding lookups count zero."""
    from torchpruner_tpu_torch.core import layers as L

    stop = model.index(model.top_level_of(eval_layer))

    def weight_sizes(p) -> float:
        n = 0.0
        for v in p.values():
            if isinstance(v, dict):  # a composite block's child
                n += weight_sizes(v)
            elif getattr(v, "ndim", 0) >= 2:
                n += float(math.prod(v.shape))
        return n

    total = 0.0
    for spec, (_, out_shape) in zip(model.layers[:stop + 1], model.shapes):
        p = params.get(spec.name)
        if p is None or isinstance(spec, L.Embedding):
            continue
        positions = float(math.prod(out_shape[:-1])) if len(out_shape) > 1 \
            else 1.0
        total += 2.0 * batch_size * positions * weight_sizes(p)
    return total
