"""Parameter and FLOPs accounting — counterpart of ``model_cost`` in
``torchpruner_tpu/utils/flops.py``.  The JAX package reads XLA's cost
analysis of the compiled forward; the port counts the forward's
operations with ``torch.utils.flop_counter.FlopCounterMode``.  Like XLA's
cost analysis of a custom call, neither sees inside a hand-written
kernel: on CUDA the flash-attention kernels add no FLOPs to the count.
"""

from __future__ import annotations

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
