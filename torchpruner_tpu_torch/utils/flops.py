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


#: bf16 dense tensor-core peak FLOP/s by CUDA device name
#: (``torch.cuda.get_device_name``, matched exactly).  NVIDIA's H100
#: data-sheet values (dense, without sparsity, at the card's full power
#: limit: 700 W for the SXM part); no other card is listed, so any other
#: device — another H100 variant such as the NVL included — and the CPU
#: read ``None``.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,    # SXM
    "NVIDIA H100 PCIe": 756e12,
}

#: HBM bytes/s by CUDA device name: NVIDIA's H100 data-sheet values,
#: paired with :data:`PEAK_BF16_FLOPS`.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def _device_name(device) -> str:
    """The CUDA device name of ``device``: a name string as it is, a
    ``torch.device`` or index of a CUDA device read from the driver; ""
    for the CPU or an unknown device."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    try:
        dev = torch.device(device) if not isinstance(device, int) \
            else torch.device("cuda", device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return ""
        return torch.cuda.get_device_name(dev)
    except (RuntimeError, ValueError, TypeError, AssertionError):
        return ""


def peak_bf16_flops(device) -> Optional[float]:
    """Data-sheet bf16 peak for ``device`` (a CUDA device name, a
    ``torch.device`` or a CUDA index; None when unknown or the CPU)."""
    return PEAK_BF16_FLOPS.get(_device_name(device))


def peak_hbm_bw(device) -> Optional[float]:
    """Data-sheet HBM bandwidth (bytes/s) for ``device`` (None when
    unknown or the CPU, whose DRAM rate is not a chip constant)."""
    return PEAK_HBM_BYTES_PER_S.get(_device_name(device))


def roofline_position(flops: Optional[float], bytes_moved: Optional[float],
                      time_s: Optional[float],
                      peak_flops: Optional[float] = None,
                      peak_bw: Optional[float] = None) -> dict:
    """One kernel's roofline coordinates from *estimates* (the profile
    subsystem's per-kernel FLOPs/bytes attributions — see
    ``obs.profile.kernels``): achieved FLOP/s and bytes/s, arithmetic
    intensity, fraction of each peak, and a compute/memory-bound
    classification against the ridge intensity ``peak_flops/peak_bw``.
    Every field degrades to ``None`` when its inputs are unknown rather
    than guessing (a copy of the JAX package's function)."""
    t = float(time_s) if time_s else None
    f = float(flops) if flops else None
    b = float(bytes_moved) if bytes_moved else None
    achieved_f = (f / t) if f and t else None
    achieved_b = (b / t) if b and t else None
    intensity = (f / b) if f and b else None
    ridge = (peak_flops / peak_bw) if peak_flops and peak_bw else None
    bound = "unknown"
    if intensity is not None and ridge is not None:
        bound = "compute" if intensity >= ridge else "memory"
    elif f and not b:
        bound = "compute"
    elif b and not f:
        bound = "memory"
    return {
        "flops_est": f,
        "bytes_est": b,
        "achieved_flops_per_s": achieved_f,
        "achieved_bytes_per_s": achieved_b,
        "intensity_flops_per_byte": intensity,
        "ridge_intensity": ridge,
        "pct_peak_flops": (100.0 * achieved_f / peak_flops
                           if achieved_f and peak_flops else None),
        "pct_peak_bw": (100.0 * achieved_b / peak_bw
                        if achieved_b and peak_bw else None),
        "bound": bound,
    }
