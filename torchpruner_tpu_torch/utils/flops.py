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


#: Order-of-magnitude host constants (FLOP/s, bytes/s, bytes/s of
#: interconnect) a chip-less pricing run uses — the JAX package's
#: ``CPU_COST_DEFAULTS``, copied, so a campaign's decisions are
#: deterministic on any host.  The rates are env-overridable
#: (TORCHPRUNER_COST_CPU_FLOPS / _BW); nothing here reads ``ici``.
CPU_COST_DEFAULTS = {"flops": 5e10, "hbm": 2e10, "ici": 1e10}

#: Deterministic stand-in device memory for a chip-less host (the JAX
#: package's ``CPU_HBM_CAPACITY_BYTES``): big enough that smoke configs
#: are never spuriously infeasible, small enough that a planted budget
#: (TORCHPRUNER_PLAN_HBM_BYTES) can undercut it in tests.
CPU_HBM_CAPACITY_BYTES = 8 * 2 ** 30

#: env override for the per-device memory a pricing run budgets against
PLAN_HBM_ENV = "TORCHPRUNER_PLAN_HBM_BYTES"


def _env_float(name: str, default: float) -> float:
    import os

    v = os.environ.get(name)
    return float(v) if v else default


def hbm_capacity(device=None) -> float:
    """Per-device memory in bytes that a pricing gate budgets against.
    ``TORCHPRUNER_PLAN_HBM_BYTES`` overrides everything.  With no device
    given it is :data:`CPU_HBM_CAPACITY_BYTES`, as the JAX package's is
    in its chip-less campaign driver; only a CUDA device passed in
    explicitly reads the card (``parallel.memory.hbm_bytes``)."""
    import os

    env = os.environ.get(PLAN_HBM_ENV)
    if env:
        return float(env)
    if device is not None and torch.device(device).type == "cuda":
        from torchpruner_tpu_torch.parallel.memory import hbm_bytes

        return float(hbm_bytes(torch.device(device)))
    return float(CPU_HBM_CAPACITY_BYTES)


def predicted_hbm_bytes_per_chip(
    model,
    mesh_axes: dict,
    *,
    partition: str = "fsdp",
    zero: bool = False,
    tx=None,
    batch_per_chip: int = 1,
    compute_dtype=None,
    remat: bool = False,
    params=None,
    min_shard_size: int = 2 ** 14,
) -> int:
    """Predicted per-rank memory watermark (bytes) for training
    ``model`` at a placement — params + grads + optimizer slots (at
    their ZeRO placement when ``zero``) + the coarse activation
    estimate, all from ``parallel.memory.training_memory`` over
    ``meta`` trees and a ``{axis: size}`` mesh (no device, no
    materialized parameter).  ``mesh_axes`` may be empty (one device).
    The JAX package's function, over the port's placement rules."""
    from torchpruner_tpu_torch.parallel.memory import training_memory
    from torchpruner_tpu_torch.parallel.sharding import (
        fsdp_sharding,
        tp_sharding,
    )

    axes = dict(mesh_axes or {"data": 1})
    if "data" not in axes:
        axes["data"] = 1
    if params is None:
        from torchpruner_tpu_torch.analysis.plan_lint import abstract_trees

        params, _ = abstract_trees(model)
    if partition == "tp" and "model" in axes:
        sh = tp_sharding(model, params, axes, min_size=min_shard_size)
    else:
        sh = fsdp_sharding(params, axes, min_size=min_shard_size)
    budget = training_memory(
        model, sh, axes, tx=tx, batch_per_chip=max(1, batch_per_chip),
        compute_dtype=compute_dtype, remat=remat, params=params,
        zero=zero,
    )
    return int(budget.total_bytes)


def train_step_roofline(forward_flops: float, step_bytes: float) -> dict:
    """A train step's roofline from the port's own counts, at the
    chip-less :data:`CPU_COST_DEFAULTS` (env overrides
    TORCHPRUNER_COST_CPU_FLOPS / _BW): compute time is ``3 x
    forward_flops`` (forward + backward) over the FLOP rate, memory time
    the bytes the step plans (``training_memory``'s total) over the
    bandwidth, and the prediction the larger of the two.  Returns
    ``{step_ms, compute_ms, memory_ms, bound, comm_ms, device_kind}`` —
    ``bound`` is ``"compute"`` or ``"hbm"``; ``comm_ms`` is None (no
    collective program is read)."""
    flops = _env_float("TORCHPRUNER_COST_CPU_FLOPS",
                       CPU_COST_DEFAULTS["flops"])
    hbm = _env_float("TORCHPRUNER_COST_CPU_BW", CPU_COST_DEFAULTS["hbm"])
    compute_ms = 3.0 * float(forward_flops) / flops * 1e3
    memory_ms = float(step_bytes) / hbm * 1e3
    return {
        "step_ms": max(compute_ms, memory_ms),
        "compute_ms": compute_ms,
        "memory_ms": memory_ms,
        "bound": "compute" if compute_ms >= memory_ms else "hbm",
        "comm_ms": None,
        "device_kind": "cpu-default cost constants",
    }
