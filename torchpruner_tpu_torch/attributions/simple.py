"""Data-free metrics: Random and WeightNorm — counterpart of
``torchpruner_tpu/attributions/simple.py``."""

from __future__ import annotations

import numpy as np
import torch

from torchpruner_tpu_torch.attributions.base import (
    AttributionMetric,
    cpu_generator,
    param_at,
)
from torchpruner_tpu_torch.core import layers as L


class RandomAttributionMetric(AttributionMetric):
    """Uniform random scores; the control baseline.  Drawn from a CPU
    generator seeded from ``seed`` and the call count, so the CPU and
    the card draw the same scores, and every call draws fresh ones."""

    shiftable = False
    data_dependent = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._calls = 0

    def run(self, layer, *, find_best_evaluation_layer=False, **kw):
        n = L.n_units(self.model.layer(layer))
        self._calls += 1
        g = cpu_generator(self.seed, self._calls)
        return torch.rand(n, generator=g).numpy()


class WeightNormAttributionMetric(AttributionMetric):
    """L1 norm of each unit's incoming weights (Li et al., ICLR 2017):
    abs, then the sum over every axis but the unit axis."""

    shiftable = False
    data_dependent = False

    def run(self, layer, *, find_best_evaluation_layer=False, **kw):
        spec = self.model.layer(layer)
        p = param_at(self.params, layer)
        if isinstance(spec, L.Dense):  # (in, out)
            norm = p["w"].abs().sum(dim=0)
        elif isinstance(spec, L.Conv):  # HWIO
            norm = p["w"].abs().sum(dim=(0, 1, 2))
        elif isinstance(spec, L.GatedDense):  # gate + up, per channel
            norm = p["wg"].abs().sum(dim=0) + p["wu"].abs().sum(dim=0)
        elif isinstance(spec, L.MultiHeadAttention):
            # per query head: incoming |wq| + outgoing |wo| (KV
            # projections are shared across groups under GQA: excluded)
            norm = (p["wq"].abs().sum(dim=(0, 2))
                    + p["wo"].abs().sum(dim=(1, 2)))
        elif isinstance(spec, L.MoE):
            # per expert: all of its weight planes + its router column
            norm = (p["wg"].abs().sum(dim=(1, 2))
                    + p["wu"].abs().sum(dim=(1, 2))
                    + p["wo"].abs().sum(dim=(1, 2))
                    + p["router"].abs().sum(dim=0))
        else:
            raise TypeError(f"no weights to score on {type(spec).__name__}")
        return np.asarray(norm.detach().float().cpu().numpy())
