"""Analytic ``max_model`` fixture — counterpart of
``torchpruner_tpu/models/analytic.py``: a hand-weighted 2→4→1 ReLU net
computing ``max(x1, x2)`` on four symmetric inputs, whose attributions
are known exactly.

Hidden units (columns of w1): A = relu(-x1/2 + x2/2), B = relu(x1 - x2),
C = relu(x1 + x2), D = relu(x1 + x2).  Output = A + B/2 + C/2 + w_D·D,
which equals max(x1, x2) when w_D = 0 (version 1).  Version 2 gives the
redundant unit D a small negative outgoing weight (-0.1), making its
Sensitivity/Taylor/Shapley attributions nonzero and hand-checkable.
"""

from __future__ import annotations

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.utils.device import resolve_device


def max_model(version: int = 1, device=None):
    """``(model, params, x, y)`` on ``device`` (``None`` = ``cuda``;
    raises without a GPU unless ``device="cpu"``).

    Expected ground truths on the four points (MSE loss, batch size 1,
    reduction "mean"): WeightNorm [1, 2, 2, 2]; APoZ [.5, .5, 1, 1];
    Sensitivity/Taylor all 0 (version 1) / [.2, .1, .2, .04] and
    [.1, .1, .5, .1] (version 2); Shapley ≈ [0.37, 0.37, 1.7, 0.0]
    (version 1, sv_samples → ∞)."""
    dev = resolve_device(device)
    x = np.array([[0, 1], [1, 0], [1, 2], [2, 1]], dtype=np.float32)
    y = np.max(x, axis=1, keepdims=True).astype(np.float32)
    w1 = np.array([[-0.5, 1.0, 1.0, 1.0],
                   [0.5, -1.0, 1.0, 1.0]], dtype=np.float32)  # units A-D
    w_d = 0.0 if version == 1 else -0.1
    w2 = np.array([[1.0], [0.5], [0.5], [w_d]], dtype=np.float32)
    model = SegmentedModel(
        layers=(L.Dense("fc1", 4, use_bias=False),
                L.Activation("act1", "relu"),
                L.Dense("fc2", 1, use_bias=False)),
        input_shape=(2,))
    params = {"fc1": {"w": torch.from_numpy(w1).to(dev)},
              "fc2": {"w": torch.from_numpy(w2).to(dev)}}
    return model, params, torch.from_numpy(x).to(dev), \
        torch.from_numpy(y).to(dev)


def max_model_batches(batch_size: int = 1, device=None):
    """The fixture's dataset as a list of ``(x, y)`` batches."""
    _, _, x, y = max_model(device=device)
    return [(x[i:i + batch_size], y[i:i + batch_size])
            for i in range(0, x.shape[0], batch_size)]
