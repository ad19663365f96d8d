"""Named reductions over per-example attribution rows ``(N, n_units)`` —
counterpart of ``torchpruner_tpu/utils/reductions.py``."""

from __future__ import annotations

import numpy as np


def mean_plus_2std(rows: np.ndarray) -> np.ndarray:
    return np.mean(rows, 0) + 2.0 * np.std(rows, 0)


def from_moments(reduction, s1, s2, n):
    """Evaluate a moment-computable reduction from (Σx, Σx², N) per unit."""
    mean = s1 / n
    if reduction == "mean":
        return mean
    if reduction == "sum":
        return s1
    var = np.maximum(s2 / n - mean**2, 0.0)
    if reduction in ("mean+2std", mean_plus_2std):
        return mean + 2.0 * np.sqrt(var)
    raise ValueError(f"reduction {reduction!r} is not moment-computable")
