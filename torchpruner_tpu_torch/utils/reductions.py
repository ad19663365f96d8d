"""Named reductions over per-example attribution rows ``(N, n_units)`` —
counterpart of ``torchpruner_tpu/utils/reductions.py``."""

from __future__ import annotations

import numpy as np


def mean_plus_2std(rows: np.ndarray) -> np.ndarray:
    return np.mean(rows, 0) + 2.0 * np.std(rows, 0)
