"""The splitmix64 Fisher-Yates shuffle — the port's copy of the pure-Python
path of ``torchpruner_tpu/data/native.py`` (``_splitmix64``,
``_py_shuffle``, ``shuffled_indices``).  Training epochs draw their
order from it, so a seed gives both packages the same batches.  The JAX
package's optional C++ library draws the same sequence; the port has no
native path."""

from __future__ import annotations

from typing import Tuple

import numpy as np

_M = (1 << 64) - 1


def _splitmix64(s: int) -> Tuple[int, int]:
    s = (s + 0x9E3779B97F4A7C15) & _M
    z = s
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M
    return s, z ^ (z >> 31)


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """Seeded permutation of ``0..n-1``: Fisher-Yates from the top, each
    swap index drawn from splitmix64 without modulo bias (draws below
    ``2**64 mod bound`` are rejected)."""
    idx = np.arange(n, dtype=np.int64)
    s = seed & _M
    for i in range(n - 1, 0, -1):
        bound = i + 1
        threshold = ((1 << 64) - bound) % bound  # 2**64 mod bound
        while True:
            s, r = _splitmix64(s)
            if r >= threshold:
                break
        j = r % bound
        idx[i], idx[j] = idx[j], idx[i]
    return idx
