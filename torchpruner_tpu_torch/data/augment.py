"""Train-time image augmentation — the port's copy of the numpy path of
``torchpruner_tpu/data/native.py`` (``_augment_draws``,
``_augment_numpy``, ``augment_batch``): random horizontal flip, then a
``pad``-pixel shift-and-crop, each example drawing from its own
splitmix64 stream, so a seed gives both packages the same batch bit for
bit.  The JAX package's optional C++ library (``cpp/data_pipeline.cc``)
draws the same numbers faster; the port has no native path (ROADMAP
A3b)."""

from __future__ import annotations

import numpy as np

_M = (1 << 64) - 1


def _augment_draws(n: int, seed: int, pad: int):
    """Per-example splitmix64 streams seeded ``seed ^ ((i+1) *
    0xD1B54A32D192ED03)``, three draws each: ``(flip bool, dy, dx)``."""
    span = np.uint64(2 * pad + 1)
    s = (np.uint64(seed & _M)
         ^ (np.arange(1, n + 1, dtype=np.uint64)
            * np.uint64(0xD1B54A32D192ED03)))

    def draw(state):
        # uint64 arithmetic wraps mod 2**64
        state = state + np.uint64(0x9E3779B97F4A7C15)
        z = state.copy()
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return state, z ^ (z >> np.uint64(31))

    s, r1 = draw(s)
    s, r2 = draw(s)
    s, r3 = draw(s)
    return ((r1 & np.uint64(1)).astype(bool),
            (r2 % span).astype(np.int64),
            (r3 % span).astype(np.int64))


def _augment_numpy(x: np.ndarray, seed: int, pad: int,
                   fill=None) -> np.ndarray:
    """Flip, then pad (0, or ``fill`` per channel) and crop back to the
    image size at the drawn offset."""
    n, h, w, c = x.shape
    flip, dy, dx = _augment_draws(n, seed, pad)
    x = np.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
    if fill is None:
        padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="constant")
    else:
        padded = np.empty((n, h + 2 * pad, w + 2 * pad, c), np.float32)
        padded[:] = np.asarray(fill, np.float32)
        padded[:, pad:pad + h, pad:pad + w, :] = x
    rows = dy[:, None] + np.arange(h)[None, :]
    cols = dx[:, None] + np.arange(w)[None, :]
    return padded[np.arange(n)[:, None, None], rows[:, :, None],
                  cols[:, None, :], :]


def augment_batch(x: np.ndarray, seed: int, pad: int = 4,
                  fill=None) -> np.ndarray:
    """Random horizontal flip + ``pad``-pixel shift-and-crop of a
    channels-last float32 image batch; a non-image (not 4-d) batch passes
    through unchanged.

    ``fill`` is the per-channel border value (a length-``c`` vector, one
    value, or None for 0).  Augmentation runs after normalization, where
    the reference pads the raw image with 0 before normalizing, so its
    border sits at ``-mean/std``: pass
    :func:`~torchpruner_tpu_torch.data.datasets.norm_zero`'s value to
    reproduce it."""
    if x.ndim != 4:
        return x
    x = np.ascontiguousarray(x, dtype=np.float32)
    c = x.shape[-1]
    if fill is not None:
        fill = np.ascontiguousarray(fill, dtype=np.float32).reshape(-1)
        if fill.size == 1:
            fill = np.repeat(fill, c)
        if fill.size != c:
            raise ValueError(f"fill has {fill.size} channels, images have "
                             f"{c}")
    return _augment_numpy(x, seed, pad, fill)
