"""In-memory datasets with deterministic batching — counterpart of
``torchpruner_tpu/data/datasets.py``.

Host numpy only, copied from the JAX package so the port yields the same
arrays bit for bit from the same names, splits and seeds (real data from
``$TORCHPRUNER_TPU_DATA_DIR`` when present, the bundled 8x8 digits for
the ``digits*`` names, else the synthetic generators of the right
shapes).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

#: (input_shape channels-last, n_classes) of the reference's datasets, plus
#: the BASELINE.json image targets.
DATASET_SHAPES = {
    "mnist": ((28, 28, 1), 10),
    "fashion_mnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
    "mnist_flat": ((784,), 10),
    "cifar10_flat": ((3072,), 10),
    "imagenet": ((224, 224, 3), 1000),
    "imagenet64": ((64, 64, 3), 1000),
    "tiny_images16": ((16, 16, 3), 10),
    # scikit-learn's bundled handwritten-digits set (1,797 REAL 8x8 scans,
    # no download): the in-CI real-data vehicle for the reference's
    # untrained-net-pruning and method-ranking experiments
    "digits": ((8, 8, 1), 10),
    "digits_flat": ((64,), 10),
    # digits upscaled 8x8 -> 32x32 (nearest-neighbour) and tiled to 3
    # channels: REAL image data at CIFAR-10 geometry, so VGG16-bn-scale
    # experiments (training + the layerwise-robustness sweep) can run on
    # a genuinely trained net in environments without the CIFAR files
    "digits32": ((32, 32, 3), 10),
    "digits32_flat": ((3072,), 10),
}

#: fixed deterministic split of the 1,797 digits examples
_DIGITS_SPLIT = {"train": (0, 1297), "val": (1297, 1497), "test": (1497, 1797)}

#: (seq_len, vocab_size, n_classes) — token datasets; ``n_classes=None``
#: marks language-modeling data (targets = inputs, next-token loss).
TOKEN_DATASET_SHAPES = {
    "glue_sst2": (128, 30522, 2),
    "glue_tiny": (16, 128, 2),
    "lm_corpus": (2048, 128256, None),
    "lm_mfu": (1024, 32000, None),  # matches models.mfu_llama
    "lm_tiny": (16, 256, None),
}


@dataclass
class Dataset:
    """A pair of arrays + batching.  ``batches()`` returns a list (re-iterable,
    the contract attribution metrics expect); ``iter_batches`` streams."""

    x: np.ndarray
    y: np.ndarray
    name: str = "dataset"

    def __len__(self):
        return len(self.x)

    def subset(self, n: int, seed: int = 0) -> "Dataset":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))[:n]
        return Dataset(self.x[idx], self.y[idx], self.name)

    def resample(self, n: int, seed: int = 0) -> "Dataset":
        """``n`` examples drawn WITH replacement — grows a split past its
        real size for cost-curve measurements (wall-clock depends on
        array sizes, not label novelty; see experiments/sweep_scaling).
        Not for accuracy evaluation: repeated examples bias statistics."""
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(self.x), size=n)
        return Dataset(self.x[idx], self.y[idx],
                       f"{self.name}[resampled {n}]")

    def iter_batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.x)
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        stop = n - (n % batch_size) if drop_remainder else n
        for i in range(0, stop, batch_size):
            j = idx[i : i + batch_size]
            yield self.x[j], self.y[j]

    def batches(self, batch_size: int, **kw):
        return list(self.iter_batches(batch_size, **kw))


def synthetic_dataset(
    input_shape,
    n_classes: int,
    n: int,
    seed: int = 0,
    name: str = "synthetic",
    center_seed: int = 1234,
) -> Dataset:
    """Deterministic gaussian-blob classification data: class c is drawn
    around a class-specific random mean, so models can actually learn
    (loss decreases, pruning effects are measurable).

    Class centers depend only on ``center_seed`` — train/val/test splits
    generated with different ``seed`` values share the same class structure.
    """
    centers = np.random.default_rng(center_seed).normal(
        0.0, 1.0, size=(n_classes,) + tuple(input_shape)
    )
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=(n,))
    x = centers[y] + rng.normal(0.0, 1.0, size=(n,) + tuple(input_shape))
    return Dataset(x.astype(np.float32), y.astype(np.int32), name)


def _load_from_disk(name: str, split: str, dtype) -> Optional[Dataset]:
    """``$TORCHPRUNER_TPU_DATA_DIR/{name}_{split}_{x,y}.npy`` if present
    (real data drops in for any dataset name, image or token).

    ``x`` is memory-mapped: imagenet-scale arrays never fully
    materialize in host RAM — batching slices copy only the touched rows
    (labels are small and load eagerly).  The dtype conversion is skipped
    when the file already carries the requested dtype (what
    ``data/prepare.py`` writes), preserving the mapping; a mismatched
    dtype forces a one-time conversion in memory."""
    data_dir = os.environ.get("TORCHPRUNER_TPU_DATA_DIR", "")
    fx = os.path.join(data_dir, f"{name}_{split}_x.npy")
    fy = os.path.join(data_dir, f"{name}_{split}_y.npy")
    if data_dir and os.path.exists(fx) and os.path.exists(fy):
        x = np.load(fx, mmap_mode="r")
        if x.dtype != dtype:
            x = np.asarray(x).astype(dtype)
        # y maps too: for LM datasets the target file is corpus-sized
        y = np.load(fy, mmap_mode="r")
        if y.dtype != np.int32:
            y = np.asarray(y).astype(np.int32)
        return Dataset(x, y, name)
    return None


def synthetic_token_dataset(
    seq_len: int,
    vocab_size: int,
    n_classes: Optional[int],
    n: int,
    seed: int = 0,
    name: str = "tokens",
    center_seed: int = 1234,
) -> Dataset:
    """Deterministic synthetic token data.

    Classification (``n_classes`` set): each class has a preferred token
    subset (drawn from ``center_seed``); examples mix class tokens with
    uniform noise, so attention models can actually learn the labels.
    Language modeling (``n_classes=None``): first-order Markov sequences
    with a fixed random transition structure; targets are the inputs
    (next-token objective).
    """
    rng = np.random.default_rng(seed)
    cg = np.random.default_rng(center_seed)
    if n_classes is not None:
        pref = cg.integers(0, vocab_size, size=(n_classes, max(4, seq_len // 4)))
        y = rng.integers(0, n_classes, size=(n,))
        x = rng.integers(0, vocab_size, size=(n, seq_len))
        sig = rng.random((n, seq_len)) < 0.5  # half the positions carry signal
        choice = rng.integers(0, pref.shape[1], size=(n, seq_len))
        x = np.where(sig, pref[y[:, None], choice], x)
        return Dataset(x.astype(np.int32), y.astype(np.int32), name)
    # LM: sparse Markov chain — each token has a few likely successors
    succ = cg.integers(0, vocab_size, size=(vocab_size, 4))
    x = np.empty((n, seq_len), dtype=np.int64)
    x[:, 0] = rng.integers(0, vocab_size, size=(n,))
    for t in range(1, seq_len):
        pick = succ[x[:, t - 1], rng.integers(0, 4, size=(n,))]
        noise = rng.integers(0, vocab_size, size=(n,))
        x[:, t] = np.where(rng.random(n) < 0.8, pick, noise)
    x = x.astype(np.int32)
    return Dataset(x, x, name)


def _load_digits(name: str, split: str) -> Dataset:
    """The real 8x8 digits scans (scikit-learn's ``load_digits``: the test
    set of the UCI Optical Recognition of Handwritten Digits data,
    Alpaydin and Kaynak, 1998, CC BY 4.0), bundled as ``digits.npz``
    (pixel counts 0..16 and labels, uint8) so that no machine needs
    scikit-learn.  Pixels scaled to [0, 1]; a fixed permutation (seed 0)
    makes the train/val/test split deterministic."""
    if split not in _DIGITS_SPLIT:
        raise KeyError(
            f"unknown digits split {split!r} (use one of "
            f"{sorted(_DIGITS_SPLIT)})"
        )
    raw = np.load(os.path.join(os.path.dirname(__file__), "digits.npz"))
    x = (raw["x"] / 16.0).astype(np.float32)  # (1797, 64)
    y = raw["y"].astype(np.int32)
    idx = np.random.default_rng(0).permutation(len(x))
    lo, hi = _DIGITS_SPLIT[split]
    sel = idx[lo:hi]
    x = x[sel]
    if name == "digits":
        x = x.reshape(-1, 8, 8, 1)
    return Dataset(x, y[sel], f"{name}:{split}")


def load_dataset(
    name: str, split: str = "train", n: Optional[int] = None, seed: int = 0
) -> Dataset:
    """Load ``name`` (see DATASET_SHAPES / TOKEN_DATASET_SHAPES) from disk
    if available, else synthesize with the right shapes.  ``n`` limits the
    example count."""
    if name == "synthetic":
        name = "mnist_flat"
    if name in TOKEN_DATASET_SHAPES:
        ds = _load_from_disk(name, split, dtype=np.int32)
        if ds is None:
            seq_len, vocab, n_classes = TOKEN_DATASET_SHAPES[name]
            defaults = {"train": 10000, "val": 1000, "test": 2000}
            count = n or defaults.get(split, 1000)
            split_seed = {"train": 1, "val": 2, "test": 3}.get(split, 9)
            ds = synthetic_token_dataset(
                seq_len, vocab, n_classes, count, seed=seed * 10 + split_seed,
                name=f"{name}:{split}:synthetic",
            )
        if n is not None and len(ds) > n:
            ds = ds.subset(n, seed=seed)
        return ds
    if name not in DATASET_SHAPES:
        raise KeyError(
            f"unknown dataset {name!r}; known: "
            f"{list(DATASET_SHAPES) + list(TOKEN_DATASET_SHAPES)}"
        )
    shape, n_classes = DATASET_SHAPES[name]
    ds = _load_from_disk(name, split, dtype=np.float32)
    if ds is None and name in ("digits", "digits_flat"):
        ds = _load_digits(name, split)
    if ds is None and name in ("digits32", "digits32_flat"):
        base = _load_digits("digits", split)
        x = np.kron(base.x, np.ones((1, 4, 4, 1), np.float32))
        x = np.repeat(x, 3, axis=3)
        if name == "digits32_flat":
            # CIFAR-10-FC geometry (3072 = 32*32*3,) on real scans —
            # the vehicle for the reference's untrained CIFAR10-FC row
            x = x.reshape(len(x), -1)
        ds = Dataset(x, base.y, f"{name}:{split}")
    if ds is None:
        defaults = {"train": 50000, "val": 1000, "test": 10000}
        count = n or defaults.get(split, 1000)
        # different splits draw from the same class centers (same seed for
        # centers via the generator chain) but different example noise
        split_seed = {"train": 1, "val": 2, "test": 3}.get(split, 9)
        ds = synthetic_dataset(shape, n_classes, count, seed=seed * 10 + split_seed,
                               name=f"{name}:{split}:synthetic")
    if n is not None and len(ds) > n:
        ds = ds.subset(n, seed=seed)
    return ds
