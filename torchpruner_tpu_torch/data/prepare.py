"""Prepare real datasets into the ``TORCHPRUNER_TPU_DATA_DIR`` npy layout
— the port's copy of ``torchpruner_tpu/data/prepare.py``.

:func:`~torchpruner_tpu_torch.data.load_dataset` looks for
``{name}_{split}_{x,y}.npy`` under ``$TORCHPRUNER_TPU_DATA_DIR`` before
synthesizing.  This module converts the public distribution files a user
already has into that layout, with the reference's preprocessing; it
never downloads:

- **MNIST** from the four IDX files (``train-images-idx3-ubyte[.gz]``
  ...), normalized with the ``(0.1307, 0.3081)`` mean / std, a 54k / 6k
  train / val split by a fixed permutation plus the 10k test set;
  written as ``mnist`` (28, 28, 1) and ``mnist_flat`` (784,).
- **CIFAR-10** from the ``cifar-10-batches-py`` pickles, normalized with
  the ImageNet mean (0.485, 0.456, 0.406) and std (0.229, 0.224, 0.225),
  a 45k / 5k split plus the 10k test set; written as ``cifar10`` NHWC
  and ``cifar10_flat``.  Train-time flip and crop are not baked in:
  ``data.augment.augment_batch`` draws them per batch.
- **digits** needs no input files (the 8x8 scans are bundled);
  ``prepare_digits`` writes the same arrays for inspection.

The arrays written are byte-equal to the JAX package's for the same
input files.  CLI::

    python -m torchpruner_tpu_torch.data.prepare mnist   --src IDX_DIR --out DIR
    python -m torchpruner_tpu_torch.data.prepare cifar10 --src cifar-10-batches-py --out DIR
    python -m torchpruner_tpu_torch.data.prepare digits  --out DIR
"""

from __future__ import annotations

import argparse
import gzip
import os
import pickle
import struct
from typing import Dict, Tuple

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_SPLIT_SEED = 0  # fixed permutation for the train/val split


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find(src: str, *names: str) -> str:
    for n in names:
        for cand in (os.path.join(src, n), os.path.join(src, n + ".gz")):
            if os.path.exists(cand):
                return cand
    raise FileNotFoundError(f"none of {names} (or .gz) under {src}")


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (the MNIST distribution format)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        if (magic >> 8) != 0x08:  # 0x08 = unsigned byte data
            raise ValueError(f"{path}: unsupported IDX magic {magic:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _split(x: np.ndarray, y: np.ndarray, n_val: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    idx = np.random.default_rng(_SPLIT_SEED).permutation(len(x))
    val, train = idx[:n_val], idx[n_val:]
    return x[train], y[train], x[val], y[val]


def _write(out: str, name: str, split: str, x: np.ndarray, y: np.ndarray):
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, f"{name}_{split}_x.npy"), x)
    np.save(os.path.join(out, f"{name}_{split}_y.npy"), y.astype(np.int32))


def _write_splits(out: str, name: str, train, val, test) -> Dict[str, int]:
    """Each split as ``name`` (images) and ``name_flat``; returns the
    split sizes."""
    sizes = {}
    for split, (x, y) in (("train", train), ("val", val), ("test", test)):
        _write(out, name, split, x, y)
        _write(out, f"{name}_flat", split, x.reshape(len(x), -1), y)
        sizes[split] = len(x)
    return sizes


def prepare_mnist(src: str, out: str, n_val: int = 6000) -> Dict[str, int]:
    """IDX files -> mnist / mnist_flat npy layout.  Returns split sizes."""
    xs = read_idx(_find(src, "train-images-idx3-ubyte",
                        "train-images.idx3-ubyte"))
    ys = read_idx(_find(src, "train-labels-idx1-ubyte",
                        "train-labels.idx1-ubyte"))
    xt = read_idx(_find(src, "t10k-images-idx3-ubyte",
                        "t10k-images.idx3-ubyte"))
    yt = read_idx(_find(src, "t10k-labels-idx1-ubyte",
                        "t10k-labels.idx1-ubyte"))

    def norm(a):
        a = a.astype(np.float32) / 255.0
        return ((a - MNIST_MEAN) / MNIST_STD)[..., None]  # NHWC, C=1

    xs, xt = norm(xs), norm(xt)
    x_tr, y_tr, x_val, y_val = _split(xs, ys, n_val)
    return _write_splits(out, "mnist", (x_tr, y_tr), (x_val, y_val),
                         (xt, yt))


def prepare_cifar10(src: str, out: str, n_val: int = 5000) -> Dict[str, int]:
    """``cifar-10-batches-py`` pickles -> cifar10 / cifar10_flat layout."""

    def read_batch(name):
        with open(_find(src, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
        return x, np.asarray(d[b"labels"])

    parts = [read_batch(f"data_batch_{i}") for i in range(1, 6)]
    xs = np.concatenate([p[0] for p in parts])
    ys = np.concatenate([p[1] for p in parts])
    xt, yt = read_batch("test_batch")

    def norm(a):
        a = a.astype(np.float32) / 255.0
        return (a - IMAGENET_MEAN) / IMAGENET_STD

    xs, xt = norm(xs), norm(xt)
    x_tr, y_tr, x_val, y_val = _split(xs, ys, n_val)
    return _write_splits(out, "cifar10", (x_tr, y_tr), (x_val, y_val),
                         (xt, yt))


def prepare_digits(out: str) -> Dict[str, int]:
    """The bundled digits under the npy layout (the loaders already serve
    them without this)."""
    from torchpruner_tpu_torch.data.datasets import _load_digits

    sizes = {}
    for split in ("train", "val", "test"):
        for name in ("digits", "digits_flat"):
            ds = _load_digits(name, split)
            _write(out, name, split, ds.x, ds.y)
        sizes[split] = len(ds.x)
    return sizes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", choices=["mnist", "cifar10", "digits"])
    ap.add_argument("--src", default="", help="directory with the "
                    "distribution files (mnist / cifar10)")
    ap.add_argument("--out", default=os.environ.get(
        "TORCHPRUNER_TPU_DATA_DIR", "data"))
    args = ap.parse_args(argv)
    if args.dataset == "digits":
        sizes = prepare_digits(args.out)
    elif args.dataset == "mnist":
        sizes = prepare_mnist(args.src, args.out)
    else:
        sizes = prepare_cifar10(args.src, args.out)
    print(f"{args.dataset} -> {args.out}: {sizes}")


if __name__ == "__main__":
    main()
