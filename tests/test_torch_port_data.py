"""The port's data pipeline pieces against the JAX package's, on the CPU:

- ``data.augment.augment_batch`` bit-equal to the JAX package's numpy
  augmentation (``data/native.py _augment_numpy``, called directly so no
  native library is built), over seeds, pads and border fills;
- ``data.datasets.norm_zero`` equal;
- the augmented epoch stream of ``experiments/train_model.py
  epoch_batches`` bit-equal to the JAX package's;
- ``data.prepare`` on MNIST IDX files, CIFAR-10 pickles and the digits,
  all written by the test itself (nothing is downloaded): every ``.npy``
  file byte-equal to the one the JAX package's ``prepare`` writes, and
  ``load_dataset`` reading it back;
- ``run_train`` with ``augment=True`` on the digits convnet.

Everything here is exact (host numpy in both packages).
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import gzip
import math
import os
import pickle
import struct

import numpy as np
import pytest

from torchpruner_tpu.data import datasets as JD
from torchpruner_tpu.data import native as JN
from torchpruner_tpu.data import prepare as JP
from torchpruner_tpu.experiments import train_model as JTM
from torchpruner_tpu.utils.config import ExperimentConfig as JConfig
from torchpruner_tpu_torch.data import augment as PAUG
from torchpruner_tpu_torch.data import datasets as PD
from torchpruner_tpu_torch.data import prepare as PP
from torchpruner_tpu_torch.data.datasets import Dataset
from torchpruner_tpu_torch.experiments import train_model as PTM
from torchpruner_tpu_torch.utils.config import ExperimentConfig


def _images(n=6, h=12, w=10, c=3, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("seed,pad,fill", [
    (0, 4, None), (12345, 4, None), (2 ** 63 + 17, 2, None),
    (7, 4, [-2.1, -2.0, -1.8]), (9, 3, 0.5), (3, 0, None)])
def test_augment_batch_bit_equal_to_the_reference(seed, pad, fill):
    x = _images()
    got = PAUG.augment_batch(x, seed=seed, pad=pad, fill=fill)
    jfill = None if fill is None else np.repeat(
        np.asarray(fill, np.float32).reshape(-1), 3 // np.size(fill))
    want = JN._augment_numpy(x, seed, pad, jfill)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.array_equal(got, want)
    for a, b in zip(PAUG._augment_draws(16, seed, pad),
                    JN._augment_draws(16, seed, pad)):
        assert np.array_equal(a, b)


def test_augment_batch_passes_non_images_and_checks_fill():
    flat = np.ones((4, 7), np.float32)
    assert PAUG.augment_batch(flat, seed=1) is flat
    with pytest.raises(ValueError, match="channels"):
        PAUG.augment_batch(_images(c=3), seed=1, fill=[0.0, 1.0])


@pytest.mark.parametrize("name", ["mnist", "cifar10", "digits", "mnist_flat",
                                  "digits32", "imagenet"])
def test_norm_zero_equal(name):
    got, want = PD.norm_zero(name), JD.norm_zero(name)
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("dataset,shape", [("cifar10", (32, 32, 3)),
                                           ("digits", (8, 8, 1))])
def test_augmented_epoch_stream_equals_the_jax_stream(dataset, shape):
    """Two epochs of B 16 over 40 images (a ragged tail), augmented with
    the per-batch seed rule and the dataset's border fill: the same
    batches as the JAX package's ``epoch_batches``, bit for bit."""
    rng = np.random.default_rng(1)
    ds = Dataset(rng.normal(size=(40,) + shape).astype(np.float32),
                 rng.integers(0, 10, size=40).astype(np.int32))
    kw = dict(dataset=dataset, batch_size=16, augment=True, seed=3)
    cfg = ExperimentConfig(**kw)
    jcfg = JConfig(**kw, prefetch=False)
    for epoch in (0, 1):
        got = list(PTM.epoch_batches(ds, cfg, epoch))
        want = list(JTM.epoch_batches(ds, jcfg, epoch))
        assert [len(x) for x, _ in got] == [16, 16, 8]
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    plain = list(PTM.epoch_batches(ds, dataclasses.replace(
        cfg, augment=False), 0))
    assert not np.array_equal(plain[0][0], got[0][0])


def _write_idx(path, a):
    a = np.ascontiguousarray(a, np.uint8)
    head = struct.pack(">I", (0x08 << 8) | a.ndim) + struct.pack(
        f">{a.ndim}I", *a.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + a.tobytes())


def _files(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".npy"))


def _same_bytes(a_dir, b_dir):
    names = _files(a_dir)
    assert names and names == _files(b_dir)
    for n in names:
        with open(os.path.join(a_dir, n), "rb") as fa, \
                open(os.path.join(b_dir, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


def test_prepare_mnist_byte_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    src = tmp_path / "idx"
    src.mkdir()
    for stem, n, gz in (("train", 30, True), ("t10k", 8, False)):
        suffix = ".gz" if gz else ""
        _write_idx(str(src / f"{stem}-images-idx3-ubyte{suffix}"),
                   rng.integers(0, 256, size=(n, 28, 28)))
        _write_idx(str(src / f"{stem}-labels-idx1-ubyte{suffix}"),
                   rng.integers(0, 10, size=(n,)))
    sizes = PP.prepare_mnist(str(src), str(tmp_path / "p"), n_val=6)
    assert sizes == JP.prepare_mnist(str(src), str(tmp_path / "j"), n_val=6)
    assert sizes == {"train": 24, "val": 6, "test": 8}
    names = _same_bytes(tmp_path / "p", tmp_path / "j")
    assert len(names) == 12  # mnist and mnist_flat, 3 splits, x and y
    monkeypatch.setenv("TORCHPRUNER_TPU_DATA_DIR", str(tmp_path / "p"))
    ds = PD.load_dataset("mnist", "val")
    assert ds.x.shape == (6, 28, 28, 1) and ds.y.dtype == np.int32


def test_prepare_cifar10_byte_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    src = tmp_path / "cifar-10-batches-py"
    src.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(src / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, size=(4, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, size=4).tolist()},
                        f)
    sizes = PP.prepare_cifar10(str(src), str(tmp_path / "p"), n_val=5)
    assert sizes == JP.prepare_cifar10(str(src), str(tmp_path / "j"),
                                       n_val=5)
    assert sizes == {"train": 15, "val": 5, "test": 4}
    _same_bytes(tmp_path / "p", tmp_path / "j")
    monkeypatch.setenv("TORCHPRUNER_TPU_DATA_DIR", str(tmp_path / "p"))
    ds = PD.load_dataset("cifar10_flat", "train")
    assert ds.x.shape == (15, 3072) and ds.x.dtype == np.float32


def test_prepare_digits_and_the_cli_byte_equal(tmp_path, capsys):
    PP.main(["digits", "--out", str(tmp_path / "p")])
    assert "digits ->" in capsys.readouterr().out
    JP.prepare_digits(str(tmp_path / "j"))
    assert len(_same_bytes(tmp_path / "p", tmp_path / "j")) == 12


def test_run_train_with_augmentation_on_a_conv_net(tmp_path):
    """One epoch of the digits convnet with ``augment=True`` (and
    ``accum_steps`` 2 on batches that divide): 4 steps, finite losses."""
    cfg = ExperimentConfig(name="aug", model="digits_convnet",
                           dataset="digits", experiment="train", epochs=1,
                           batch_size=64, optimizer="adam", lr=1e-3,
                           augment=True, accum_steps=2,
                           log_path=str(tmp_path / "t.csv"))
    train = PD.load_dataset("digits", "train")
    train = Dataset(train.x[:256], train.y[:256], train.name)
    datasets = (train, PD.load_dataset("digits", "val"),
                PD.load_dataset("digits", "test"))
    trainer, hist = PTM.run_train(cfg, datasets=datasets, verbose=False,
                                  device="cpu")
    assert trainer.step_count == 4 and len(hist) == 1
    assert all(math.isfinite(hist[0][k])
               for k in ("train_loss", "test_loss", "test_acc"))
