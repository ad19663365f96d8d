"""From-scratch training driver — counterpart of
``torchpruner_tpu/experiments/train_model.py``: config-driven training
with the LR schedules, an evaluation once an epoch and the per-epoch CSV
rows.  Each epoch's order is the splitmix64 shuffle of
``data/shuffle.py`` seeded ``cfg.seed * 1000 + epoch``, the JAX
package's stream whether or not its prefetch is on (the port has no
background prefetch: ``prefetch`` gives the same batches either way).
Augmentation (ROADMAP A3b) and checkpoints (A1e) are not ported and
raise.
"""

from __future__ import annotations

import time
from typing import Iterator, Tuple

import numpy as np

from torchpruner_tpu_torch.data.shuffle import shuffled_indices
from torchpruner_tpu_torch.train.logger import CSVLogger
from torchpruner_tpu_torch.train.loop import Trainer
from torchpruner_tpu_torch.utils.config import ExperimentConfig
from torchpruner_tpu_torch.utils.device import (
    resolve_device,
    strict_fp32_matmul,
)


def epoch_batches(dataset, cfg: ExperimentConfig, epoch: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch's batches: the splitmix64 permutation seeded
    ``cfg.seed * 1000 + epoch``, cut into ``cfg.batch_size`` slices (the
    last one ragged)."""
    if cfg.augment:
        raise NotImplementedError(
            "augment=True is not ported yet (ROADMAP A3b)")
    idx = shuffled_indices(len(dataset), cfg.seed * 1000 + epoch)
    for i in range(0, len(dataset), cfg.batch_size):
        j = idx[i:i + cfg.batch_size]
        yield dataset.x[j], dataset.y[j]


def run_train(cfg: ExperimentConfig, *, model=None, datasets=None,
              verbose: bool = True, device=None):
    """Train ``cfg.model`` on ``cfg.dataset`` for ``cfg.epochs`` on
    ``device`` (``None`` = ``cuda``; raises without a GPU unless
    ``device="cpu"``).  Returns the trainer and the per-epoch history
    ``[{epoch, train_loss, test_loss, test_acc, seconds}, ...]``."""
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        check_ported,
        compute_dtype,
        make_optimizer,
        resolve_model_and_data,
    )

    check_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32_matmul()
    model, (train, _val, test) = resolve_model_and_data(cfg, model, datasets)
    tx = make_optimizer(cfg,
                        steps_per_epoch=max(1, len(train) // cfg.batch_size))
    trainer = Trainer.create(model, tx, LOSS_REGISTRY[cfg.loss],
                             seed=cfg.seed,
                             compute_dtype=compute_dtype(cfg.compute_dtype),
                             device=dev)
    test_batches = test.batches(cfg.eval_batch_size)
    history = []
    with CSVLogger(cfg.log_path, experiment=cfg.name) as logger:
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            # losses stay on the device until the epoch ends
            losses = [trainer.step(x, y)
                      for x, y in epoch_batches(train, cfg, epoch)]
            losses = [float(l) for l in losses]
            test_loss, test_acc = trainer.evaluate(test_batches)
            rec = {"epoch": epoch,
                   "train_loss": float(np.mean(losses)) if losses
                   else float("nan"),
                   "test_loss": test_loss, "test_acc": test_acc,
                   "seconds": time.perf_counter() - t0}
            history.append(rec)
            logger.log_epoch(epoch=epoch, train_loss=rec["train_loss"],
                             test_loss=test_loss, test_acc=test_acc,
                             seconds=rec["seconds"])
            if verbose:
                print(f"[{cfg.name}] epoch {epoch}: train "
                      f"{rec['train_loss']:.4f} test {test_loss:.4f} acc "
                      f"{test_acc:.4f} ({rec['seconds']:.1f}s)", flush=True)
    return trainer, history
