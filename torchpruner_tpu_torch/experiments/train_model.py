"""From-scratch training driver — counterpart of
``torchpruner_tpu/experiments/train_model.py``: config-driven training
with the LR schedules, an evaluation once an epoch and the per-epoch CSV
rows.  Each epoch's order is the splitmix64 shuffle of
``data/shuffle.py`` seeded ``cfg.seed * 1000 + epoch``, the JAX
package's stream whether or not its prefetch is on (the port has no
background prefetch: ``prefetch`` gives the same batches either way).
With ``cfg.checkpoint_path`` set the run resumes from the checkpoint
there (its ``extra["epoch"]``) and saves to it every
``cfg.checkpoint_every_epochs`` and at the end, in the format both
packages read (``checkpoint.py``).  With ``cfg.augment`` each image
batch is flipped and shift-cropped (``data/augment.py``), seeded
``(cfg.seed * 1000 + epoch) * 1_000_003 + b`` for batch ``b``, its
border filled with ``data.datasets.norm_zero``'s value: the JAX
package's batches bit for bit.  ``cfg.remat`` and ``cfg.accum_steps`` go to the trainer; as in
the JAX package, an epoch's ragged tail batch that ``accum_steps`` does
not divide raises.  Each epoch's training and evaluation run in obs
``train`` / ``eval`` spans, and the epoch is ledgered
(``obs.record_epoch``).
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Tuple

import numpy as np

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from torchpruner_tpu_torch.data.augment import augment_batch
from torchpruner_tpu_torch.data.datasets import norm_zero
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
    """One epoch's batches: the splitmix64 permutation seeded ``seed =
    cfg.seed * 1000 + epoch``, cut into ``cfg.batch_size`` slices (the
    last one ragged); with ``cfg.augment`` batch ``b`` augmented with
    seed ``seed * 1_000_003 + b``."""
    seed = cfg.seed * 1000 + epoch
    idx = shuffled_indices(len(dataset), seed)
    fill = norm_zero(cfg.dataset) if cfg.augment else None
    for b, i in enumerate(range(0, len(dataset), cfg.batch_size)):
        j = idx[i:i + cfg.batch_size]
        x = dataset.x[j]
        if cfg.augment:
            x = augment_batch(x, seed=seed * 1_000_003 + b, fill=fill)
        yield x, dataset.y[j]


def run_train(cfg: ExperimentConfig, *, model=None, datasets=None,
              verbose: bool = True, device=None):
    """Train ``cfg.model`` on ``cfg.dataset`` for ``cfg.epochs`` on
    ``device`` (``None`` = ``cuda``; raises without a GPU unless
    ``device="cpu"``).  Resumes from ``cfg.checkpoint_path`` when a
    checkpoint exists there and saves to it every
    ``cfg.checkpoint_every_epochs`` and at the end.  Returns the trainer
    and the per-epoch history ``[{epoch, train_loss, test_loss,
    test_acc, seconds}, ...]`` of the epochs this call ran."""
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
    start_epoch = 0
    params = state = opt_state = None
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        model, params, state, opt_state, meta = restore_checkpoint(
            cfg.checkpoint_path, tx=tx, device=dev)
        start_epoch = int(meta.get("extra", {}).get("epoch", 0))
        if verbose:
            print(f"[{cfg.name}] resumed from {cfg.checkpoint_path} at "
                  f"epoch {start_epoch}", flush=True)
    trainer = Trainer.create(model, tx, LOSS_REGISTRY[cfg.loss],
                             seed=cfg.seed, params=params, state=state,
                             compute_dtype=compute_dtype(cfg.compute_dtype),
                             device=dev, remat=cfg.remat,
                             accum_steps=cfg.accum_steps)
    if opt_state is not None:
        trainer.opt_state = opt_state
    test_batches = test.batches(cfg.eval_batch_size)
    history = []
    with CSVLogger(cfg.log_path, experiment=cfg.name) as logger:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            with obs.span("train", epoch=epoch):
                # losses stay on the device until the epoch ends
                losses = [trainer.step(x, y)
                          for x, y in epoch_batches(train, cfg, epoch)]
                losses = [float(l) for l in losses]
            with obs.span("eval", epoch=epoch):
                test_loss, test_acc = trainer.evaluate(test_batches)
            rec = {"epoch": epoch,
                   "train_loss": float(np.mean(losses)) if losses
                   else float("nan"),
                   "test_loss": test_loss, "test_acc": test_acc,
                   "seconds": time.perf_counter() - t0}
            history.append(rec)
            obs.record_epoch(**rec)
            logger.log_epoch(epoch=epoch, train_loss=rec["train_loss"],
                             test_loss=test_loss, test_acc=test_acc,
                             seconds=rec["seconds"])
            if verbose:
                print(f"[{cfg.name}] epoch {epoch}: train "
                      f"{rec['train_loss']:.4f} test {test_loss:.4f} acc "
                      f"{test_acc:.4f} ({rec['seconds']:.1f}s)", flush=True)
            if cfg.checkpoint_path and (
                    (cfg.checkpoint_every_epochs
                     and (epoch + 1) % cfg.checkpoint_every_epochs == 0)
                    or epoch + 1 == cfg.epochs):
                save_checkpoint(cfg.checkpoint_path, trainer.model,
                                trainer.params, trainer.state,
                                trainer.opt_state,
                                extra={"epoch": epoch + 1})
    return trainer, history
