"""The prune → fine-tune driver — counterpart of
``torchpruner_tpu/experiments/prune_retrain.py`` (without the resumable
journal and the mesh): for each prunable layer, outermost first: score →
turn scores into indices (policy) → prune (or, with ``cfg.simulate``,
mask the same slices at fixed shapes) → evaluate (→ optionally
fine-tune).

Inside an obs session the run is annotated (``obs.annotate_run``) and
emits the span ``prune_retrain`` around ``setup`` and, per target,
``attribution``, ``eval`` (pre and post), ``prune``, ``retrain`` and
``flops``, each tagged with the target's name, plus the ledger's
``score_distribution``, ``record_prune`` and ``record_round`` records.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.attributions import (
    APoZAttributionMetric,
    RandomAttributionMetric,
    SensitivityAttributionMetric,
    ShapleyAttributionMetric,
    TaylorAttributionMetric,
    WeightNormAttributionMetric,
)
from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.graph import pruning_graph
from torchpruner_tpu_torch.core.masking import apply_masks, drop_masks
from torchpruner_tpu_torch.core.pruner import prune, score_drop_indices
from torchpruner_tpu_torch.data import load_dataset
from torchpruner_tpu_torch.experiments.presets import MODEL_REGISTRY
from torchpruner_tpu_torch.train import optim
from torchpruner_tpu_torch.train.logger import CSVLogger
from torchpruner_tpu_torch.train.loop import Trainer, train_epoch
from torchpruner_tpu_torch.utils.config import ExperimentConfig
from torchpruner_tpu_torch.utils.device import (
    resolve_device,
    strict_fp32_matmul,
)
from torchpruner_tpu_torch.utils.flops import model_cost
from torchpruner_tpu_torch.utils.losses import (
    cross_entropy_loss,
    lm_cross_entropy_loss,
    mse_loss,
    nll_loss,
)
from torchpruner_tpu_torch.utils.reductions import mean_plus_2std

METRIC_REGISTRY = {
    "random": RandomAttributionMetric,
    "weight_norm": WeightNormAttributionMetric,
    "apoz": APoZAttributionMetric,
    "sensitivity": SensitivityAttributionMetric,
    "taylor": TaylorAttributionMetric,
    "shapley": ShapleyAttributionMetric,
}

LOSS_REGISTRY = {
    "cross_entropy": cross_entropy_loss,
    "lm_cross_entropy": lm_cross_entropy_loss,
    "nll": nll_loss,
    "mse": mse_loss,
}


def build_metric(name: str, model, params, data, loss_fn, *, state=None,
                 reduction="mean", seed=0, **kwargs):
    """Metric factory; ``reduction`` accepts the named 'mean+2std'."""
    if reduction == "mean+2std":
        reduction = mean_plus_2std
    if name not in METRIC_REGISTRY:
        raise KeyError(f"unknown attribution method {name!r} (the panel "
                       f"'all' is the robustness sweep's); known: "
                       f"{sorted(METRIC_REGISTRY)}")
    return METRIC_REGISTRY[name](model, params, data, loss_fn, state=state,
                                 reduction=reduction, seed=seed, **kwargs)


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise ``NotImplementedError`` naming every setting of ``cfg`` the
    port does not run yet."""
    missing = cfg.unported()
    if missing:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(f"{s} ({item})"
                                           for s, item in missing))


def compute_dtype(name: str):
    """A config's ``compute_dtype`` / ``score_dtype`` string as the torch
    dtype the trainers and metrics take (``None`` = float32)."""
    return torch.bfloat16 if name == "bfloat16" else None


def resolve_model_and_data(cfg: ExperimentConfig, model=None, datasets=None):
    """Registry lookups with injection overrides; returns ``(model,
    (train, val, test))``."""
    if model is None:
        if cfg.model not in MODEL_REGISTRY:
            raise KeyError(f"unknown model {cfg.model!r}; known: "
                           f"{sorted(MODEL_REGISTRY)}")
        model_fn, default_ds = MODEL_REGISTRY[cfg.model]
        model = model_fn()
        ds_name = cfg.dataset if cfg.dataset != "synthetic" else default_ds
    else:
        if datasets is None and cfg.dataset == "synthetic":
            raise ValueError(
                "injecting a model requires an explicit cfg.dataset (or "
                "injected datasets) — 'synthetic' has no shape to infer")
        ds_name = cfg.dataset
    if datasets is None:
        datasets = (load_dataset(ds_name, "train", seed=cfg.seed),
                    load_dataset(ds_name, "val", n=cfg.score_examples,
                                 seed=cfg.seed),
                    load_dataset(ds_name, "test", seed=cfg.seed))
    return model, datasets


def filter_targets(targets, cfg: ExperimentConfig):
    """Apply ``cfg.target_filter`` (substring match; empty = keep all)."""
    if not cfg.target_filter:
        return list(targets)
    return [t for t in targets if any(s in t for s in cfg.target_filter)]


def policy_for_target(cfg: ExperimentConfig, target: str):
    """``(policy, fraction)`` for one target: the first
    ``cfg.layer_fractions`` substring match forces the fraction policy at
    its ratio; otherwise the config's policy/fraction."""
    for key, frac in (cfg.layer_fractions or {}).items():
        if key in target:
            return "fraction", float(frac)
    return cfg.policy, cfg.fraction


def make_lr_schedule(cfg: ExperimentConfig, steps_per_epoch: int = 1,
                     total_epochs: Optional[int] = None):
    """``cfg.lr_schedule`` as a schedule (or the constant lr); epochs
    convert to optimizer steps through ``steps_per_epoch``;
    ``total_epochs`` sizes the decaying schedules for the whole run."""
    spe = max(1, steps_per_epoch)
    if cfg.lr_schedule == "constant":
        return cfg.lr
    if cfg.lr_schedule == "multistep":
        return optim.piecewise_constant_schedule(
            cfg.lr, {int(m) * spe: cfg.lr_gamma for m in cfg.lr_milestones})
    if total_epochs is None:
        total_epochs = cfg.epochs or cfg.finetune_epochs or 1
    total = max(1, total_epochs) * spe
    if cfg.lr_schedule == "cosine":
        return optim.cosine_decay_schedule(cfg.lr, decay_steps=total)
    warmup = cfg.lr_warmup_epochs * spe
    return optim.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup_steps=max(1, warmup),
        decay_steps=max(total, warmup + 1))


def make_optimizer(cfg: ExperimentConfig, steps_per_epoch: int = 1,
                   total_epochs: Optional[int] = None):
    lr = make_lr_schedule(cfg, steps_per_epoch, total_epochs)
    if cfg.optimizer == "adam":
        return optim.adam(lr)
    if cfg.optimizer == "adamw":
        return optim.adamw(lr, weight_decay=cfg.weight_decay)
    tx = optim.sgd(lr, momentum=cfg.momentum or None)
    if cfg.weight_decay:
        tx = optim.chain(optim.add_decayed_weights(cfg.weight_decay), tx)
    return tx


@dataclass
class PruneStepRecord:
    layer: str
    pre_loss: float
    pre_acc: float
    post_loss: float
    post_acc: float
    n_params: int
    n_dropped: int
    prune_time: float
    widths: Dict[str, int]


def run_prune_retrain(cfg: ExperimentConfig, *, model=None, datasets=None,
                      verbose: bool = True, device=None
                      ) -> List[PruneStepRecord]:
    """Run the prune(-retrain) experiment ``cfg`` on ``device`` (``None``
    = ``cuda``; raises without a GPU unless ``device="cpu"``).
    ``model`` / ``datasets=(train, val, test)`` may be injected.  A
    setting the port does not run yet raises ``NotImplementedError``, and
    so does another experiment (``experiments/train_model.py``,
    ``experiments/robustness.py`` run those).

    Telemetry, as in the JAX package: when an obs session is active the
    run emits nested phase spans — ``prune_retrain`` → ``setup``, then
    per target ``attribution`` / ``eval`` / ``prune`` (``plan``,
    ``apply_plan``) / ``retrain`` / ``eval`` / ``flops`` — ledgers each
    round (``record_round`` with the score distribution), and the CSV
    rows carry the active span id.  The resumable journal is ROADMAP
    A8."""
    if cfg.experiment != "prune_retrain":
        raise NotImplementedError(
            f"run_prune_retrain runs experiment='prune_retrain' only, not "
            f"experiment={cfg.experiment!r}: the CLI dispatches that to "
            f"experiments/robustness.py or experiments/train_model.py")
    check_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32_matmul()
    obs.annotate_run(experiment=cfg.name, kind="prune_retrain",
                     model=cfg.model, method=cfg.method, policy=cfg.policy)
    with obs.span("prune_retrain", experiment=cfg.name):
        return _run_prune_retrain(cfg, dev, model=model, datasets=datasets,
                                  verbose=verbose)


def _run_prune_retrain(cfg: ExperimentConfig, dev, *, model=None,
                       datasets=None, verbose: bool = True
                       ) -> List[PruneStepRecord]:
    with obs.span("setup"):
        model, (train, val, test) = resolve_model_and_data(cfg, model,
                                                           datasets)
        groups = list(pruning_graph(model))
        if cfg.prune_order == "reverse":
            groups = groups[::-1]  # outermost layer first (reference recipe)
        targets = filter_targets([g.target for g in groups], cfg)

        spe = max(1, len(train) // cfg.batch_size)
        # one opt_state spans every target's fine-tune pass, so decaying
        # schedules are sized for the whole run
        tx = make_optimizer(
            cfg, steps_per_epoch=spe,
            total_epochs=cfg.finetune_epochs * max(1, len(targets)))
        loss_fn = LOSS_REGISTRY[cfg.loss]
        sdtype = compute_dtype(cfg.score_dtype)
        trainer = Trainer.create(
            model, tx, loss_fn, seed=cfg.seed,
            compute_dtype=compute_dtype(cfg.compute_dtype), device=dev,
            moe_aux_weight=cfg.moe_aux_weight, remat=cfg.remat,
            accum_steps=cfg.accum_steps, grad_norm=cfg.obs_grad_norm)
        _configure_mfu(cfg, trainer)
    val_batches = val.batches(cfg.eval_batch_size)
    test_batches = test.batches(cfg.eval_batch_size)
    history: List[PruneStepRecord] = []
    with CSVLogger(cfg.log_path, experiment=cfg.name) as logger:
        for target in targets:
            with obs.span("attribution", target=target, method=cfg.method):
                metric = build_metric(
                    cfg.method, trainer.model, trainer.params, val_batches,
                    loss_fn, state=trainer.state, reduction=cfg.reduction,
                    seed=cfg.seed, compute_dtype=sdtype, **cfg.method_kwargs)
                t0 = time.perf_counter()
                scores = metric.run(
                    target,
                    find_best_evaluation_layer=cfg.find_best_evaluation_layer)
            with obs.span("eval", target=target, which="pre"):
                pre_loss, pre_acc = trainer.evaluate(test_batches)
            # one policy evaluation feeds the prune and the ledger's
            # decision record, so the two cannot disagree
            policy, fraction = policy_for_target(cfg, target)
            drop_idx = score_drop_indices(scores, policy=policy,
                                          fraction=fraction,
                                          bucket=cfg.bucket)
            score_dist = obs.score_distribution(scores, drop_idx)
            if cfg.simulate:
                # mask the same slices a real prune would remove: shapes
                # never change across the sweep
                with obs.span("prune", target=target, simulate=True):
                    obs.record_prune(target, drop_idx,
                                     L.n_units(trainer.model.layer(target)),
                                     simulate=True)
                    pm, sm = drop_masks(trainer.model, trainer.params,
                                        {target: drop_idx},
                                        state=trainer.state)
                    trainer.params = apply_masks(trainer.params, pm)
                    if trainer.state:
                        trainer.state = apply_masks(trainer.state, sm)
                prune_time = time.perf_counter() - t0
                n_dropped = len(drop_idx)
            else:
                with obs.span("prune", target=target):
                    res = prune(trainer.model, trainer.params, target,
                                drop_idx, state=trainer.state,
                                opt_state=trainer.opt_state)
                    prune_time = time.perf_counter() - t0
                    n_dropped = L.n_units(trainer.model.layer(target)) \
                        - L.n_units(res.model.layer(target))
                    trainer = trainer.rebuild(res.model, res.params,
                                              res.state, res.opt_state)
                _configure_mfu(cfg, trainer)
            with obs.span("retrain", target=target,
                          epochs=cfg.finetune_epochs):
                for epoch_i in range(cfg.finetune_epochs):
                    # accumulation cannot split a ragged tail batch: drop
                    # it
                    train_epoch(
                        trainer,
                        train.batches(cfg.batch_size, shuffle=True,
                                      seed=cfg.seed + epoch_i,
                                      drop_remainder=cfg.accum_steps > 1),
                        epoch=epoch_i, verbose=False)
            with obs.span("eval", target=target, which="post"):
                post_loss, post_acc = trainer.evaluate(test_batches)
            with obs.span("flops", target=target):
                n_params, flops = model_cost(trainer.model, trainer.params,
                                             trainer.state)
            rec = PruneStepRecord(
                layer=target, pre_loss=pre_loss, pre_acc=pre_acc,
                post_loss=post_loss, post_acc=post_acc, n_params=n_params,
                n_dropped=n_dropped, prune_time=prune_time,
                widths=trainer.model.widths())
            history.append(rec)
            obs.record_round(
                target=target, round=len(history) - 1, method=cfg.method,
                policy=cfg.policy, n_dropped=int(n_dropped),
                simulate=bool(cfg.simulate), score_dist=score_dist,
                pre={"loss": float(pre_loss), "acc": float(pre_acc)},
                post={"loss": float(post_loss), "acc": float(post_acc)},
                params=int(n_params), flops=flops, widths=rec.widths,
                prune_time=float(prune_time),
                runtime=obs.runtime_snapshot())
            logger.log_prune_step(
                layer=target, method=cfg.method, test_loss=pre_loss,
                test_acc=pre_acc, test_loss_pp=post_loss,
                test_acc_pp=post_acc, n_params=n_params, flops=flops,
                widths=rec.widths, prune_time=prune_time)
            if verbose:
                print(f"[{cfg.name}] pruned {n_dropped} units from {target}: "
                      f"acc {pre_acc:.4f}→{post_acc:.4f}, params {n_params}",
                      flush=True)
    return history


def _configure_mfu(cfg: ExperimentConfig, trainer):
    """Point the obs step telemetry at the CURRENT model's training FLOPs
    (3x a forward at the training batch size, re-aimed after every prune
    since the model shrinks).  Costs one counted forward, so it runs only
    while a session is active."""
    if obs.get() is None:
        return
    try:
        _, fwd = model_cost(trainer.model, trainer.params, trainer.state,
                            batch_size=cfg.batch_size)
        if fwd:
            obs.configure_step_flops(
                flops_per_step=obs.train_flops_per_step(fwd))
    except Exception:
        pass
