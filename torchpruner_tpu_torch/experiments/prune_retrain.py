"""The prune → fine-tune driver — counterpart of
``torchpruner_tpu/experiments/prune_retrain.py``: for each prunable
layer, outermost first: score → turn scores into indices (policy) →
prune (or, with ``cfg.simulate``, mask the same slices at fixed shapes)
→ evaluate (→ optionally fine-tune).

With ``cfg.mesh`` the loop runs on every rank of a ``torchrun`` world:
a ``parallel.ShardedTrainer`` (``cfg.partition``, ``cfg.zero``) trains,
a ``parallel.DistributedScorer`` scores over the ``data`` axis, every
rank prunes the gathered full trees the same way and re-places them,
and only rank 0 writes the CSV, the ledger, the report and the
checkpoints.

Inside an obs session the run is annotated (``obs.annotate_run``) and
emits the span ``prune_retrain`` around ``setup`` and, per target,
``attribution``, ``eval`` (pre and post), ``prune``, ``retrain`` and
``flops``, each tagged with the target's name, plus the ledger's
``score_distribution``, ``record_prune`` and ``record_round`` records.
"""

from __future__ import annotations

import dataclasses
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
from torchpruner_tpu_torch.train.loop import (
    train_epoch,
    trainer_from_config,
)
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
    rows carry the active span id.

    Resilience, as in the JAX package: with ``cfg.run_dir`` set the loop
    journals into it (``resilience/runner.py PruneJournal``): a
    checkpoint and a manifest commit after every prune (the mid-round
    anchor), after every retrain epoch when ``cfg.checkpoint_every_steps``
    is set, and after every round.  Run again with the same ``run_dir``
    (CLI ``--resume DIR``) it restores the committed checkpoint (params,
    optimizer state, BatchNorm state, the dropout generator, the step
    count), skips the completed targets and, killed mid-retrain, resumes
    that target's retrain without scoring it again; the history it
    returns spans every attempt.  ``cfg.guard_nonfinite`` skips
    non-finite steps, and a streak of ``cfg.max_bad_steps`` rolls the
    round back to the last commit with the LR times ``cfg.lr_backoff``
    (at most ``cfg.max_rollbacks`` times); an out-of-memory retrain step
    rolls back with ``accum_steps`` doubled (the manifest keeps it), an
    epoch's ragged tail batch then dropped and counted in
    ``resilience_ragged_drops_total``.  SIGTERM snapshots at the next
    target or epoch boundary, marks the manifest ``preempted`` and
    returns the rounds done.  ``cfg.chaos`` installs the fault
    injections (``resilience/chaos.py``)."""
    if cfg.experiment != "prune_retrain":
        raise NotImplementedError(
            f"run_prune_retrain runs experiment='prune_retrain' only, not "
            f"experiment={cfg.experiment!r}: the CLI dispatches that to "
            f"experiments/robustness.py or experiments/train_model.py")
    check_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32_matmul()
    mesh = None
    if cfg.mesh:
        # the loop over a mesh: sharded training, data-parallel scoring
        # over its data axis (a mesh the world does not fill raises here)
        from torchpruner_tpu_torch.parallel import make_mesh
        from torchpruner_tpu_torch.parallel.mesh import rank_device

        dev = rank_device(dev)
        mesh = make_mesh(cfg.mesh, device=dev)
    obs.annotate_run(experiment=cfg.name, kind="prune_retrain",
                     model=cfg.model, method=cfg.method, policy=cfg.policy)
    with obs.span("prune_retrain", experiment=cfg.name):
        return _run_prune_retrain(cfg, dev, mesh, model=model,
                                  datasets=datasets, verbose=verbose)


def _run_prune_retrain(cfg: ExperimentConfig, dev, mesh, *, model=None,
                       datasets=None, verbose: bool = True
                       ) -> List[PruneStepRecord]:
    from torchpruner_tpu_torch.resilience import chaos as _chaos

    if cfg.chaos:
        _chaos.configure(cfg.chaos)
    journal = None
    if cfg.run_dir:
        from torchpruner_tpu_torch.resilience.runner import PruneJournal

        journal = PruneJournal(cfg)
    try:
        return _prune_loop(cfg, dev, journal, mesh, model=model,
                           datasets=datasets, verbose=verbose)
    finally:
        # every exit path (done, preempted, a resume that fails on a
        # corrupt checkpoint, a crash) gives the SIGTERM handler back —
        # a leaked handler would make the rest of the process ignore
        # preemption notices
        if journal is not None:
            journal.close()


def _prune_loop(cfg: ExperimentConfig, dev, journal, mesh, *, model=None,
                datasets=None, verbose: bool = True
                ) -> List[PruneStepRecord]:
    from torchpruner_tpu_torch.resilience.guards import Preempted, StepGuard
    from torchpruner_tpu_torch.resilience.runner import (
        recover,
        recovery_plan,
    )

    from torchpruner_tpu_torch.parallel.mesh import is_writer

    verbose = verbose and is_writer()
    with obs.span("setup"):
        model, (train, val, test) = resolve_model_and_data(cfg, model,
                                                           datasets)
        groups = list(pruning_graph(model))
        if cfg.prune_order == "reverse":
            groups = groups[::-1]  # outermost layer first (reference recipe)
        targets = filter_targets([g.target for g in groups], cfg)

        guard = StepGuard(cfg.max_bad_steps) if cfg.guard_nonfinite \
            else None
        # a resumed run re-enters at the journal's (possibly OOM-degraded)
        # accumulation factor, not the config's
        accum_steps = (journal.manifest.accum_steps
                       if journal is not None and journal.manifest.accum_steps
                       else cfg.accum_steps)
        spe = max(1, len(train) // cfg.batch_size)
        total_ft_epochs = cfg.finetune_epochs * max(1, len(targets))

        def build_tx():
            # one opt_state spans every target's fine-tune pass, so
            # decaying schedules are sized for the whole run; in a
            # resilient run the LR-backoff stage rides along (empty
            # state, so the state structure survives rollbacks)
            if journal is not None:
                from torchpruner_tpu_torch.resilience.runner import (
                    scaled_optimizer,
                )

                return scaled_optimizer(cfg, spe, journal.lr_scale,
                                        total_epochs=total_ft_epochs)
            return make_optimizer(cfg, steps_per_epoch=spe,
                                  total_epochs=total_ft_epochs)

        tx = build_tx()
        loss_fn = LOSS_REGISTRY[cfg.loss]
        sdtype = compute_dtype(cfg.score_dtype)
        trainer = trainer_from_config(
            cfg, model, tx, loss_fn, device=dev, mesh=mesh,
            accum_steps=accum_steps, grad_norm=cfg.obs_grad_norm,
            guard=guard)
        _configure_mfu(cfg, trainer)
    history: List[PruneStepRecord] = []

    def _restore(trainer, tx, accum=None):
        """The trainer at the journal's committed checkpoint under ``tx``
        (its guard kept, its accumulation ``accum`` if given), its
        generator and step count included."""
        from torchpruner_tpu_torch.resilience.runner import rng_from_list

        m2, p2, s2, o2, meta = journal.restore(tx, dev)
        trainer.tx = tx
        if accum is not None:
            trainer.accum_steps = accum
        t = trainer.rebuild(m2, p2, s2, o2)
        rng = meta.get("extra", {}).get("rng")
        if rng is not None:
            t.rng = rng_from_list(rng, dev)
        t.step_count = int(meta.get("step", 0))
        return t

    if journal is not None and journal.resuming:
        with obs.span("resume"):
            trainer = _restore(trainer, tx)
            history = [PruneStepRecord(**r) for r in journal.records()]
            # ledger continuity across the kill: the rounds the manifest
            # committed rehydrate into the ledger (deduped)
            obs.ledger_backfill(journal.records())
        _configure_mfu(cfg, trainer)
        if verbose:
            print(f"[{cfg.name}] resumed prune-retrain from "
                  f"{journal.manifest.checkpoint}: "
                  f"{len(journal.completed)}/{len(targets)} targets done",
                  flush=True)
    # a mesh splits each scoring batch over its data axis, which a
    # ragged tail may not divide: on a mesh the tail is dropped, as in
    # the JAX loop
    drop = mesh is not None
    val_batches = val.batches(cfg.eval_batch_size, drop_remainder=drop)
    test_batches = test.batches(cfg.eval_batch_size)

    def _run_target(target, logger):
        nonlocal trainer
        stage = journal.stage_for(target) if journal is not None else None
        if stage is None:
            with obs.span("attribution", target=target, method=cfg.method):
                # the full params (a sharded trainer gathers its pieces)
                params = trainer.full_params()
                metric = build_metric(
                    cfg.method, trainer.model, params, val_batches,
                    loss_fn, state=trainer.state, reduction=cfg.reduction,
                    seed=cfg.seed, compute_dtype=sdtype, **cfg.method_kwargs)
                t0 = time.perf_counter()
                scorer = metric
                if mesh is not None and "data" in cfg.mesh:
                    from torchpruner_tpu_torch.parallel import (
                        DistributedScorer,
                    )

                    scorer = DistributedScorer(metric, mesh)
                scores = scorer.run(
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
                    pm, sm = drop_masks(trainer.model, params,
                                        {target: drop_idx},
                                        state=trainer.state)
                    state = (apply_masks(trainer.state, sm)
                             if trainer.state else trainer.state)
                    if mesh is None:
                        trainer.params = apply_masks(params, pm)
                        trainer.state = state
                    else:
                        trainer = trainer.rebuild(
                            trainer.model, apply_masks(params, pm), state,
                            trainer.full_opt_state())
                prune_time = time.perf_counter() - t0
                n_dropped = len(drop_idx)
            else:
                with obs.span("prune", target=target):
                    res = prune(trainer.model, params, target,
                                drop_idx, state=trainer.state,
                                opt_state=trainer.full_opt_state())
                    prune_time = time.perf_counter() - t0
                    n_dropped = L.n_units(trainer.model.layer(target)) \
                        - L.n_units(res.model.layer(target))
                    trainer = trainer.rebuild(res.model, res.params,
                                              res.state, res.opt_state)
                _configure_mfu(cfg, trainer)
                if journal is not None:
                    # the mid-round anchor: prune applied, retrain not
                    # started — a kill during fine-tuning resumes here
                    journal.pruned(trainer, target, {
                        "pre_loss": float(pre_loss),
                        "pre_acc": float(pre_acc),
                        "n_dropped": int(n_dropped),
                        "prune_time": float(prune_time),
                        # the scores die with this process: stage the
                        # distribution, so a resumed round's record
                        # still carries its decision margins
                        "score_dist": score_dist})
            epoch_i = 0
            # the pre-prune trees, not needed now
            metric = scorer = res = params = None
        else:
            # resumed mid-round: the restored checkpoint already holds the
            # pruned shapes; skip scoring and the prune, finish the
            # retrain
            pre_loss = float(stage["pre_loss"])
            pre_acc = float(stage["pre_acc"])
            n_dropped = int(stage["n_dropped"])
            prune_time = float(stage["prune_time"])
            epoch_i = int(stage.get("retrain_epoch", 0))
            score_dist = stage.get("score_dist")

        while True:
            try:
                with obs.span("retrain", target=target,
                              epochs=cfg.finetune_epochs):
                    while epoch_i < cfg.finetune_epochs:
                        # accumulation, and a mesh's data axis, cannot
                        # split a ragged tail batch: drop it (counted
                        # when degraded accumulation alone drops it)
                        drop_now = drop or trainer.accum_steps > 1
                        if (drop_now and not drop
                                and len(train) % cfg.batch_size):
                            obs.inc("resilience_ragged_drops_total",
                                    help="tail batches dropped because "
                                         "they don't divide the degraded "
                                         "accum_steps")
                        train_epoch(
                            trainer,
                            train.batches(cfg.batch_size, shuffle=True,
                                          seed=cfg.seed + epoch_i,
                                          drop_remainder=drop_now),
                            epoch=epoch_i, verbose=False)
                        epoch_i += 1
                        if journal is not None:
                            journal.retrain_epoch_done(trainer, target,
                                                       epoch_i)
                            # a snapshot on preemption carries the true
                            # position of the trainer it checkpoints
                            journal.check_preempt(
                                trainer, stage=dict(journal.manifest.stage,
                                                    retrain_epoch=epoch_i))
                break
            except Exception as e:  # noqa: BLE001 - classified below
                # a non-finite streak: back to the last commit with the LR
                # backed off; an OOM: back with accum_steps doubled
                if journal is None or cfg.simulate:
                    raise
                plan = recovery_plan(e, cfg, journal.manifest,
                                     trainer.accum_steps)
                if plan is None:
                    raise
            trainer = recover(
                plan, trainer,
                lambda failed, accum: _restore(failed, build_tx(), accum),
                guard=guard, dev=dev, oom_is_rollback=False)
            st = journal.manifest.stage
            epoch_i = (int(st.get("retrain_epoch", 0))
                       if st.get("target") == target else 0)
            if verbose:
                print(f"[{cfg.name}] {target} retrain rolled back to "
                      f"{journal.manifest.checkpoint} ({plan.note})",
                      flush=True)

        with obs.span("eval", target=target, which="post"):
            post_loss, post_acc = trainer.evaluate(test_batches)
        with obs.span("flops", target=target):
            n_params, flops = model_cost(trainer.model,
                                         trainer.full_params(),
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
        if journal is not None:
            journal.round_done(trainer, target, dataclasses.asdict(rec))
        logger.log_prune_step(
            layer=target, method=cfg.method, test_loss=pre_loss,
            test_acc=pre_acc, test_loss_pp=post_loss,
            test_acc_pp=post_acc, n_params=n_params, flops=flops,
            widths=rec.widths, prune_time=prune_time)
        if verbose:
            print(f"[{cfg.name}] pruned {n_dropped} units from {target}: "
                  f"acc {pre_acc:.4f}→{post_acc:.4f}, params {n_params}",
                  flush=True)

    try:
        with CSVLogger(cfg.log_path, experiment=cfg.name,
                       enabled=is_writer()) as logger:
            for target in targets:
                if journal is not None:
                    if target in journal.completed:
                        continue
                    journal.check_preempt(trainer)
                _run_target(target, logger)
        if journal is not None:
            journal.done()
    except Preempted:
        if verbose:
            print(f"[{cfg.name}] preempted: manifest committed "
                  f"({len(journal.completed)}/{len(targets)} targets); "
                  f"re-run with --resume {cfg.run_dir} to continue",
                  flush=True)
    return history


def _configure_mfu(cfg: ExperimentConfig, trainer):
    """Point the obs step telemetry at the CURRENT model's training FLOPs
    (3x a forward at the training batch size, re-aimed after every prune
    since the model shrinks).  Costs one counted forward, so it runs only
    while a session is active."""
    if obs.get() is None or getattr(trainer, "mesh", None) is not None:
        # a sharded trainer's params are pieces, and a gather here would
        # run on the telemetry rank alone
        return
    try:
        _, fwd = model_cost(trainer.model, trainer.params, trainer.state,
                            batch_size=cfg.batch_size)
        if fwd:
            obs.configure_step_flops(
                flops_per_step=obs.train_flops_per_step(fwd))
    except Exception:
        pass
