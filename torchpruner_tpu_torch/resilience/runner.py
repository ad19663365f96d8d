"""Resumable pipelines — the port of
``torchpruner_tpu/resilience/runner.py``: the wiring between
checkpoints, manifests, guards, chaos and the experiment loops.

Commit protocol (everything else follows from it):

1. write a new digest-sealed checkpoint directory ``ckpt-…``
   (``checkpoint.save_checkpoint``: every leaf copied to the host before
   its bytes are written, the arrays fsynced, their digest sealed into
   ``spec.json`` last), then fsync the run directory;
2. atomically replace ``manifest.json`` to point at it (position:
   epoch, data cursor, completed rounds, LR backoff, accum override);
3. garbage-collect superseded checkpoint directories.

A SIGKILL between any two instructions leaves the manifest referencing
a complete checkpoint; resume = load the manifest → restore its
checkpoint (the dropout generator's state included) → fast-forward the
deterministic data stream past ``batch_cursor`` → keep going.  The
resumed trajectory is the uninterrupted one (same generator state, same
shuffle, same batches).

Recovery paths on the same machinery:

- **NaN/Inf streak** (``StepGuard`` raising ``NonFiniteStreakError``):
  roll back to the manifest's checkpoint, multiply the LR by
  ``cfg.lr_backoff`` (an ``optim.scale`` stage whose factor changes but
  whose state structure does not, so the restored optimizer state stays
  valid), retry.
- **OOM** (``is_oom_error``): drop the exception, the failed trainer
  and the graph its frames hold, ``gc.collect()`` and
  ``torch.cuda.empty_cache()``, then roll back at doubled
  ``accum_steps`` (halved microbatch activations) and retry.
- **Preemption** (SIGTERM): snapshot at the next step boundary, mark the
  manifest ``preempted``, unwind.

Divergences from the JAX package: a training run that has committed
nothing yet rolls back to its seeded start (the JAX package raises), so
a first step that does not fit degrades too; no compilation-cache
quarantine on resume (the port has no persistent compilation cache); a
run directory the JAX package wrote is refused on resume (its rng is a
JAX key and its optimizer state does not cross), though its manifest
reads.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.resilience import chaos
from torchpruner_tpu_torch.resilience.guards import (
    NonFiniteStreakError,
    Preempted,
    PreemptionHandler,
    StepGuard,
    is_oom_error,
    next_accum_for_oom,
)
from torchpruner_tpu_torch.resilience.manifest import (
    RunManifest,
    atomic_write_json,
    fsync_dir,
    read_json,
)
from torchpruner_tpu_torch.resilience.retry import (
    DEFAULT_TRANSIENT,
    RetryPolicy,
    retry_call,
)

_CKPT_RETRY = RetryPolicy(tries=3, base_delay_s=0.1)


def rng_to_list(gen: torch.Generator) -> Dict[str, Any]:
    """A generator's state as JSON: its device type and its state bytes
    (a CUDA generator's Philox seed and offset, 16 bytes; a CPU
    generator's 5,056)."""
    return {"device": gen.device.type,
            "state": gen.get_state().tolist()}


def rng_from_list(saved, device) -> torch.Generator:
    """A generator on ``device`` in the state :func:`rng_to_list` saved;
    ``ValueError`` for another device type or the JAX package's key."""
    if not isinstance(saved, dict):
        raise ValueError(
            f"the saved rng {str(saved)[:60]} is a JAX PRNG key, written "
            "by torchpruner_tpu (the JAX package) — the port resumes only "
            "its own run directories")
    dev = torch.device(device)
    if saved.get("device") != dev.type:
        raise ValueError(
            f"the run was checkpointed with a {saved.get('device')} "
            f"generator and cannot resume on {dev.type}: the dropout "
            "stream would differ")
    gen = torch.Generator(device=dev)
    gen.set_state(torch.tensor(saved["state"], dtype=torch.uint8))
    return gen


def _is_writer() -> bool:
    """Rank 0 writes checkpoints, manifests and results; the other ranks
    of a distributed run keep their manifest in step without writing."""
    from torchpruner_tpu_torch.parallel.mesh import is_writer

    return is_writer()


def _preempt_agreed(pre: PreemptionHandler, at_boundary: bool = True
                    ) -> bool:
    """Mesh-safe preemption poll.  Single process: the local flag, any
    time.  Distributed: only at ``at_boundary`` points every rank
    reaches together (checkpoint cadence, epoch and round ends), where
    rank 0's flag is broadcast, so a SIGTERM that reached one rank stops
    every rank at the same step; gating the broadcast on a rank's own
    flag would send the signalled rank into a collective the others
    skip."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from torchpruner_tpu_torch.parallel.collectives import (
            broadcast_flag,
            default_device,
        )

        return at_boundary and broadcast_flag(pre.requested,
                                              default_device())
    return pre.requested


def _check_producer(run_dir: str, manifest: RunManifest) -> None:
    """Refuse a run directory the JAX package wrote, naming it: its
    checkpoint's rng is a JAX key and its optimizer state does not cross
    between the packages."""
    spec = os.path.join(run_dir, manifest.checkpoint, "spec.json")
    try:
        meta = read_json(spec)
    except (OSError, ValueError):
        return  # a damaged checkpoint: restore_checkpoint says how
    rng = meta.get("extra", {}).get("rng")
    treedef = meta.get("opt_treedef")
    from torchpruner_tpu_torch.checkpoint import _OPT_PREFIX

    if (rng is not None and not isinstance(rng, dict)) or (
            treedef is not None and not treedef.startswith(_OPT_PREFIX)):
        raise ValueError(
            f"run dir {run_dir!r} was written by torchpruner_tpu (the JAX "
            f"package): checkpoint {manifest.checkpoint!r} holds a JAX "
            "PRNG key and JAX optimizer state, which the port cannot "
            "resume — start a fresh run directory (its manifest and "
            "params read; `obs report` reads its telemetry)")


def scaled_optimizer(cfg, steps_per_epoch: int, lr_scale: float,
                     total_epochs: Optional[int] = None):
    """The config's optimizer with the rollback LR-backoff stage chained
    on.  ``optim.scale``'s state is empty, so every ``lr_scale`` gives
    the same state structure — a checkpoint saved before a backoff
    restores after it."""
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        make_optimizer,
    )
    from torchpruner_tpu_torch.train import optim

    return optim.chain(
        make_optimizer(cfg, steps_per_epoch=steps_per_epoch,
                       total_epochs=total_epochs),
        optim.scale(lr_scale))


def commit_checkpoint(run_dir: str, manifest: RunManifest, trainer, *,
                      epoch: int, batch_cursor: int,
                      stage: Optional[Dict[str, Any]] = None,
                      records: Optional[List[dict]] = None,
                      status: str = "running") -> None:
    """The 3-step commit of the module docstring.  Timed into
    ``checkpoint_write_seconds``; the checkpoint write is retry-wrapped
    (transient filesystem errors).  A sharded trainer's trees are
    gathered on every rank (a collective) and rank 0 alone writes; every
    rank's manifest advances, and the ranks meet once the files are
    down."""
    from torchpruner_tpu_torch.checkpoint import save_checkpoint

    params, opt_state = trainer.full_params(), trainer.full_opt_state()
    manifest.commits = getattr(manifest, "commits", 0) + 1
    name = f"ckpt-{manifest.commits:06d}-s{int(trainer.step_count):08d}"
    path = os.path.join(run_dir, name)
    if _is_writer():
        t0 = time.perf_counter()
        with obs.span("checkpoint_write", ckpt=name):
            retry_call(
                save_checkpoint, path, trainer.model, params,
                trainer.state, opt_state,
                step=int(trainer.step_count),
                extra={"rng": rng_to_list(trainer.rng), "epoch": epoch,
                       "batch_cursor": batch_cursor},
                policy=_CKPT_RETRY, label="checkpoint_write")
            # the directory's entry, before the manifest
            fsync_dir(run_dir)
        obs.observe("checkpoint_write_seconds", time.perf_counter() - t0,
                    help="wall seconds per committed checkpoint write")
        if chaos.active():
            # fault injection after the write: the digest must catch it
            chaos.corrupt_checkpoint_bytes(path)
    manifest.checkpoint = name
    manifest.step = int(trainer.step_count)
    manifest.epoch = epoch
    manifest.batch_cursor = batch_cursor
    if stage is not None:
        manifest.stage = stage
    if records is not None:
        manifest.records = records
    manifest.status = status
    if _is_writer():
        retry_call(manifest.save, run_dir, policy=_CKPT_RETRY,
                   label="manifest_write")
        manifest.gc_checkpoints(run_dir)
    _barrier()


def _barrier() -> None:
    """Every rank of a distributed run waits here (no-op alone)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def restore_committed(run_dir: str, manifest: RunManifest, tx, device):
    """Load the manifest's checkpoint onto ``device`` → ``(model, params,
    state, opt_state, meta)`` (digest-verified; raises
    ``CheckpointCorruptError`` on damage, ``ValueError`` for a run
    directory of the JAX package)."""
    from torchpruner_tpu_torch.checkpoint import restore_checkpoint

    _check_producer(run_dir, manifest)
    return restore_checkpoint(os.path.join(run_dir, manifest.checkpoint),
                              tx=tx, device=device)


class Recovery(NamedTuple):
    """What a failed step calls for (:func:`recovery_plan`)."""

    kind: str  # "streak" or "oom"
    accum: int  # the accum_steps to retry at
    note: str  # for the log line


def recovery_plan(e: BaseException, cfg, manifest: RunManifest,
                  accum: int) -> Optional[Recovery]:
    """Inside a resilient loop's ``except`` block: the recovery the
    failure ``e`` calls for, or None (the caller re-raises).  A
    non-finite streak spends one of ``cfg.max_rollbacks`` and multiplies
    the manifest's LR scale by ``cfg.lr_backoff``; an OOM doubles
    ``accum_steps`` while the batch still splits."""
    if isinstance(e, NonFiniteStreakError):
        manifest.rollbacks += 1
        if manifest.rollbacks > cfg.max_rollbacks:
            return None
        manifest.lr_scale *= cfg.lr_backoff
        return Recovery("streak", accum,
                        f"{e.streak} consecutive non-finite steps; "
                        f"lr_scale -> {manifest.lr_scale:g}")
    if is_oom_error(e):
        nxt = next_accum_for_oom(accum, cfg.batch_size)
        if nxt is not None:
            return Recovery("oom", nxt,
                            f"OOM; accum_steps -> {nxt} (microbatch "
                            f"{cfg.batch_size // nxt})")
    return None


def recover(plan: Recovery, trainer, restore, *, guard, dev,
            oom_is_rollback: bool):
    """Carry out ``plan`` after the ``except`` block (so the exception
    and the activations its frames held are gone) → the trainer at the
    last commit, from ``restore(failed_trainer, accum_steps)``.  An OOM
    drops the failed bundle's trees first, then ``gc.collect()`` and
    ``torch.cuda.empty_cache()``, so the retry at the smaller microbatch
    has the card's memory.  The guard's streak restarts.  Counters as in
    the JAX package: a streak counts in ``resilience_rollbacks_total``,
    an OOM in ``resilience_oom_retries_total`` and, in the training
    runner (``oom_is_rollback``), in the rollbacks too."""
    if plan.kind == "oom":
        if trainer is not None:
            trainer.params = trainer.opt_state = trainer.state = None
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        obs.inc("resilience_oom_retries_total",
                help="OOM recoveries via doubled accum_steps")
    if plan.kind == "streak" or oom_is_rollback:
        obs.inc("resilience_rollbacks_total",
                help="rollback-to-checkpoint recoveries")
    trainer = restore(trainer, plan.accum)
    if guard is not None:
        guard.reset()
    return trainer


# -- resumable from-scratch training ----------------------------------------


_SENTINEL = object()


def _floats(losses) -> List[float]:
    """Device scalars → finite floats (guard-skipped steps report a
    non-finite loss and are left out of epoch means)."""
    out = []
    for v in losses:
        f = float(v)
        if np.isfinite(f):
            out.append(f)
    return out


def run_resilient_train(cfg, *, model=None, datasets=None,
                        verbose: bool = True, device=None):
    """``experiments.train_model.run_train`` semantics with the whole
    resilience loop (``cfg.run_dir`` set; ``run_train`` delegates here).
    Returns ``(trainer, history)`` where ``history`` spans every attempt
    — a resumed run returns the epochs its predecessors completed too."""
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        resolve_model_and_data,
    )
    from torchpruner_tpu_torch.experiments.train_model import epoch_batches
    from torchpruner_tpu_torch.train.logger import CSVLogger
    from torchpruner_tpu_torch.train.loop import trainer_from_config
    from torchpruner_tpu_torch.utils.device import resolve_device

    if cfg.chaos:
        chaos.configure(cfg.chaos)
    dev = resolve_device(device)
    verbose = verbose and _is_writer()
    mesh = None
    data_size = 1
    if cfg.mesh:
        # the same commit protocol over a ShardedTrainer: checkpoints
        # gather on save, restore re-places every tree
        from torchpruner_tpu_torch.parallel import make_mesh, mesh_axes
        from torchpruner_tpu_torch.parallel.mesh import rank_device

        dev = rank_device(dev)
        mesh = make_mesh(cfg.mesh, device=dev)
        data_size = mesh_axes(mesh).get("data", 1)
    run_dir = os.path.abspath(cfg.run_dir)
    os.makedirs(run_dir, exist_ok=True)
    manifest = RunManifest.load_or_new(run_dir, kind="train",
                                       experiment=cfg.name)
    resuming = bool(manifest.checkpoint)

    model, (train, _val, test) = resolve_model_and_data(cfg, model, datasets)
    spe = max(1, len(train) // cfg.batch_size)
    loss_fn = LOSS_REGISTRY[cfg.loss]
    accum = manifest.accum_steps or cfg.accum_steps
    guard = StepGuard(cfg.max_bad_steps) if cfg.guard_nonfinite else None

    def build_trainer(params=None, state=None, opt_state=None):
        # restored trees are adopted at their actual (possibly pruned)
        # shapes
        return trainer_from_config(
            cfg, model, scaled_optimizer(cfg, spe, manifest.lr_scale),
            loss_fn, device=dev, mesh=mesh, params=params, state=state,
            opt_state=opt_state, accum_steps=accum,
            grad_norm=cfg.obs_grad_norm, guard=guard)

    def restore_trainer():
        nonlocal model
        tx = scaled_optimizer(cfg, spe, manifest.lr_scale)
        m2, p2, s2, o2, meta = restore_committed(run_dir, manifest, tx, dev)
        model = m2
        t = build_trainer(params=p2, state=s2, opt_state=o2)
        rng = meta.get("extra", {}).get("rng")
        if rng is not None:
            t.rng = rng_from_list(rng, dev)
        t.step_count = int(meta.get("step", 0))
        return t

    if resuming:
        # injections already survived before the commit stay dead — a
        # kill step coinciding with a commit boundary must not re-kill
        chaos.disarm_through(manifest.step)
        trainer = restore_trainer()
        manifest.resumes += 1
        obs.inc("resilience_resumes_total",
                help="runs resumed from a manifest + checkpoint")
        if verbose:
            print(f"[{cfg.name}] resumed from {manifest.checkpoint} "
                  f"(epoch {manifest.epoch}, step {manifest.step}, "
                  f"cursor {manifest.batch_cursor}, "
                  f"resume #{manifest.resumes})", flush=True)
    else:
        trainer = build_trainer()

    logger = CSVLogger(cfg.log_path, experiment=cfg.name,
                       enabled=_is_writer())
    test_batches = test.batches(cfg.eval_batch_size)
    history: List[dict] = [dict(r) for r in manifest.records]
    # ledger continuity: epochs committed before the kill rehydrate from
    # the manifest (deduped against a reused obs dir's own records)
    if history:
        obs.ledger_backfill(history, kind="epoch")
    epoch = manifest.epoch
    cursor = manifest.batch_cursor
    losses: List[Any] = list(manifest.stage.get("losses", []))
    every = cfg.checkpoint_every_steps
    data_retry = RetryPolicy(tries=4, base_delay_s=0.02, seed=cfg.seed)

    def snapshot(status: str = "running") -> None:
        losses[:] = _floats(losses)
        commit_checkpoint(
            run_dir, manifest, trainer, epoch=epoch, batch_cursor=cursor,
            stage={"losses": list(losses)}, records=list(history),
            status=status)

    def restore(_failed, acc):
        nonlocal accum
        accum = acc
        if manifest.checkpoint:
            return restore_trainer()
        # nothing committed yet (a first step that does not fit): back
        # to the run's start, the seeded init (the JAX package raises
        # here)
        return build_trainer()

    def open_stream():
        """This epoch's batch stream fast-forwarded to the cursor — the
        shuffle is deterministic, so re-opening after a transient
        failure replays the exact remaining batches."""
        s = epoch_batches(train, cfg, epoch)
        for _ in range(cursor):
            next(s)
        return s

    def next_batch(it):
        """One fetch with transient-data retry: a generator that raised
        is closed for good, so recovery re-opens the stream at the
        cursor rather than re-polling it (which would silently truncate
        the epoch)."""
        attempt = 0
        while True:
            try:
                if chaos.active():
                    chaos.maybe_fail_data(trainer.step_count)
                    chaos.maybe_delay()
                return it, next(it, _SENTINEL)
            except DEFAULT_TRANSIENT:
                attempt += 1
                if attempt >= data_retry.tries:
                    raise
                obs.inc("resilience_retries_total",
                        help="transient-failure retries (retry_call)")
                obs.inc("resilience_retries_data_fetch_total",
                        help="transient-failure retries (data_fetch)")
                time.sleep(data_retry.delay(attempt))
                it = open_stream()

    try:
        with PreemptionHandler() as pre:
            while epoch < cfg.epochs:
                plan = None
                try:
                    t0 = time.perf_counter()
                    it = open_stream()
                    with obs.span("train", epoch=epoch):
                        while True:
                            it, batch = next_batch(it)
                            if batch is _SENTINEL:
                                break
                            x, y = batch
                            if accum > 1 and x.shape[0] % accum:
                                # OOM-degraded accumulation cannot split
                                # a ragged tail batch: drop it (counted)
                                # and keep the cursor on the stream
                                cursor += 1
                                obs.inc("resilience_ragged_drops_total",
                                        help="tail batches dropped "
                                             "because they don't divide "
                                             "the degraded accum_steps")
                                continue
                            if data_size > 1 and \
                                    x.shape[0] % (data_size * accum):
                                # a ragged tail the data axis cannot
                                # split: dropped (counted), the cursor
                                # kept on the stream
                                cursor += 1
                                obs.inc(
                                    "resilience_mesh_ragged_drops_total",
                                    help="tail batches dropped because "
                                         "they don't divide the mesh's "
                                         "data axis")
                                continue
                            losses.append(trainer.step(x, y))
                            cursor += 1
                            due = bool(every
                                       and trainer.step_count % every == 0)
                            if _preempt_agreed(pre, at_boundary=due):
                                snapshot(status="preempted")
                                raise Preempted()
                            if due:
                                snapshot()
                    epoch_losses = _floats(losses)
                    with obs.span("eval", epoch=epoch):
                        test_loss, test_acc = trainer.evaluate(test_batches)
                    rec = {"epoch": epoch,
                           "train_loss": float(np.mean(epoch_losses))
                           if epoch_losses else float("nan"),
                           "test_loss": test_loss, "test_acc": test_acc,
                           "seconds": time.perf_counter() - t0}
                    history.append(rec)
                    obs.record_epoch(**rec)
                    logger.log_epoch(epoch=epoch,
                                     train_loss=rec["train_loss"],
                                     test_loss=test_loss, test_acc=test_acc,
                                     seconds=rec["seconds"])
                    if verbose:
                        print(f"[{cfg.name}] epoch {epoch}: train "
                              f"{rec['train_loss']:.4f} test "
                              f"{test_loss:.4f} acc {test_acc:.4f} "
                              f"({rec['seconds']:.1f}s)", flush=True)
                    epoch += 1
                    cursor = 0
                    losses = []
                    # epoch boundaries always commit: the manifest must
                    # never point behind completed work
                    if _preempt_agreed(pre, at_boundary=True):
                        snapshot(status="preempted")
                        raise Preempted()
                    snapshot()
                except Exception as e:  # noqa: BLE001 - classified below
                    plan = recovery_plan(e, cfg, manifest, accum)
                    if plan is None:
                        raise
                if plan is not None:
                    if plan.kind == "oom":
                        it = None
                        manifest.accum_steps = plan.accum
                    trainer = recover(plan, trainer, restore, guard=guard,
                                      dev=dev, oom_is_rollback=True)
                    epoch = manifest.epoch
                    cursor = manifest.batch_cursor
                    losses = list(manifest.stage.get("losses", []))
                    if verbose:
                        print(f"[{cfg.name}] rolled back to "
                              f"{manifest.checkpoint or 'the seeded start'}"
                              f" ({plan.note})", flush=True)
    except Preempted:
        if verbose:
            print(f"[{cfg.name}] preempted: snapshot committed at step "
                  f"{manifest.step}; re-run with --resume {run_dir} to "
                  "continue", flush=True)
        logger.close()
        return trainer, history

    manifest.status = "done"
    if _is_writer():
        manifest.save(run_dir)
    logger.close()
    return trainer, history


# -- prune-retrain journal ---------------------------------------------------


class PruneJournal:
    """Round-granular resume for ``run_prune_retrain``: which targets
    completed (with their full ``PruneStepRecord`` payloads), and —
    mid-round — whether the prune was applied and how many retrain
    epochs ran, so a kill during fine-tuning resumes at the next epoch
    of the same target instead of scoring it again."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.run_dir = os.path.abspath(cfg.run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.manifest = RunManifest.load_or_new(
            self.run_dir, kind="prune_retrain", experiment=cfg.name)
        self.resuming = bool(self.manifest.checkpoint)
        if self.resuming:
            _check_producer(self.run_dir, self.manifest)
        # last, after what can raise: the caller's finally gives it back
        self.pre = PreemptionHandler().__enter__()
        if self.resuming:
            chaos.disarm_through(self.manifest.step)
            self.manifest.resumes += 1
            obs.inc("resilience_resumes_total",
                    help="runs resumed from a manifest + checkpoint")

    @property
    def completed(self) -> List[str]:
        return self.manifest.completed

    @property
    def lr_scale(self) -> float:
        return self.manifest.lr_scale

    def records(self) -> List[dict]:
        return [dict(r) for r in self.manifest.records]

    def stage_for(self, target: str) -> Optional[Dict[str, Any]]:
        """Mid-round state for ``target`` if the run died during its
        retrain phase (prune already applied)."""
        st = self.manifest.stage
        if st.get("phase") == "retrain" and st.get("target") == target:
            return st
        return None

    def restore(self, tx, device):
        return restore_committed(self.run_dir, self.manifest, tx, device)

    def _commit(self, trainer, stage, status="running"):
        # persist OOM degradation: without it a resumed run would rebuild
        # at the config's accum_steps and OOM again on its first step
        acc = int(getattr(trainer, "accum_steps", 0) or 0)
        self.manifest.accum_steps = \
            acc if acc != self.cfg.accum_steps else 0
        commit_checkpoint(
            self.run_dir, self.manifest, trainer,
            epoch=len(self.manifest.completed), batch_cursor=0,
            stage=stage, records=self.manifest.records, status=status)

    def pruned(self, trainer, target: str, stage: Dict[str, Any]) -> None:
        """Prune applied, retrain not started — the mid-round anchor."""
        stage = dict(stage, phase="retrain", target=target,
                     retrain_epoch=0)
        self._commit(trainer, stage)

    def retrain_epoch_done(self, trainer, target: str, epoch: int) -> None:
        if not self.cfg.checkpoint_every_steps:
            # round-boundary-only cadence: no per-epoch checkpoint, and
            # the stage's retrain_epoch stays at the last committed
            # anchor (advancing it without a checkpoint would make a
            # resume skip epochs the checkpoint never saw)
            return
        stage = dict(self.manifest.stage, retrain_epoch=epoch)
        self._commit(trainer, stage)

    def round_done(self, trainer, target: str, record: dict) -> None:
        self.manifest.completed.append(target)
        self.manifest.records.append(record)
        self._commit(trainer, stage={})

    def check_preempt(self, trainer,
                      stage: Optional[Dict[str, Any]] = None) -> None:
        """Target / retrain-epoch boundaries.  ``stage`` must describe
        the trainer being snapshotted: a mid-retrain call passes its
        current ``retrain_epoch``, otherwise the (possibly stale)
        last-committed stage would make the resumed run redo epochs on
        top of already-retrained params."""
        if _preempt_agreed(self.pre, at_boundary=True):
            self._commit(trainer,
                         stage=(stage if stage is not None
                                else dict(self.manifest.stage)),
                         status="preempted")
            raise Preempted()

    def close(self) -> None:
        """Restore the SIGTERM handler (idempotent) — must run on every
        exit path, or later code in the process silently swallows
        preemption notices."""
        self.pre.__exit__(None, None, None)

    def done(self) -> None:
        self.manifest.status = "done"
        if _is_writer():
            self.manifest.save(self.run_dir)
        self.close()


# -- robustness-sweep journal ------------------------------------------------


class SweepJournal:
    """Layer-granular resume for the robustness sweep: completed layers'
    full results persist (atomically) in ``sweep_results.json`` inside
    the run dir; a resumed sweep skips them and merges at the end.  The
    sweep holds no optimizer state, so there is no checkpoint — the
    results file is the durable artifact."""

    RESULTS_NAME = "sweep_results.json"

    def __init__(self, cfg):
        self.cfg = cfg
        self.run_dir = os.path.abspath(cfg.run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.manifest = RunManifest.load_or_new(
            self.run_dir, kind="robustness", experiment=cfg.name)
        self.results_path = os.path.join(self.run_dir, self.RESULTS_NAME)
        self.saved: Dict[str, Any] = {}
        if os.path.exists(self.results_path):
            self.saved = read_json(self.results_path)
        # last, after what can raise: the caller's finally gives it back
        self.pre = PreemptionHandler().__enter__()
        self.resuming = bool(self.manifest.completed)
        if self.resuming:
            self.manifest.resumes += 1
            obs.inc("resilience_resumes_total",
                    help="runs resumed from a manifest + checkpoint")
            if _is_writer():
                self.manifest.save(self.run_dir)

    def remaining(self, layers: List[str]) -> List[str]:
        done = set(self.manifest.completed)
        return [l for l in layers if l not in done]

    def on_layer(self, layer: str, layer_results: Dict[str, list]) -> None:
        """Persist one finished layer (as lists, for JSON) and advance
        the manifest — then honour a pending preemption at this
        boundary."""
        self.saved[layer] = {
            m: [{k: (np.asarray(v).tolist() if hasattr(v, "__array__")
                     else v) for k, v in r.items()} for r in runs]
            for m, runs in layer_results.items()}
        self.manifest.completed.append(layer)
        if _is_writer():
            retry_call(atomic_write_json, self.results_path, self.saved,
                       policy=_CKPT_RETRY, label="sweep_results")
            self.manifest.save(self.run_dir)
        if _preempt_agreed(self.pre, at_boundary=True):
            self.manifest.status = "preempted"
            if _is_writer():
                self.manifest.save(self.run_dir)
            raise Preempted()

    def merged(self, fresh: Dict[str, Dict[str, list]]):
        out = dict(self.saved)
        for layer, methods in fresh.items():
            out[layer] = methods
        return out

    def close(self) -> None:
        """See :meth:`PruneJournal.close` — idempotent handler restore."""
        self.pre.__exit__(None, None, None)

    def done(self) -> None:
        self.manifest.status = "done"
        if _is_writer():
            self.manifest.save(self.run_dir)
        self.close()
