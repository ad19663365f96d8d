"""Training and evaluation loops — counterpart of
``torchpruner_tpu/train/loop.py``.

The JAX package compiles one donated step per model spec; the port runs
the same step eagerly: the forward on params cast to the compute dtype,
``torch.autograd.grad`` with respect to the f32 master params, then the
functional optimizer (``train/optim.py``).  ``remat`` recomputes each
block's forward in the backward (``torch.utils.checkpoint``);
``accum_steps`` splits a batch into equal microbatches whose gradients
are summed before one update; ``multi_step`` runs K steps as a loop of
``step`` calls.  After a prune step changes shapes, ``Trainer.rebuild``
carries the bundle over to the new spec.

Resilience, at the JAX package's call sites: :meth:`Trainer.step` runs
the chaos hooks (``resilience/chaos.py``: kill, synthetic OOM, NaN
batch) on the global ``step_count`` before it computes, each one module
global check when no chaos is configured.  ``guard=StepGuard(...)``
adds the non-finite guard: the JAX package compiles ``ok =
isfinite(loss) & isfinite(global_norm(grads))`` into the step and gates
the update with ``jnp.where``; here the host reads ``ok`` once after
:meth:`Trainer.loss_and_grads` and, when it is false, skips the
optimizer update and the parameter and state writes, so the bundle stays
bit-equal and the step returns its non-finite loss (the runners' epoch
means leave it out).  ``StepGuard.observe`` gets the flag and may raise
``NonFiniteStreakError``.  Without a guard the step makes no added host
read or launch.

Telemetry, at the JAX package's call sites: every :meth:`Trainer.step`
and :meth:`Trainer.multi_step` records its return-to-return interval
with its examples and tokens (``obs.record_step``); ``grad_norm=True``
(the config's ``obs_grad_norm``) records the global gradient norm of
each step (``obs.record_grad_norm``, one host read a step); an empty
evaluation or training iterator bumps ``eval_empty_total``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.core import segment
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.resilience import chaos as _chaos
from torchpruner_tpu_torch.train.optim import apply_updates
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.losses import prediction_counts
from torchpruner_tpu_torch.utils.tree import (
    cast_floats,
    device_of,
    tree_leaves,
    tree_map,
)


def to_device(a, device) -> torch.Tensor:
    """A host batch array (numpy) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def make_loss_closure(model: SegmentedModel, loss_fn, compute_dtype=None,
                      param_transform: Optional[Callable] = None,
                      moe_aux_weight: float = 0.0, remat: bool = False):
    """``(params, state, x, y, rng) -> (mean loss, new_state)`` — the
    training forward policy of the JAX package's ``make_loss_closure``:
    with ``compute_dtype`` (``torch.bfloat16``) the forward and backward
    run on params and float inputs cast to it, while master params,
    optimizer state, loss and update math stay f32 (logits are promoted
    back to f32 before the loss; gradients arrive in f32 through the
    cast).

    ``param_transform`` rewrites the params inside the step, after the
    compute-dtype cast — the kernel-dispatch hook: e.g.
    ``masking.blocksparse_transform`` wraps masked Dense weights in
    :class:`~torchpruner_tpu_torch.ops.blocksparse.BlockSparseWeight` so
    the forward and backward products skip dropped blocks.  Gradients
    flow to the PLAIN param leaves; the optimizer never sees a
    wrapper.

    ``moe_aux_weight`` > 0 adds that multiple of every MoE layer's
    load-balancing loss (1.0 when expert dispatch is perfectly
    balanced), in f32.  ``remat`` recomputes each ``Residual`` block's
    forward in the backward (``SegmentedModel.apply``)."""

    def loss(params, state, x, y, rng):
        if compute_dtype is not None:
            params = cast_floats(params, compute_dtype)
            x = cast_floats(x, compute_dtype)
        if param_transform is not None:
            params = param_transform(params)
        aux = {}
        if moe_aux_weight:
            out, new_state, aux = model.apply(params, x, state=state,
                                              train=True, rng=rng,
                                              collect_aux=True, remat=remat)
        else:
            out, new_state = model.apply(params, x, state=state,
                                         train=True, rng=rng, remat=remat)
        if compute_dtype is not None:
            out = out.float()
        total = loss_fn(out, y).mean()
        for a in aux.values():
            total = total + moe_aux_weight * a.float()
        return total, new_state

    return loss


def _batch_tokens(x, y):
    """Token count of one batch for LM workloads (targets carry a
    sequence dim); ``None`` for classification."""
    shape = getattr(y, "shape", ())
    if len(shape) >= 2:
        return int(shape[0]) * int(shape[1])
    return None


def _warn_empty_eval(where: str) -> None:
    """An empty or exhausted evaluation iterator is almost always a
    caller bug: a logger warning plus the ``eval_empty_total`` counter."""
    from torchpruner_tpu_torch.train.logger import log

    obs.inc("eval_empty_total",
            help="evaluate()/train_epoch() calls that saw zero batches")
    log.warning(
        "%s received an empty or exhausted data iterator — no examples "
        "were evaluated (did you pass a one-shot generator instead of a "
        "re-iterable batch list?)", where)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of every entry squared)`` over ``tensors``, in f32 (the
    JAX package's ``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def evaluate(model, params, state, data, loss_fn):
    """Average loss and accuracy over ``data``: loss per example,
    accuracy per prediction (per next-token target for LMs)."""
    dev = device_of(params)
    tot_l, tot_c, tot_n, tot_p = 0.0, 0, 0, 0
    for x, y in (data() if callable(data) else data):
        x, y = to_device(x, dev), to_device(y, dev)
        out, _ = model.apply(params, x, state=state, train=False)
        losses = loss_fn(out, y)
        correct, n_pred = prediction_counts(out, y)
        tot_l += float(losses.sum())
        tot_c += int(correct)
        tot_n += int(losses.shape[0])
        tot_p += int(n_pred)
    if tot_n == 0:
        _warn_empty_eval("evaluate()")
        raise ValueError("evaluate() got an empty dataset")
    return tot_l / tot_n, tot_c / tot_p


def train_epoch(trainer, data, epoch: int = 0, log_every: int = 20,
                verbose: bool = True) -> float:
    """One epoch over ``data``; returns the mean step loss (``nan`` for
    an empty iterator)."""
    t0 = time.perf_counter()
    losses = []
    for i, (x, y) in enumerate(data() if callable(data) else data):
        losses.append(float(trainer.step(x, y)))
        if verbose and i % log_every == 0:
            print(f"epoch {epoch} batch {i}: loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if not losses:
        _warn_empty_eval("train_epoch()")
        return float("nan")
    return float(np.mean(losses))


@dataclass
class Trainer:
    """The mutable training bundle: f32 master ``params``, ``state``,
    the optimizer ``tx`` and its ``opt_state``, and the generator that
    feeds train-mode Dropout."""

    model: SegmentedModel
    params: Any
    state: Any
    tx: Any
    opt_state: Any
    loss_fn: Callable
    rng: torch.Generator
    #: None = full f32; torch.bfloat16 = mixed precision
    compute_dtype: Any = None
    step_count: int = 0
    #: rewrites the cast params inside the step (``make_loss_closure``)
    param_transform: Optional[Callable] = None
    #: weight of the MoE load-balancing loss (``make_loss_closure``)
    moe_aux_weight: float = 0.0
    #: recompute each block's forward in the backward
    remat: bool = False
    #: > 1 = gradient accumulation over that many equal microbatches
    accum_steps: int = 1
    #: opt-in telemetry: record each step's global gradient norm through
    #: ``obs.record_grad_norm`` (one extra reduction and a host read)
    grad_norm: bool = False
    #: optional ``resilience.StepGuard``: the non-finite guard (module
    #: docstring) — one host read of the step's ``ok`` flag, fed to the
    #: guard, which raises ``NonFiniteStreakError`` after M consecutive
    #: skips; ``None`` on latency-critical paths
    guard: Any = None
    #: end of the previous step in the current stepping streak: step
    #: telemetry records return-to-return intervals (CUDA launches return
    #: before the device finishes; the device time surfaces in the
    #: caller's next host read, between two step calls); evaluate() and
    #: rebuild() break the streak
    _t_stream: Any = field(default=None, repr=False)

    @classmethod
    def create(cls, model, tx, loss_fn, seed: int = 0, params=None,
               state=None, compute_dtype=None, device=None,
               param_transform=None, moe_aux_weight: float = 0.0,
               remat: bool = False, accum_steps: int = 1,
               grad_norm: bool = False, guard: Any = None):
        """A trainer on ``device`` (``None`` = ``cuda``; raises without a
        GPU unless ``device="cpu"``), initialized from ``seed`` unless
        ``params`` are given."""
        dev = resolve_device(device)
        if params is None:
            params, state = segment.init_model(model, seed, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return cls(model=model, params=params,
                   state=state if state is not None else {}, tx=tx,
                   opt_state=tx.init(params), loss_fn=loss_fn, rng=gen,
                   compute_dtype=compute_dtype,
                   param_transform=param_transform,
                   moe_aux_weight=moe_aux_weight, remat=remat,
                   accum_steps=accum_steps, grad_norm=grad_norm,
                   guard=guard)

    def step(self, x, y) -> torch.Tensor:
        """One optimizer step on the batch ``(x, y)`` (host arrays or
        tensors): :meth:`loss_and_grads`, then one update.  Returns the
        mean loss as a 0-d tensor."""
        if _chaos.active():
            # deterministic fault injection at the step boundary (kill /
            # synthetic OOM / NaN-poisoned batch)
            _chaos.maybe_kill(self.step_count)
            _chaos.maybe_oom(self.step_count)
            x = _chaos.poison_batch(self.step_count, x)
        loss = self._update(x, y)
        now = time.perf_counter()
        if self._t_stream is not None:
            # a streak's first step is not recorded: its interval would
            # hold whatever the caller did before it
            obs.record_step(now - self._t_stream, int(x.shape[0]),
                            _batch_tokens(x, y))
        self._t_stream = now
        return loss

    def _update(self, x, y) -> torch.Tensor:
        loss, grads, state = self.loss_and_grads(x, y)
        ok = True
        with torch.no_grad():
            if self.grad_norm or self.guard is not None:
                gnorm = global_norm(tree_leaves(grads))
                if self.grad_norm:
                    obs.record_grad_norm(gnorm)
                if self.guard is not None:
                    # the guard's one host read a step
                    ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            if ok:
                updates, self.opt_state = self.tx.update(
                    grads, self.opt_state, self.params)
                self.params = apply_updates(self.params, updates)
                self.state = state
        self.step_count += 1
        if self.guard is not None:
            self.guard.observe(not ok)
        return loss

    def loss_and_grads(self, x, y):
        """``(mean loss, grads, new state)`` of the batch ``(x, y)`` at
        the current params, which it leaves as they are.

        With ``accum_steps`` > 1 the batch splits into that many equal
        microbatches, run in order (BatchNorm state and the dropout
        generator thread through them); their gradients are summed and
        divided by ``accum_steps``, and the loss is their mean.  A batch
        that does not divide raises ``ValueError``."""
        dev = device_of(self.params)
        x, y = to_device(x, dev), to_device(y, dev)
        k = self.accum_steps
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accum_steps={k}")
        loss_c = make_loss_closure(self.model, self.loss_fn,
                                   self.compute_dtype,
                                   self.param_transform,
                                   self.moe_aux_weight, self.remat)
        leaves = [t.detach().requires_grad_() for t in
                  tree_leaves(self.params)]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), self.params)
        state, loss, grads = self.state, None, None
        for xb, yb in zip(x.split(x.shape[0] // k), y.split(x.shape[0] // k)):
            with torch.enable_grad():
                l, state = loss_c(params, state, xb, yb, self.rng)
                g = torch.autograd.grad(l, leaves)
            loss = l.detach() if loss is None else loss + l.detach()
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        if k > 1:
            loss = loss / k
            grads = [g / k for g in grads]
        it = iter(grads)
        return loss, tree_map(lambda _: next(it), self.params), state

    def multi_step(self, xs, ys) -> torch.Tensor:
        """K optimizer steps over stacked batches ``xs`` of shape ``(K,
        B, ...)``: exactly K :meth:`step` calls in order.  Returns the
        ``(K,)`` losses.  The JAX package scans the K steps inside one
        compiled program to pay one dispatch; here they are a plain loop
        (one CUDA graph of the K steps is ROADMAP A6a), recorded as one
        K-step interval as the JAX package records its program."""
        losses = torch.stack([self._update(xs[i], ys[i])
                              for i in range(len(xs))])
        k = int(len(xs))
        now = time.perf_counter()
        if self._t_stream is not None:  # see step(): first of a streak
            yshape = tuple(getattr(ys, "shape", ()))
            tok = int(yshape[0] * yshape[1] * yshape[2]) \
                if len(yshape) >= 3 else None
            obs.record_step(now - self._t_stream, int(xs.shape[1]) * k,
                            tok, steps=k)
        self._t_stream = now
        return losses

    def rebuild(self, model, params, state, opt_state) -> "Trainer":
        return Trainer(model=model, params=params,
                       state=state if state is not None else {},
                       tx=self.tx, opt_state=opt_state,
                       loss_fn=self.loss_fn, rng=self.rng,
                       compute_dtype=self.compute_dtype,
                       step_count=self.step_count,
                       param_transform=self.param_transform,
                       moe_aux_weight=self.moe_aux_weight,
                       remat=self.remat, accum_steps=self.accum_steps,
                       grad_norm=self.grad_norm, guard=self.guard)

    def evaluate(self, data):
        self._t_stream = None  # eval wall time is not step time
        return evaluate(self.model, self.params, self.state, data,
                        self.loss_fn)

    def full_params(self):
        """The full params (``ShardedTrainer`` gathers its pieces)."""
        return self.params

    def full_opt_state(self):
        """The full optimizer state (``ShardedTrainer`` gathers)."""
        return self.opt_state


def trainer_from_config(cfg, model, tx, loss_fn, *, device=None,
                        mesh=None, params=None, state=None, opt_state=None,
                        accum_steps: Optional[int] = None,
                        grad_norm: bool = False, guard=None):
    """The one trainer factory the drivers share: a
    ``parallel.ShardedTrainer`` over ``mesh`` (placement per
    ``cfg.partition``, ZeRO per ``cfg.zero``) when a mesh is given, else
    the single-device :class:`Trainer`; compute dtype, remat, MoE aux
    weight and seed from ``cfg``.  Restored ``params`` / ``state`` /
    ``opt_state`` (full trees) are adopted at their actual (possibly
    pruned) shapes, never re-initialized.  ``accum_steps`` overrides
    ``cfg.accum_steps`` (a manifest's OOM-doubled value)."""
    if mesh is not None:
        from torchpruner_tpu_torch.parallel import ShardedTrainer

        return ShardedTrainer.create(
            model, tx, loss_fn, mesh, seed=cfg.seed,
            partition=cfg.partition, zero=cfg.zero,
            compute_dtype=torch.bfloat16
            if cfg.compute_dtype == "bfloat16" else None,
            remat=cfg.remat,
            accum_steps=cfg.accum_steps if accum_steps is None
            else accum_steps, moe_aux_weight=cfg.moe_aux_weight,
            grad_norm=grad_norm, guard=guard, params=params, state=state,
            opt_state=opt_state, device=device)
    t = Trainer.create(
        model, tx, loss_fn, seed=cfg.seed, params=params, state=state,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16"
        else None, device=device, moe_aux_weight=cfg.moe_aux_weight,
        remat=cfg.remat,
        accum_steps=cfg.accum_steps if accum_steps is None else accum_steps,
        grad_norm=grad_norm, guard=guard)
    if opt_state is not None:
        t.opt_state = opt_state
    return t
