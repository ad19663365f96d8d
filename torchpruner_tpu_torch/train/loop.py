"""Training and evaluation loops — counterpart of
``torchpruner_tpu/train/loop.py``.

The JAX package compiles one donated step per model spec; the port runs
the same step eagerly: the forward on params cast to the compute dtype,
``torch.autograd.grad`` with respect to the f32 master params, then the
functional optimizer (``train/optim.py``).  After a prune step changes
shapes, ``Trainer.rebuild`` carries the bundle over to the new spec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchpruner_tpu_torch.core import segment
from torchpruner_tpu_torch.core.segment import SegmentedModel
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
                      param_transform: Optional[Callable] = None):
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
    wrapper."""

    def loss(params, state, x, y, rng):
        if compute_dtype is not None:
            params = cast_floats(params, compute_dtype)
            x = cast_floats(x, compute_dtype)
        if param_transform is not None:
            params = param_transform(params)
        out, new_state = model.apply(params, x, state=state, train=True,
                                     rng=rng)
        if compute_dtype is not None:
            out = out.float()
        return loss_fn(out, y).mean(), new_state

    return loss


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
    return float(np.mean(losses)) if losses else float("nan")


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

    @classmethod
    def create(cls, model, tx, loss_fn, seed: int = 0, params=None,
               state=None, compute_dtype=None, device=None,
               param_transform=None):
        """A trainer on ``device`` (``None`` = ``cuda``; raises without a
        GPU unless ``device="cpu"``), initialized from ``seed`` unless
        ``params`` are given.  The JAX trainer's remat, gradient
        accumulation and MoE aux loss are not ported yet (ROADMAP A1,
        A3); configs asking for them raise in ``run_prune_retrain``."""
        dev = resolve_device(device)
        if params is None:
            params, state = segment.init_model(model, seed, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return cls(model=model, params=params,
                   state=state if state is not None else {}, tx=tx,
                   opt_state=tx.init(params), loss_fn=loss_fn, rng=gen,
                   compute_dtype=compute_dtype,
                   param_transform=param_transform)

    def step(self, x, y) -> torch.Tensor:
        """One optimizer step on the batch ``(x, y)`` (host arrays or
        tensors); returns the mean loss as a 0-d tensor."""
        dev = device_of(self.params)
        x, y = to_device(x, dev), to_device(y, dev)
        loss_c = make_loss_closure(self.model, self.loss_fn,
                                   self.compute_dtype,
                                   self.param_transform)
        leaves = [t.detach().requires_grad_() for t in
                  tree_leaves(self.params)]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), self.params)
        with torch.enable_grad():
            loss, new_state = loss_c(params, self.state, x, y, self.rng)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), self.params)
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     self.params)
            self.params = apply_updates(self.params, updates)
        self.state = new_state
        self.step_count += 1
        return loss.detach()

    def rebuild(self, model, params, state, opt_state) -> "Trainer":
        return Trainer(model=model, params=params,
                       state=state if state is not None else {},
                       tx=self.tx, opt_state=opt_state,
                       loss_fn=self.loss_fn, rng=self.rng,
                       compute_dtype=self.compute_dtype,
                       step_count=self.step_count,
                       param_transform=self.param_transform)

    def evaluate(self, data):
        return evaluate(self.model, self.params, self.state, data,
                        self.loss_fn)
