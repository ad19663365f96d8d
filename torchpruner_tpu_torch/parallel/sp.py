"""Sequence-parallel training — long-context causal-LM steps over a
``data x seq`` mesh; counterpart of ``torchpruner_tpu/parallel/sp.py``.

DP / FSDP / TP (``parallel/train.py``) shard batches and weights; this
trainer shards the SEQUENCE dim.  Every rank runs the step on its
``(batch shard, sequence shard)``: position-independent layers (norms,
dense, MoE) compute on the local shard, and the attention layers, built
with ``impl="ring"`` or ``"ulysses"`` (``core/layers.py``), exchange KV
shards around the ring or heads by all-to-all over the ``seq`` group,
with RoPE at each shard's global offset.  The loss is the masked
next-token NLL summed over every rank divided by the summed count;
gradients are all-reduced over both axes in buckets
(``collectives.all_reduce_many_``) and every rank applies the same
update, so parameters stay replicated, bit for bit.

The causal next-token shift crosses shard boundaries, so the targets are
aligned on the host once per batch (:func:`aligned_targets`): each shard
then has a fully local masked loss, with no halo exchange in the step.

``SPTrainer`` mirrors the ``Trainer`` / ``ShardedTrainer`` surface
(step / rebuild / evaluate).  Its dropout masks come from each rank's
own generator, so they differ from the JAX package's (ROADMAP C2c).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel, init_model
from torchpruner_tpu_torch.parallel import collectives as C
from torchpruner_tpu_torch.parallel.mesh import (
    axis_index,
    mesh_axes,
    rank_device,
)
from torchpruner_tpu_torch.train.optim import apply_updates
from torchpruner_tpu_torch.utils.tree import cast_floats, tree_map


def sp_model(model: SegmentedModel, impl: str = "ring") -> SegmentedModel:
    """``model`` with every attention layer switched to the ``impl``
    sequence-parallel core (``"ring"`` | ``"ulysses"``), or back to a
    single-device core (``"auto"`` | ``"xla"`` | ``"flash"``), which is
    how :meth:`SPTrainer.evaluate` runs."""
    if impl not in ("ring", "ulysses", "auto", "xla", "flash"):
        raise ValueError(f"unknown SP impl {impl!r}")

    def convert(spec):
        if isinstance(spec, L.MultiHeadAttention):
            return dataclasses.replace(spec, impl=impl)
        if isinstance(spec, L.Residual):
            return dataclasses.replace(
                spec, body=tuple(convert(c) for c in spec.body),
                shortcut=tuple(convert(c) for c in spec.shortcut))
        return spec

    return dataclasses.replace(
        model, layers=tuple(convert(s) for s in model.layers))


def _contains_batchnorm(layers) -> bool:
    for spec in layers:
        if isinstance(spec, L.BatchNorm):
            return True
        if isinstance(spec, L.Residual) and (
                _contains_batchnorm(spec.body)
                or _contains_batchnorm(spec.shortcut)):
            return True
    return False


def aligned_targets(tokens) -> tuple:
    """``(targets, mask)`` with ``targets[:, t] = tokens[:, t + 1]`` and
    the final (targetless) position masked out: the host-side shift that
    makes the causal-LM loss local to each sequence shard."""
    tokens = np.asarray(tokens)
    tgt = np.concatenate([tokens[:, 1:], np.zeros_like(tokens[:, :1])],
                         axis=1)
    mask = np.ones(tokens.shape, np.float32)
    mask[:, -1] = 0.0
    return tgt, mask


def _rank_seed(seed: int, data: int, seq: int) -> int:
    """A rank's dropout seed: its own stream on every (data, seq)
    coordinate."""
    return (int(seed) * 0x9E3779B1 + data * 4096 + seq) % (1 << 63)


@dataclass
class SPTrainer:
    """Causal-LM trainer with the sequence dim sharded over ``seq`` (and
    the batch over ``data``).  Parameters replicated on every rank; the
    loss is the masked mean next-token cross-entropy over all predicted
    positions."""

    model: SegmentedModel
    params: Any
    state: Any
    tx: Any
    opt_state: Any
    #: this rank's dropout generator
    rng: torch.Generator
    mesh: Any
    impl: str = "ring"
    #: None = f32; torch.bfloat16 = mixed precision (f32 masters, the
    #: policy of train.loop.make_loss_closure)
    compute_dtype: Any = None
    #: recompute each block's forward in the backward
    remat: bool = False
    step_count: int = 0

    @classmethod
    def create(cls, model: SegmentedModel, tx, mesh, seed: int = 0,
               impl: str = "ring", compute_dtype=None,
               remat: bool = False) -> "SPTrainer":
        """A trainer on the mesh's device (each rank's ``cuda`` card, or
        the CPU for a mesh made with ``device="cpu"``), its params drawn
        from ``seed``; :meth:`rebuild` adopts other trees."""
        names = tuple(mesh.mesh_dim_names or ())
        for axis in ("data", "seq"):
            if axis not in names:
                raise ValueError(f"SPTrainer needs a '{axis}' mesh axis, "
                                 f"got {names}")
        if _contains_batchnorm(model.layers):
            # per-shard running statistics would diverge across the
            # sequence shards of one replicated state
            raise NotImplementedError(
                "SPTrainer does not support BatchNorm (per-batch running "
                "stats diverge across sequence shards); use LayerNorm/"
                "RMSNorm")
        model = sp_model(model, impl)
        dev = rank_device(mesh.device_type)
        params, state = init_model(model, seed, device=dev)
        gen = torch.Generator(device=dev).manual_seed(_rank_seed(
            seed, axis_index(mesh, "data"), axis_index(mesh, "seq")))
        return cls(model=model, params=params,
                   state=state if state is not None else {}, tx=tx,
                   opt_state=tx.init(params), rng=gen, mesh=mesh, impl=impl,
                   compute_dtype=compute_dtype, remat=remat)

    def _device(self) -> torch.device:
        return self.rng.device

    def _local(self, a) -> torch.Tensor:
        """This rank's (batch shard, sequence shard) of a host array."""
        shp = mesh_axes(self.mesh)
        B, S = a.shape[:2]
        nd, ns = shp["data"], shp["seq"]
        if B % nd or S % ns:
            raise ValueError(f"batch {B} x sequence {S} not divisible by "
                             f"mesh data={nd} x seq={ns}")
        d, s = axis_index(self.mesh, "data"), axis_index(self.mesh, "seq")
        b, n = B // nd, S // ns
        piece = np.ascontiguousarray(np.asarray(a)[d * b:(d + 1) * b,
                                                   s * n:(s + 1) * n])
        return torch.from_numpy(piece).to(self._device())

    def _all_reduce_many(self, ts):
        """In-place sums over ``seq``, then over ``data`` (one collective
        a bucket each; an axis of one rank makes none)."""
        C.all_reduce_many_(ts, self.mesh.get_group("seq"))
        return C.all_reduce_many_(ts, self.mesh.get_group("data"))

    def step(self, tokens) -> torch.Tensor:
        """One SP train step on a ``(B, S)`` token batch (the same on
        every rank; B divisible by the data axis, S by the seq axis).
        Returns the global mean loss."""
        tgt, mask = aligned_targets(tokens)
        x, tgt, mask = (self._local(a) for a in (tokens, tgt, mask))
        leaves = []

        def leaf(t):
            t = t.detach().requires_grad_()
            leaves.append(t)
            return t

        params = tree_map(leaf, self.params)
        with C.sequence_parallel_over(self.mesh.get_group("seq")), \
                torch.enable_grad():
            p = params if self.compute_dtype is None \
                else cast_floats(params, self.compute_dtype)
            logits, new_state = self.model.apply(
                p, x, state=self.state, train=True, rng=self.rng,
                remat=self.remat)
            logp = F.log_softmax(logits.float(), dim=-1)
            nll = -logp.gather(-1, tgt.long()[..., None])[..., 0]
            loc = torch.stack([(nll * mask).sum(), mask.sum()])
            tot = self._all_reduce_many([loc.detach().clone()])[0]
            # the gradient of (local sum / global count); summed over the
            # ranks it is the gradient of the global mean
            grads = list(torch.autograd.grad(loc[0] / tot[1], leaves))
        with torch.no_grad():
            self._all_reduce_many(grads)
            it = iter(grads)
            grads = tree_map(lambda _t: next(it), self.params)
            updates, self.opt_state = self.tx.update(
                grads, self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)
        self.state = new_state
        self.step_count += 1
        return tot[0] / tot[1]

    def evaluate(self, data, loss_fn):
        """Average loss / accuracy over ``data`` (batches of ``(tokens,
        targets)``) through the single-device attention core: the params
        are replicated, so every rank evaluates the whole of ``data``."""
        from torchpruner_tpu_torch.train.loop import evaluate

        return evaluate(sp_model(self.model, "auto"), self.params,
                        self.state, data, loss_fn)

    def rebuild(self, model, params, state, opt_state) -> "SPTrainer":
        """Adopt other (e.g. pruned) trees, moved to this rank's
        device."""
        dev = self._device()

        def move(t):
            return t.to(dev) if isinstance(t, torch.Tensor) else t

        return dataclasses.replace(
            self, model=sp_model(model, self.impl),
            params=tree_map(move, params),
            state=tree_map(move, state if state is not None else {}),
            opt_state=tree_map(move, opt_state))

