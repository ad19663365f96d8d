"""SPMD pipeline parallelism — collective-based, one process per stage;
counterpart of ``torchpruner_tpu/parallel/pp_spmd.py``.

For uniform-block transformer stacks (the llama, ViT and BERT families):
the ranks of a ``pp`` mesh axis each hold ``depth / n_stages`` blocks,
microbatches stream through the stages, and activations move stage to
stage by a cyclic shift over the ``pp`` group
(:func:`~torchpruner_tpu_torch.parallel.collectives.shift`).

Schedule: the Megatron interleaved schedule (Narayanan et al., 2021)
with ``V = interleave`` virtual stages per rank; ``V = 1`` is GPipe
forward fill / drain (Huang et al., 2019).  Each rank holds the ``V``
depth chunks ``v * S + d`` (``cb = depth / (S V)`` blocks each) and the
activation ring gains a wrap edge ``S - 1 -> 0``, so a microbatch passes
every rank ``V`` times.  At tick ``t`` rank ``d`` sits on lane ``tt = t -
d`` and computes chunk ``v = (tt // S) mod V`` for microbatch ``m = (tt //
(S V)) S + tt mod S``: stage 0 injects when ``v = 0``, the last stage
banks when ``v = V - 1``.  Lanes outside the schedule (the bubble, and
the missing microbatches of a ragged last wave) compute nothing; every
rank still makes each tick's shift, so the collectives pair up.

The backward: JAX differentiates the whole program, the transpose of a
``ppermute`` being the reverse permutation.  In eager torch each rank's
pipelined region is one autograd node whose backward walks the ticks in
reverse: at tick ``t`` every rank shifts the gradient of the activation it
received at ``t + 1`` back to its sender, then runs ``autograd.grad`` of
its tick-``t`` output (kept from the forward), so every rank issues its
shifts in the order its peers do.

``pre`` (the embedding) and ``post`` (final norm and head) run on every
rank; the last stage's outputs reach the other ranks by an all-reduce
(zeros elsewhere), so every rank returns the same logits and loss.  In
the train step their gradients are all-reduced over ``pp``, each counted
once (``pre``'s is non-zero on stage 0 alone, ``post``'s is kept on the
last stage alone); with ``data_axis`` every gradient is all-reduced over
``data`` too.  A rank holds the params and optimizer state of ``pre``,
``post`` and its own blocks (:func:`stage_params`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.parallel import collectives as C
from torchpruner_tpu_torch.parallel.mesh import axis_index, mesh_axes
from torchpruner_tpu_torch.train.optim import apply_updates
from torchpruner_tpu_torch.utils.tree import (
    cast_floats,
    device_of,
    tree_leaves,
    tree_map,
)


def split_pipeline(model: SegmentedModel):
    """``(pre, groups, post)``: the top-level layers before the first
    transformer block, one spec tuple per block (the repeating unit, by
    the zoo's ``block{i}_*`` naming), and the layers after the last
    block.  Raises if the groups are not uniform, if block indices are
    not contiguous, if non-block layers interleave the stack, or on
    BatchNorm and MoE layers."""
    pat = re.compile(r"^block(\d+)_(.+)$")
    pre: List[L.LayerSpec] = []
    groups: List[List[L.LayerSpec]] = []
    post: List[L.LayerSpec] = []
    cur_idx = None
    for spec in model.layers:
        m = pat.match(spec.name)
        if m is None:
            (post if groups else pre).append(spec)
            continue
        if post:
            raise ValueError(
                f"block layer {spec.name} appears after non-block layer "
                f"{post[0].name}: the block stack must be contiguous "
                "for SPMD pipelining")
        idx = int(m.group(1))
        if cur_idx is None or idx == cur_idx + 1:
            groups.append([spec])
            cur_idx = idx
        elif idx == cur_idx:
            groups[-1].append(spec)
        else:
            raise ValueError(
                f"block indices jump at {spec.name} (previous block "
                f"{cur_idx}): the stack must be contiguous")
    if not groups:
        raise ValueError(
            "no block{i}_* layers found — pp_spmd needs a uniform "
            "transformer block stack (llama / ViT / BERT families)")

    def _reject_unsupported(spec):
        if isinstance(spec, L.BatchNorm):
            raise ValueError(
                f"BatchNorm ({spec.name}) carries running state; "
                "cross-microbatch state threading belongs to "
                "parallel.pipeline, not the SPMD formulation")
        if isinstance(spec, L.MoE):
            raise ValueError(
                f"MoE ({spec.name}) emits a load-balancing aux loss this "
                "schedule does not collect — train MoE stacks with "
                "ShardedTrainer (EP) or parallel.pipeline instead")
        for child in tuple(getattr(spec, "body", ()) or ()) + tuple(
                getattr(spec, "shortcut", ()) or ()):
            _reject_unsupported(child)

    for spec in list(pre) + [s for g in groups for s in g] + list(post):
        _reject_unsupported(spec)
    canon = canonical_group(groups[0])
    for g in groups[1:]:
        if canonical_group(g) != canon:
            raise ValueError(
                f"non-uniform blocks ({g[0].name}... differs from "
                f"{groups[0][0].name}...) — stage stacking requires "
                "identical block shapes")
    return tuple(pre), tuple(tuple(g) for g in groups), tuple(post)


def canonical_group(group) -> tuple:
    """The group's specs with block-index-free names (``pp{j}``): the
    uniformity comparand and the spec set a stage applies."""
    return tuple(dataclasses.replace(s, name=f"pp{j}")
                 for j, s in enumerate(group))


def stack_block_params(params, groups):
    """Per-leaf ``torch.stack`` of the blocks' param subtrees along a new
    leading depth axis, keyed by canonical position name (``pp{j}``);
    positions without params (e.g. Activation) are absent."""
    out = {}
    for j, spec in enumerate(groups[0]):
        present = [g[j].name in params for g in groups]
        if not any(present):
            continue
        if not all(present):
            raise ValueError(
                f"block position {j} ({spec.name}) has params in some "
                "blocks but not others")
        trees = [params[g[j].name] for g in groups]
        out[f"pp{j}"] = tree_map(lambda *xs: torch.stack(xs), *trees)
    return out


def _layout(model, n_stages: int, V: int, d: int):
    """``(pre, groups, post, blocks)``: :func:`split_pipeline`'s parts and
    the global indices of stage ``d``'s blocks in its local order (its
    ``V`` chunks ``v S + d``, chunk-major)."""
    pre, groups, post = split_pipeline(model)
    depth = len(groups)
    if V < 1:
        raise ValueError(f"interleave must be >= 1, got {V}")
    if depth % (n_stages * V) != 0:
        raise ValueError(f"depth {depth} not divisible by {n_stages} "
                         f"stages × {V} virtual chunks")
    cb = depth // (n_stages * V)
    blocks = [(v * n_stages + d) * cb + b
              for v in range(V) for b in range(cb)]
    return pre, groups, post, blocks


def stage_params(model: SegmentedModel, params, *, mesh, axis: str = "pp",
                 interleave: int = 1):
    """This rank's part of a full param tree: ``pre``, ``post`` and the
    blocks of its stage (what :func:`pp_spmd_train_step`'s step takes
    and returns, and what its optimizer state is made from)."""
    pre, groups, post, blocks = _layout(
        model, mesh_axes(mesh)[axis], int(interleave),
        axis_index(mesh, axis))
    names = [s.name for s in pre] + [s.name for b in blocks
                                     for s in groups[b]] + [
        s.name for s in post]
    return {k: params[k] for k in names if k in params}


def _mix(*xs) -> int:
    h = 0
    for x in xs:
        h = (h * 0x9E3779B97F4A7C15 + int(x) + 1) % (1 << 63)
    return h


class _FromLast(torch.autograd.Function):
    """The last stage's ``x`` on every rank of ``group`` (the others pass
    zeros): an all-reduce; the backward keeps the gradient on the last
    stage, where ``x`` was computed."""

    @staticmethod
    def forward(ctx, x, group, last: bool):
        ctx.last = last
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


class _Schedule:
    """One rank's view of the interleaved schedule (module docstring)."""

    def __init__(self, n_stages: int, V: int, cb: int, M: int, d: int):
        self.S, self.V, self.cb, self.M, self.d = n_stages, V, cb, M, d
        # ticks to the last bank of microbatch M - 1
        self.T = (((M - 1) // n_stages * V + V - 1) * n_stages
                  + (M - 1) % n_stages + n_stages)

    def lane(self, t: int):
        """``(v, m, valid)`` of this rank at tick ``t``."""
        tt = t - self.d
        if tt < 0:
            return 0, 0, False
        rnd = tt // self.S
        v = rnd % self.V
        m = (rnd // self.V) * self.S + tt % self.S
        return v, m, m < self.M


class _Pipelined(torch.autograd.Function):
    """The pipelined region of one rank: ``x_micro`` (M, mb, ...) in, the
    banked outputs (zeros off the last stage) out; ``leaves`` are the
    flat param tensors of the rank's blocks (module docstring)."""

    @staticmethod
    def forward(ctx, run, x_micro, *leaves):
        sch, group = run["schedule"], run["group"]
        wrap = sch.V > 1
        keep = run["grad"]  # build each tick's graph for the backward
        p = [t.detach().requires_grad_(keep) for t in leaves]
        it = iter(p)
        blocks = [tree_map(lambda _t: next(it), b) for b in run["blocks"]]
        x_micro = x_micro.detach()
        out = torch.zeros_like(x_micro)
        act_in = torch.zeros_like(x_micro[0])
        recs = []
        for t in range(sch.T):
            v, m, valid = sch.lane(t)
            send = torch.zeros_like(act_in)
            if valid:
                inject = sch.d == 0 and v == 0
                cur = (x_micro[m] if inject else act_in).detach()
                with torch.set_grad_enabled(keep):
                    y = cur.requires_grad_(keep)
                    for b in range(v * sch.cb, (v + 1) * sch.cb):
                        y, _ = L.apply_seq(
                            run["specs"], blocks[b], {}, y,
                            train=run["train"], rng=run["rng"],
                            remat=run["remat"])
                if keep:
                    recs.append((inject, m, cur, y))
                if sch.d == sch.S - 1 and v == sch.V - 1:
                    out[m] = y.detach()
                send = y.detach()
            if t < sch.T - 1:
                (act_in,) = C.shift([send], group, 1, wrap)
        ctx.run, ctx.p, ctx.recs = run, p, recs
        return out

    @staticmethod
    def backward(ctx, g_out):
        run, p, recs = ctx.run, ctx.p, ctx.recs
        sch, group = run["schedule"], run["group"]
        wrap = sch.V > 1
        g_x = torch.zeros((sch.M,) + tuple(g_out.shape[1:]),
                          dtype=g_out.dtype, device=g_out.device)
        # f32 sums over the ticks of each parameter's gradient
        g_p = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in p]
        g_recv = torch.zeros_like(g_out[0])  # of act_in at tick t + 1
        for t in reversed(range(sch.T)):
            if t < sch.T - 1:
                (g_y,) = C.shift([g_recv], group, -1, wrap)
            else:
                g_y = torch.zeros_like(g_recv)
            g_recv = torch.zeros_like(g_recv)
            v, m, valid = sch.lane(t)
            if not valid:
                continue
            inject, m, cur, y = recs.pop()
            if sch.d == sch.S - 1 and v == sch.V - 1:
                g_y = g_y + g_out[m]
            with torch.enable_grad():  # a remat block recomputes here
                got = torch.autograd.grad(y, [cur] + p, g_y.to(y.dtype),
                                          allow_unused=True)
            for acc, g in zip(g_p, got[1:]):
                if g is not None:
                    acc += g.float()
            if inject:
                g_x[m] = got[0]
            else:
                g_recv = got[0]
        ctx.recs = None
        return (None, g_x) + tuple(g.to(t.dtype) for g, t in zip(g_p, p))


def _check_dropout_rng(layers, train: bool, rng) -> None:
    """Raise the Dropout rule's own error before any collective (a rank
    that raised mid-schedule would leave its peers waiting)."""
    if not train or rng is not None:
        return
    for spec in layers:
        if isinstance(spec, L.Dropout) and spec.rate > 0.0:
            raise ValueError(f"Dropout {spec.name!r} needs an rng in "
                             f"train mode")
        _check_dropout_rng(tuple(getattr(spec, "body", ()) or ())
                           + tuple(getattr(spec, "shortcut", ()) or ()),
                           train, rng)


def _forward_local(model, params, tokens, *, mesh, n_microbatches, axis,
                   data_axis, remat, compute_dtype, train, rng, interleave):
    """``(logits of this rank's rows, those rows' inputs, global B)``:
    the rows are this rank's data shard of every microbatch, in
    microbatch order."""
    shp = mesh_axes(mesh)
    n_stages, V = shp[axis], int(interleave)
    d = axis_index(mesh, axis)
    pre, groups, post, blocks = _layout(model, n_stages, V, d)
    M = n_microbatches
    B = tokens.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    nd, di = 1, 0
    if data_axis is not None:
        if data_axis not in shp:
            raise ValueError(f"data_axis {data_axis!r} not in mesh axes "
                             f"{tuple(shp)}")
        nd, di = shp[data_axis], axis_index(mesh, data_axis)
        if (B // M) % nd != 0:
            raise ValueError(
                f"microbatch size {B // M} not divisible by mesh axis "
                f"{data_axis}={nd}")
    _check_dropout_rng(model.layers, train, rng)
    dev = device_of(params)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    mbl = B // M // nd
    x = tokens.to(dev).reshape((M, B // M) + tuple(tokens.shape[1:]))
    x = x[:, di * mbl:(di + 1) * mbl].reshape(
        (M * mbl,) + tuple(tokens.shape[1:]))
    if compute_dtype is not None:
        params = cast_floats(params, compute_dtype)
    gens = [None] * 3
    if rng is not None:
        seeds = torch.randint(0, 1 << 62, (3,), generator=rng,
                              device=rng.device).tolist()
        gens = [torch.Generator(device=dev).manual_seed(_mix(s, *c))
                for s, c in zip(seeds, ((di,), (d, di), (di,)))]
    h, _ = L.apply_seq(pre, params, {}, x, train=train, rng=gens[0])
    x_micro = h.reshape((M, mbl) + tuple(h.shape[1:]))
    local = [{f"pp{j}": params[s.name] for j, s in enumerate(groups[b])
              if s.name in params} for b in blocks]
    leaves = [t for b in local for t in tree_leaves(b)]
    run = {"schedule": _Schedule(n_stages, V, len(blocks) // V, M, d),
           "group": mesh.get_group(axis), "blocks": local,
           "specs": canonical_group(groups[0]), "train": train,
           "remat": remat, "rng": gens[1],
           "grad": torch.is_grad_enabled() and (h.requires_grad or any(
               t.requires_grad for t in leaves))}
    y = _Pipelined.apply(run, x_micro, *leaves)
    if n_stages > 1:
        y = _FromLast.apply(y, run["group"], d == n_stages - 1)
    y = y.reshape((M * mbl,) + tuple(y.shape[2:]))
    logits, _ = L.apply_seq(post, params, {}, y, train=train, rng=gens[2])
    return logits, x, B


def pp_spmd_apply(model: SegmentedModel, params, tokens, *, mesh,
                  n_microbatches: int, axis: str = "pp",
                  data_axis: str | None = None, remat: bool = False,
                  compute_dtype=None, train: bool = False, rng=None,
                  interleave: int = 1):
    """Forward pass with the block stack pipelined over the group of
    mesh axis ``axis`` (module docstring); every rank passes the same
    ``tokens`` (``(B, S)``, ``B % n_microbatches == 0``) and ``params``
    holding at least :func:`stage_params`, and every rank returns the
    ``(B, S, vocab)`` logits.

    - ``interleave = V > 1``: the interleaved schedule, which needs
      ``depth % (n_stages V) == 0``;
    - ``data_axis``: PP x DP on a 2-D mesh: each microbatch's rows are
      split over the data axis, and the logits gathered back;
    - ``rng`` (a ``torch.Generator``, the same on every rank) feeds
      train-mode Dropout: ``pre`` and ``post`` draw the same masks on
      every stage, each stage's blocks their own.

    Differentiable: gradients reach ``pre``'s params on stage 0, each
    block's on its stage and ``post``'s on every rank."""
    logits, _, B = _forward_local(
        model, params, tokens, mesh=mesh, n_microbatches=n_microbatches,
        axis=axis, data_axis=data_axis, remat=remat,
        compute_dtype=compute_dtype, train=train, rng=rng,
        interleave=interleave)
    if data_axis is None or mesh_axes(mesh)[data_axis] == 1:
        return logits
    M = n_microbatches
    lm = logits.reshape((M, -1) + tuple(logits.shape[1:]))
    full = C.gather_dim(lm, 1, mesh.get_group(data_axis))
    return full.reshape((B,) + tuple(logits.shape[1:]))


def pp_spmd_train_step(model, optimizer, loss_fn, *, mesh, n_microbatches,
                       axis: str = "pp", data_axis: str | None = None,
                       remat: bool = False, compute_dtype=None,
                       interleave: int = 1):
    """A ``(params, opt_state, tokens, rng=None) -> (params', opt_state',
    loss)`` step whose forward and backward are pipelined over the group
    of mesh axis ``axis``.  ``params`` and ``opt_state`` are the rank's
    (:func:`stage_params`, and ``optimizer.init`` of them; a full tree is
    narrowed to the rank's part).  ``loss_fn(logits, tokens) -> (B,)``
    per-example losses; the loss is their mean over the global batch.
    Dropout-bearing models pass a fresh ``rng`` per step."""

    def step(params, opt_state, tokens, rng=None):
        params = stage_params(model, params, mesh=mesh, axis=axis,
                              interleave=interleave)
        pre, _, post = split_pipeline(model)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _t: next(it), params)
        with torch.enable_grad():
            logits, x, B = _forward_local(
                model, p, tokens, mesh=mesh, n_microbatches=n_microbatches,
                axis=axis, data_axis=data_axis, remat=remat,
                compute_dtype=compute_dtype, train=True, rng=rng,
                interleave=interleave)
            loss = loss_fn(logits, x).sum() / B
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, got)]
        shp = mesh_axes(mesh)
        # which top-level layer each leaf belongs to
        owner = [k for k, sub in params.items() for _ in tree_leaves(sub)]
        outer = {s.name for s in pre} | {s.name for s in post}
        last = axis_index(mesh, axis) == shp[axis] - 1
        with torch.no_grad():
            if shp[axis] > 1:
                post_names = {s.name for s in post}
                for i, k in enumerate(owner):
                    if k in post_names and not last:
                        grads[i].zero_()
                C.all_reduce_many_([g for g, k in zip(grads, owner)
                                    if k in outer], mesh.get_group(axis))
            loss = loss.detach().reshape(1)
            if data_axis is not None and shp[data_axis] > 1:
                C.all_reduce_many_(grads + [loss],
                                   mesh.get_group(data_axis))
            git = iter(grads)
            gtree = tree_map(lambda _t: next(git), params)
            updates, opt_state = optimizer.update(gtree, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss[0]

    return step
