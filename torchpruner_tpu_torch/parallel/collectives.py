"""The collectives the distribution layer issues, over one mesh axis's
process group at a time.  GSPMD inserts these in the JAX package; here
they are explicit.  A group of one rank makes no call, so a world of
one computes exactly what the single-device code computes.

- :func:`gather` / :func:`scatter_reduce` move tensors between their
  full form and their pieces under specs (``parallel/sharding.py``), one
  axis at a time: tuple entries model-major, as the placements say.
  Both take a whole tree's leaves at once and coalesce the collectives
  that go over one axis into flat buckets (:data:`BUCKET_BYTES`).
- :func:`all_reduce_sum` is differentiable (the backward all-reduces
  the gradient), for batch statistics computed over the data axis.
- :func:`copy_to` / :func:`reduce_from` are Megatron's ``f`` / ``g``:
  identity forward with an all-reduced gradient at a column-parallel
  layer's input, an all-reduced forward with an identity gradient after
  a row-parallel product.
- :func:`batch_stats_over` names the data-axis group inside which
  BatchNorm's train-mode moments and the MoE balancing loss's routing
  shares are global (``core/layers.py`` reads it).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch
import torch.distributed as dist

_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_stats_group", default=None)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@contextlib.contextmanager
def batch_stats_over(group):
    """Within the block, batch statistics are all-reduced over ``group``
    (the data axis): the forward AND the backward of a sharded step
    run inside it (remat recomputes in the backward)."""
    token = _BATCH_GROUP.set(group if group_size(group) > 1 else None)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group():
    """The data-axis group of the enclosing :func:`batch_stats_over`, or
    None (local statistics)."""
    return _BATCH_GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, differentiable."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron ``f``: the input of a column-parallel product."""
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron ``g``: the partial sums of a row-parallel product."""
    if group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place sum (or ``op``) over ``group``; returns ``x``."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenation of every rank's ``t`` along ``dim`` in group-rank
    order (no gradient)."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    # contiguous, as the full tensor would be: a product on a strided
    # operand can take another kernel, and round differently
    return out.movedim(0, dim).contiguous()


#: the most bytes one coalesced collective moves (a larger tensor goes
#: alone): the per-call cost of a collective, which over gloo on CUDA
#: tensors includes a host round trip, is paid once a bucket
BUCKET_BYTES = 1 << 26


def _buckets(ts, nbytes, bucket_bytes):
    """Index runs over ``ts`` of one dtype and device, each at most
    ``bucket_bytes`` by ``nbytes(i)`` (a larger tensor alone)."""
    keyed = {}
    for i, t in enumerate(ts):
        keyed.setdefault((t.dtype, t.device), []).append(i)
    for idx in keyed.values():
        run, size = [], 0
        for i in idx:
            if run and size + nbytes(i) > bucket_bytes:
                yield run
                run, size = [], 0
            run.append(i)
            size += nbytes(i)
        if run:
            yield run


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_many_(ts, group, bucket_bytes: int = BUCKET_BYTES):
    """In-place sums over ``group`` of the contiguous tensors ``ts``, one
    collective a bucket of them.  The sum is elementwise, so over two
    ranks each element is what :func:`all_reduce_` gives it (over more,
    a backend may add in another order); returns ``ts``."""
    if group_size(group) == 1:
        return ts
    for run in _buckets(ts, lambda i: _nbytes(ts[i]), bucket_bytes):
        if len(run) == 1:
            dist.all_reduce(ts[run[0]], group=group)
            continue
        flat = torch.cat([ts[i].reshape(-1) for i in run])
        dist.all_reduce(flat, group=group)
        for i, piece in zip(run, flat.split([ts[i].numel() for i in run])):
            ts[i].copy_(piece.view_as(ts[i]))
    return ts


def all_gather_many(items, group, bucket_bytes: int = BUCKET_BYTES):
    """:func:`all_gather_dim` of each ``(t, dim)`` of ``items``, one
    collective a bucket (the same tensors, bit for bit)."""
    n = group_size(group)
    if n == 1:
        return [t for t, _ in items]
    src = [t.movedim(d, 0).contiguous() for t, d in items]
    out = [None] * len(items)
    for run in _buckets(src, lambda i: n * _nbytes(src[i]), bucket_bytes):
        flat = torch.cat([src[i].reshape(-1) for i in run])
        got = flat.new_empty((n * flat.numel(),))
        dist.all_gather_into_tensor(got, flat, group=group)
        # row r: rank r's pieces, one after another
        rows = got.view(n, -1).split([src[i].numel() for i in run], dim=1)
        for i, piece in zip(run, rows):
            s = src[i]
            full = piece.reshape((n * s.shape[0],) + tuple(s.shape[1:]))
            # contiguous, as the full tensor would be: a product on a
            # strided operand can take another kernel, and round otherwise
            out[i] = full.movedim(0, items[i][1]).contiguous()
    return out


def reduce_scatter_many(items, group, bucket_bytes: int = BUCKET_BYTES):
    """This rank's piece (group-rank order) along ``dim`` of the sum of
    every rank's ``t``, for each ``(t, dim)`` of ``items``, one
    collective a bucket."""
    n = group_size(group)
    if n == 1:
        return [t for t, _ in items]
    src = [t.movedim(d, 0).contiguous() for t, d in items]
    out = [None] * len(items)
    for run in _buckets(src, lambda i: _nbytes(src[i]), bucket_bytes):
        # row r: every tensor's piece r, one after another
        flat = torch.cat([src[i].reshape(n, -1) for i in run], dim=1)
        got = flat.new_empty((flat.shape[1],))
        dist.reduce_scatter_tensor(got, flat.reshape(-1), group=group)
        pieces = got.split([src[i].numel() // n for i in run])
        for i, piece in zip(run, pieces):
            s = src[i]
            out[i] = piece.reshape((s.shape[0] // n,) + tuple(s.shape[1:])
                                   ).movedim(0, items[i][1]).contiguous()
    return out


def _entry_axes(spec, d):
    e = spec[d] if d < len(spec) else None
    if e is None:
        return ()
    return tuple(e) if isinstance(e, tuple) else (e,)


def gather(items, mesh):
    """The full tensor of each ``(piece, spec)`` of ``items`` from every
    rank's pieces: per dimension, the innermost axis of a tuple entry
    first.  The k-th gathers of all the tensors that make one on the same
    axis go as one coalesced collective."""
    ops = [[(d, a) for d in range(len(spec))
            for a in reversed(_entry_axes(spec, d))] for _, spec in items]
    out = [t for t, _ in items]
    for k in range(max(map(len, ops), default=0)):
        by_axis = {}
        for i, o in enumerate(ops):
            if k < len(o):
                by_axis.setdefault(o[k][1], []).append(i)
        for a, idx in by_axis.items():
            got = all_gather_many([(out[i], ops[i][k][0]) for i in idx],
                                  mesh.get_group(a))
            for i, t in zip(idx, got):
                out[i] = t
    return out


def scatter_reduce(items, mesh, data_axis: str):
    """This rank's piece under ``spec`` of the sum over ``data_axis`` of
    every rank's ``t``, for each ``(t, spec, local)`` of ``items``: a
    reduce-scatter where the spec shards over the data axis, a slice
    where it shards over an axis whose ranks hold the same ``t`` (the
    model axis), an all-reduce when the spec does not shard over the data
    axis at all.  Dimensions whose entry axes are in ``local`` are
    already this rank's piece on those axes.  The reduce-scatters, and
    the all-reduces, of all the tensors go as coalesced collectives."""
    from torchpruner_tpu_torch.parallel.mesh import axis_index, mesh_axes

    shp = mesh_axes(mesh)

    def narrow(t, d, a):
        size = t.shape[d] // shp[a]
        return t.narrow(d, axis_index(mesh, a) * size, size)

    out, after, scatter = [], [], []
    for i, (t, spec, local) in enumerate(items):
        ops = [(d, a) for d in range(len(spec))
               for a in _entry_axes(spec, d) if a not in local]
        k = next((j for j, (_, a) in enumerate(ops) if a == data_axis),
                 len(ops))
        for d, a in ops[:k]:
            t = narrow(t, d, a)
        if k < len(ops):
            scatter.append((i, ops[k][0]))
        out.append(t.contiguous())
        after.append(ops[k + 1:])
    if scatter:
        got = reduce_scatter_many([(out[i], d) for i, d in scatter],
                                  mesh.get_group(data_axis))
        for (i, _), t in zip(scatter, got):
            out[i] = t
    if data_axis in shp:
        scattered = {i for i, _ in scatter}
        all_reduce_many_([t for i, t in enumerate(out)
                          if i not in scattered], mesh.get_group(data_axis))
    return [functools.reduce(lambda t, op: narrow(t, *op), ops, t)
            .contiguous() for t, ops in zip(out, after)]


def broadcast_flag(flag: bool, device, group=None) -> bool:
    """Rank 0's ``flag`` on every rank (one collective; no group: the
    flag as is)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.broadcast(t, src=0, group=group)
    return bool(t.item())


def default_device() -> Optional[torch.device]:
    """The device the default group's collectives take tensors on."""
    if not dist.is_initialized():
        return None
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
