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
- :func:`all_to_all` and :func:`ppermute` are the exchanges of sequence
  and pipeline parallelism (``lax.all_to_all`` with ``tiled=True``, and
  ``lax.ppermute`` as a cyclic shift), differentiable: the backward is
  the inverse exchange.  Both go through one ``all_to_all_single``, a
  collective, so two ranks cannot deadlock on a paired send and receive;
  a shift gives it uneven splits, the whole buffer to the one peer.
  gloo refuses CUDA tensors for the list form of ``all_to_all`` and for
  point-to-point sends (``experiments/dist_probe.py``), and takes them
  for ``all_to_all_single``.
- :func:`sequence_parallel_over` names the ``seq`` group of the enclosing
  sequence-parallel step (the attention rule's ring and Ulysses cores
  read it).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.distributed as dist

#: the data-axis group of the enclosing :func:`batch_stats_over` and the
#: seq group of the enclosing :func:`sequence_parallel_over`: plain
#: globals, not context variables, because the backward of a CUDA step
#: (and a remat block's recompute in it) runs on autograd's device
#: thread, which sees none of the caller's context variables
_BATCH_GROUP = [None]
_SEQ_GROUP = [None]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@contextlib.contextmanager
def _scoped(slot, value):
    prev = slot[0]
    slot[0] = value
    try:
        yield
    finally:
        slot[0] = prev


def batch_stats_over(group):
    """Within the block, batch statistics are all-reduced over ``group``
    (the data axis): the forward AND the backward of a sharded step
    run inside it (remat recomputes in the backward)."""
    return _scoped(_BATCH_GROUP, group if group_size(group) > 1 else None)


def batch_group():
    """The data-axis group of the enclosing :func:`batch_stats_over`, or
    None (local statistics)."""
    return _BATCH_GROUP[0]


def sequence_parallel_over(group):
    """Within the block, attention layers whose ``impl`` is ``"ring"`` or
    ``"ulysses"`` run on the sequence shard of this rank of ``group``
    (the forward and the backward of a sequence-parallel step)."""
    return _scoped(_SEQ_GROUP, group)


def seq_group():
    """The group of the enclosing :func:`sequence_parallel_over`, or
    None outside one."""
    return _SEQ_GROUP[0]


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


def _all_to_all(t: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    # row j of ``src`` goes to group rank j; row i of ``out`` came from i
    n = group_size(group)
    src = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over ``group``: ``x`` is split into ``n`` chunks along ``split_dim``,
    chunk ``r`` goes to group rank ``r``, and the chunks a rank receives
    are concatenated along ``concat_dim`` in rank order.
    Differentiable (the backward is the inverse exchange)."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def shift(ts, group, offset: int = 1, wrap: bool = True):
    """Group rank ``r``'s tensors ``ts`` sent to rank ``r + offset`` (mod
    ``n`` with ``wrap``, else the edge rank sends nothing and the other
    edge receives zeros); returns what this rank received, one
    collective for all of ``ts`` (no gradient).  The collective's splits
    are uneven: the whole buffer goes to the one peer and nothing to the
    others, so a shift moves the bytes a send would at any ``n``."""
    n = group_size(group)
    if n == 1:
        return [t if wrap else torch.zeros_like(t) for t in ts]
    r = dist.get_rank(group)
    flat = torch.cat([t.reshape(-1) for t in ts])
    size = flat.numel()
    send, recv = [0] * n, [0] * n
    if wrap or 0 <= r + offset < n:
        send[(r + offset) % n] = size
    if wrap or 0 <= r - offset < n:
        recv[(r - offset) % n] = size
    got = flat.new_empty(sum(recv))
    dist.all_to_all_single(got, flat[:sum(send)], output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    if not sum(recv):
        got = torch.zeros_like(flat)
    out = got.split([t.numel() for t in ts])
    return [o.view_as(t) for o, t in zip(out, ts)]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(shift([t.contiguous() for t in ts], group, 1))

    @staticmethod
    def backward(ctx, *gs):
        back = shift([g.contiguous() for g in gs], ctx.group, -1)
        return (None,) + tuple(back)


def ppermute(ts, group):
    """``lax.ppermute`` over ``group`` with the cyclic permutation ``r ->
    r + 1``: the tensors ``ts`` (one dtype) of rank ``r - 1``, all in one
    exchange.  Differentiable: the backward shifts the gradients back,
    ``r -> r - 1``."""
    return list(_Shift.apply(group, *ts))


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


def _piece(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = t.shape[dim] // group_size(group)
    return t.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _piece(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.dim, ctx.group), None, None


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece (group-rank order) of the replicated ``x``
    along ``dim``; the backward all-gathers the pieces' gradients, so
    every rank gets the gradient of the whole ``x``."""
    if group_size(group) == 1:
        return x
    return _Scatter.apply(x, dim, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The pieces of every rank concatenated along ``dim`` (replicated);
    the backward keeps this rank's piece of the (replicated)
    gradient."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group)


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
