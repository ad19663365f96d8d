"""Sharded training over a mesh — counterpart of
``torchpruner_tpu/parallel/train.py``: DP over ``data`` x FSDP or
tensor parallelism over ``model``, optional ZeRO weight-update sharding.

Every rank holds its piece of each parameter and optimizer leaf under
the placement plan (:func:`plan_placements`) and takes its slice of
each global batch.  One step, on every rank (the collectives the JAX
package's GSPMD inserts, written out):

1. the compute form of the params: each leaf all-gathered from its
   pieces, except the pieces of tensor-parallel groups, which stay
   local (:func:`tp_compute`: column-parallel targets take Megatron's
   ``f`` on their input, row-parallel consumers reduce their partial
   sums over ``model``, attention runs on the rank's heads);
2. the forward and backward of ``train/loop.py``'s loss closure on the
   rank's batch slice, BatchNorm's moments and the MoE balancing
   loss's routing shares all-reduced over ``data``;
3. each gradient reduced to its update domain: reduce-scattered where
   the domain shards over ``data`` (ZeRO, full-mesh FSDP), all-reduced
   over ``data`` otherwise, sliced where it shards over ``model`` (the
   model axis's ranks hold the same gradient), and divided by the data
   axis's size (the loss is the global batch's mean);
4. the functional optimizer on the domain; with ZeRO the optimizer
   state lives there and the updated pieces are all-gathered over
   ``data`` back to the param placement.

At world size one no collective is made and a step computes what
``train.loop.Trainer.step`` computes, bit for bit.  After a prune,
:meth:`ShardedTrainer.rebuild` re-places the smaller trees.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel, init_model
from torchpruner_tpu_torch.parallel import collectives as C
from torchpruner_tpu_torch.parallel.memory import (
    opt_specs,
    training_memory,
)
from torchpruner_tpu_torch.parallel.mesh import (
    axis_index,
    mesh_axes,
    rank_device,
)
from torchpruner_tpu_torch.parallel.sharding import (
    P,
    fsdp_sharding,
    local_shard,
    tp_sharding,
    zero_update_sharding,
)
from torchpruner_tpu_torch.resilience import chaos as _chaos
from torchpruner_tpu_torch.train.loop import (
    _batch_tokens,
    _warn_empty_eval,
    make_loss_closure,
    to_device,
)
from torchpruner_tpu_torch.train.optim import apply_updates
from torchpruner_tpu_torch.utils.losses import prediction_counts
from torchpruner_tpu_torch.utils.tree import device_of

Path = Tuple[str, ...]


def _walk(tree, fn, prefix=()):
    """``fn(path, leaf)`` over a nested-dict / list tree, same structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [_walk(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(prefix, tree)


def _walk_all(tree, fn):
    """``fn([(path, leaf), ...])`` over every leaf of a tree at once (so
    their collectives coalesce), returning the new leaves in order; the
    same structure."""
    leaves = []
    _walk(tree, lambda p, t: leaves.append((p, t)))
    it = iter(fn(leaves))
    return _walk(tree, lambda _p, _t: next(it))


def _gather_tensors(leaves, specs, mesh):
    """``leaves`` (``[(path, leaf)]``) with every tensor gathered under
    its spec in ``specs``; other leaves as they are."""
    idx = [i for i, (_, t) in enumerate(leaves)
           if isinstance(t, torch.Tensor)]
    out = [t for _, t in leaves]
    got = C.gather([(leaves[i][1], _at(specs, leaves[i][0])) for i in idx],
                   mesh)
    for i, t in zip(idx, got):
        out[i] = t
    return out


def _at(tree, path: Path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) \
            and not isinstance(tree, P) else tree[k]
    return tree


def plan_placements(model, params, state, opt_state, tx, mesh, *,
                    partition: str = "fsdp", zero: bool = False,
                    data_axis: str = "data", model_axis="model",
                    min_shard_size: int = 2 ** 14):
    """``(param, state, opt, zero)`` spec trees — the one placement
    planner of the trainer and of its memory plan.  Pure shape work:
    ``params`` / ``opt_state`` may be ``meta`` tensors.  Param-shaped
    optimizer leaves take their param's placement, or the ZeRO update
    domain's with ``zero``; other leaves (step counts) replicate."""
    if partition not in ("fsdp", "tp"):
        raise ValueError(
            f"unknown partition {partition!r} (use 'fsdp' or 'tp')")
    if partition == "tp":
        ps = tp_sharding(model, params, mesh, model_axis, min_shard_size)
    else:
        ps = fsdp_sharding(params, mesh, model_axis, min_shard_size)
    ss = _walk(state, lambda _p, _l: P())
    zs = None
    if zero and mesh_axes(mesh).get(data_axis, 1) > 1:
        zs = zero_update_sharding(params, ps, mesh, data_axis)
    os_ = opt_specs(opt_state, params, zs if zs is not None else ps, P())
    return ps, ss, os_, zs


def mesh_factorizations(n_devices: int, *, data_axis: str = "data",
                        model_axis: str = "model",
                        max_model: int = None) -> list:
    """Every 2-axis factorization of ``n_devices`` into ``{data: d,
    model: m}``, data-major (pure DP first); the pure-DP entry omits the
    ``model: 1`` axis.  ``max_model`` bounds the model axis."""
    out = []
    n = max(1, int(n_devices))
    for m in range(1, n + 1):
        if n % m:
            continue
        if max_model is not None and m > max_model:
            break
        d = n // m
        if m == 1:
            out.append({data_axis: d})
        else:
            out.append({data_axis: d, model_axis: m})
    return out


def _spec_at(specs, layer: str, pname: str):
    try:
        return _at(specs, tuple(L.parse_path(layer)) + (pname,))
    except (KeyError, IndexError, TypeError):
        return None


def tp_compute(model: SegmentedModel, specs, mesh, axis: str = "model"
               ) -> Tuple[SegmentedModel, Dict[Path, str]]:
    """Which param pieces compute locally under tensor parallelism, and
    the model as one rank runs it: ``(local model, {path: "col" |
    "row" | "local"})``.  A prune group computes tensor-parallel when
    its placement is the column/row pair of ``sharding.tp_specs`` and
    nothing between target and consumers mixes the units: a Dense or
    GatedDense target with Dense / GatedDense / attention consumers
    (no attached norm, no flatten), or an attention layer (query heads
    column-parallel, ``wo`` row-parallel; K/V heads too when their
    count divides and the grouping is uniform, else the rank takes its
    heads' K/V from the gathered projections).  The local model gives
    such attention layers the rank's head count.  Every other leaf
    (Conv and MoE pieces included) is gathered for compute: the result
    is the same, with the compute repeated on the model axis."""
    from torchpruner_tpu_torch.core.graph import pruning_graph

    size = mesh_axes(mesh).get(axis, 1)
    kinds: Dict[Path, str] = {}
    if size == 1:
        return model, kinds
    r = axis_index(mesh, axis)
    col2, row2 = P(None, axis), P(axis, None)
    col3, row3 = P(None, axis, None), P(axis, None, None)
    local_model = model

    def path(layer, pname) -> Path:
        return tuple(L.parse_path(layer)) + (pname,)

    for g in pruning_graph(model, include_output=True):
        tgt = model.layer(g.target)
        if isinstance(tgt, L.MultiHeadAttention):
            if (_spec_at(specs, g.target, "wq") != col3
                    or _spec_at(specs, g.target, "wo") != row3):
                continue
            bias = P(axis, None)
            if tgt.use_bias and _spec_at(specs, g.target, "bq") != bias:
                continue
            mark = {"wq": "col", "wo": "row"}
            if tgt.use_bias:
                mark["bq"] = "local"
            hl = tgt.num_heads // size
            kv_local = (_spec_at(specs, g.target, "wk") == col3
                        and tgt.kv_group is None
                        and (not tgt.use_bias
                             or _spec_at(specs, g.target, "bk") == bias))
            if kv_local:
                mark.update(wk="col", wv="col")
                if tgt.use_bias:
                    mark.update(bk="local", bv="local")
                new = dataclasses.replace(
                    tgt, num_heads=hl, num_kv_heads=None
                    if tgt.num_kv_heads is None else tgt.kv_heads // size)
            else:
                idx = tgt.head_kv_index()[r * hl:(r + 1) * hl]
                new = dataclasses.replace(tgt, num_heads=hl,
                                          num_kv_heads=tgt.kv_heads,
                                          kv_group=tuple(idx))
            for p, k in mark.items():
                kinds[path(g.target, p)] = k
            local_model = local_model.replace_layer(g.target, new)
            continue
        if not isinstance(tgt, (L.Dense, L.GatedDense)) or not g.consumers \
                or g.attached_bn or any(c.fan_out != 1 for c in g.consumers):
            continue
        tnames = ("w",) if isinstance(tgt, L.Dense) else ("wg", "wu")
        bnames = [b for b in (("b",) if isinstance(tgt, L.Dense)
                              else ("bg", "bu"))
                  if _spec_at(specs, g.target, b) is not None]
        if any(_spec_at(specs, g.target, n) != col2 for n in tnames) or any(
                _spec_at(specs, g.target, b) != P(axis) for b in bnames):
            continue
        ok, rows = True, {}
        for c in g.consumers:
            cs = model.layer(c.layer)
            want = row3 if isinstance(cs, L.MultiHeadAttention) else row2
            if (not isinstance(cs, (L.Dense, L.GatedDense,
                                    L.MultiHeadAttention))
                    or _spec_at(specs, c.layer, c.param) != want):
                ok = False
                break
            rows[path(c.layer, c.param)] = "row"
        if not ok:
            continue
        for n in tnames:
            kinds[path(g.target, n)] = "col"
        for b in bnames:
            kinds[path(g.target, b)] = "local"
        kinds.update(rows)
    return local_model, kinds


@dataclass
class ShardedTrainer:
    """DP x FSDP / TP trainer over a mesh; the surface of
    ``train.loop.Trainer``.  ``params`` and ``opt_state`` hold this
    rank's pieces (:meth:`full_params` / :meth:`full_opt_state` gather
    them, on every rank at once); ``state`` (BatchNorm's statistics) is
    replicated."""

    model: SegmentedModel
    params: Any
    state: Any
    tx: Any
    opt_state: Any
    loss_fn: Callable
    rng: torch.Generator
    mesh: Any
    data_axis: str = "data"
    model_axis: str = "model"
    min_shard_size: int = 2 ** 14
    #: "fsdp": each large param's largest axis sharded; "tp": pruning-
    #: graph tensor parallelism with the FSDP rule elsewhere
    partition: str = "fsdp"
    #: ZeRO weight-update sharding over the data axis
    zero: bool = False
    compute_dtype: Any = None
    remat: bool = False
    accum_steps: int = 1
    moe_aux_weight: float = 0.0
    grad_norm: bool = False
    guard: Any = None
    step_count: int = 0
    #: (param, state, opt, zero) spec trees from plan_placements
    placements: Any = field(default=None, repr=False)
    #: full (unsharded) param shapes, as meta tensors
    full_shapes: Any = field(default=None, repr=False)
    _local_model: Any = field(default=None, repr=False)
    _kinds: Any = field(default=None, repr=False)
    _t_stream: Any = field(default=None, repr=False)

    @classmethod
    def create(cls, model, tx, loss_fn, mesh, seed: int = 0,
               data_axis: str = "data", model_axis="model",
               min_shard_size: int = 2 ** 14, partition: str = "fsdp",
               zero: bool = False, compute_dtype=None, remat: bool = False,
               accum_steps: int = 1, moe_aux_weight: float = 0.0,
               grad_norm: bool = False, guard: Any = None, params=None,
               state=None, opt_state=None, device=None
               ) -> "ShardedTrainer":
        """A trainer whose rank holds its pieces of the full trees:
        ``params`` / ``state`` / ``opt_state`` (full, on every rank) are
        adopted at their shapes, else initialized from ``seed`` (the same
        numbers on every rank).  Every rank's dropout generator starts
        from ``seed``: a data-axis rank draws the global batch's masks and
        keeps its rows (``core/layers.py``), so the masks are the
        single-device run's."""
        dev = rank_device(device if device is not None
                          else mesh.device_type)
        if params is None:
            params, state = init_model(model, seed, device=dev)
        params = _walk(params, lambda _p, t: t.to(dev))
        state = _walk(state or {}, lambda _p, t: t.to(dev))
        if opt_state is None:
            opt_state = tx.init(params)
        else:
            opt_state = _walk(opt_state, lambda _p, t: t.to(dev)
                              if isinstance(t, torch.Tensor) else t)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        t = cls(model=model, params=params, state=state, tx=tx,
                opt_state=opt_state, loss_fn=loss_fn, rng=gen, mesh=mesh,
                data_axis=data_axis, model_axis=model_axis,
                min_shard_size=min_shard_size, partition=partition,
                zero=zero, compute_dtype=compute_dtype, remat=remat,
                accum_steps=accum_steps, moe_aux_weight=moe_aux_weight,
                grad_norm=grad_norm, guard=guard)
        t._place()
        return t

    # -- placement -----------------------------------------------------------

    @property
    def data_size(self) -> int:
        return mesh_axes(self.mesh).get(self.data_axis, 1)

    def _group(self, axis):
        return self.mesh.get_group(axis)

    def _place(self):
        """Plan the placements of the full trees held in ``params`` /
        ``opt_state`` and keep this rank's pieces."""
        with obs.span("shard", partition=self.partition, zero=self.zero):
            ps, ss, os_, zs = plan_placements(
                self.model, self.params, self.state, self.opt_state,
                self.tx, self.mesh, partition=self.partition,
                zero=self.zero, data_axis=self.data_axis,
                model_axis=self.model_axis,
                min_shard_size=self.min_shard_size)
            self.placements = (ps, ss, os_, zs)
            self.full_shapes = _walk(self.params, lambda _p, t: torch.empty(
                tuple(t.shape), dtype=t.dtype, device="meta"))
            self.params = _walk(self.params, lambda p, t: local_shard(
                t, _at(ps, p), self.mesh))
            self.opt_state = _walk(
                self.opt_state, lambda p, t: local_shard(
                    t, _at(os_, p), self.mesh)
                if isinstance(t, torch.Tensor) else t)
            if self.partition == "tp":
                self._local_model, self._kinds = tp_compute(
                    self.model, ps, self.mesh, self.model_axis)
            else:
                self._local_model, self._kinds = self.model, {}
            self._record_memory_budget()

    def memory_plan(self, batch_per_chip: int = 1):
        """The per-rank budget of ``parallel.memory.training_memory`` for
        this trainer's placement."""
        return training_memory(
            self.model, self.placements[0], mesh_axes(self.mesh),
            tx=self.tx, batch_per_chip=batch_per_chip,
            compute_dtype=self.compute_dtype, remat=self.remat,
            params=self.full_shapes, zero=self.zero,
            data_axis=self.data_axis)

    def _record_memory_budget(self):
        """Planned per-rank bytes as obs gauges (inside a session)."""
        session = obs.get()
        if session is None:
            return
        budget = self.memory_plan()
        g = session.metrics.gauge
        g("planned_params_bytes_per_chip").set(budget.params_bytes)
        g("planned_grads_bytes_per_chip").set(budget.grads_bytes)
        g("planned_opt_bytes_per_chip").set(budget.opt_bytes)
        g("planned_total_bytes_per_chip").set(budget.total_bytes)

    def _compute_params(self):
        """The params as the step consumes them: tensor-parallel pieces
        local, every other leaf gathered."""
        ps = self.placements[0]
        # a tensor-parallel piece's spec as replicated: kept local
        specs = _walk(ps, lambda p, s: P() if p in self._kinds else s)
        return _walk_all(self.params,
                         lambda ls: _gather_tensors(ls, specs, self.mesh))

    def _transform(self, params):
        """Wrap the tensor-parallel product weights (after the compute
        dtype cast) in ``core.layers.TPWeight``."""
        if not self._kinds:
            return params
        group = self._group(self.model_axis)
        return _walk(params, lambda p, t: L.TPWeight(
            t, self._kinds[p] == "row", group)
            if self._kinds.get(p) in ("col", "row") else t)

    def full_params(self):
        """The full params, gathered (a collective: every rank calls)."""
        return _walk_all(self.params, lambda ls: _gather_tensors(
            ls, self.placements[0], self.mesh))

    def full_opt_state(self):
        """The full optimizer state, gathered (every rank calls)."""
        return _walk_all(self.opt_state, lambda ls: _gather_tensors(
            ls, self.placements[2], self.mesh))

    # -- training ------------------------------------------------------------

    def _local_batch(self, x, y):
        """This rank's rows of the global batch: microbatch ``j`` of the
        global batch is split over the data axis, so rank ``i`` takes
        rows ``j B/k + [i, i + 1) B/(k D)`` of every microbatch."""
        dev = self._device()
        x, y = to_device(x, dev), to_device(y, dev)
        k, n = self.accum_steps, self.data_size
        b = int(x.shape[0])
        if b % (k * n):
            raise ValueError(
                f"batch {b} not divisible by accum_steps={k} x mesh axis "
                f"{self.data_axis}={n}")
        i, m = axis_index(self.mesh, self.data_axis), b // (k * n)

        def take(a):
            a = a.reshape((k, b // k) + tuple(a.shape[1:]))
            return a[:, i * m:(i + 1) * m].reshape(
                (k * m,) + tuple(a.shape[2:]))

        return take(x), take(y)

    def loss_and_grads(self, x, y):
        """``(global mean loss, local grads in compute form, new
        state)`` of the global batch ``(x, y)``."""
        x, y = self._local_batch(x, y)
        k = self.accum_steps
        loss_c = make_loss_closure(
            self._local_model, self.loss_fn, self.compute_dtype,
            self._transform, self.moe_aux_weight, self.remat)
        cparams = self._compute_params()
        leaves = []

        def leaf(_p, t):
            t = t.detach().requires_grad_()
            leaves.append(t)
            return t

        params = _walk(cparams, leaf)
        state, loss, grads = self.state, None, None
        data_group = self._group(self.data_axis) \
            if self.data_size > 1 else None
        mb = x.shape[0] // k
        with C.batch_stats_over(data_group):
            for xb, yb in zip(x.split(mb), y.split(mb)):
                with torch.enable_grad():
                    l, state = loss_c(params, state, xb, yb, self.rng)
                    g = torch.autograd.grad(l, leaves)
                loss = l.detach() if loss is None else loss + l.detach()
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
        if k > 1:
            loss = loss / k
            grads = [g / k for g in grads]
        if data_group is not None:
            loss = C.all_reduce_(loss.clone(), data_group) / self.data_size
        it = iter(grads)
        return loss, _walk(cparams, lambda _p, _t: next(it)), state

    def _reduce_grads(self, grads):
        """Each gradient reduced to its update domain (module
        docstring, step 3)."""
        ps, _, _, zs = self.placements
        dom = zs if zs is not None else ps
        n = self.data_size

        def all_(leaves):
            got = C.scatter_reduce(
                [(g, _at(dom, p),
                  (self.model_axis,) if p in self._kinds else ())
                 for p, g in leaves], self.mesh, self.data_axis)
            return [g / n for g in got] if n > 1 else got

        return _walk_all(grads, all_)

    def _to_domain(self, params):
        """This rank's params narrowed from the param placement to the
        ZeRO update domain (identity without ZeRO)."""
        ps, _, _, zs = self.placements
        if zs is None:
            return params
        n, i = self.data_size, axis_index(self.mesh, self.data_axis)

        def one(p, t):
            for d, e in enumerate(_at(zs, p)):
                axes = e if isinstance(e, tuple) else (e,)
                pe = _at(ps, p)[d] if d < len(_at(ps, p)) else None
                paxes = pe if isinstance(pe, tuple) else (pe,)
                if self.data_axis in axes and self.data_axis not in paxes:
                    size = t.shape[d] // n
                    t = t.narrow(d, i * size, size)
            return t

        return _walk(params, one)

    def _from_domain(self, params):
        """Updated domain pieces all-gathered over the data axis back to
        the param placement (identity without ZeRO)."""
        ps, _, _, zs = self.placements
        if zs is None:
            return params
        group = self._group(self.data_axis)

        def dim(p):
            """The dimension ZeRO extended over the data axis, or None."""
            for d, e in enumerate(_at(zs, p)):
                axes = e if isinstance(e, tuple) else (e,)
                pe = _at(ps, p)[d] if d < len(_at(ps, p)) else None
                paxes = pe if isinstance(pe, tuple) else (pe,)
                if self.data_axis in axes and self.data_axis not in paxes:
                    return d
            return None

        def all_(leaves):
            out = [t for _, t in leaves]
            idx = [i for i, (p, _) in enumerate(leaves)
                   if dim(p) is not None]
            got = C.all_gather_many(
                [(out[i], dim(leaves[i][0])) for i in idx], group)
            for i, t in zip(idx, got):
                out[i] = t
            return out

        return _walk_all(params, all_)

    def _global_sq_norm(self, grads) -> torch.Tensor:
        """The squared global norm of the reduced gradients: each
        domain piece counted once over the ranks that hold a copy."""
        ps, _, _, zs = self.placements
        dom = zs if zs is not None else ps
        shp = mesh_axes(self.mesh)
        world = math.prod(shp.values())
        terms = []

        def one(p, g):
            spec = _at(dom, p)
            pieces = math.prod(shp[a] for e in spec if e is not None
                               for a in (e if isinstance(e, tuple) else (e,)))
            terms.append((g.float() ** 2).sum() * (pieces / world))
            return g

        _walk(grads, one)
        sq = torch.stack(terms).sum()
        if world > 1:
            import torch.distributed as dist

            C.all_reduce_(sq, dist.group.WORLD)
        return sq

    def _update(self, x, y) -> torch.Tensor:
        loss, grads, state = self.loss_and_grads(x, y)
        ok = True
        with torch.no_grad():
            grads = self._reduce_grads(grads)
            if self.grad_norm or self.guard is not None:
                gnorm = torch.sqrt(self._global_sq_norm(grads))
                if self.grad_norm:
                    obs.record_grad_norm(gnorm)
                if self.guard is not None:
                    ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            if ok:
                pdom = self._to_domain(self.params)
                updates, self.opt_state = self.tx.update(
                    grads, self.opt_state, pdom)
                self.params = self._from_domain(apply_updates(pdom, updates))
                self.state = state
        self.step_count += 1
        if self.guard is not None:
            self.guard.observe(not ok)
        return loss

    def step(self, x, y) -> torch.Tensor:
        """One optimizer step on the global batch ``(x, y)`` (every rank
        passes the same batch and takes its slice).  Returns the global
        mean loss."""
        if _chaos.active():
            _chaos.maybe_kill(self.step_count)
            _chaos.maybe_oom(self.step_count)
            x = _chaos.poison_batch(self.step_count, x)
        loss = self._update(x, y)
        now = time.perf_counter()
        if self._t_stream is not None:
            obs.record_step(now - self._t_stream, int(x.shape[0]),
                            _batch_tokens(x, y))
        self._t_stream = now
        return loss

    def multi_step(self, xs, ys) -> torch.Tensor:
        """K optimizer steps over stacked global batches ``(K, B, ...)``:
        K :meth:`step` bodies in order; returns the ``(K,)`` losses."""
        losses = torch.stack([self._update(xs[i], ys[i])
                              for i in range(len(xs))])
        k = int(len(xs))
        now = time.perf_counter()
        if self._t_stream is not None:
            yshape = tuple(getattr(ys, "shape", ()))
            tok = int(yshape[0] * yshape[1] * yshape[2]) \
                if len(yshape) >= 3 else None
            obs.record_step(now - self._t_stream, int(xs.shape[1]) * k,
                            tok, steps=k)
        self._t_stream = now
        return losses

    def rebuild(self, model, params, state, opt_state) -> "ShardedTrainer":
        """Adopt pruned FULL trees (``full_params`` / ``full_opt_state``
        after surgery): re-planned and re-placed over the same mesh."""
        t = dataclasses.replace(
            self, model=model, params=params,
            state=state if state is not None else {}, opt_state=opt_state,
            placements=None, full_shapes=None, _local_model=None,
            _kinds=None, _t_stream=None)
        t._place()
        return t

    @torch.no_grad()
    def evaluate(self, data):
        """Average loss and accuracy over ``data`` (global batches): a
        batch that does not divide the data axis is padded with zeros
        to the next multiple and only its real rows are counted (zeros,
        not a repeated row: a non-finite last example must count once);
        the sums are all-reduced over ``data``."""
        self._t_stream = None
        n = self.data_size
        i = axis_index(self.mesh, self.data_axis)
        dev = self._device()
        params = self._transform(self._compute_params())
        tot_l, tot_c, tot_n, tot_p, seen = 0.0, 0, 0, 0, False
        for x, y in (data() if callable(data) else data):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            b = int(x.shape[0])
            pad = (-b) % n
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
                y = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
            m = (b + pad) // n
            real = max(0, min(m, b - i * m))
            xl = to_device(x[i * m:(i + 1) * m], dev)
            yl = to_device(y[i * m:(i + 1) * m], dev)
            out, _ = self._local_model.apply(params, xl, state=self.state,
                                             train=False)
            losses = self.loss_fn(out, yl)[:real]
            correct, n_pred = prediction_counts(out[:real], yl[:real])
            tot_l += float(losses.sum())
            tot_c += int(correct)
            tot_n += real
            tot_p += int(n_pred)
            seen = True
        if n > 1:
            tot = torch.tensor([tot_l, tot_c, tot_n, tot_p],
                               dtype=torch.float64, device=dev)
            C.all_reduce_(tot, self._group(self.data_axis))
            tot_l, tot_c, tot_n, tot_p = tot.tolist()
        if not seen or tot_n == 0:
            _warn_empty_eval("ShardedTrainer.evaluate()")
            raise ValueError("evaluate() got an empty dataset")
        return tot_l / tot_n, tot_c / tot_p

    def _device(self) -> torch.device:
        return device_of(self.params)
