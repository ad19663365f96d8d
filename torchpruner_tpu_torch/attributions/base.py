"""Attribution metric base — counterpart of
``torchpruner_tpu/attributions/base.py``.

Every metric reduces to a row function ``(params, state, x, y) ->
(batch, n_units)`` of per-example scores.  The base class iterates the
dataset (numpy batches, moved to the params' device), stacks rows on the
host and applies the reduction.  Scoring runs the model in eval mode,
which keeps examples independent.

A sweep that scores many metrics at many layers over the same data
shares one :class:`ActivationCache` (installed on
``metric.capture_cache``): one forward a batch captures every
evaluation site's activation, and the metrics resume from it instead of
recomputing the prefix.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.graph import find_best_evaluation_layer
from torchpruner_tpu_torch.core.plan import _get_path
from torchpruner_tpu_torch.core.segment import SegmentedModel, capture_fn
from torchpruner_tpu_torch.train.loop import to_device
from torchpruner_tpu_torch.utils.tree import (
    cast_floats,
    device_of,
    tree_leaves,
)


class AttributionMetric:
    """Base attribution metric::

        metric = Metric(model, params, data, loss_fn, state=state,
                        reduction="mean")
        scores = metric.run("block1_mlp/fc1",
                            find_best_evaluation_layer=True)

    - ``data``: a re-iterable of ``(x, y)`` batches, or a zero-arg
      callable returning an iterator;
    - ``loss_fn(preds, y) -> (batch,)`` per-example losses;
    - ``reduction``: ``"mean" | "sum" | "none"`` or a callable on the
      ``(N, n_units)`` row matrix;
    - ``compute_dtype`` (``torch.bfloat16``): scoring forwards and
      backwards on params/inputs cast to it; rows stay f32.
    """

    #: whether evaluation-point shifting applies
    shiftable = True
    #: whether scoring runs model forwards over the dataset
    data_dependent = True

    def __init__(self, model: SegmentedModel, params, data,
                 loss_fn: Callable, *, state=None, reduction="mean",
                 seed: int = 0, compute_dtype=None):
        self.model = model
        self.params = params
        self.state = state if state is not None else {}
        self.data = data
        self.loss_fn = loss_fn
        self.reduction = reduction
        self.seed = seed
        self.compute_dtype = compute_dtype
        #: an :class:`ActivationCache` a sweep installs; when it matches
        #: this metric's model, params, state, data and dtype, rows start
        #: from the cached evaluation-site activation
        self.capture_cache: Optional["ActivationCache"] = None

    def run(self, layer: str, *, find_best_evaluation_layer: bool = False,
            **kw) -> np.ndarray:
        """Per-unit scores for prunable layer ``layer``."""
        spec = self.model.layer(layer)
        if not isinstance(spec, L.PRUNABLE_TYPES):
            raise TypeError(f"attributions require a prunable layer, got "
                            f"{type(spec).__name__}")
        eval_layer = self.find_evaluation_layer(layer,
                                                find_best_evaluation_layer)
        rows = self.compute_rows(layer, eval_layer, **kw)
        scores = self.aggregate_over_samples(rows)
        # provenance: the per-unit score distribution (percentiles, not
        # raw scores) goes to the run ledger, keyed by scoring site
        obs.record_scores(eval_layer, scores, layer=layer,
                          method=type(self).__name__, run=self.seed)
        return scores

    def find_evaluation_layer(self, layer: str, find_best: bool = False
                              ) -> str:
        if find_best and self.shiftable:
            return find_best_evaluation_layer(self.model, layer)
        return layer

    def compute_rows(self, layer: str, eval_layer: str, **kw) -> np.ndarray:
        stream = self.cached_row_stream(eval_layer, **kw)
        if stream is not None:
            return torch.cat(list(stream), dim=0).cpu().numpy()
        return self._collect(self.make_row_fn(eval_layer, **kw))

    def make_row_fn(self, eval_layer: str, **kw):
        """The row function ``(params, state, x, y) -> (batch,
        n_units)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement make_row_fn")

    def make_cached_row_fn(self, eval_layer: str, **kw):
        """The row function ``(params, state, z, y) -> (batch, n_units)``
        from the captured activation ``z`` at ``eval_layer``, or
        ``None`` (the default) when this metric or site cannot start
        from a cached activation and scores uncached."""
        return None

    def cached_row_stream(self, eval_layer: str, **kw):
        """Per-batch f32 rows from the installed capture cache, or
        ``None`` when the cache is absent, built from other inputs, or
        cannot serve this metric or site (counted as a miss).  The one
        place a metric's hits and misses are counted."""
        cache = self.capture_cache
        if cache is None or not self.data_dependent:
            return None
        if not cache.matches(self):
            cache.record_miss(eval_layer)
            return None
        fn = None
        if cache.has(eval_layer):
            fn = self.make_cached_row_fn(eval_layer, **kw)
        if fn is None:
            cache.record_miss(eval_layer)
            return None
        cache.record_hit(eval_layer)

        def gen():
            params = self.cast(self.params)
            for z, y in cache.batches_for(eval_layer):
                yield fn(params, self.state, z, y).float()

        return gen()

    def n_units(self, eval_layer: str) -> int:
        """Units at the evaluation site (its unit axis is last)."""
        return self.model.site_shape(eval_layer)[-1]

    def aggregate_over_samples(self, rows: np.ndarray) -> np.ndarray:
        if self.reduction == "mean":
            return np.mean(rows, 0)
        if self.reduction == "sum":
            return np.sum(rows, 0)
        if self.reduction == "none":
            return rows
        return self.reduction(rows)

    def batches(self):
        return self.data() if callable(self.data) else iter(self.data)

    def cast(self, tree):
        """The metric's ``compute_dtype`` applied to a tree's float
        leaves (identity when none is set)."""
        if self.compute_dtype is None:
            return tree
        return cast_floats(tree, self.compute_dtype)

    def run_rows(self, row_fn, params, x, y) -> torch.Tensor:
        """One batch of rows under the metric's compute dtype — inputs
        moved and cast, rows coerced to f32."""
        dev = device_of(params)
        rows = row_fn(params, self.state, self.cast(to_device(x, dev)),
                      to_device(y, dev))
        return rows.float()

    def _collect(self, row_fn) -> np.ndarray:
        """``row_fn`` over the dataset; rows stay on the device until one
        host fetch of the stacked matrix."""
        params = self.cast(self.params)
        out = [self.run_rows(row_fn, params, x, y) for x, y in self.batches()]
        if not out:
            raise ValueError(f"{type(self).__name__}: empty dataset — no "
                             f"batches to score")
        return torch.cat(out, dim=0).cpu().numpy()


def needs_taps(model: SegmentedModel, eval_layer: str) -> bool:
    """True when the evaluation site cannot be a segment boundary and
    metrics instrument a full forward instead: nested sites (inside a
    ``Residual``), attention layers (whose unit site is the head
    context) and MoE layers (whose unit site is the gates)."""
    if len(L.parse_path(eval_layer)) > 1:
        return True
    return isinstance(model.layer(eval_layer), (L.MultiHeadAttention, L.MoE))


def cpu_generator(seed: int, calls: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``(seed, calls)``: a metric's
    random draws are the same whatever device it scores on."""
    state = np.random.SeedSequence([int(seed), int(calls)]).generate_state(1)
    return torch.Generator(device="cpu").manual_seed(int(state[0]))


def param_at(params, layer: str):
    """Resolve a (possibly nested) layer's param dict."""
    return _get_path(params, L.parse_path(layer))


@functools.lru_cache(maxsize=512)
def prefix_fn(model: SegmentedModel, eval_layer: str):
    """``(params, state, x) -> activation at eval_layer`` (no grad)."""

    @torch.no_grad()
    def fn(params, state, x):
        z, _ = model.apply(params, x, state=state, train=False,
                           to_layer=eval_layer)
        return z

    return fn


@functools.lru_cache(maxsize=512)
def suffix_loss_fn(model: SegmentedModel, eval_layer: str, loss_fn):
    """``(params, state, z, y) -> per-example loss (batch,)``, resuming
    after ``eval_layer``."""

    def fn(params, state, z, y):
        preds, _ = model.apply(params, z, state=state, train=False,
                               from_layer=eval_layer)
        return loss_fn(preds, y)

    return fn


def batch_mean(losses: torch.Tensor) -> torch.Tensor:
    """The batch-mean loss a gradient row differentiates: over the
    global batch when ``parallel.DistributedScorer`` splits it over the
    data axis (the JAX package's mean over a sharded batch), so a rank's
    rows carry the global batch's ``1/N``."""
    from torchpruner_tpu_torch.parallel.collectives import (
        batch_group,
        group_size,
    )

    group = batch_group()
    if group is None:
        return losses.mean()
    return losses.sum() / (losses.shape[0] * group_size(group))


def spatial_sum(rows: torch.Tensor) -> torch.Tensor:
    """(B, ..., n) -> (B, n): sum every non-batch, non-unit axis."""
    if rows.ndim <= 2:
        return rows
    return rows.sum(dim=tuple(range(1, rows.ndim - 1)))


def float_dtype_of(params) -> torch.dtype:
    """The dtype of the first floating leaf (the activation dtype)."""
    return next((t.dtype for t in tree_leaves(params)
                 if isinstance(t, torch.Tensor) and t.is_floating_point()),
                torch.float32)


# ---------------------------------------------------------------------------
# One-pass sweep capture engine
# ---------------------------------------------------------------------------


class ActivationCache:
    """Activations at many evaluation sites, captured once and shared by
    a whole scoring sweep.

    A layerwise sweep scores every metric, stochastic run and ablation
    walk at L sites; each would otherwise rerun the prefix forward (input
    to site) per batch: O(L**2) prefix layer forwards.  The cache runs
    one forward a batch (``core.segment.capture_fn``) that stops at the
    deepest site, keeps each site's activation on the metric's device,
    and serves it to every consumer: O(L).

    - ``sites`` keeps the segment boundaries only: nested and head sites
      (``needs_taps``) cannot resume a suffix, so they stay uncached,
      listed in ``skipped_sites`` and counted as misses when scored;
    - ``compute_dtype`` casts params and inputs as the metrics do, so
      cached and uncached rows agree;
    - the fill happens on first use;
    - consumers check :meth:`matches` (the same model, params, state and
      data objects, the same dtype): a metric scoring other data or
      weights computes its own prefix instead of reading another's
      activations.

    Each fill runs inside an obs ``capture_fill`` span and each hit or
    miss bumps the obs capture counters (``attrib_capture_hits_total``,
    ``attrib_capture_misses_total``, the ``prefix_flops_saved`` gauge),
    as in the JAX package; :meth:`stats` carries the same counts.

    With ``mesh`` each batch is split over ``data_axis`` at fill time
    (``parallel.sharding.shard_batch``): a rank captures and keeps its
    slice only, and serves it to ``parallel.DistributedScorer`` and the
    sweep's walk, which reduce over the axis.
    """

    def __init__(self, model: SegmentedModel, params, data, *,
                 sites: Sequence[str], state=None, compute_dtype=None,
                 mesh=None, data_axis: str = "data"):
        self.mesh = mesh
        self.data_axis = data_axis
        self.model = model
        self.params = params          # identity anchor for matches()
        self.state = state if state is not None else {}
        self.data = data
        self.compute_dtype = compute_dtype
        self.sites: Tuple[str, ...] = tuple(dict.fromkeys(
            s for s in sites if not needs_taps(model, s)))
        self.skipped_sites: Tuple[str, ...] = tuple(
            s for s in dict.fromkeys(sites) if needs_taps(model, s))
        #: filled lazily: ({site: activation}, y) per batch
        self._batches: Optional[List[Tuple[Dict[str, Any], Any]]] = None
        self._param_aliases: set = set()
        self._state_aliases: set = set()
        #: (site, loss_fn) -> [dL/dz per batch], see :meth:`grads_for`
        self._grads: Dict[Tuple[str, Any], List[Any]] = {}
        self.hits = 0
        self.misses = 0
        self.prefix_flops_saved = 0.0
        self._examples = 0
        from torchpruner_tpu_torch.utils.flops import prefix_flops_estimate

        #: per-example prefix FLOPs per site, the price of one hit
        self._site_flops = {
            s: prefix_flops_estimate(model, params, s, batch_size=1)
            for s in self.sites}

    # -- guards ---------------------------------------------------------------

    def matches(self, metric: AttributionMetric) -> bool:
        """True when ``metric`` scores the very objects this cache was
        built from (identity, which cannot give a false positive)."""
        return self.provides_for(metric.model, metric.params, metric.state,
                                 metric.data, metric.compute_dtype)

    def provides_for(self, model, params, state, data,
                     compute_dtype) -> bool:
        return (model is self.model and self.owns_params(params)
                and self.owns_state(state) and data is self.data
                and compute_dtype == self.compute_dtype)

    def alias_params(self, params) -> None:
        """Accept another tree holding the same parameter values (a copy
        the caller made) in the identity guards."""
        self._param_aliases.add(id(params))

    def alias_state(self, state) -> None:
        """:meth:`alias_params` for the state tree."""
        self._state_aliases.add(id(state))

    def owns_params(self, params) -> bool:
        return params is self.params or id(params) in self._param_aliases

    def owns_state(self, state) -> bool:
        return (state is self.state or (not state and not self.state)
                or id(state) in self._state_aliases)

    def has(self, site: str) -> bool:
        return site in self.sites

    # -- fill / serve -----------------------------------------------------------

    def _fill(self):
        if self._batches is not None:
            return
        if not self.sites:
            self._batches = []
            return
        fn = capture_fn(self.model, self.sites)
        params = self.params
        if self.compute_dtype is not None:
            params = cast_floats(params, self.compute_dtype)
        dev = device_of(params)
        filled = []
        n = 0
        with torch.no_grad(), obs.span("capture_fill",
                                       sites=len(self.sites)):
            for x, y in (self.data() if callable(self.data)
                         else iter(self.data)):
                if self.mesh is not None:
                    from torchpruner_tpu_torch.parallel.sharding import (
                        shard_batch,
                    )

                    x, y = shard_batch((x, y), self.mesh, self.data_axis)
                x = to_device(x, dev)
                if self.compute_dtype is not None:
                    x = cast_floats(x, self.compute_dtype)
                filled.append((fn(params, self.state, x), to_device(y, dev)))
                n += int(x.shape[0])
        self._batches = filled
        self._examples = n

    def batches_for(self, site: str):
        """``(z, y)`` per batch for ``site``, on the params' device
        (fills the cache on first use)."""
        self._fill()
        for caps, y in self._batches:
            yield caps[site], y

    def grads_for(self, site: str, loss_fn, params, state) -> List[Any]:
        """The per-batch suffix gradient dL/dz of the batch-mean loss at
        ``site``, computed once per (site, loss): Sensitivity, Taylor and
        signed Taylor differentiate the same loss through the same
        suffix, so the panel shares one backward a batch and each metric
        keeps only its row math.  ``params`` carry the metric's cast
        (:meth:`matches` pins every consumer to the same values and
        dtype)."""
        key = (site, loss_fn)
        if key not in self._grads:
            from torchpruner_tpu_torch.attributions.activation import (
                suffix_grad_fn,
            )

            gfn = suffix_grad_fn(self.model, site, loss_fn)
            self._grads[key] = [gfn(params, state, z, y)
                                for z, y in self.batches_for(site)]
        return self._grads[key]

    def drop(self, site: str) -> None:
        """Release ``site``'s activations and gradients: the sweep drops
        a site once its layer's panel and walk are done and no later
        layer shares it, so the cache holds the live sites only."""
        self.sites = tuple(s for s in self.sites if s != site)
        if self._batches is not None:
            for caps, _y in self._batches:
                caps.pop(site, None)
        for key in [k for k in self._grads if k[0] == site]:
            del self._grads[key]

    # -- accounting -------------------------------------------------------------
    # hits and misses count scoring passes (one metric run, or one
    # ablation walk), whether or not the cache was filled yet, so two
    # identical sweeps report the same totals

    def record_hit(self, site: str):
        """One scoring pass served from the cache; prices the prefix
        forwards it saved."""
        self._fill()
        self.hits += 1
        saved = self._site_flops.get(site, 0.0) * self._examples
        self.prefix_flops_saved += saved
        obs.record_capture(hits=1, prefix_flops_saved=saved)

    def record_miss(self, site: str):
        """One scoring pass that recomputed its prefix despite the cache
        (an unsupported metric or site, or other inputs)."""
        self.misses += 1
        obs.record_capture(misses=1)

    def stats(self) -> Dict[str, float]:
        return {"sites": len(self.sites),
                "skipped_sites": len(self.skipped_sites),
                "hits": self.hits, "misses": self.misses,
                "prefix_flops_saved": self.prefix_flops_saved}
