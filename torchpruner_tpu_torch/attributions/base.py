"""Attribution metric base — counterpart of
``torchpruner_tpu/attributions/base.py`` (without the one-pass
``ActivationCache``, ROADMAP A2: ``capture_cache`` stays ``None``).

Every metric reduces to a row function ``(params, state, x, y) ->
(batch, n_units)`` of per-example scores.  The base class iterates the
dataset (numpy batches, moved to the params' device), stacks rows on the
host and applies the reduction.  Scoring runs the model in eval mode,
which keeps examples independent.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.graph import find_best_evaluation_layer
from torchpruner_tpu_torch.core.plan import _get_path
from torchpruner_tpu_torch.core.segment import SegmentedModel
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
        self.capture_cache = None

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
        return self.aggregate_over_samples(rows)

    def find_evaluation_layer(self, layer: str, find_best: bool = False
                              ) -> str:
        if find_best and self.shiftable:
            return find_best_evaluation_layer(self.model, layer)
        return layer

    def compute_rows(self, layer: str, eval_layer: str, **kw) -> np.ndarray:
        return self._collect(self.make_row_fn(eval_layer, **kw))

    def make_row_fn(self, eval_layer: str, **kw):
        """The row function ``(params, state, x, y) -> (batch,
        n_units)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement make_row_fn")

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
    ``Residual``) and attention layers (whose unit site is the head
    context)."""
    if len(L.parse_path(eval_layer)) > 1:
        return True
    return isinstance(model.layer(eval_layer), L.MultiHeadAttention)


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
