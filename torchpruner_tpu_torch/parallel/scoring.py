"""Data-parallel attribution scoring — counterpart of
``torchpruner_tpu/parallel/scoring.py``.

The per-example score rows, the currency of every metric
(``make_row_fn``), are computed with each batch split over the mesh's
``data`` axis: each rank scores its slice.  ``mean``, ``sum`` and
``mean+2std`` never gather the ``(examples, n_units)`` matrix: each rank
sums its rows' moments (Σx, Σx², N) and one all-reduce over ``data``
combines them; ``none`` or a callable gathers the rows, batch by batch
in the global batch's row order.
"""

from __future__ import annotations

import numpy as np
import torch

from torchpruner_tpu_torch.attributions.base import AttributionMetric
from torchpruner_tpu_torch.parallel import collectives as C
from torchpruner_tpu_torch.parallel.mesh import mesh_axes
from torchpruner_tpu_torch.parallel.sharding import shard_batch
from torchpruner_tpu_torch.utils.reductions import (
    from_moments,
    mean_plus_2std,
)

MOMENT_REDUCTIONS = ("mean", "sum", "mean+2std")


class DistributedScorer:
    """Wrap any attribution metric to score with batches split over the
    mesh's ``data`` axis: ``DistributedScorer(metric, mesh).run(layer)``
    gives ``metric.run(layer)``'s result (same rows, same reduction) on
    every rank.  A data axis of one rank scores through ``metric.run``
    itself, so a world of one computes what a run without a mesh does.
    The metric scores with the full params (a sharded trainer's
    ``full_params()``)."""

    def __init__(self, metric: AttributionMetric, mesh, axis: str = "data"):
        self.metric = metric
        self.mesh = mesh
        self.axis = axis

    # the sweep installs the capture cache on whatever ``run`` object its
    # factory returned: forwarded to the wrapped metric
    @property
    def capture_cache(self):
        return self.metric.capture_cache

    @capture_cache.setter
    def capture_cache(self, cache):
        self.metric.capture_cache = cache

    def run(self, layer: str, *, find_best_evaluation_layer: bool = False,
            **kw) -> np.ndarray:
        metric = self.metric
        if (mesh_axes(self.mesh).get(self.axis, 1) == 1
                or not metric.data_dependent
                or type(metric).make_row_fn is AttributionMetric.make_row_fn):
            # one rank on the axis, or weight-only metrics (and metrics
            # that override run() without a row fn): no rows to split
            return metric.run(
                layer, find_best_evaluation_layer=find_best_evaluation_layer,
                **kw)
        eval_layer = metric.find_evaluation_layer(
            layer, find_best_evaluation_layer)
        reduction = metric.reduction
        group = self.mesh.get_group(self.axis)
        params = metric.cast(metric.params)
        # the uncached row fn (and Shapley's permutation draw) is built
        # only when the capture cache cannot serve the site
        row_fn = None
        if metric.capture_cache is None:
            row_fn = metric.make_row_fn(eval_layer, **kw)

        if reduction in MOMENT_REDUCTIONS or reduction is mean_plus_2std:
            red = "mean+2std" if reduction is mean_plus_2std else reduction
            s1 = s2 = None
            n = 0
            for rows in self._rows(eval_layer, row_fn, params, **kw):
                b1, b2 = rows.sum(dim=0), (rows * rows).sum(dim=0)
                s1 = b1 if s1 is None else s1 + b1
                s2 = b2 if s2 is None else s2 + b2
                n += int(rows.shape[0])
            if s1 is None:
                raise ValueError(f"{type(metric).__name__}: empty dataset")
            mom = torch.stack([s1, s2])
            C.all_reduce_(mom, group)
            cnt = torch.tensor([n], dtype=torch.int64, device=mom.device)
            C.all_reduce_(cnt, group)
            mom = mom.cpu().numpy()
            return np.asarray(from_moments(red, mom[0], mom[1],
                                           int(cnt.item())))
        out = [C.all_gather_dim(rows.contiguous(), 0, group)
               for rows in self._rows(eval_layer, row_fn, params, **kw)]
        if not out:
            raise ValueError(f"{type(metric).__name__}: empty dataset")
        return metric.aggregate_over_samples(
            torch.cat(out, dim=0).cpu().numpy())

    def _rows(self, eval_layer, row_fn, params, **kw):
        """This rank's rows, batch by batch, computed inside
        ``batch_stats_over`` the data axis: a row that differentiates the
        batch-mean loss takes the global batch's mean."""
        group = self.mesh.get_group(self.axis)
        cached = self.metric.cached_row_stream(eval_layer, **kw)
        if cached is not None:  # a mesh cache holds this rank's slices
            while True:
                with C.batch_stats_over(group):
                    rows = next(cached, None)
                if rows is None:
                    return
                yield rows
        if row_fn is None:
            row_fn = self.metric.make_row_fn(eval_layer, **kw)
        for x, y in self.metric.batches():
            x, y = shard_batch((x, y), self.mesh, self.axis)
            with C.batch_stats_over(group):
                rows = self.metric.run_rows(row_fn, params, x, y)
            yield rows
