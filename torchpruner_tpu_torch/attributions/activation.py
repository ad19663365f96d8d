"""Forward/backward activation metrics: APoZ, Sensitivity, Taylor —
counterpart of ``torchpruner_tpu/attributions/activation.py``.

Each metric is one row function.  The gradient is of the batch-mean
loss, taken with ``torch.autograd.grad``:

- top-level non-attention sites split the model at the site and
  differentiate the suffix with respect to the cut activation;
- nested sites (inside ``Residual`` bodies) and attention head sites
  instrument one full forward: the activation is captured and the
  gradient is taken with respect to a zero ``perturb`` tensor added at
  the site (the JAX package runs a capture forward and a perturbed
  forward; here one forward serves both, since ``z + 0 == z``).

Params are not differentiated: only the path from the site to the loss
carries a gradient.  Top-level rows go through the same from-``z`` core
whether ``z`` is computed here or read from a sweep's
``ActivationCache``; with a cache the gradient metrics also share one
suffix gradient per (site, loss) (``ActivationCache.grads_for``).
"""

from __future__ import annotations

import functools

import torch

from torchpruner_tpu_torch.attributions.base import (
    AttributionMetric,
    batch_mean,
    float_dtype_of,
    needs_taps,
    prefix_fn,
    spatial_sum,
    suffix_loss_fn,
)


class _GradRowsMetric(AttributionMetric):
    """Shared base of the forward/backward activation metrics: one
    ``mode`` string selects the row math; cached (from ``z``) and
    uncached rows come from the same core."""

    mode: str = ""

    def _mode(self) -> str:
        return self.mode

    def make_row_fn(self, eval_layer, **kw):
        return grad_rows_fn(self.model, eval_layer, self.loss_fn,
                            self._mode())

    def make_cached_row_fn(self, eval_layer, **kw):
        if needs_taps(self.model, eval_layer):
            return None  # the from-z core resumes at a segment boundary
        return grad_rows_from_z_fn(self.model, eval_layer, self.loss_fn,
                                   self._mode())

    def cached_row_stream(self, eval_layer, **kw):
        """The gradient modes share one memoized suffix gradient per
        (site, loss) across the panel; APoZ and every miss take the base
        class's path."""
        cache = self.capture_cache
        mode = self._mode()
        if (cache is None or mode == "apoz" or not cache.matches(self)
                or not cache.has(eval_layer)
                or needs_taps(self.model, eval_layer)):
            return super().cached_row_stream(eval_layer, **kw)
        cache.record_hit(eval_layer)
        finish = finish_rows_fn(mode)
        params = self.cast(self.params)

        def gen():
            grads = cache.grads_for(eval_layer, self.loss_fn, params,
                                    self.state)
            for (z, _y), g in zip(cache.batches_for(eval_layer), grads):
                yield finish(z, g)

        return gen()


def _finish(mode: str, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # row math in f32 even under bf16 scoring (the spatial sum
    # accumulates many terms)
    z, g = z.float(), g.float()
    if mode == "sensitivity":
        return spatial_sum(g.abs())  # abs first, then the spatial sum
    taylor = spatial_sum(-g * z)  # sum first, then abs
    if mode == "taylor":
        return taylor.abs()
    return taylor  # taylor_signed


@functools.lru_cache(maxsize=512)
def grad_rows_fn(model, eval_layer, loss_fn, mode: str):
    """``(params, state, x, y) -> (batch, n_units)`` rows for ``mode`` in
    ``{"apoz", "sensitivity", "taylor", "taylor_signed"}``."""
    if needs_taps(model, eval_layer):
        site = model.site_shape(eval_layer)

        def fn(params, state, x, y):
            if mode == "apoz":
                with torch.no_grad():
                    _, _, z = model.apply(params, x, state=state,
                                          train=False, capture=eval_layer)
                return spatial_sum((z > 0).float())
            delta = torch.zeros((x.shape[0],) + tuple(site),
                                dtype=float_dtype_of(params),
                                device=x.device, requires_grad=True)
            with torch.enable_grad():
                preds, _, z = model.apply(params, x, state=state,
                                          train=False,
                                          perturb=(eval_layer, delta),
                                          capture=eval_layer)
                loss = batch_mean(loss_fn(preds, y))
                (g,) = torch.autograd.grad(loss, delta)
            return _finish(mode, z.detach(), g)

        return fn

    prefix = prefix_fn(model, eval_layer)
    from_z = grad_rows_from_z_fn(model, eval_layer, loss_fn, mode)

    def fn(params, state, x, y):
        return from_z(params, state, prefix(params, state, x), y)

    return fn


@functools.lru_cache(maxsize=512)
def grad_rows_from_z_fn(model, eval_layer, loss_fn, mode: str):
    """``(params, state, z, y) -> (batch, n_units)`` rows from the
    evaluation-site activation ``z``: the prefix-free core of
    :func:`grad_rows_fn` (which computes ``z`` and calls it), and what a
    sweep's activation cache feeds."""
    grad = suffix_grad_fn(model, eval_layer, loss_fn)

    def fn(params, state, z, y):
        if mode == "apoz":
            return spatial_sum((z > 0).float())
        return _finish(mode, z, grad(params, state, z, y))

    return fn


@functools.lru_cache(maxsize=512)
def suffix_grad_fn(model, eval_layer, loss_fn):
    """``(params, state, z, y) -> dL/dz`` of the batch-mean loss through
    the model suffix after ``eval_layer``: the one gradient Sensitivity,
    Taylor and signed Taylor share at a site."""
    suffix = suffix_loss_fn(model, eval_layer, loss_fn)

    def fn(params, state, z, y):
        z = z.detach().requires_grad_()
        with torch.enable_grad():
            loss = batch_mean(suffix(params, state, z, y))
            (g,) = torch.autograd.grad(loss, z)
        return g

    return fn


@functools.lru_cache(maxsize=16)
def finish_rows_fn(mode: str):
    """``(z, g) -> rows``: the per-mode row math on a shared gradient."""
    return functools.partial(_finish, mode)


class APoZAttributionMetric(_GradRowsMetric):
    """1−APoZ: per-example count of positive activations per unit.
    Higher = more alive."""

    mode = "apoz"


class SensitivityAttributionMetric(_GradRowsMetric):
    """Average absolute gradient of the loss w.r.t. each unit's
    activation."""

    mode = "sensitivity"


class TaylorAttributionMetric(_GradRowsMetric):
    """First-order Taylor expansion |−g·a| of the loss change on unit
    removal; ``signed=True`` keeps the sign."""

    def __init__(self, *args, signed: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.signed = signed

    def _mode(self) -> str:
        return "taylor_signed" if self.signed else "taylor"
