"""Monte-Carlo Shapley value attribution — counterpart of
``torchpruner_tpu/attributions/shapley.py``, the hot loop of the
framework.

Per batch and for each of ``sv_samples`` unit permutations, the units
are zeroed one at a time in permutation order (cumulative masking) and
each step's change of the per-example loss is recorded; the changes are
scattered back to unit order and averaged over the permutations.  As the
JAX package's ``vmap`` batches the permutations, each of the ``n``
sequential unit steps here is one forward on ``S·B`` rows (every
permutation's copy of the batch, each under its own mask), not ``S``
forwards on ``B`` rows:

- the fast path (``use_partial``, top-level sites) computes the prefix
  activation once per batch and runs only the suffix at each step;
- the masking path (nested and attention-head sites) runs the full
  forward at each step with a per-row ``unit_mask`` of shape
  ``(S·B, n)``.

Permutations are drawn on a CPU generator and then moved to the device,
so the CPU and the card drop the same units.  Under a sweep's
``ActivationCache`` the fast path resumes from the cached activation
(``make_cached_row_fn``); the masking path scores uncached.
"""

from __future__ import annotations

import functools

import torch

from torchpruner_tpu_torch.attributions.base import (
    AttributionMetric,
    cpu_generator,
    float_dtype_of,
    needs_taps,
    prefix_fn,
    suffix_loss_fn,
)


def _tile(t: torch.Tensor, S: int) -> torch.Tensor:
    """``S`` copies of a batch along the rows: row ``s·B + b`` is
    ``t[b]``."""
    return t.repeat((S,) + (1,) * (t.ndim - 1))


@functools.lru_cache(maxsize=512)
def shapley_rows_from_z_fn(model, eval_layer: str, loss_fn):
    """``(params, state, z, y, perms) -> (batch, n_units)`` Shapley rows
    from the eval-site activation ``z``: the prefix-free core of the
    ``use_partial`` fast path."""
    n = model.site_shape(eval_layer)[-1]
    suffix = suffix_loss_fn(model, eval_layer, loss_fn)

    @torch.no_grad()
    def fn(params, state, z, y, perms):
        base = suffix(params, state, z, y)  # (B,) per-example loss
        S, B = perms.shape[0], z.shape[0]
        zs, ys = _tile(z, S), _tile(y, S)
        # the mask in the activation's dtype: a f32 mask would promote a
        # bf16 suffix back to f32
        rows = (S * B,) + (1,) * (z.ndim - 2) + (n,)

        def masked_loss(mask):  # (S, n) -> (S·B,)
            m = mask.repeat_interleave(B, dim=0).reshape(rows)
            return suffix(params, state, zs * m, ys)

        return _perm_scan(masked_loss, base, perms, n, z.dtype)

    return fn


def _perm_scan(masked_loss, base, perms, n, mask_dt):
    """The sequential marginal chain shared by both paths: ``n`` steps of
    cumulative zeroing, each step one ``masked_loss`` call on every
    permutation's rows at once; the deltas land in unit order."""
    S, B = perms.shape[0], base.shape[0]
    dev = base.device
    mask = torch.ones((S, n), dtype=mask_dt, device=dev)
    perm_rows = torch.arange(S, device=dev)
    prev = base.repeat(S)
    deltas = torch.empty((S, n, B), dtype=base.dtype, device=dev)
    for t in range(n):
        units = perms[:, t]
        mask[perm_rows, units] = 0  # cumulative zeroing
        loss = masked_loss(mask)
        deltas[perm_rows, units] = (loss - prev).view(S, B)
        prev = loss
    return deltas.mean(dim=0).T  # (B, n): mean over permutations


@functools.lru_cache(maxsize=512)
def shapley_rows_fn(model, eval_layer: str, loss_fn, use_partial: bool):
    """``(params, state, x, y, perms) -> (batch, n_units)`` Shapley rows;
    ``perms`` is an ``(sv_samples, n_units)`` int64 tensor of unit
    permutations on the batch's device, fixed across batches."""
    n = model.site_shape(eval_layer)[-1]
    if use_partial:
        prefix = prefix_fn(model, eval_layer)
        from_z = shapley_rows_from_z_fn(model, eval_layer, loss_fn)

        def fn(params, state, x, y, perms):
            return from_z(params, state, prefix(params, state, x), y, perms)

        return fn

    @torch.no_grad()
    def fn(params, state, x, y, perms):
        # the mask multiplies the site activation mid-forward, in the
        # dtype the model computes in (x may be integer tokens)
        mask_dt = x.dtype if x.is_floating_point() \
            else float_dtype_of(params)
        S, B = perms.shape[0], x.shape[0]

        def loss_at(xx, yy, mask):
            preds, _ = model.apply(params, xx, state=state, train=False,
                                   unit_mask=(eval_layer, mask))
            return loss_fn(preds, yy)

        base = loss_at(x, y, torch.ones((n,), dtype=mask_dt,
                                        device=x.device))
        xs, ys = _tile(x, S), _tile(y, S)
        return _perm_scan(
            lambda mask: loss_at(xs, ys, mask.repeat_interleave(B, dim=0)),
            base, perms, n, mask_dt)

    return fn


class ShapleyAttributionMetric(AttributionMetric):
    """Sampled Shapley values of each unit's per-example loss
    contribution: ``sv_samples × n_units`` masked evaluations per batch,
    as ``n_units`` calls on ``sv_samples × batch`` rows.

    ``use_partial=False`` forces the full-forward masking path; the
    scores are the same, only the prefix is recomputed under the mask.
    """

    def __init__(self, *args, sv_samples: int = 5, use_partial: bool = True,
                 **kw):
        super().__init__(*args, **kw)
        self.sv_samples = sv_samples
        self.use_partial = use_partial
        self._calls = 0

    def _draw_perms(self, n: int, S: int) -> torch.Tensor:
        """``(S, n)`` fresh permutations on the CPU, fixed across batches:
        one draw per scoring request, seeded from ``seed`` and the call
        count."""
        self._calls += 1
        g = cpu_generator(self.seed, self._calls)
        return torch.stack([torch.randperm(n, generator=g)
                            for _ in range(S)])

    def _resolve(self, eval_layer, sv_samples, use_partial):
        S = sv_samples if sv_samples is not None else self.sv_samples
        partial = use_partial if use_partial is not None \
            else self.use_partial
        if needs_taps(self.model, eval_layer):
            # nested / attention-head sites cannot be segment boundaries:
            # the masking path applies the unit mask mid-forward
            partial = False
        return S, partial

    def make_row_fn(self, eval_layer: str, sv_samples=None,
                    use_partial=None):
        """Draw the permutations and return a plain ``(params, state, x,
        y) -> rows`` function (the permutations follow the batch to its
        device)."""
        S, partial = self._resolve(eval_layer, sv_samples, use_partial)
        perms = self._draw_perms(self.n_units(eval_layer), S)
        return _with_perms(
            shapley_rows_fn(self.model, eval_layer, self.loss_fn, partial),
            perms)

    def make_cached_row_fn(self, eval_layer: str, sv_samples=None,
                           use_partial=None):
        """The prefix-free form ``(params, state, z, y) -> rows`` from
        the captured activation.  Only the ``use_partial`` fast path
        resumes from ``z``; the forced masking path (``use_partial=
        False``, or a site segmentation cannot cut) returns ``None`` and
        scores uncached.  The permutations are drawn as
        :meth:`make_row_fn` draws them, so cached and uncached requests
        see the same sequence."""
        S, partial = self._resolve(eval_layer, sv_samples, use_partial)
        if not partial:
            return None
        perms = self._draw_perms(self.n_units(eval_layer), S)
        return _with_perms(
            shapley_rows_from_z_fn(self.model, eval_layer, self.loss_fn),
            perms)


def _with_perms(fn, perms: torch.Tensor):
    """``fn(params, state, a, y, perms)`` as a row function of ``(params,
    state, a, y)``; the permutations follow the batch to its device."""
    placed = {}

    def row_fn(params, state, a, y):
        if a.device not in placed:
            placed[a.device] = perms.to(a.device)
        return fn(params, state, a, y, placed[a.device])

    return row_fn
