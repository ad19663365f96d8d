"""The port's Shapley and weight-only metrics against the JAX package's,
on the CPU.

- Ground truth on the analytic ``max_model``: WeightNorm ``[1, 2, 2,
  2]``; Shapley at sv_samples 1000 ≈ ``[0.37, 0.37, 1.7, 0.0]`` to one
  decimal; the masking path equals the fast path; Random has the right
  shape, repeats for a seed and call count and changes between calls.
- Shapley rows against the JAX functions fed the same permutations
  (drawn by the JAX metric's ``_draw_perms``): the fast path on
  ``digits_fc_tiny`` (``fc1`` and its shifted site ``act1``), the
  masking path on ``vit_tiny`` (``block1_attn/attn``, a head site, and
  ``block2_mlp/fc1``, a nested site) and on ``bert_tiny`` (token
  inputs).
- Each unit step is one call on ``sv_samples × batch`` rows, and a
  per-row unit mask equals masking each row alone.
- WeightNorm against the JAX metric on Dense, Conv, GatedDense and
  attention heads.

Inputs come from numpy with a seed; JAX weights are carried over by
``params_from_numpy``.  Tolerance: f32 rows agree to rtol 1e-5 of the
rows' scale (the same masked losses, sums in other orders).
"""

import jax
import numpy as np
import pytest
import torch

from torchpruner_tpu import attributions as JA
from torchpruner_tpu.attributions import shapley as JSH
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.models import bert_tiny as j_bert_tiny
from torchpruner_tpu.models import fc_net as j_fc_net
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.models import vit_tiny as j_vit_tiny
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch.attributions import shapley as PSH
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.models import max_model, max_model_batches
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
from torchpruner_tpu_torch.utils.losses import mse_loss as p_mse

F32_RTOL = 1e-5


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _make(cls, version=1, **kw):
    model, params, _, _ = max_model(version, device="cpu")
    return cls(model, params, max_model_batches(1, device="cpu"), p_mse,
               **kw)


def jax_perms(seed, calls, n, S):
    """The permutations the JAX metric draws on its ``calls``-th
    request."""
    m = JA.ShapleyAttributionMetric(None, None, None, None, seed=seed)
    m._calls = calls - 1
    return np.array(m._draw_perms(n, S))


# -- ground truth on max_model ---------------------------------------------


def test_weight_norm_ground_truth():
    np.testing.assert_array_almost_equal(
        _make(PA.WeightNormAttributionMetric).run("fc1"), [1, 2, 2, 2])


def test_shapley_ground_truth_statistical():
    attr = _make(PA.ShapleyAttributionMetric, sv_samples=1000).run("fc1")
    np.testing.assert_array_almost_equal(attr, [0.37, 0.37, 1.7, 0.0],
                                         decimal=1)


@pytest.mark.parametrize("version", [1, 2])
def test_shapley_masking_path_equals_fast_path(version):
    fast = _make(PA.ShapleyAttributionMetric, version, sv_samples=20,
                 seed=7).run("fc1")
    slow = _make(PA.ShapleyAttributionMetric, version, sv_samples=20,
                 seed=7, use_partial=False).run("fc1")
    np.testing.assert_allclose(fast, slow, rtol=1e-4, atol=1e-5)


def test_random_shape_and_determinism():
    m1 = _make(PA.RandomAttributionMetric, seed=3)
    m2 = _make(PA.RandomAttributionMetric, seed=3)
    a, b = m1.run("fc1"), m2.run("fc1")
    assert a.shape == (4,) and a.dtype == np.float32
    assert np.all((a >= 0) & (a < 1))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(m1.run("fc1"), a)  # a fresh draw per call
    assert not np.array_equal(
        _make(PA.RandomAttributionMetric, seed=4).run("fc1"), a)


def test_weight_only_metrics_do_not_shift():
    for cls in (PA.WeightNormAttributionMetric, PA.RandomAttributionMetric):
        m = _make(cls)
        assert not m.shiftable and not m.data_dependent
        assert m.find_evaluation_layer("fc1", True) == "fc1"
    assert _make(PA.ShapleyAttributionMetric).find_evaluation_layer(
        "fc1", True) == "act1"


def test_shapley_draws_permutations_on_the_cpu():
    m = _make(PA.ShapleyAttributionMetric, seed=5)
    p1, p2 = m._draw_perms(7, 3), m._draw_perms(7, 3)
    assert p1.shape == (3, 7) and p1.device.type == "cpu"
    assert all(sorted(r.tolist()) == list(range(7)) for r in p1)
    assert not torch.equal(p1, p2)  # the call count moves the seed
    again = _make(PA.ShapleyAttributionMetric, seed=5)._draw_perms(7, 3)
    assert torch.equal(again, p1)


# -- Shapley rows against the JAX functions -------------------------------


def _fc_case():
    jm = j_fc_net(64, hidden=(64, 64))
    jparams, _ = j_init_model(jm, seed=1)
    rng = np.random.default_rng(11)
    x = rng.random((12, 64)).astype(np.float32)
    y = rng.integers(0, 10, size=(12,)).astype(np.int32)
    return jm, jparams, x, y


def _vit_case():
    jm = j_vit_tiny()
    jparams, _ = j_init_model(jm, seed=2)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(6,)).astype(np.int32)
    return jm, jparams, x, y


def _bert_case():
    jm = j_bert_tiny()
    jparams, _ = j_init_model(jm, seed=3)
    rng = np.random.default_rng(13)
    x = rng.integers(0, 128, size=(5, 16)).astype(np.int32)
    y = rng.integers(0, 2, size=(5,)).astype(np.int32)
    return jm, jparams, x, y


@pytest.mark.parametrize("case,site,partial", [
    ("fc", "fc1", True), ("fc", "act1", True), ("fc", "act2", True),
    ("fc", "act1", False), ("vit", "block1_attn/attn", False),
    ("vit", "block2_mlp/fc1", False), ("bert", "block2_attn/attn", False),
])
def test_shapley_rows_match_jax(case, site, partial):
    jm, jparams, x, y = {"fc": _fc_case, "vit": _vit_case,
                         "bert": _bert_case}[case]()
    pm = model_from_reference(jm)
    n = pm.site_shape(site)[-1]
    assert n == jm.site_shape(site)[-1]
    perms = jax_perms(seed=0, calls=1, n=n, S=3)
    want = JSH.shapley_rows_fn(jm, site, j_ce, partial)(
        jparams, {}, jax.numpy.asarray(x), jax.numpy.asarray(y),
        jax.numpy.asarray(perms))
    got = PSH.shapley_rows_fn(pm, site, p_ce, partial)(
        params_from_numpy(numpy_tree(jparams), device="cpu"), {},
        torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(perms).long())
    assert tuple(got.shape) == (x.shape[0], n)
    _close(got.numpy(), np.asarray(want), F32_RTOL)


@pytest.mark.parametrize("case,site", [
    ("fc", "fc2"), ("vit", "block1_attn/attn"), ("vit", "block1_mlp/fc1"),
])
def test_shapley_metric_run_matches_jax(case, site, monkeypatch):
    """The whole metric (find_best shift, batches, permutations drawn
    per request, mean over examples), the port's draw replaced by the
    JAX one."""
    jm, jparams, x, y = {"fc": _fc_case, "vit": _vit_case}[case]()
    data = [(x[:4], y[:4]), (x[4:], y[4:])]

    def draw(self, n, S):
        self._calls += 1
        return torch.from_numpy(jax_perms(self.seed, self._calls, n, S))

    monkeypatch.setattr(PA.ShapleyAttributionMetric, "_draw_perms", draw)
    want = JA.ShapleyAttributionMetric(jm, jparams, data, j_ce, seed=4,
                                       sv_samples=3).run(
        site, find_best_evaluation_layer=True)
    got = PA.ShapleyAttributionMetric(
        model_from_reference(jm),
        params_from_numpy(numpy_tree(jparams), device="cpu"), data, p_ce,
        seed=4, sv_samples=3).run(site, find_best_evaluation_layer=True)
    _close(got, want, F32_RTOL)


@pytest.mark.parametrize("case,site", [
    ("fc", "act1"), ("vit", "block1_attn/attn"), ("vit", "block2_mlp/fc1"),
])
def test_each_unit_step_is_one_call_on_all_permutations(case, site,
                                                        monkeypatch):
    """n unit steps of one forward (masking path) or suffix (fast path)
    each, on S·B rows, after one base call on B rows."""
    jm, jparams, x, y = {"fc": _fc_case, "vit": _vit_case}[case]()
    pm = model_from_reference(jm)
    params = params_from_numpy(numpy_tree(jparams), device="cpu")
    n, S, B = pm.site_shape(site)[-1], 3, x.shape[0]
    rows = []
    orig = PS.SegmentedModel.apply

    def apply(self, params, x, **kw):
        rows.append((x.shape[0], kw.get("to_layer")))
        return orig(self, params, x, **kw)

    monkeypatch.setattr(PS.SegmentedModel, "apply", apply)
    perms = torch.stack([torch.randperm(n) for _ in range(S)])
    partial = case == "fc"
    PSH.shapley_rows_fn(pm, site, p_ce, partial)(
        params, {}, torch.from_numpy(x), torch.from_numpy(y), perms)
    calls = [r for r, to in rows if to is None]  # the prefix excluded
    assert calls == [B] + [S * B] * n


def test_per_row_unit_mask_equals_masking_each_row_alone():
    jm, jparams, x, _ = _vit_case()
    pm = model_from_reference(jm)
    params = params_from_numpy(numpy_tree(jparams), device="cpu")
    xt = torch.from_numpy(x)
    for site in ("block1_attn/attn", "block2_mlp/fc1", "patchify"):
        n = pm.site_shape(site)[-1]
        masks = (torch.rand((x.shape[0], n),
                            generator=torch.Generator().manual_seed(0))
                 > 0.5).float()
        got, _ = pm.apply(params, xt, unit_mask=(site, masks))
        for b in range(x.shape[0]):
            want, _ = pm.apply(params, xt[b:b + 1],
                               unit_mask=(site, masks[b]))
            torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5,
                                       atol=1e-6)


# -- WeightNorm against the JAX metric -------------------------------------


@pytest.mark.parametrize("make_model,site", [
    (j_vit_tiny, "patchify"), (j_vit_tiny, "block1_mlp/fc1"),
    (j_vit_tiny, "block2_attn/attn"), (j_llama_tiny, "block1_ffn/gate"),
    (j_llama_tiny, "block2_attn/attn"),
])
def test_weight_norm_matches_jax(make_model, site):
    jm = make_model()
    jparams, _ = j_init_model(jm, seed=6)
    want = JA.WeightNormAttributionMetric(jm, jparams, [], j_ce).run(site)
    got = PA.WeightNormAttributionMetric(
        model_from_reference(jm),
        params_from_numpy(numpy_tree(jparams), device="cpu"), [],
        p_ce).run(site)
    _close(got, want, F32_RTOL)
