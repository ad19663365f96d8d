"""The port's one-pass capture engine (``attributions.base
.ActivationCache``) against the JAX package's, and cached against
uncached scoring in the port, on the CPU.

Seeded numpy data and the JAX init weights (carried over with
``convert.params_from_numpy``) go through both packages; Shapley and
Random draw the JAX permutations and scores (``feed_jax_draws``, as the
robustness tests feed them).  These mirror the JAX package's
``tests/test_capture.py`` without its mesh cases (ROADMAP A7):

- ``capture_fn`` against per-site prefix forwards, and the JAX
  package's;
- the 8-method panel with the cache on and off in the port (equal), and
  cached against the JAX cached sweep: scores, curves, and the hits,
  misses and saved prefix FLOPs of the two sweeps' caches;
- cached ablation curves and cached Shapley rows against the JAX
  package's;
- a metric built from other data falls back and counts a miss; the
  forced masking path declines the cache; ``drop`` releases a site;
  nested sites are skipped;
- a BatchNorm conv sweep, cached, against the JAX capture sweep;
- ``nan_cascade_oracle`` against the JAX package's on flat MLP and conv
  models.

Tolerances: the cache changes where ``z`` comes from, not how rows are
computed, so cached and uncached rows in the port are equal (rtol 1e-6);
against the JAX package, scores agree to rtol 1e-4 of their scale and
losses, accuracies and AUCs to 1e-4 absolute, as the robustness tests
hold them.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu.attributions import ShapleyAttributionMetric as JSM
from torchpruner_tpu.attributions import base as JB
from torchpruner_tpu.core import graph as JG
from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core.segment import SegmentedModel as JModel
from torchpruner_tpu.core.segment import capture_fn as j_capture_fn
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.data import synthetic_dataset
from torchpruner_tpu.experiments import robustness as JR
from torchpruner_tpu.models.mlp import fc_net as j_fc_net
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch import nan_cascade_oracle
from torchpruner_tpu_torch.attributions.base import ActivationCache
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core.segment import capture_fn
from torchpruner_tpu_torch.experiments import robustness as PR
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce

from test_torch_port_robustness import feed_jax_draws, jax_perms

ABS_TOL = 1e-4
SCORE_RTOL = 1e-4


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_tree(tree):
    return params_from_numpy(numpy_tree(tree), device="cpu")


def small_setup(n=32, bs=16, seed=0):
    """A 3-hidden-layer MLP (3 prunable sites whose evaluation layers
    shift through the LeakyReLUs) in both packages, from the JAX init,
    and synthetic batches."""
    jm = j_fc_net(16, hidden=(12, 10, 8))
    jparams, jstate = j_init_model(jm, seed=seed)
    batches = synthetic_dataset((16,), 10, n, seed=seed).batches(bs)
    return (jm, jparams, jstate, model_from_reference(jm),
            torch_tree(jparams), torch_tree(jstate), batches)


def port_sweep(pm, params, state, batches, *, capture, sv_samples=2,
               layers=None):
    methods = PR.method_panel(pm, params, batches, p_ce, state=state,
                              sv_samples=sv_samples)
    return PR.layerwise_robustness(pm, params, state, batches, methods,
                                   p_ce, layers=layers, verbose=False,
                                   capture=capture)


def jax_sweep(jm, params, state, batches, *, sv_samples=2, layers=None):
    batches = [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]
    methods = JR.method_panel(jm, params, batches, j_ce, state=state,
                              sv_samples=sv_samples)
    return JR.layerwise_robustness(jm, params, state, batches, methods,
                                   j_ce, layers=layers, verbose=False,
                                   capture=True)


def recording(module, monkeypatch):
    """Patch ``module.ActivationCache`` with a subclass that keeps every
    instance built, so a test can read the sweep's cache."""
    made = []
    base = module.ActivationCache

    class Rec(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "ActivationCache", Rec)
    return made


def assert_sweeps_equal(a, b, rtol=1e-6, atol=1e-7):
    assert a.keys() == b.keys()
    for layer in a:
        assert a[layer].keys() == b[layer].keys()
        for m in a[layer]:
            for ra, rb in zip(a[layer][m], b[layer][m]):
                np.testing.assert_allclose(ra["scores"], rb["scores"],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{layer}/{m} scores")
                for k in ("loss", "acc", "base_loss", "base_acc", "auc"):
                    np.testing.assert_allclose(ra[k], rb[k], rtol=rtol,
                                               atol=atol,
                                               err_msg=f"{layer}/{m} {k}")


def assert_close_to_jax(got, want):
    assert list(got) == list(want)
    for layer in want:
        assert list(got[layer]) == list(want[layer])
        for m, runs in want[layer].items():
            assert len(got[layer][m]) == len(runs)
            for g, w in zip(got[layer][m], runs):
                ws = np.asarray(w["scores"])
                np.testing.assert_allclose(
                    g["scores"], ws, rtol=SCORE_RTOL,
                    atol=SCORE_RTOL * float(np.abs(ws).max()),
                    err_msg=f"{layer}/{m} scores")
                for k in ("loss", "acc", "base_loss", "base_acc", "auc"):
                    np.testing.assert_allclose(
                        g[k], np.asarray(w[k]), rtol=0, atol=ABS_TOL,
                        err_msg=f"{layer}/{m} {k}")


def test_capture_fn_matches_per_site_prefix_and_jax():
    """The one multi-site forward emits exactly what per-site prefix
    forwards give (bit-equal), and the JAX package's capture (rtol
    1e-5)."""
    jm, jparams, jstate, pm, params, state, batches = small_setup()
    sites = ("act1", "act2", "act3")
    x = torch.from_numpy(batches[0][0])
    with torch.no_grad():
        caps = capture_fn(pm, sites)(params, state, x)
        for s in sites:
            ref, _ = pm.apply(params, x, state=state, to_layer=s)
            assert torch.equal(caps[s], ref)
    jcaps = j_capture_fn(jm, sites)(jparams, jstate, jnp.asarray(x.numpy()))
    for s in sites:
        np.testing.assert_allclose(caps[s].numpy(), np.asarray(jcaps[s]),
                                   rtol=1e-5, atol=1e-6)


def test_panel_cached_equals_uncached_in_the_port(monkeypatch):
    """All 8 panel methods (14 runs a layer) and the walks, on every
    layer: the same results with the capture engine on and off; the
    cached sweep serves 11 passes a layer from the cache and misses
    none."""
    *_, pm, params, state, batches = small_setup()
    made = recording(PR, monkeypatch)
    on = port_sweep(pm, params, state, batches, capture=True)
    off = port_sweep(pm, params, state, batches, capture=False)
    assert_sweeps_equal(on, off)
    (cache,) = made
    assert (cache.hits, cache.misses) == (33, 0)


def test_panel_cached_matches_the_jax_cached_sweep(monkeypatch):
    """The cached 8-method sweep on every layer against the JAX
    package's cached sweep, from the same weights and draws: scores,
    curves and AUCs, and the two caches' hits, misses and saved prefix
    FLOPs (3 layers x 11 passes: apoz, sensitivity, taylor, signed
    taylor, 2 x 3 Shapley runs and the walk; the weight-only metrics
    never consult the cache)."""
    feed_jax_draws(monkeypatch)
    jm, jparams, jstate, pm, params, state, batches = small_setup()
    pmade = recording(PR, monkeypatch)
    jmade = recording(JB, monkeypatch)
    got = port_sweep(pm, params, state, batches, capture=True)
    want = jax_sweep(jm, jparams, jstate, batches)
    assert_close_to_jax(got, want)
    (pc,), (jc,) = pmade, jmade
    assert pc.stats() == pytest.approx(jc.stats())
    assert pc.hits == 33 and pc.misses == 0
    assert pc.prefix_flops_saved > 0
    assert pc.sites == () and pc._batches is not None  # every site dropped


def test_ablation_curves_batch_cached_matches_jax():
    jm, jparams, jstate, pm, params, state, batches = small_setup()
    rankings = np.stack([np.argsort(np.arange(12)),
                         np.argsort(-np.arange(12))])
    cache = ActivationCache(pm, params, batches, sites=("act1",),
                            state=state)
    got = PR.ablation_curves_batch(pm, params, state, "fc1", rankings,
                                   batches, p_ce, eval_layer="act1",
                                   capture_cache=cache)
    plain = PR.ablation_curves_batch(pm, params, state, "fc1", rankings,
                                     batches, p_ce, eval_layer="act1")
    jbatches = [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]
    jcache = JB.ActivationCache(jm, jparams, jbatches, sites=("act1",),
                                state=jstate)
    want = JR.ablation_curves_batch(jm, jparams, jstate, "fc1", rankings,
                                    jbatches, j_ce, eval_layer="act1",
                                    capture_cache=jcache)
    assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses) \
        == (1, 0)
    for g, p, w in zip(got, plain, want):
        for k in ("loss", "acc", "base_loss", "base_acc"):
            np.testing.assert_array_equal(g[k], p[k])
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ABS_TOL)


def test_shapley_cached_rows_match_jax():
    """Cached Shapley rows at ``act2`` (the JAX permutations fed in)
    against the JAX package's cached rows, and equal to the port's
    uncached rows."""
    jm, jparams, jstate, pm, params, state, batches = small_setup()
    jbatches = [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]
    jcache = JB.ActivationCache(jm, jparams, jbatches, sites=("act2",),
                                state=jstate)
    jmetric = JSM(jm, jparams, jbatches, j_ce, state=jstate, sv_samples=4,
                  seed=3)
    jfn = jmetric.make_cached_row_fn("act2")
    want = np.concatenate([np.asarray(jfn(jparams, jstate, z, y))
                           for z, y in jcache.batches_for("act2")])
    perms = jax_perms(3, 1, 10, 4)

    class Fed(PA.ShapleyAttributionMetric):
        def _draw_perms(self, n, S):
            self._calls += 1
            return perms

    cache = ActivationCache(pm, params, batches, sites=("act2",),
                            state=state)
    metric = Fed(pm, params, batches, p_ce, state=state, sv_samples=4,
                 seed=3)
    fn = metric.make_cached_row_fn("act2")
    got = torch.cat([fn(params, state, z, y)
                     for z, y in cache.batches_for("act2")]).numpy()
    uncached = metric._collect(metric.make_row_fn("act2"))
    np.testing.assert_allclose(got, uncached, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                               atol=SCORE_RTOL * float(np.abs(want).max()))
    assert metric.make_cached_row_fn("act2", use_partial=False) is None


def test_mismatched_metric_falls_back_and_counts_miss():
    """A metric scoring other data than the cache's recomputes its own
    prefix (the right scores), counted as a miss."""
    *_, pm, params, state, batches = small_setup()
    other = synthetic_dataset((16,), 10, 32, seed=9).batches(16)
    cache = ActivationCache(pm, params, batches, sites=("act1",),
                            state=state)
    m = PA.TaylorAttributionMetric(pm, params, other, p_ce, state=state)
    m.capture_cache = cache
    got = m.run("fc1", find_best_evaluation_layer=True)
    ref = PA.TaylorAttributionMetric(pm, params, other, p_ce,
                                     state=state).run(
        "fc1", find_best_evaluation_layer=True)
    np.testing.assert_array_equal(got, ref)
    assert cache.misses == 1 and cache.hits == 0


def test_forced_masking_path_declines_cache():
    """Shapley with ``use_partial=False`` cannot resume from a captured
    activation: it declines (a miss) and still matches the fast path,
    which hits."""
    *_, pm, params, state, batches = small_setup()
    cache = ActivationCache(pm, params, batches, sites=("act1",),
                            state=state)

    def scores(use_partial):
        m = PA.ShapleyAttributionMetric(pm, params, batches, p_ce,
                                        state=state, sv_samples=4,
                                        use_partial=use_partial, seed=3)
        m.capture_cache = cache
        return m.run("fc1", find_best_evaluation_layer=True)

    slow = scores(False)
    assert (cache.hits, cache.misses) == (0, 1)
    fast = scores(True)
    assert (cache.hits, cache.misses) == (1, 1)
    np.testing.assert_allclose(slow, fast, rtol=1e-4, atol=1e-5)


def test_drop_releases_a_site():
    *_, pm, params, state, batches = small_setup()
    cache = ActivationCache(pm, params, batches, sites=("act1", "act2"),
                            state=state)
    for m in (PA.SensitivityAttributionMetric(pm, params, batches, p_ce,
                                              state=state),
              PA.TaylorAttributionMetric(pm, params, batches, p_ce,
                                         state=state)):
        m.capture_cache = cache
        m.run("fc2", find_best_evaluation_layer=True)
    assert cache.hits == 2 and len(cache._grads) == 1  # one shared grad
    assert all("act2" in caps for caps, _ in cache._batches)
    cache.drop("act2")
    assert not cache.has("act2") and cache.has("act1")
    assert all("act2" not in caps and "act1" in caps
               for caps, _ in cache._batches)
    assert cache._grads == {}


def test_nested_sites_are_skipped_not_cached():
    """Sites inside a Residual body never enter the cache; a metric
    scoring one misses and takes the instrumented full forward."""
    from torchpruner_tpu_torch.core import layers as PL
    from torchpruner_tpu_torch.core.segment import SegmentedModel, init_model

    model = SegmentedModel(
        (PL.Dense("fc1", 8), PL.Activation("a1", "relu"),
         PL.Residual("blk", body=(PL.Dense("inner", 8),
                                  PL.Activation("ia", "relu"),
                                  PL.Dense("proj", 8))),
         PL.Dense("out", 4)), (16,))
    params, state = init_model(model, seed=0, device="cpu")
    batches = synthetic_dataset((16,), 4, 16, seed=0).batches(16)
    cache = ActivationCache(model, params, batches, sites=("a1", "blk/ia"),
                            state=state)
    assert cache.sites == ("a1",)
    assert cache.skipped_sites == ("blk/ia",)
    assert not cache.has("blk/ia")
    m = PA.TaylorAttributionMetric(model, params, batches, p_ce,
                                   state=state)
    m.capture_cache = cache
    got = m.run("blk/inner", find_best_evaluation_layer=True)
    assert (cache.hits, cache.misses) == (0, 1)
    ref = PA.TaylorAttributionMetric(model, params, batches, p_ce,
                                     state=state).run(
        "blk/inner", find_best_evaluation_layer=True)
    np.testing.assert_array_equal(got, ref)
    # with a mesh, each batch splits over its data axis at fill time: the
    # rank at data coordinate 1 of 2 holds the second half of each batch
    import types

    mesh = types.SimpleNamespace(mesh_dim_names=("data",),
                                 mesh=torch.empty(2),
                                 get_coordinate=lambda: [1])
    half = ActivationCache(model, params, batches, sites=("a1",),
                           state=state, mesh=mesh)
    (z, y), = list(half.batches_for("a1"))
    x_all, y_all = batches[0]
    want = capture_fn(model, ("a1",))(
        params, state, torch.from_numpy(np.asarray(x_all[8:])))["a1"]
    np.testing.assert_array_equal(z.numpy(), want.numpy())
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_all[8:]))


def _bn_conv():
    return JModel(
        (JL.Conv("c1", 6, (3, 3)), JL.BatchNorm("bn1"),
         JL.Activation("r1", "relu"), JL.Pool("p1", "max", (2, 2)),
         JL.Conv("c2", 5, (3, 3)), JL.Flatten("flat"), JL.Dense("out", 3)),
        (10, 10, 2))


def test_batchnorm_conv_sweep_cached_matches_jax(monkeypatch):
    """A conv net with BatchNorm (non-empty state, running statistics
    from a train-mode forward) swept at ``c1`` (site ``r1``) and ``c2``:
    the cached panel in the port against the JAX capture sweep, with no
    miss in either."""
    feed_jax_draws(monkeypatch)
    jm = _bn_conv()
    jparams, jstate = j_init_model(jm, seed=0)
    batches = synthetic_dataset((10, 10, 2), 3, 32, seed=5).batches(16)
    _, jstate = jm.apply(jparams, jnp.asarray(batches[0][0]), state=jstate,
                         train=True)
    pmade = recording(PR, monkeypatch)
    jmade = recording(JB, monkeypatch)
    got = port_sweep(model_from_reference(jm), torch_tree(jparams),
                     torch_tree(jstate), batches, capture=True)
    want = jax_sweep(jm, jparams, jstate, batches)
    assert list(got) == ["c1", "c2"]
    assert_close_to_jax(got, want)
    (pc,), (jc,) = pmade, jmade
    assert (pc.hits, pc.misses) == (jc.hits, jc.misses) == (22, 0)


NAN_CASES = [
    ("mlp", lambda: j_fc_net(16, hidden=(12, 10, 8)), "fc2", [0, 3, 7]),
    ("bn_conv", _bn_conv, "c1", [0, 4]),
]


@pytest.mark.parametrize("name,make,target,drop", NAN_CASES,
                         ids=[c[0] for c in NAN_CASES])
def test_nan_cascade_oracle_matches_jax(name, make, target, drop):
    """NaN at the dropped units of ``target``: every later Dense, Conv,
    BatchNorm and Dropout reports the same tainted input positions in
    both packages."""
    jm = make()
    jparams, jstate = j_init_model(jm, seed=0)
    want = JG.nan_cascade_oracle(jm, jparams, jstate, target, drop)
    got = nan_cascade_oracle(model_from_reference(jm), torch_tree(jparams),
                             torch_tree(jstate), target, drop)
    assert list(got) == list(want) and got
    for k in want:
        np.testing.assert_array_equal(got[k][0], np.asarray(want[k][0]))
        assert got[k][1] == want[k][1]
