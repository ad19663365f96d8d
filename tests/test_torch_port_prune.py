"""The port's prune loop against the JAX package's, on the CPU.

Inputs come from numpy with a seed, and the JAX init weights are carried
into the port with ``convert.params_from_numpy``:

- bert_tiny and llama_tiny: logits, train-mode loss and parameter
  gradients against ``SegmentedModel.apply``;
- Sensitivity, Taylor and APoZ scores on a nested fc1 site and on an
  attention head site;
- ``pruning_graph`` groups and ``find_best_evaluation_layer``;
- ``prune``: widths and values, and the Adam state sliced in step;
- one sgd-with-momentum step and one adam step against optax;
- the token datasets, bit for bit;
- the whole loop: ``run_prune_retrain`` on ``bert_glue_sensitivity
  --smoke`` (as shipped and with one fine-tune epoch),
  ``llama3_ffn_taylor``, ``mnist_mlp_shapley``,
  ``vit_head_mlp_shapley`` and ``resnet50_taylor --smoke``, the port's
  init monkeypatched to the JAX init weights and state and its Shapley
  permutations to the JAX ones.

Tolerances: f32 forwards, losses and gradients agree to rtol 1e-5 of the
output scale (the same math, sums in other orders).  Scores agree to
rtol 1e-4 of their scale (a gradient through two blocks, then a product
with the activation).  Optimizer steps agree to 1e-6.  The loop's losses
and accuracies agree to 1e-4 after up to 1,250 SGD steps; drop-index
sets may differ only where scores tie within tolerance at the cut.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchpruner_tpu import attributions as JA
from torchpruner_tpu.core import graph as JG
from torchpruner_tpu.core import pruner as JP
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.data import datasets as JD
from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.models import bert_tiny as j_bert_tiny
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu.utils.losses import lm_cross_entropy_loss as j_lm_ce
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import graph as PG
from torchpruner_tpu_torch.core import pruner as PP
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.data import datasets as PD
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.experiments import prune_retrain as PPR
from torchpruner_tpu_torch.train import optim as PO
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss as p_lm
from torchpruner_tpu_torch.utils.tree import tree_leaves

F32_RTOL = 1e-5
SCORE_RTOL = 1e-4


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_tree(tree):
    return params_from_numpy(numpy_tree(tree), device="cpu")


def _close(got, want, rtol, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _trees_close(got, want, rtol):
    """Leaf by leaf, relative to the whole tree's scale (a leaf whose
    exact gradient is 0, like an attention key bias, holds rounding
    noise only)."""
    scale = max(float(np.abs(np.asarray(w)).max())
                for w in tree_leaves(want))

    def walk(g, w):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k])
            else:
                _close(g[k].detach().numpy(), w[k], rtol, scale)

    walk(got, want)


def _case(kind, seed=0):
    jm = j_bert_tiny() if kind == "bert" else j_llama_tiny()
    jparams, _ = j_init_model(jm, seed=seed)
    rng = np.random.default_rng(seed)
    vocab = 128 if kind == "bert" else 256
    x = rng.integers(0, vocab, size=(4, 16)).astype(np.int32)
    y = (rng.integers(0, 2, size=(4,)).astype(np.int32) if kind == "bert"
         else x)
    losses = (j_ce, p_ce) if kind == "bert" else (j_lm_ce, p_lm)
    return jm, jparams, model_from_reference(jm), x, y, losses


@pytest.mark.parametrize("kind", ["bert", "llama"])
def test_logits_train_loss_and_grads_match_jax(kind):
    jm, jparams, pm, x, y, (jl, pl) = _case(kind)
    pparams = torch_tree(jparams)
    j_out, _ = jm.apply(jparams, jnp.asarray(x))
    p_out, _ = pm.apply(pparams, torch.from_numpy(x))
    _close(p_out.numpy(), j_out, F32_RTOL)

    def j_loss(p):
        out, _ = jm.apply(p, jnp.asarray(x), train=True,
                          rng=jax.random.PRNGKey(0))
        return jnp.mean(jl(out, jnp.asarray(y)))

    j_val, j_grads = jax.value_and_grad(j_loss)(jparams)
    leaves = list(tree_leaves(pparams))
    for t in leaves:
        t.requires_grad_()
    out, _ = pm.apply(pparams, torch.from_numpy(x), train=True,
                      rng=torch.Generator().manual_seed(0))
    loss = pl(out, torch.from_numpy(y)).mean()
    loss.backward()
    _close(float(loss.detach()), float(j_val), F32_RTOL)
    _trees_close(_grad_tree(pparams), numpy_tree(j_grads), F32_RTOL)


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


@pytest.mark.parametrize("site,metric", [
    ("block1_mlp/fc1", "sensitivity"), ("block1_mlp/fc1", "taylor"),
    ("block1_mlp/fc1", "apoz"), ("block2_attn/attn", "sensitivity"),
    ("block2_attn/attn", "taylor"), ("block1_attn/attn", "apoz"),
])
def test_scores_match_jax(site, metric):
    jm, jparams, pm, _, _, _ = _case("bert", seed=1)
    rng = np.random.default_rng(5)
    data = [(rng.integers(0, 128, size=(8, 16)).astype(np.int32),
             rng.integers(0, 2, size=(8,)).astype(np.int32))
            for _ in range(2)]
    jcls = {"sensitivity": JA.SensitivityAttributionMetric,
            "taylor": JA.TaylorAttributionMetric,
            "apoz": JA.APoZAttributionMetric}[metric]
    pcls = {"sensitivity": PA.SensitivityAttributionMetric,
            "taylor": PA.TaylorAttributionMetric,
            "apoz": PA.APoZAttributionMetric}[metric]
    want = jcls(jm, jparams, data, j_ce).run(site)
    got = pcls(pm, torch_tree(jparams), data, p_ce).run(site)
    assert got.shape == want.shape == (pm.site_shape(site)[-1],)
    _close(got, want, SCORE_RTOL)


def _group_key(g):
    return (g.target, tuple((a.layer, a.fan_out) for a in g.attached_bn),
            tuple(g.attached_dropout),
            tuple((c.layer, c.param, c.axis, c.fan_out)
                  for c in g.consumers))


@pytest.mark.parametrize("kind", ["bert", "llama"])
def test_pruning_graph_and_eval_layer_match_jax(kind):
    jm, _, pm, _, _, _ = _case(kind)
    for incl in (False, True):
        jg = [_group_key(g) for g in JG.pruning_graph(jm, incl)]
        pg = [_group_key(g) for g in PG.pruning_graph(pm, incl)]
        assert pg == jg and len(pg) > 0
    for t in list(jm.widths()):
        assert PG.find_best_evaluation_layer(pm, t) == \
            JG.find_best_evaluation_layer(jm, t)


def test_prune_widths_values_and_adam_state_match_jax():
    jm, jparams, pm, _, _, _ = _case("bert")
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
        jparams)
    tx = optax.adam(1e-3)
    jopt = tx.init(jparams)
    _, jopt = tx.update(grads, jopt, jparams)
    adam = jopt[0]
    popt = [{"count": torch.tensor(int(adam.count), dtype=torch.int32),
             "mu": torch_tree(adam.mu), "nu": torch_tree(adam.nu)}, {}]
    for target, drop in (("block1_mlp/fc1", [0, 5, 17, 63]),
                         ("block2_attn/attn", [1, 2])):
        jres = JP.prune(jm, jparams, target, drop, opt_state=jopt)
        pres = PP.prune(pm, torch_tree(jparams), target, drop,
                        opt_state=popt)
        assert pres.model.widths() == jres.model.widths()
        assert pres.model == model_from_reference(jres.model)
        _trees_close(pres.params, numpy_tree(jres.params), 0.0)
        _trees_close(pres.opt_state[0]["mu"], numpy_tree(jres.opt_state[0].mu),
                     0.0)
        _trees_close(pres.opt_state[0]["nu"], numpy_tree(jres.opt_state[0].nu),
                     0.0)
        assert int(pres.opt_state[0]["count"]) == int(jres.opt_state[0].count)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "sgd_wd_cosine"])
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(3)]
    if name == "sgd":
        jtx, ptx = optax.sgd(0.05, momentum=0.9), PO.sgd(0.05, momentum=0.9)
    elif name == "adam":
        jtx, ptx = optax.adam(1e-2), PO.adam(1e-2)
    elif name == "adamw":
        jtx = optax.adamw(1e-2, weight_decay=0.1)
        ptx = PO.adamw(1e-2, weight_decay=0.1)
    else:
        jtx = optax.chain(optax.add_decayed_weights(0.01), optax.sgd(
            optax.cosine_decay_schedule(0.1, decay_steps=4)))
        ptx = PO.chain(PO.add_decayed_weights(0.01), PO.sgd(
            PO.cosine_decay_schedule(0.1, decay_steps=4)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = torch_tree(params)
    js, ps = jtx.init(jp), ptx.init(pp)
    for g in grads:
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update(torch_tree(g), ps, pp)
        pp = PO.apply_updates(pp, pu)
    _trees_close(pp, numpy_tree(jp), 1e-6)


@pytest.mark.parametrize("name", ["glue_tiny", "glue_sst2", "lm_tiny"])
def test_token_datasets_equal_bit_for_bit(name):
    for split, n in (("train", 64), ("val", 32), ("test", None)):
        for seed in (0, 3):
            j = JD.load_dataset(name, split, n=n, seed=seed)
            p = PD.load_dataset(name, split, n=n, seed=seed)
            assert np.array_equal(j.x, p.x) and np.array_equal(j.y, p.y)
            assert j.x.dtype == p.x.dtype and j.y.dtype == p.y.dtype
            jb = j.batches(16, shuffle=True, seed=seed)
            pb = p.batches(16, shuffle=True, seed=seed)
            assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                       for a, b in zip(jb, pb))


def test_preset_table_matches_jax():
    assert tuple(PPS.PRESETS) == JPS.preset_names()
    for name in PPS.PRESETS:
        for smoke in (False, True):
            assert dataclasses.asdict(PPS.get_preset(name, smoke)) == \
                dataclasses.asdict(JPS.get_preset(name, smoke))
    cfg = PPS.get_preset("llama3_ffn_taylor")
    with pytest.raises(NotImplementedError, match="mesh"):
        PPR.run_prune_retrain(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="experiment"):
        PPR.run_prune_retrain(
            PPS.get_preset("vgg16_digits32_layerwise", True), device="cpu")
    smoke = PPS.get_preset("bert_glue_sensitivity", True)
    for field, value in (("remat", True), ("accum_steps", 2),
                         ("run_dir", "x"), ("augment", True)):
        with pytest.raises(NotImplementedError, match=field):
            PPR.run_prune_retrain(dataclasses.replace(smoke, **{field: value}),
                                  device="cpu")


#: (preset, fine-tune epochs; None = the preset's own), all --smoke; the
#: two BERT cases keep the ids they had when the test held only BERT
LOOP_CASES = [
    pytest.param("bert_glue_sensitivity", 0, id="0"),
    pytest.param("bert_glue_sensitivity", 1, id="1"),
    pytest.param("llama3_ffn_taylor", None, id="llama3_ffn_taylor"),
    pytest.param("mnist_mlp_shapley", None, id="mnist_mlp_shapley"),
    pytest.param("vit_head_mlp_shapley", None, id="vit_head_mlp_shapley"),
    pytest.param("resnet50_taylor", None, id="resnet50_taylor"),
]

#: splits injected into both loops, (split, examples): resnet20_cifar's
#: cifar10 fallback is 50,000 / 10,000 synthetic images, whose
#: evaluation each round would take minutes on the CPU
LOOP_SPLITS = {"resnet50_taylor": (("train", 256), ("val", 64),
                                   ("test", 500))}


def jax_perms(seed, calls, n, S):
    """The permutations the JAX Shapley metric draws on its
    ``calls``-th request."""
    m = JA.ShapleyAttributionMetric(None, None, None, None, seed=seed)
    m._calls = calls - 1
    return torch.from_numpy(np.array(m._draw_perms(n, S)))


@pytest.mark.parametrize("preset,finetune", LOOP_CASES)
def test_prune_retrain_loop_matches_jax(preset, finetune, tmp_path,
                                        monkeypatch):
    """The port's loop from the JAX initial weights and BatchNorm state
    (and, for Shapley, the JAX permutations) against the JAX loop:
    layers, widths, units dropped, params, and pre/post losses and
    accuracies to 1e-4."""
    over = {} if finetune is None else {"finetune_epochs": finetune}
    cfg_j = dataclasses.replace(JPS.get_preset(preset, smoke=True), **over,
                                log_path=str(tmp_path / "j.csv"))
    cfg_p = dataclasses.replace(PPS.get_preset(preset, smoke=True), **over,
                                log_path=str(tmp_path / "p.csv"))
    splits = LOOP_SPLITS.get(preset)
    datasets = {pkg: None if splits is None else tuple(
        load(cfg_j.dataset, s, n=n, seed=cfg_j.seed) for s, n in splits)
        for pkg, load in (("jax", JD.load_dataset), ("port", PD.load_dataset))}
    j_hist = JPR.run_prune_retrain(cfg_j, verbose=False,
                                   datasets=datasets["jax"])
    j_model = JPR.MODEL_REGISTRY[cfg_j.model][0]

    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jparams, jstate = j_init_model(j_model(), seed=seed)
        return (params_from_numpy(numpy_tree(jparams), device=device),
                params_from_numpy(numpy_tree(jstate), device=device))

    def draw(self, n, S):
        self._calls += 1
        return jax_perms(self.seed, self._calls, n, S)

    monkeypatch.setattr(PS, "init_model", jax_init)
    monkeypatch.setattr(PA.ShapleyAttributionMetric, "_draw_perms", draw)
    p_hist = PPR.run_prune_retrain(cfg_p, verbose=False, device="cpu",
                                   datasets=datasets["port"])
    assert [r.layer for r in p_hist] == [r.layer for r in j_hist]
    assert len(p_hist) == {"vit_head_mlp_shapley": 4,
                           "resnet50_taylor": 9}.get(preset, 2)
    for p, j in zip(p_hist, j_hist):
        assert p.widths == j.widths and p.n_dropped == j.n_dropped
        assert p.n_params == j.n_params
        for f in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            assert abs(getattr(p, f) - getattr(j, f)) <= 1e-4, (
                f, getattr(p, f), getattr(j, f))


def test_segment_and_capture_fns_compose_to_the_full_forward():
    jm, jparams, pm, x, _, _ = _case("bert")
    params = torch_tree(jparams)
    xt = torch.from_numpy(x)
    full, _ = pm.apply(params, xt)
    z, _ = PS.segment_fn(pm, to_layer="block1_mlp")(params, {}, xt)
    y, _ = PS.segment_fn(pm, from_layer="block1_mlp")(params, {}, z)
    assert torch.allclose(y, full, rtol=1e-6, atol=1e-6)
    sites = ("block1_mlp/fc1", "block2_attn/attn")
    caps = PS.capture_fn(pm, sites)(params, {}, xt)
    for site in sites:
        _, _, want = pm.apply(params, xt, capture=site)
        assert torch.equal(caps[site], want)
        assert tuple(caps[site].shape[1:]) == pm.site_shape(site)


def test_full_sequence_path_makes_no_fixed_order_calls():
    """``SegmentedModel.apply`` (scoring, training) runs plain products
    on whole tensors; only the KV-cache path chunks rows."""
    from torchpruner_tpu_torch.generate import generate
    from torchpruner_tpu_torch.ops.fixed_order import per_rows

    jm, jparams, pm, x, y, _ = _case("llama")
    params = torch_tree(jparams)
    per_rows.calls = 0
    out, _ = pm.apply(params, torch.from_numpy(x))
    p_lm(out, torch.from_numpy(y)).mean()
    assert per_rows.calls == 0
    generate(pm, params, x[:1, :4], 2, device="cpu")
    assert per_rows.calls > 0
