"""The port's training driver and layerwise-robustness sweep against the
JAX package's, on the CPU.

Inputs come from numpy with a seed or from the bundled digits; JAX
weights and BatchNorm state are carried into the port with
``convert.params_from_numpy``:

- ``ablation_curves_batch`` fed the same rankings: curves and base
  metrics;
- ``run_train`` from the JAX initial weights with the VGG preset's
  recipe (Adam, digits, two shuffle seeds): the per-epoch history, on the
  digits MLP.  VGG16-bn's training cannot be held to 1e-4 from the same
  weights: the JAX package's f32 batch statistics are about 1e-5 off a
  float64 evaluation (XLA's CPU sums; the port's are within 4e-8), which
  flips near-tied max-pool windows of the block-constant digits32 images,
  and Adam's first step turns rounding-level gradients (a conv bias
  ahead of BatchNorm has a gradient of exactly 0 in exact arithmetic)
  into +-lr updates; after one epoch the two losses are 1e-2 apart, with
  SGD too, also on gaussian images.  The layers' train-mode math is held
  in ``test_torch_port_conv.py``, and the dropout masks differ anyway
  (drawn from other generators);
- ``vgg16_digits32_layerwise --smoke``: the sweep from the JAX-*trained*
  params and state (trained with the preset's own dropout), the JAX
  Shapley permutations fed in: per-layer curves and AUCs on three of its
  15 layers;
- the full ``method="all"`` panel on ``digits_convnet``, the JAX Random
  draws and Shapley permutations fed in: every method's scores, curves
  and AUCs;
- the CLI on the train and train-robustness experiments (a digits
  convnet config).

Tolerances: losses, accuracies and AUCs agree to 1e-4 absolute, as the
prune loop's test holds them; scores to rtol 1e-4 of their scale.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu.attributions import shapley as JSH
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.experiments import robustness as JR
from torchpruner_tpu.experiments import train_model as JTM
from torchpruner_tpu.models import convnet as JCN
from torchpruner_tpu.models import vgg as JVGG
from torchpruner_tpu.utils.config import ExperimentConfig as JConfig
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch.__main__ import main as p_main
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import layers as PL
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.data import load_dataset
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.experiments import robustness as PR
from torchpruner_tpu_torch.experiments import train_model as PTM
from torchpruner_tpu_torch.utils.config import ExperimentConfig
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce

ABS_TOL = 1e-4
SCORE_RTOL = 1e-4


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_tree(tree, device="cpu"):
    return params_from_numpy(numpy_tree(tree), device=device)


def jax_perms(seed, calls, n, S):
    """The permutations the JAX Shapley metric draws on its
    ``calls``-th request."""
    m = JSH.ShapleyAttributionMetric(None, None, None, None, seed=seed)
    m._calls = calls - 1
    return torch.from_numpy(np.array(m._draw_perms(n, S)))


def feed_jax_draws(monkeypatch):
    """The port's Shapley permutations and Random scores drawn as the
    JAX package draws them (same seed, same call count)."""

    def draw(self, n, S):
        self._calls += 1
        return jax_perms(self.seed, self._calls, n, S)

    def random_run(self, layer, **kw):
        self._calls += 1
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), self._calls)
        n = PL.n_units(self.model.layer(layer))
        return np.asarray(jax.random.uniform(key, (n,)))

    monkeypatch.setattr(PA.ShapleyAttributionMetric, "_draw_perms", draw)
    monkeypatch.setattr(PA.RandomAttributionMetric, "run", random_run)


def _trained_state(jm, jparams, jstate, x):
    """Running statistics after one train-mode forward, so that eval-mode
    BatchNorm is not the identity."""
    fwd = jax.jit(lambda p, s, xx: jm.apply(p, xx, state=s, train=True,
                                            rng=jax.random.PRNGKey(1)))
    return fwd(jparams, jstate, jnp.asarray(x))[1]


def _curves_close(got, want, tol=ABS_TOL):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=0, atol=tol)
    for k in ("base_loss", "base_acc"):
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


WALK_CASES = [("vgg16_bn_tiny", "conv12"), ("vgg16_bn_tiny", "fc1"),
              ("digits_convnet", "conv2")]


@pytest.mark.parametrize("name,layer", WALK_CASES)
def test_ablation_curves_batch_matches_jax(name, layer):
    """Three rankings walked at the layer's post-BN/ReLU site over two
    batches, from the same weights, state and rankings."""
    jm = JPR.MODEL_REGISTRY[name][0]()
    pm = model_from_reference(jm)
    jparams, jstate = j_init_model(jm, seed=0)
    rng = np.random.default_rng(4)
    data = [(rng.normal(size=(12,) + tuple(jm.input_shape)).astype(
                np.float32),
             rng.integers(0, 10, size=(12,)).astype(np.int32))
            for _ in range(2)]
    jstate = _trained_state(jm, jparams, jstate, data[0][0])
    n = PL.n_units(pm.layer(layer))
    rankings = np.stack([rng.permutation(n) for _ in range(3)])
    site = JR.find_best_evaluation_layer(jm, layer)
    want = JR.ablation_curves_batch(jm, jparams, jstate, layer, rankings,
                                    data, j_ce, eval_layer=site)
    got = PR.ablation_curves_batch(pm, torch_tree(jparams),
                                   torch_tree(jstate), layer, rankings, data,
                                   p_ce, eval_layer=site)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g["loss"].shape == (n,)
        _curves_close(g, w)


def _no_dropout_vgg(monkeypatch):
    """``vgg16_bn_tiny`` at dropout 0 in both packages' registries."""
    monkeypatch.setitem(JPR.MODEL_REGISTRY, "vgg16_bn_tiny", (
        lambda: JVGG.vgg16_bn(width_multiplier=0.125, classifier_width=64,
                              dropout=0.0), "cifar10"))
    monkeypatch.setitem(PPS.MODEL_REGISTRY, "vgg16_bn_tiny", (
        lambda: model_from_reference(JPR.MODEL_REGISTRY["vgg16_bn_tiny"][0]()),
        "cifar10"))


def _jax_init_in_port(monkeypatch, name):
    """The port's init replaced by the JAX init of registry ``name``."""

    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jparams, jstate = j_init_model(JPR.MODEL_REGISTRY[name][0](),
                                       seed=seed)
        return (params_from_numpy(numpy_tree(jparams), device=device),
                params_from_numpy(numpy_tree(jstate), device=device))

    monkeypatch.setattr(PS, "init_model", jax_init)


def test_run_train_matches_jax(tmp_path, monkeypatch):
    """``vgg16_digits32_layerwise --smoke``'s training recipe (Adam 1e-3,
    constant, B 64) for two epochs (two shuffle seeds) from the JAX
    initial weights, on the digits MLP (see the module docstring for why
    not VGG16-bn)."""
    _jax_init_in_port(monkeypatch, "digits_fc_tiny")
    over = {"epochs": 2, "model": "digits_fc_tiny", "dataset": "digits_flat"}
    cfg_j = dataclasses.replace(
        JPS.get_preset("vgg16_digits32_layerwise", smoke=True), **over,
        log_path=str(tmp_path / "j.csv"))
    cfg_p = dataclasses.replace(
        PPS.get_preset("vgg16_digits32_layerwise", smoke=True), **over,
        log_path=str(tmp_path / "p.csv"))
    _, j_hist = JTM.run_train(cfg_j, verbose=False)
    trainer, p_hist = PTM.run_train(cfg_p, verbose=False, device="cpu")
    assert len(p_hist) == len(j_hist) == 2
    for p, j in zip(p_hist, j_hist):
        assert p["epoch"] == j["epoch"]
        for k in ("train_loss", "test_loss", "test_acc"):
            assert abs(p[k] - j[k]) <= ABS_TOL, (k, p[k], j[k])
    assert trainer.step_count == 2 * math.ceil(1297 / cfg_p.batch_size)
    rows = (tmp_path / "p.csv").read_text().splitlines()
    assert len(rows) == 3 and "epoch1" in rows[-1]


def _sweep_results(path):
    with open(path) as f:
        return json.load(f)


def _results_close(got, want, scores=False):
    assert list(got["results"]) == list(want["results"])
    for layer, methods in want["results"].items():
        assert list(got["results"][layer]) == list(methods)
        for method, runs in methods.items():
            gruns = got["results"][layer][method]
            assert len(gruns) == len(runs)
            for g, w in zip(gruns, runs):
                assert len(g["loss"]) == len(w["scores"])
                _curves_close({k: np.asarray(v) for k, v in g.items()},
                              {k: np.asarray(v) for k, v in w.items()})
                assert abs(g["auc"] - w["auc"]) <= ABS_TOL
                if scores:
                    ws = np.asarray(w["scores"])
                    np.testing.assert_allclose(
                        g["scores"], ws, rtol=SCORE_RTOL,
                        atol=SCORE_RTOL * float(np.abs(ws).max()))
    for method, auc in want["auc_summary"].items():
        assert abs(got["auc_summary"][method] - auc) <= ABS_TOL


def test_vgg16_digits32_layerwise_smoke_sweep_matches_jax(tmp_path,
                                                           monkeypatch):
    """The smoke preset's training leg (with its dropout) in the JAX
    package, then the sweep with Shapley (3 runs of 5 permutations) from
    the weights and state it trained, in both packages, on three of the
    15 layers (the JAX package compiles each layer's programs; all 15
    cost minutes on the CPU): a 32x32 site, a 2x2 site and fc1."""
    feed_jax_draws(monkeypatch)
    over = {"target_filter": ("conv2", "conv13", "fc1")}
    cfg_j = dataclasses.replace(
        JPS.get_preset("vgg16_digits32_layerwise", smoke=True), **over,
        log_path=str(tmp_path / "j.csv"),
        results_path=str(tmp_path / "j.json"))
    cfg_p = dataclasses.replace(
        PPS.get_preset("vgg16_digits32_layerwise", smoke=True), **over,
        log_path=str(tmp_path / "p.csv"),
        results_path=str(tmp_path / "p.json"))
    trainer, _ = JTM.run_train(cfg_j, verbose=False)
    j_aucs = JR.run_robustness_config(cfg_j, model=trainer.model,
                                      params=trainer.params,
                                      state=trainer.state, verbose=False)
    p_aucs = PR.run_robustness_config(
        cfg_p, model=model_from_reference(trainer.model),
        params=torch_tree(trainer.params), state=torch_tree(trainer.state),
        verbose=False, device="cpu")
    assert set(p_aucs) == set(j_aucs) == {"shapley"}
    got, want = (_sweep_results(tmp_path / f) for f in ("p.json", "j.json"))
    assert list(got["results"]) == ["conv2", "conv13", "fc1"]
    _results_close(got, want)


def test_method_all_panel_on_digits_convnet_matches_jax(tmp_path,
                                                       monkeypatch):
    """The 8-method panel (14 runs a layer) on every prunable layer of
    digits_convnet, from JAX weights and running statistics."""
    feed_jax_draws(monkeypatch)
    kw = dict(name="digits_all", model="digits_convnet", dataset="digits",
              experiment="robustness", method="all",
              method_kwargs={"sv_samples": 3}, score_examples=64,
              eval_batch_size=32, log_path=str(tmp_path / "log.csv"))
    jm = JCN.digits_convnet()
    jparams, jstate = j_init_model(jm, seed=0)
    x = load_dataset("digits", "train", n=32).x
    jstate = _trained_state(jm, jparams, jstate, x)
    JR.run_robustness_config(
        JConfig(**kw, results_path=str(tmp_path / "j.json")),
        params=jparams, state=jstate, verbose=False)
    PR.run_robustness_config(
        ExperimentConfig(**kw, results_path=str(tmp_path / "p.json")),
        params=torch_tree(jparams), state=torch_tree(jstate), verbose=False,
        device="cpu")
    got, want = (_sweep_results(tmp_path / f) for f in ("p.json", "j.json"))
    assert list(got["results"]) == ["conv1", "conv2", "fc1"]
    for methods in got["results"].values():
        assert [len(r) for r in methods.values()] == [3, 1, 1, 1, 1, 1, 3, 3]
        randoms = [tuple(np.argsort(r["scores"])) for r in methods["random"]]
        assert len(set(randoms)) == 3
    _results_close(got, want, scores=True)


def test_cli_runs_the_train_and_train_robustness_experiments(tmp_path,
                                                            capsys):
    cfg = ExperimentConfig(name="digits_train", model="digits_convnet",
                           dataset="digits", experiment="train", epochs=1,
                           batch_size=32, optimizer="adam", lr=1e-3,
                           log_path=str(tmp_path / "t.csv"))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    assert p_main(["--config", path, "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs"] == 1 and 0.0 <= out["final_test_acc"] <= 1.0
    cfg = dataclasses.replace(cfg, name="digits_sweep",
                              experiment="train_robustness",
                              method_kwargs={"sv_samples": 2},
                              score_examples=32, eval_batch_size=32)
    cfg.to_json(path)
    assert p_main(["--config", path, "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"shapley"} and math.isfinite(out["shapley"])


def test_unported_settings_raise():
    cfg = PPS.get_preset("vgg16_digits32_layerwise", smoke=True)
    for field, value in (("augment", True), ("plot_dir", "figs"),
                         ("run_dir", "x"), ("mesh", {"data": 2})):
        bad = dataclasses.replace(cfg, **{field: value})
        with pytest.raises(NotImplementedError, match=field):
            PTM.run_train(bad, device="cpu")
        with pytest.raises(NotImplementedError, match=field):
            PR.run_robustness_config(bad, device="cpu")


@pytest.mark.cuda
def test_walk_on_the_card_matches_the_cpu():
    """The f32 walk at full-width VGG16-bn's ``fc1`` on cuDNN / cuBLAS
    against the CPU's, within 1e-5 of the base loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PPS.MODEL_REGISTRY["vgg16_bn"][0]()
    params, state = PS.init_model(model, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(32, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=(32,)).astype(np.int32))]
    rankings = np.stack([rng.permutation(512) for _ in range(2)])
    cpu = PR.ablation_curves_batch(model, params, state, "fc1", rankings,
                                   data, p_ce, eval_layer="relu_fc1")

    def cuda(tree):
        return {k: cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    card = PR.ablation_curves_batch(model, cuda(params), cuda(state), "fc1",
                                    rankings, data, p_ce,
                                    eval_layer="relu_fc1")
    for g, w in zip(card, cpu):
        _curves_close(g, w, 1e-5 * w["base_loss"])
