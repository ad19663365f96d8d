"""The port's ViT family and its layers against the JAX package's, on
the CPU.

- ``Conv`` forwards: VALID at stride 16 (the ViT patchify), SAME at
  stride 2 on odd and even sizes and kernels (XLA puts the odd pad row
  at the high end), SAME at stride 1, bias or none; the padding rule
  itself; ``Reshape`` and ``ClsToken`` forwards;
- ``vit_tiny`` logits, train-mode loss and parameter gradients;
- ``pruning_graph`` (targets, attached norms, consumers) and
  ``find_best_evaluation_layer`` on ``vit_tiny``, on a conv net whose
  conv feeds a conv and a pooled Dense, and on a conv whose channels a
  ``Reshape`` folds;
- ``prune``: ViT head and MLP pruning, and conv channel pruning, give
  the JAX widths and values.

Inputs come from numpy with a seed; JAX weights are carried over by
``params_from_numpy``.  Tolerance: f32 forwards, losses and gradients
agree to rtol 1e-5 of the output scale (the same math, sums in other
orders); surgery is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu.core import graph as JG
from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core import pruner as JP
from torchpruner_tpu.core.segment import SegmentedModel as JSegmentedModel
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.models import vit_tiny as j_vit_tiny
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import graph as PG
from torchpruner_tpu_torch.core import layers as PL
from torchpruner_tpu_torch.core import pruner as PP
from torchpruner_tpu_torch.models import vit_tiny as p_vit_tiny
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
from torchpruner_tpu_torch.utils.tree import tree_leaves

F32_RTOL = 1e-5


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


def _layer_case(jspec, in_shape, seed=0):
    """One layer's JAX init params and a numpy batch of 2 inputs."""
    jparams, _, _ = JL.init_layer(jspec, jax.random.PRNGKey(seed), in_shape)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2,) + tuple(in_shape)).astype(np.float32)
    if "b" in jparams:  # a non-zero bias, so its add is checked too
        jparams["b"] = jnp.asarray(
            rng.normal(size=jparams["b"].shape).astype(np.float32))
    return jparams, x


@pytest.mark.parametrize("in_shape,features,k,s,pad,bias", [
    ((16, 16, 3), 8, (16, 16), (16, 16), "VALID", True),  # ViT patchify
    ((32, 32, 3), 6, (4, 4), (4, 4), "VALID", False),
    ((7, 9, 4), 5, (3, 3), (2, 2), "SAME", True),  # odd sizes, stride 2
    ((8, 8, 3), 4, (3, 3), (2, 2), "SAME", True),  # pad 0 low, 1 high
    ((8, 10, 2), 3, (4, 2), (2, 2), "SAME", True),  # even kernels
    ((6, 5, 2), 3, (3, 3), (1, 1), "SAME", False),
    ((9, 9, 3), 4, (3, 3), (2, 2), "VALID", True),
])
def test_conv_forward_matches_jax(in_shape, features, k, s, pad, bias):
    jspec = JL.Conv("c", features, k, s, pad, use_bias=bias)
    jparams, x = _layer_case(jspec, in_shape)
    want, _ = JL.apply_layer(jspec, jparams, {}, jnp.asarray(x))
    pspec = PL.Conv("c", features, k, s, pad, use_bias=bias)
    got, _ = PL.apply_layer(pspec, torch_tree(jparams), {},
                            torch.from_numpy(x))
    assert tuple(got.shape[1:]) == PL.out_shape(pspec, in_shape) \
        == JL.out_shape(jspec, in_shape)
    assert PL.param_shapes(pspec, in_shape) == {
        n: tuple(a.shape) for n, a in jparams.items()}
    _close(got.numpy(), np.asarray(want), F32_RTOL)


@pytest.mark.parametrize("size,k,stride,want", [
    (8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (8, 4, 2, (1, 1)),
    (9, 4, 2, (1, 2)), (5, 3, 1, (1, 1)), (16, 16, 16, (0, 0)),
    (3, 4, 2, (1, 2)), (3, 5, 2, (2, 2)),
])
def test_same_pads_put_the_odd_row_high(size, k, stride, want):
    assert PL.same_pads(size, k, stride) == want
    lo, hi = want
    assert (size + lo + hi - k) // stride + 1 == -(-size // stride)


@pytest.mark.parametrize("jspec,pspec,in_shape", [
    (JL.Reshape("r", (16, 8)), PL.Reshape("r", (16, 8)), (4, 4, 8)),
    (JL.Reshape("r", (-1,)), PL.Reshape("r", (-1,)), (4, 4, 8)),
    (JL.Reshape("r", (2, -1, 8)), PL.Reshape("r", (2, -1, 8)), (4, 4, 8)),
    (JL.ClsToken("cls"), PL.ClsToken("cls"), (9, 8)),
])
def test_reshape_and_cls_token_match_jax(jspec, pspec, in_shape):
    jparams, x = _layer_case(jspec, in_shape, seed=3)
    want, _ = JL.apply_layer(jspec, jparams, {}, jnp.asarray(x))
    got, _ = PL.apply_layer(pspec, torch_tree(jparams), {},
                            torch.from_numpy(x))
    assert tuple(got.shape[1:]) == PL.out_shape(pspec, in_shape)
    assert PL.param_shapes(pspec, in_shape) == {
        n: tuple(a.shape) for n, a in jparams.items()}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reshape_refuses_two_free_axes():
    with pytest.raises(ValueError, match="one -1"):
        PL.out_shape(PL.Reshape("r", (-1, -1)), (4, 4))


# -- the ViT forward and backward ------------------------------------------


def _vit(seed=0):
    jm = j_vit_tiny()
    jparams, _ = j_init_model(jm, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(4,)).astype(np.int32)
    return jm, jparams, model_from_reference(jm), x, y


def test_vit_tiny_spec_and_init_shapes_match_jax():
    jm, jparams, pm, _, _ = _vit()
    assert pm == p_vit_tiny()
    assert pm.param_shapes() == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jparams)
    params, state = _port_init(pm)
    assert state == {}
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert _shape_tree(params) == shapes
    # the JAX init scales: the CLS token and positions 0.02 normal, Conv
    # Kaiming normal over kh * kw * in, biases 0
    assert float(params["cls"]["tok"].std()) < 0.05
    w = params["patchify"]["w"]
    assert abs(float(w.std()) - (2.0 / (4 * 4 * 3)) ** 0.5) < 0.05
    assert float(params["patchify"]["b"].abs().max()) == 0.0


def _port_init(model):
    from torchpruner_tpu_torch.core.segment import init_model

    return init_model(model, seed=0, device="cpu")


def _shape_tree(tree):
    return {k: _shape_tree(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_vit_tiny_logits_loss_and_grads_match_jax():
    jm, jparams, pm, x, y = _vit(seed=1)
    pparams = torch_tree(jparams)
    j_out, _ = jm.apply(jparams, jnp.asarray(x))
    p_out, _ = pm.apply(pparams, torch.from_numpy(x))
    _close(p_out.numpy(), j_out, F32_RTOL)

    def j_loss(p):
        out, _ = jm.apply(p, jnp.asarray(x), train=True,
                          rng=jax.random.PRNGKey(0))
        return jnp.mean(j_ce(out, jnp.asarray(y)))

    j_val, j_grads = jax.value_and_grad(j_loss)(jparams)
    for t in tree_leaves(pparams):
        t.requires_grad_()
    out, _ = pm.apply(pparams, torch.from_numpy(x), train=True,
                      rng=torch.Generator().manual_seed(0))
    loss = p_ce(out, torch.from_numpy(y)).mean()
    loss.backward()
    _close(float(loss.detach()), float(j_val), F32_RTOL)
    want = numpy_tree(j_grads)
    scale = max(float(np.abs(w).max()) for w in tree_leaves(want))

    def walk(g, w):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k])
            else:
                _close(g[k].grad.numpy(), w[k], F32_RTOL, scale)

    walk(pparams, want)


# -- the pruning graph -------------------------------------------------------


def _conv_net():
    """conv1 -> conv2 (consumer on w axis 2) -> pooled Dense head."""
    return JSegmentedModel((
        JL.Conv("conv1", 6, (3, 3), (2, 2), "SAME"),
        JL.LayerNorm("ln1"),
        JL.Activation("relu1", "relu"),
        JL.Conv("conv2", 5, (3, 3), (1, 1), "SAME"),
        JL.Activation("relu2", "relu"),
        JL.GlobalPool("pool", "avg"),
        JL.Dense("fc", 7),
        JL.Activation("relu3", "relu"),
        JL.Dense("head", 3),
    ), (9, 9, 3))


def _folded_net():
    """A conv whose channels a Reshape folds: no group for it."""
    return JSegmentedModel((
        JL.Conv("conv", 4, (3, 3), (2, 2), "SAME"),
        JL.Reshape("flat", (-1,)),
        JL.Dense("fc", 6),
        JL.Dense("head", 2),
    ), (6, 6, 2))


def _group_key(g):
    return (g.target, tuple((a.layer, a.fan_out) for a in g.attached_bn),
            tuple(g.attached_dropout),
            tuple((c.layer, c.param, c.axis, c.fan_out)
                  for c in g.consumers))


@pytest.mark.parametrize("make_model", [j_vit_tiny, _conv_net, _folded_net])
def test_pruning_graph_and_eval_layer_match_jax(make_model):
    jm = make_model()
    pm = model_from_reference(jm)
    for incl in (False, True):
        jg = [_group_key(g) for g in JG.pruning_graph(jm, incl)]
        pg = [_group_key(g) for g in PG.pruning_graph(pm, incl)]
        assert pg == jg and len(pg) > 0
    assert pm.widths() == jm.widths()
    for t in jm.widths():
        assert PG.find_best_evaluation_layer(pm, t) == \
            JG.find_best_evaluation_layer(jm, t)


def test_vit_patchify_forms_no_group_but_keeps_its_width():
    pm = p_vit_tiny()
    targets = [g.target for g in PG.pruning_graph(pm, include_output=True)]
    assert "patchify" not in targets
    assert pm.widths()["patchify"] == 32
    assert targets == ["block1_attn/attn", "block1_mlp/fc1",
                       "block2_attn/attn", "block2_mlp/fc1", "head"]


# -- surgery -----------------------------------------------------------------


def _trees_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _trees_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("make_model,steps", [
    (j_vit_tiny, (("block1_attn/attn", [1, 2]), ("block2_mlp/fc1",
                                                 [0, 5, 17, 63]),
                  ("block2_attn/attn", [3]), ("block1_mlp/fc1", [2, 9]))),
    (_conv_net, (("conv1", [0, 4]), ("conv2", [1]), ("fc", [6]))),
])
def test_prune_widths_and_values_match_jax(make_model, steps):
    jm = make_model()
    jparams, _ = j_init_model(jm, seed=4)
    pm, pparams = model_from_reference(jm), torch_tree(jparams)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2,) + tuple(jm.input_shape)).astype(np.float32)
    for target, drop in steps:
        jres = JP.prune(jm, jparams, target, drop)
        pres = PP.prune(pm, pparams, target, drop)
        assert pres.model == model_from_reference(jres.model)
        assert pres.model.widths() == jres.model.widths()
        _trees_equal(pres.params, numpy_tree(jres.params))
        jm, jparams, pm, pparams = jres.model, jres.params, pres.model, \
            pres.params
        j_out, _ = jm.apply(jparams, jnp.asarray(x))
        p_out, _ = pm.apply(pparams, torch.from_numpy(x))
        _close(p_out.numpy(), j_out, F32_RTOL)
