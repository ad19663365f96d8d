"""The port's MoE layer against the JAX package's, on the CPU.

Seeded numpy inputs and the JAX init weights (carried over with
``convert.params_from_numpy``) go through both packages:

- the forward, dense and sparse: top-1, top-2 and top-E routing, a tie
  in the router logits (every logit equal to the k-th largest survives;
  the sparse dispatch then takes the lower expert index), an overflow
  that drops pairs, and the Mixtral-shaped ``llama_moe_tiny``;
- gates ablated through the unit-site tap;
- the Switch balancing loss, and the loss and gradients of a training
  step with ``moe_aux_weight`` > 0;
- Taylor, Sensitivity and WeightNorm expert scores;
- the pruning graph, expert surgery (the same kept experts give the
  same params) and the width pinning of a producer feeding MoE;
- int8 and int4 MoE trees: the same payload bytes, scales and
  ``pack_axis`` (an MoE ``wo`` packs along E, or along F after an
  odd-count prune), and the same forward;

Decode, serving and the prune loop: ``test_torch_port_moe_decode.py``.

Tolerances: f32 forwards, losses and gradients agree to rtol 1e-5 of the
output scale (the same math, sums in other orders); scores to 1e-4 of
their scale; quantized trees are byte-equal.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu import attributions as JA
from torchpruner_tpu.core import graph as JG
from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core import pruner as JP
from torchpruner_tpu.core.segment import SegmentedModel as JModel
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.models import llama_moe_tiny as j_llama_moe_tiny
from torchpruner_tpu.ops.quant import QTensor as JQTensor
from torchpruner_tpu.ops.quant import quantize_params as j_quantize_params
from torchpruner_tpu.train.loop import make_loss_closure as j_loss_closure
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu.utils.losses import lm_cross_entropy_loss as j_lm
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import graph as PG
from torchpruner_tpu_torch.core import layers as PL
from torchpruner_tpu_torch.core import pruner as PP
from torchpruner_tpu_torch.ops.quant import QTensor as PQTensor
from torchpruner_tpu_torch.ops.quant import quantize_params as p_quantize
from torchpruner_tpu_torch.train.loop import make_loss_closure as p_loss_c
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss as p_lm
from torchpruner_tpu_torch.utils.tree import tree_leaves

F32_RTOL = 1e-5
SCORE_RTOL = 1e-4


def numpy_tree(tree):
    """A JAX tree as numpy, QTensors as plain dicts (``convert``'s
    input)."""
    if isinstance(tree, JQTensor):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "in_axes": tuple(tree.in_axes), "bits": tree.bits,
                "pack_axis": tree.pack_axis}
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


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# -- models and cases --------------------------------------------------------


def moe_net(n_experts=4, top_k=2, dispatch="dense", capacity_factor=1.25):
    """Flat Embedding -> MoE -> seq-mean pool -> head (JAX spec)."""
    return JModel(
        layers=(JL.Embedding("emb", 32, 16),
                JL.MoE("moe", n_experts, 24, top_k=top_k, dispatch=dispatch,
                       capacity_factor=capacity_factor),
                JL.GlobalPool("pool", "seq_mean"),
                JL.Dense("head", 5)),
        input_shape=(8,), input_dtype="int32")


def _tie_params(params):
    """Expert 3 always first; experts 1 and 2 share a router column, so
    they tie for the second place in every token; expert 0 last."""
    p = jax.tree_util.tree_map(lambda a: a, params)
    p["emb"] = {"emb": jnp.abs(p["emb"]["emb"]) + 0.1}
    r = p["moe"]["router"].at[:, 3].set(1.0).at[:, 1:3].set(0.05)
    p["moe"] = {**p["moe"], "router": r.at[:, 0].set(-1.0)}
    return p


def _overflow_params(params):
    """Every token routed to expert 0 (its column dominates)."""
    p = jax.tree_util.tree_map(lambda a: a, params)
    p["emb"] = {"emb": jnp.abs(p["emb"]["emb"]) + 0.1}
    p["moe"] = {**p["moe"], "router": jnp.zeros_like(
        p["moe"]["router"]).at[:, 0].set(1e3)}
    return p


#: id -> (model kwargs, params rewrite): the flat net's forward cases
FLAT_CASES = {
    "dense_top2": (dict(), None),
    "dense_top1": (dict(top_k=1), None),
    "dense_topE": (dict(top_k=4), None),
    "dense_tie": (dict(), _tie_params),
    "sparse_top2": (dict(dispatch="sparse"), None),
    "sparse_top1": (dict(top_k=1, dispatch="sparse"), None),
    "sparse_nodrop": (dict(dispatch="sparse", capacity_factor=2.0), None),
    "sparse_tie": (dict(dispatch="sparse", capacity_factor=2.0),
                   _tie_params),
    "sparse_overflow": (dict(top_k=1, dispatch="sparse",
                             capacity_factor=0.25), _overflow_params),
}


@functools.lru_cache(maxsize=None)
def flat_case(case):
    kw, rewrite = FLAT_CASES[case]
    jm = moe_net(**kw)
    jparams, _ = j_init_model(jm, seed=0)
    if rewrite is not None:
        jparams = rewrite(jparams)
    x = np.random.default_rng(3).integers(0, 32, size=(3, 8)).astype(
        np.int32)
    return jm, jparams, model_from_reference(jm), x


@functools.lru_cache(maxsize=None)
def llama_case(dispatch="dense", capacity_factor=1.25):
    jm = j_llama_moe_tiny(dispatch=dispatch, capacity_factor=capacity_factor)
    jparams, _ = j_init_model(jm, seed=0)
    x = np.random.default_rng(4).integers(0, 256, size=(4, 16)).astype(
        np.int32)
    return jm, jparams, model_from_reference(jm), x


# -- forward ------------------------------------------------------------------


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_forward_and_gates_match_jax(case):
    jm, jparams, pm, x = flat_case(case)
    jy, _, jg = jm.apply(jparams, jnp.asarray(x), capture="moe")
    with torch.no_grad():
        py, _, pg = pm.apply(torch_tree(jparams), torch.from_numpy(x),
                             capture="moe")
    _close(_np(py), jy, F32_RTOL)
    _close(_np(pg), jg, F32_RTOL, scale=1.0)
    nz = (pg > 0).sum(-1)
    spec = pm.layer("moe")
    if case.endswith("tie"):
        assert bool((nz == 3).all())  # the tie at the k-th logit survives
    else:
        assert bool((nz == spec.top_k).all())
    if case == "sparse_overflow":
        plan = PL.moe_dispatch(spec, pg.reshape(-1, spec.n_experts))
        # 24 tokens, all to expert 0: C = ceil(24 / 4 * 0.25) = 2 kept
        assert plan["C"] == 2 and int(plan["keep"].sum()) == 2
        dense = flat_case("dense_top1")
        with torch.no_grad():
            dy, _ = dense[2].apply(torch_tree(jparams), torch.from_numpy(x))
        assert not torch.allclose(dy, py, atol=1e-6)  # pairs were shed


def test_sparse_tie_takes_the_lower_expert_index():
    """``lax.top_k`` order: on a tie the lower index is chosen first."""
    _, jparams, pm, x = flat_case("sparse_tie")
    spec = pm.layer("moe")
    with torch.no_grad():
        _, _, g = pm.apply(torch_tree(jparams), torch.from_numpy(x),
                           capture="moe")
    plan = PL.moe_dispatch(spec, g.reshape(-1, spec.n_experts))
    assert plan["top_e"].tolist() == [[3, 1]] * g.shape[0] * g.shape[1]


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_llama_moe_forward_and_ablation_match_jax(dispatch):
    jm, jparams, pm, x = llama_case(dispatch)
    pparams = torch_tree(jparams)
    site = "block2_moe/experts"
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    jy, _ = jm.apply(jparams, jnp.asarray(x))
    ja, _ = jm.apply(jparams, jnp.asarray(x),
                     unit_mask=(site, jnp.asarray(mask)))
    with torch.no_grad():
        py, _ = pm.apply(pparams, torch.from_numpy(x))
        pa, _ = pm.apply(pparams, torch.from_numpy(x),
                         unit_mask=(site, torch.from_numpy(mask)))
    _close(_np(py), jy, F32_RTOL)
    _close(_np(pa), ja, F32_RTOL)
    assert not np.allclose(_np(pa), _np(py))


# -- aux loss and gradients --------------------------------------------------


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def _trees_close(got, want, rtol):
    scale = max(float(np.abs(np.asarray(w)).max())
                for w in jax.tree_util.tree_leaves(want))

    def walk(g, w):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k])
            else:
                _close(_np(g[k]), w[k], rtol, scale)

    walk(got, want)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_aux_loss_and_training_gradients_match_jax(dispatch):
    jm, jparams, pm, x = llama_case(dispatch)
    xj = jnp.asarray(x)
    _, _, jaux = jm.apply(jparams, xj, train=True, collect_aux=True)
    pparams = torch_tree(jparams)
    with torch.no_grad():
        _, _, paux = pm.apply(pparams, torch.from_numpy(x), train=True,
                              collect_aux=True)
        _, _, none = pm.apply(pparams, torch.from_numpy(x), train=False,
                              collect_aux=True)
    assert set(paux) == set(jaux) == {"block1_moe/experts",
                                      "block2_moe/experts"}
    assert none == {}  # eval forwards collect nothing
    for k in jaux:
        _close(float(paux[k]), float(jaux[k]), F32_RTOL)
        assert float(paux[k]) >= 0.99

    jloss = j_loss_closure(jm, j_lm, moe_aux_weight=0.5)
    (jval, _), jgrads = jax.value_and_grad(
        lambda p: jloss(p, {}, xj, xj, None), has_aux=True)(jparams)
    for t in tree_leaves(pparams):
        t.requires_grad_()
    ploss = p_loss_c(pm, p_lm, moe_aux_weight=0.5)
    val, _ = ploss(pparams, {}, torch.from_numpy(x), torch.from_numpy(x),
                   None)
    val.backward()
    val = float(val.detach())
    with torch.no_grad():
        base = float(p_lm(pm.apply(pparams, torch.from_numpy(x))[0],
                          torch.from_numpy(x)).mean())
    assert val > base + 0.4  # + 0.5 x (two aux losses >= ~1)
    _close(val, float(jval), F32_RTOL)
    _trees_close(_grads(pparams), numpy_tree(jgrads), F32_RTOL)


def test_dense_routing_collects_no_aux():
    """With top_k == E the loss is a gradient-free 1.0: not collected."""
    _, jparams, pm, x = flat_case("dense_topE")
    _, _, aux = pm.apply(torch_tree(jparams), torch.from_numpy(x),
                         train=True, collect_aux=True)
    assert aux == {}


def test_spec_validation():
    for kw in (dict(dispatch="magic"), dict(capacity_factor=0.0),
               dict(top_k=5)):
        with pytest.raises(ValueError):
            PL.MoE("m", 4, 8, **kw)
    spec = PL.with_features(PL.MoE("m", 4, 8, top_k=3), 2)
    assert spec.n_experts == 2 and spec.top_k == 2


# -- expert scores -----------------------------------------------------------


@pytest.mark.parametrize("site", ["moe", "block1_moe/experts"])
@pytest.mark.parametrize("metric", ["taylor", "sensitivity", "weight_norm"])
def test_expert_scores_match_jax(metric, site):
    rng = np.random.default_rng(5)
    if site == "moe":
        jm, jparams, pm, _ = flat_case("sparse_top2")
        data = [(rng.integers(0, 32, size=(6, 8)).astype(np.int32),
                 rng.integers(0, 5, size=(6,)).astype(np.int32))
                for _ in range(2)]
        losses = (j_ce, p_ce)
    else:
        jm, jparams, pm, _ = llama_case()
        toks = [rng.integers(0, 256, size=(4, 16)).astype(np.int32)
                for _ in range(2)]
        data = [(t, t) for t in toks]
        losses = (j_lm, p_lm)
    jcls, pcls = {
        "taylor": (JA.TaylorAttributionMetric, PA.TaylorAttributionMetric),
        "sensitivity": (JA.SensitivityAttributionMetric,
                        PA.SensitivityAttributionMetric),
        "weight_norm": (JA.WeightNormAttributionMetric,
                        PA.WeightNormAttributionMetric)}[metric]
    want = jcls(jm, jparams, data, losses[0]).run(site)
    got = pcls(pm, torch_tree(jparams), data, losses[1]).run(site)
    assert got.shape == want.shape == (4,)
    _close(got, want, SCORE_RTOL)


# -- graph and surgery -------------------------------------------------------


def _group_key(g):
    return (g.target, tuple((a.layer, a.fan_out) for a in g.attached_bn),
            tuple(g.attached_dropout),
            tuple((c.layer, c.param, c.axis, c.fan_out)
                  for c in g.consumers))


def test_pruning_graph_and_expert_surgery_match_jax():
    jm, jparams, pm, x = llama_case()
    for incl in (False, True):
        assert [_group_key(g) for g in PG.pruning_graph(pm, incl)] == \
            [_group_key(g) for g in JG.pruning_graph(jm, incl)]
    assert "block1_moe/experts" in pm.widths()
    for t in jm.widths():
        assert PG.find_best_evaluation_layer(pm, t) == \
            JG.find_best_evaluation_layer(jm, t)
    jres = JP.prune(jm, jparams, "block2_moe/experts", [0, 2])
    pres = PP.prune(pm, torch_tree(jparams), "block2_moe/experts", [0, 2])
    assert pres.model == model_from_reference(jres.model)
    spec = pres.model.layer("block2_moe/experts")
    assert spec.n_experts == 2 and spec.top_k == 2
    got, want = pres.params["block2_moe"]["experts"], \
        jres.params["block2_moe"]["experts"]
    assert tuple(got["router"].shape) == (32, 2)
    for k in ("router", "wg", "wu", "wo"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jy, _ = jres.model.apply(jres.params, jnp.asarray(x))
    with torch.no_grad():
        py, _ = pres.model.apply(pres.params, torch.from_numpy(x))
    _close(_np(py), jy, F32_RTOL)


def test_producer_feeding_moe_is_pinned():
    jm = JModel(layers=(JL.Embedding("emb", 32, 16), JL.Dense("fc", 16),
                        JL.MoE("moe", 4, 24), JL.GlobalPool("p", "seq_mean"),
                        JL.Dense("head", 5)),
                input_shape=(8,), input_dtype="int32")
    pm = model_from_reference(jm)
    targets = [g.target for g in PG.pruning_graph(pm)]
    assert targets == [g.target for g in JG.pruning_graph(jm)]
    assert "fc" not in targets and "moe" in targets


def test_dead_expert_prune_leaves_output_unchanged():
    """An expert that never wins the top-k has gate 0 everywhere, so
    removing it leaves every output bit-equal."""
    jm, jparams, pm, x = flat_case("dense_top2")
    p = torch_tree(jparams)
    p["emb"]["emb"] = p["emb"]["emb"].abs() + 0.1
    p["moe"]["router"][:, 2] = -1e3
    with torch.no_grad():
        y0, _, g = pm.apply(p, torch.from_numpy(x), capture="moe")
        assert float(g[..., 2].max()) == 0.0
        res = PP.prune(pm, p, "moe", [2])
        y1, _ = res.model.apply(res.params, torch.from_numpy(x))
    assert torch.equal(y0, y1)


# -- quantized trees ----------------------------------------------------------


def _quantized(bits, dispatch, pruned):
    jm, jparams, _, x = llama_case(dispatch)
    if pruned:  # 4 -> 3 experts: an odd count
        res = JP.prune(jm, jparams, "block1_moe/experts", [1])
        jm, jparams = res.model, res.params
    pm = model_from_reference(jm)
    return jm, j_quantize_params(jm, jparams, bits=bits), pm, \
        p_quantize(pm, torch_tree(jparams), bits=bits), x


@pytest.mark.parametrize("bits,dispatch,pruned", [
    (8, "dense", False), (4, "dense", False), (8, "sparse", False),
    (4, "sparse", False), (4, "dense", True)],
    ids=["int8", "int4", "int8_sparse", "int4_sparse", "int4_odd_experts"])
def test_quantized_moe_matches_jax(bits, dispatch, pruned):
    jm, jq, pm, pq, x = _quantized(bits, dispatch, pruned)
    for blk in ("block1_moe", "block2_moe"):
        E = pm.layer(f"{blk}/experts").n_experts
        for k, axes in (("wg", (1,)), ("wu", (1,)), ("wo", (0, 1))):
            j, p = jq[blk]["experts"][k], pq[blk]["experts"][k]
            assert isinstance(p, PQTensor) and tuple(p.in_axes) == axes
            assert (p.bits, p.pack_axis) == (j.bits, j.pack_axis)
            np.testing.assert_array_equal(p.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(p.scale.numpy(),
                                          np.asarray(j.scale))
        wo = pq[blk]["experts"]["wo"]
        if bits == 4:  # E while it is even, F after an odd-count prune
            assert wo.pack_axis == (0 if E % 2 == 0 else 1)
        assert not isinstance(pq[blk]["experts"]["router"], PQTensor)
    # the packages' own conversion of the JAX tree gives the same forward
    jy, _ = jm.apply(jq, jnp.asarray(x))
    with torch.no_grad():
        py, _ = pm.apply(torch_tree(jq), torch.from_numpy(x))
        py2, _ = pm.apply(pq, torch.from_numpy(x))
    _close(_np(py), jy, F32_RTOL)
    assert torch.equal(py, py2)
