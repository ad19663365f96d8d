"""The port's mask-based pruning and block-sparse matmul against the JAX
package's, on the CPU.

Inputs come from numpy with a seed and go to both packages; JAX init
weights are carried into the port with ``convert.params_from_numpy``.
The JAX block-sparse kernel runs in Pallas interpret mode, as its own
tests run it; the port runs its plain version (CPU tensors).

- ``blocksparse_matmul``: forward and both gradients against the JAX
  function, exact zeros on dropped columns and blocks; the keep-block
  helpers; the no-launch cases (on the CPU an axis ``block`` does not
  divide, an empty keep list and its zero gradients);
- ``drop_masks`` leaf by leaf on bert_tiny and llama_tiny; the masked
  forward against the pruned forward;
- masked training: 3 SGD steps dense, through ``param_transform`` and in
  JAX, also with every block of a layer dropped; Adam with
  ``masked_update`` against optax;
- ``qdot`` / ``_dot`` dispatch of a ``BlockSparseWeight``, the weight
  bridge, the ``Trainer``'s hook;
- ``simulate=True`` through ``run_prune_retrain`` against the structural
  run and against the JAX package's simulated run.

Tolerances: forward atol 1e-4 and gradients atol 1e-3 (f32 sums over up
to 128 terms in other orders, the JAX tests' own bounds); masks and
helper outputs are equal; 3-step trajectories atol 5e-4, rtol 1e-3 (the
JAX test's bound); loop losses and accuracies 1e-4.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core import masking as JM
from torchpruner_tpu.core import pruner as JP
from torchpruner_tpu.core.segment import SegmentedModel as JSegmentedModel
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.models import bert_tiny as j_bert_tiny
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.ops import blocksparse as JBS
from torchpruner_tpu.train.loop import make_train_step as j_make_train_step
from torchpruner_tpu.utils.config import ExperimentConfig as JExperimentConfig
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import layers as PL
from torchpruner_tpu_torch.core import masking as PM
from torchpruner_tpu_torch.core import pruner as PP
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.experiments import prune_retrain as PPR
from torchpruner_tpu_torch.ops import blocksparse as PBS
from torchpruner_tpu_torch.ops.quant import qdot
from torchpruner_tpu_torch.train import optim as PO
from torchpruner_tpu_torch.train.loop import Trainer
from torchpruner_tpu_torch.utils.config import ExperimentConfig
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
from torchpruner_tpu_torch.utils.tree import tree_leaves


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_tree(tree):
    return params_from_numpy(numpy_tree(tree), device="cpu")


def _assert_trees(got, want, **tol):
    """Leaf by leaf: equal when no tolerance is given."""
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees(got[k], want[k], **tol)
        elif tol:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), **tol)
        else:
            assert np.array_equal(got[k].detach().numpy(),
                                  np.asarray(want[k])), k


# -- the matmul ---------------------------------------------------------------

#: (lead, D, F, block, in_keep, out_keep); None keeps every block
MATMUL_CASES = {
    "both_axes": ((2, 8), 128, 96, 32, (0, 2), (0, 2)),
    "out_only": ((16,), 64, 128, 32, None, (1, 3)),
    "in_only": ((16,), 128, 64, 32, (1, 2), None),
    "all_kept": ((4, 4), 64, 64, 32, None, None),
    "block64_unsorted": ((8,), 128, 192, 64, (1, 0), (2, 0)),
}


def _matmul_case(name):
    lead, D, F, block, ik, ok = MATMUL_CASES[name]
    rng = np.random.default_rng(sorted(MATMUL_CASES).index(name))
    x = rng.normal(size=lead + (D,)).astype(np.float32)
    w = rng.normal(size=(D, F)).astype(np.float32)
    return x, w, block, ik, ok


def _block_mask(n, keep, block):
    m = np.zeros(n, bool)
    for b in (range(n // block) if keep is None else keep):
        m[b * block:(b + 1) * block] = True
    return m


@pytest.mark.parametrize("name", sorted(MATMUL_CASES))
def test_blocksparse_forward_matches_jax(name):
    x, w, block, ik, ok = _matmul_case(name)
    want = JBS.blocksparse_matmul(jnp.asarray(x), jnp.asarray(w),
                                  in_keep=ik, out_keep=ok, block=block)
    got = PBS.blocksparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 in_keep=ik, out_keep=ok, block=block)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    dropped = ~_block_mask(w.shape[1], ok, block)
    assert (got.numpy()[..., dropped] == 0).all()
    assert (np.asarray(want)[..., dropped] == 0).all()


@pytest.mark.parametrize("name", sorted(MATMUL_CASES))
def test_blocksparse_gradients_match_jax(name):
    x, w, block, ik, ok = _matmul_case(name)

    def j_loss(x_, w_):
        return jnp.sum(JBS.blocksparse_matmul(
            x_, w_, in_keep=ik, out_keep=ok, block=block) ** 2)

    jx, jw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = PBS.blocksparse_matmul(xt, wt, in_keep=ik, out_keep=ok, block=block)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (xt, wt))
    scale = float(np.abs(np.asarray(jw)).max())
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw),
                               atol=1e-3 * max(1.0, scale), rtol=1e-4)
    in_m = _block_mask(w.shape[0], ik, block)
    out_m = _block_mask(w.shape[1], ok, block)
    kept = in_m[:, None] & out_m[None, :]
    # dropped blocks receive, and dropped inputs pass back, EXACTLY zero
    assert (gw.numpy()[~kept] == 0).all() and (np.asarray(jw)[~kept] == 0).all()
    assert (gx.numpy()[..., ~in_m] == 0).all()


@pytest.mark.parametrize("n,drop,block", [
    (128, list(range(32, 64)), 32), (128, [5], 32), (100, [], 32),
    (256, list(range(128)), 128), (64, [], 32), (64, list(range(64)), 32),
])
def test_keep_blocks_from_drop_matches_jax(n, drop, block):
    assert PBS.keep_blocks_from_drop(n, drop, block) == \
        JBS.keep_blocks_from_drop(n, drop, block)


@pytest.mark.parametrize("mask,block", [
    (np.r_[np.ones(64), np.zeros(32)], 32), (np.ones(96), 32),
    (np.r_[np.ones(60), np.zeros(36)], 32), (np.ones(50), 32),
    (np.ones((2, 32)), 32),
])
def test_keep_blocks_from_mask_matches_jax(mask, block):
    assert PBS.keep_blocks_from_mask(mask, block) == \
        JBS.keep_blocks_from_mask(mask, block)
    assert PBS.DEFAULT_BLOCK == JBS.DEFAULT_BLOCK == 128


def test_unblocked_axis_takes_the_dense_product_on_the_cpu():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 100)).astype(np.float32)
    w = rng.normal(size=(100, 64)).astype(np.float32)
    got = PBS.blocksparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 out_keep=(0,), block=32)
    want = JBS.blocksparse_matmul(jnp.asarray(x), jnp.asarray(w),
                                  out_keep=(0,), block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ w, atol=1e-4)
    # off the CPU there is no give-way: the shape is refused before any
    # product (a meta tensor stands in for a card's)
    with pytest.raises(ValueError, match="must divide"):
        PBS.blocksparse_matmul(torch.empty(5, 100, device="meta"),
                               torch.empty(100, 64, device="meta"),
                               out_keep=(0,), block=32)


@pytest.mark.parametrize("ik,ok", [((), (0, 1)), ((0,), ())])
def test_empty_keep_list_gives_exact_zeros(ik, ok):
    x = torch.ones(3, 4, 64, requires_grad=True)
    w = torch.ones(64, 64, requires_grad=True)
    got = PBS.blocksparse_matmul(x, w, in_keep=ik, out_keep=ok, block=32)

    def j_fn(x_, w_):
        return JBS.blocksparse_matmul(x_, w_, in_keep=ik, out_keep=ok,
                                      block=32)

    jx, jw = jnp.ones((3, 4, 64)), jnp.ones((64, 64))
    want = j_fn(jx, jw)
    assert tuple(got.shape) == want.shape == (3, 4, 64)
    assert (got.detach().numpy() == 0).all() and (np.asarray(want) == 0).all()
    # both operands stay in the graph and receive exactly zero, as under
    # the JAX package's VJP
    gx, gw = torch.autograd.grad(got.sum(), (x, w))
    j_gx, j_gw = jax.grad(lambda a, b: j_fn(a, b).sum(), argnums=(0, 1))(
        jx, jw)
    assert gx.shape == x.shape and gw.shape == w.shape
    assert (gx == 0).all() and (gw == 0).all()
    assert (np.asarray(j_gx) == 0).all() and (np.asarray(j_gw) == 0).all()


def test_kernel_predicate_and_cpu_wrapper_launch_nothing():
    assert PBS.kernel_active(128, torch.bfloat16, "cuda")
    assert PBS.kernel_active(32, torch.float32, "cuda:0")
    assert not PBS.kernel_active(128, torch.float32, "cpu")
    assert not PBS.kernel_active(16, torch.float32, "cuda")
    assert not PBS.kernel_active(128, torch.float16, "cuda")
    n0 = (PBS.blocksparse_fwd.launches, PBS.blocksparse_dx.launches,
          PBS.blocksparse_dw.launches)
    x = torch.ones(2, 64, requires_grad=True)
    PBS.blocksparse_matmul(x, torch.ones(64, 64), out_keep=(1,),
                           block=32).sum().backward()
    assert (PBS.blocksparse_fwd.launches, PBS.blocksparse_dx.launches,
            PBS.blocksparse_dw.launches) == n0
    with pytest.raises(ValueError, match="does not contract"):
        PBS.blocksparse_matmul(x, torch.ones(32, 64), block=32)


def test_mixed_dtypes_promote_like_jax():
    x, w, block, ik, ok = _matmul_case("both_axes")
    want = JBS.blocksparse_matmul(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w), in_keep=ik, out_keep=ok,
                                  block=block)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = PBS.blocksparse_matmul(xt, wt, in_keep=ik, out_keep=ok,
                                 block=block)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    gx, gw = torch.autograd.grad(got.sum(), (xt, wt))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32


# -- dispatch and the weight bridge -------------------------------------------


@pytest.mark.parametrize("fixed_order", [False, True])
def test_qdot_and_layer_dot_dispatch_blocksparse_weight(fixed_order):
    x, w, block, ik, ok = _matmul_case("both_axes")
    w = w * (_block_mask(128, ik, block)[:, None]
             & _block_mask(96, ok, block)[None, :])
    jb = JBS.BlockSparseWeight(jnp.asarray(w), ik, ok, block)
    from torchpruner_tpu.ops.quant import qdot as j_qdot

    want = np.asarray(j_qdot(jnp.asarray(x), jb))
    pb = PBS.BlockSparseWeight(torch.from_numpy(w), ik, ok, block)
    assert tuple(pb.shape) == (128, 96) and pb.dtype == torch.float32
    assert pb.dense() is pb.w
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(qdot(xt, pb).numpy(), want, atol=1e-4)
    np.testing.assert_allclose(PL._dot(xt, pb, fixed_order).numpy(), want,
                               atol=1e-4)
    # a Dense layer with the wrapper in its params: dropped columns carry
    # the bias only
    b = torch.arange(96, dtype=torch.float32)
    y, _ = PL.apply_layer(PL.Dense("fc", 96), {"w": pb, "b": b}, {}, xt,
                          fixed_order=fixed_order)
    dropped = ~_block_mask(96, ok, block)
    assert torch.equal(y[..., dropped],
                       b[dropped].expand(2, 8, int(dropped.sum())))
    np.testing.assert_allclose(y.numpy(), want + b.numpy(), atol=1e-4)


def test_weight_bridge_carries_masks_and_wrapped_weights():
    x, w, block, ik, ok = _matmul_case("both_axes")
    tree = {"fc": {"w": {"w": w, "in_keep": ik, "out_keep": None,
                         "block": block},
                   "b": np.zeros(96, np.float32)},
            "mask": np.ones(4, np.float32)}
    out = params_from_numpy(tree, device="cpu")
    bsw = out["fc"]["w"]
    assert isinstance(bsw, PBS.BlockSparseWeight)
    assert (bsw.in_keep, bsw.out_keep, bsw.block) == (ik, None, block)
    assert torch.equal(bsw.w, torch.from_numpy(w))
    assert torch.equal(out["mask"], torch.ones(4))
    want = JBS.blocksparse_matmul(jnp.asarray(x), jnp.asarray(w),
                                  in_keep=ik, block=block)
    np.testing.assert_allclose(bsw.matmul(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=1e-4)


# -- masks --------------------------------------------------------------------

MASK_CASES = {
    "bert": (j_bert_tiny, {"block1_mlp/fc1": [0, 5, 17, 63],
                           "block2_attn/attn": [1, 2],
                           "block2_mlp/fc1": list(range(32, 64))}),
    "llama": (j_llama_tiny, {"block1_ffn/gate": list(range(32)),
                             "block2_attn/attn": [3],
                             "block2_ffn/gate": [1, 40]}),
}


def _mask_case(kind, seed=0):
    model_fn, drops = MASK_CASES[kind]
    jm = model_fn()
    jparams, jstate = j_init_model(jm, seed=seed)
    return jm, jparams, jstate, model_from_reference(jm), drops


@pytest.mark.parametrize("kind", sorted(MASK_CASES))
def test_drop_masks_equal_jax_leaf_by_leaf(kind):
    jm, jparams, jstate, pm, drops = _mask_case(kind)
    j_pm, j_sm = JM.drop_masks(jm, jparams, drops, state=jstate)
    p_pm, p_sm = PM.drop_masks(pm, torch_tree(jparams), drops,
                               state=torch_tree(jstate))
    _assert_trees(p_pm, numpy_tree(j_pm))
    _assert_trees(p_sm, numpy_tree(j_sm))
    n_zero = sum(int((m == 0).sum()) for m in tree_leaves(p_pm))
    assert n_zero > 0
    assert PM.drop_masks(pm, torch_tree(jparams), drops)[1] is None
    masked = PM.apply_masks(torch_tree(jparams), p_pm)
    _assert_trees(masked, numpy_tree(JM.apply_masks(jparams, j_pm)))
    assert PM.apply_masks(masked, None) is masked
    with pytest.raises(KeyError):
        PM.drop_masks(pm, torch_tree(jparams), {"nope": [0]})


@pytest.mark.parametrize("kind", sorted(MASK_CASES))
def test_masked_forward_equals_pruned_forward(kind):
    jm, jparams, _, pm, drops = _mask_case(kind)
    params = torch_tree(jparams)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 128, size=(4, 16)).astype(np.int32))
    masks, _ = PM.drop_masks(pm, params, drops)
    y_masked, _ = pm.apply(PM.apply_masks(params, masks), x)
    model, pruned = pm, params
    for layer, d in drops.items():
        res = PP.prune(model, pruned, layer, d)
        model, pruned = res.model, res.params
    y_pruned, _ = model.apply(pruned, x)
    assert model.widths() != pm.widths()
    np.testing.assert_allclose(y_masked.numpy(), y_pruned.numpy(),
                               atol=1e-5)
    # and the JAX package's masked forward
    j_masks, _ = JM.drop_masks(jm, jparams, drops)
    j_y, _ = jm.apply(JM.apply_masks(jparams, j_masks), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y_masked.numpy(), np.asarray(j_y), atol=1e-5)


@pytest.mark.parametrize("kind,block,expect", [
    ("bert", 32, {("block2_mlp", "fc1", "w"): {"out_keep": (0,)},
                  ("block2_mlp", "fc2", "w"): {"in_keep": (0,)}}),
    ("llama", 32, {("block1_ffn", "gate", "wg"): {"out_keep": (1,)},
                   ("block1_ffn", "gate", "wu"): {"out_keep": (1,)},
                   ("block1_ffn", "down", "w"): {"in_keep": (1,)}}),
    ("bert", 64, {}),
])
def test_blocksparse_params_wraps_the_sites_jax_wraps(kind, block, expect):
    jm, jparams, _, pm, drops = _mask_case(kind)
    params = torch_tree(jparams)
    assert PM.blocksparse_sites(pm, params, drops, block=block) == expect
    wrapped = PM.blocksparse_params(pm, params, drops, block=block)
    j_wrapped = JM.blocksparse_params(jm, jparams, drops, block=block)

    def walk(p, j, path=()):
        for k in j:
            if isinstance(j[k], dict):
                walk(p[k], j[k], path + (k,))
            elif isinstance(j[k], JBS.BlockSparseWeight):
                assert isinstance(p[k], PBS.BlockSparseWeight), path + (k,)
                assert (p[k].in_keep, p[k].out_keep, p[k].block) == \
                    (j[k].in_keep, j[k].out_keep, j[k].block)
                assert path + (k,) in expect
            else:
                assert isinstance(p[k], torch.Tensor), path + (k,)

    walk(wrapped, j_wrapped)
    # wrapping is metadata only, and wrapping twice changes nothing
    for path in expect:
        leaf = wrapped
        for k in path:
            leaf = leaf[k]
        assert leaf.w is PM._get_path(params, path)
    again = PM.blocksparse_params(pm, wrapped, {}, block=block)
    assert again is wrapped


def test_blocksparse_transform_resolves_the_plans_once(monkeypatch):
    _, jparams, _, pm, drops = _mask_case("bert")
    params = torch_tree(jparams)
    calls = []
    orig = PM.plan_for_group
    monkeypatch.setattr(PM, "plan_for_group",
                        lambda m, g: calls.append(g.target) or orig(m, g))
    transform = PM.blocksparse_transform(pm, drops, block=32)
    first = transform(params)
    n = len(calls)
    assert n == len(drops)
    second = transform(PM.apply_masks(params, PM.drop_masks(
        pm, params, drops)[0]))
    assert len(calls) == 2 * n  # drop_masks walked them; transform did not
    for tree in (first, second):
        assert isinstance(tree["block2_mlp"]["fc1"]["w"],
                          PBS.BlockSparseWeight)
    assert second["block2_mlp"]["fc1"]["w"].w is not \
        first["block2_mlp"]["fc1"]["w"].w


# -- masked training ----------------------------------------------------------


def _mlp():
    return JSegmentedModel([
        JL.Dense("fc1", 32, 256), JL.Activation("a1", "relu"),
        JL.Dense("fc2", 256, 256), JL.Activation("a2", "relu"),
        JL.Dense("out", 256, 10),
    ], input_shape=(32,))


@pytest.mark.parametrize("transform", ["dense", "blocksparse"])
def test_masked_sgd_steps_match_jax_trajectory(transform):
    jm = _mlp()
    pm = model_from_reference(jm)
    jparams, jstate = j_init_model(jm, seed=0)
    rng = np.random.default_rng(6)
    scores = rng.normal(size=256)
    drop = JP.score_drop_indices(scores, policy="fraction", fraction=0.5,
                                 granularity=128)
    assert np.array_equal(drop, PP.score_drop_indices(
        scores, policy="fraction", fraction=0.5, granularity=128))
    drops = {"fc2": drop}
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,)).astype(np.int32)

    j_masks, _ = JM.drop_masks(jm, jparams, drops, state=jstate)
    j_mp = JM.apply_masks(jparams, j_masks)
    j_tx = optax.chain(optax.sgd(0.05), JM.masked_update(j_masks))
    j_tf = None if transform == "dense" else (
        lambda p: JM.blocksparse_params(jm, p, drops, block=128))
    step = j_make_train_step(jm, j_tx, j_ce, donate=False,
                             param_transform=j_tf)
    jp, js, jo = j_mp, jstate, j_tx.init(j_mp)
    j_losses = []
    for i in range(3):
        jp, js, jo, l = step(jp, js, jo, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(i))
        j_losses.append(float(l))

    params = torch_tree(jparams)
    masks, _ = PM.drop_masks(pm, params, drops, state={})
    p_tf = None if transform == "dense" else \
        PM.blocksparse_transform(pm, drops, block=128)
    tx = PO.chain(PO.sgd(0.05), PM.masked_update(masks))
    trainer = Trainer.create(pm, tx, p_ce, seed=0,
                             params=PM.apply_masks(params, masks),
                             device="cpu", param_transform=p_tf)
    losses = [float(trainer.step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _assert_trees(trainer.params, numpy_tree(jp), atol=5e-4, rtol=1e-3)
    # the optimizer saw plain tensors only, and masked units stay pinned
    assert all(isinstance(t, torch.Tensor)
               for t in tree_leaves(trainer.params))
    assert (trainer.params["fc2"]["w"].numpy()[:, drop] == 0).all()
    assert (trainer.params["fc2"]["b"].numpy()[drop] == 0).all()
    assert (trainer.params["out"]["w"].numpy()[drop] == 0).all()
    kept = np.setdiff1d(np.arange(256), drop)
    assert (trainer.params["fc2"]["w"].numpy()[:, kept] != 0).any()


def test_masked_sgd_steps_with_a_whole_layer_dropped_match_jax():
    """Every block of ``fc1`` dropped: its product has an empty
    ``out_keep`` and its consumer's an empty ``in_keep``, neither
    computes anything, and the step still trains the rest (both weights
    stay in the graph with zero gradients)."""
    jm = JSegmentedModel([
        JL.Dense("fc1", 128), JL.Activation("a1", "relu"),
        JL.Dense("fc2", 128), JL.Activation("a2", "relu"),
        JL.Dense("out", 10),
    ], input_shape=(32,))
    pm = model_from_reference(jm)
    jparams, jstate = j_init_model(jm, seed=0)
    drops = {"fc1": np.arange(128)}
    rng = np.random.default_rng(8)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,)).astype(np.int32)

    j_masks, _ = JM.drop_masks(jm, jparams, drops, state=jstate)
    j_mp = JM.apply_masks(jparams, j_masks)
    j_tx = optax.chain(optax.sgd(0.05), JM.masked_update(j_masks))
    step = j_make_train_step(
        jm, j_tx, j_ce, donate=False,
        param_transform=lambda p: JM.blocksparse_params(jm, p, drops,
                                                        block=32))
    jp, js, jo = j_mp, jstate, j_tx.init(j_mp)
    j_losses = []
    for i in range(2):
        jp, js, jo, l = step(jp, js, jo, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(i))
        j_losses.append(float(l))

    params = torch_tree(jparams)
    assert PM.blocksparse_sites(pm, params, drops, block=32) == {
        ("fc1", "w"): {"out_keep": ()}, ("fc2", "w"): {"in_keep": ()}}
    masks, _ = PM.drop_masks(pm, params, drops, state={})
    tx = PO.chain(PO.sgd(0.05), PM.masked_update(masks))
    start = PM.apply_masks(params, masks)
    trainer = Trainer.create(
        pm, tx, p_ce, seed=0, params=start, device="cpu",
        param_transform=PM.blocksparse_transform(pm, drops, block=32))
    losses = [float(trainer.step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _assert_trees(trainer.params, numpy_tree(jp), atol=5e-4, rtol=1e-3)
    assert (trainer.params["fc1"]["w"] == 0).all()
    assert (trainer.params["fc1"]["b"] == 0).all()
    assert (trainer.params["fc2"]["w"] == 0).all()
    # with fc2's bias at its zero init only the output bias has a gradient
    assert not torch.equal(trainer.params["out"]["b"], start["out"]["b"])


def test_blocksparse_sites_leave_out_a_weight_block_does_not_tile():
    """``out`` (256 x 10) loses whole input blocks with ``fc1``, but its
    other axis has no blocks: it stays a plain masked tensor, where the
    JAX package wraps it and takes its dense product."""
    jm = JSegmentedModel([
        JL.Dense("fc1", 256), JL.Activation("a1", "relu"),
        JL.Dense("out", 10)], input_shape=(32,))
    pm = model_from_reference(jm)
    jparams, _ = j_init_model(jm, seed=0)
    params = torch_tree(jparams)
    drops = {"fc1": np.arange(128, 256)}
    assert PM.blocksparse_sites(pm, params, drops, block=32) == {
        ("fc1", "w"): {"out_keep": (0, 1, 2, 3)}}
    wrapped = PM.blocksparse_params(pm, params, drops, block=32)
    assert isinstance(wrapped["out"]["w"], torch.Tensor)
    assert isinstance(wrapped["fc1"]["w"], PBS.BlockSparseWeight)
    assert isinstance(
        JM.blocksparse_params(jm, jparams, drops, block=32)["out"]["w"],
        JBS.BlockSparseWeight)
    # and the forward is the JAX package's all the same
    masks, _ = PM.drop_masks(pm, params, drops)
    x = np.random.default_rng(4).normal(size=(8, 32)).astype(np.float32)
    got, _ = pm.apply(PM.blocksparse_params(
        pm, PM.apply_masks(params, masks), drops, block=32),
        torch.from_numpy(x))
    j_masks, _ = JM.drop_masks(jm, jparams, drops)
    want, _ = jm.apply(JM.blocksparse_params(
        jm, JM.apply_masks(jparams, j_masks), drops, block=32),
        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_blocksparse_and_dense_trajectories_agree_on_bert_tiny():
    """The slice as a whole at a small size: score-free block drops on
    both MLPs of bert_tiny, Adam + ``masked_update``, 3 steps through
    the ``param_transform`` hook against the masked-dense steps, then
    one ``prune`` with the same indices."""
    jm = j_bert_tiny()
    pm = model_from_reference(jm)
    jparams, _ = j_init_model(jm, seed=2)
    params = torch_tree(jparams)
    drops = {"block1_mlp/fc1": list(range(32)),
             "block2_mlp/fc1": list(range(32, 64))}
    rng = np.random.default_rng(9)
    x = rng.integers(0, 128, size=(8, 16)).astype(np.int32)
    y = rng.integers(0, 2, size=(8,)).astype(np.int32)
    masks, _ = PM.drop_masks(pm, params, drops)
    tx = PO.chain(PO.adam(1e-2), PM.masked_update(masks))

    def run(tf):
        t = Trainer.create(pm, tx, p_ce, seed=0, device="cpu",
                           params=PM.apply_masks(params, masks),
                           param_transform=tf)
        return t, [float(t.step(x, y)) for _ in range(3)]

    dense, l_dense = run(None)
    sparse, l_sparse = run(PM.blocksparse_transform(pm, drops, block=32))
    np.testing.assert_allclose(l_sparse, l_dense, rtol=1e-5)
    _assert_trees(sparse.params, numpy_tree(dense.params), atol=5e-4,
                  rtol=1e-3)
    for t in (dense, sparse):
        assert (t.params["block1_mlp"]["fc1"]["w"][:, :32] == 0).all()
        assert (t.params["block1_mlp"]["fc1"]["b"][:32] == 0).all()
        assert (t.params["block1_mlp"]["fc2"]["w"][:32] == 0).all()
        assert (t.params["block2_mlp"]["fc2"]["w"][32:] == 0).all()
    # materialize: the pruned forward equals the masked forward
    xt = torch.from_numpy(x)
    y_masked, _ = pm.apply(sparse.params, xt)
    model, pruned = pm, sparse.params
    for layer, d in drops.items():
        res = PP.prune(model, pruned, layer, d)
        model, pruned = res.model, res.params
    assert model.widths()["block1_mlp/fc1"] == 32
    y_pruned, _ = model.apply(pruned, xt)
    np.testing.assert_allclose(y_masked.numpy(), y_pruned.numpy(), atol=1e-5)
    # rebuild carries the hook to the next trainer
    assert sparse.rebuild(model, pruned, {}, None).param_transform \
        is sparse.param_transform


def test_masked_adam_steps_match_optax_and_pin_zeros():
    jm = JSegmentedModel(
        (JL.Dense("fc1", 16), JL.Activation("r1", "relu"),
         JL.Dense("fc2", 12), JL.Activation("r2", "relu"),
         JL.Dense("out", 4)), (8,))
    pm = model_from_reference(jm)
    jparams, _ = j_init_model(jm, seed=0)
    drops = {"fc1": [2, 11]}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.int32)

    j_masks, _ = JM.drop_masks(jm, jparams, drops)
    j_tx = optax.chain(optax.adam(1e-2), JM.masked_update(j_masks))
    jp = JM.apply_masks(jparams, j_masks)
    jo = j_tx.init(jp)

    def j_loss(p):
        out, _ = jm.apply(p, jnp.asarray(x))
        return jnp.mean(j_ce(out, jnp.asarray(y)))

    for _ in range(5):
        u, jo = j_tx.update(jax.grad(j_loss)(jp), jo, jp)
        jp = optax.apply_updates(jp, u)

    params = torch_tree(jparams)
    masks, _ = PM.drop_masks(pm, params, drops)
    tx = PO.chain(PO.adam(1e-2), PM.masked_update(masks))
    trainer = Trainer.create(pm, tx, p_ce, seed=0, device="cpu",
                             params=PM.apply_masks(params, masks))
    for _ in range(5):
        trainer.step(x, y)
    _assert_trees(trainer.params, numpy_tree(jp), atol=1e-5, rtol=1e-4)
    w = trainer.params["fc1"]["w"].numpy()
    assert (w[:, [2, 11]] == 0).all() and (w[:, [0, 1]] != 0).any()
    assert (trainer.params["fc1"]["b"].numpy()[[2, 11]] == 0).all()
    assert (trainer.params["fc2"]["w"].numpy()[[2, 11]] == 0).all()


# -- simulate through the prune loop ------------------------------------------


def test_simulated_prune_loop_matches_structural_and_jax(tmp_path,
                                                         monkeypatch):
    def cfgs(module, **kw):
        base = module.get_preset("bert_glue_sensitivity", smoke=True)
        return [dataclasses.replace(base, simulate=sim,
                                    log_path=str(tmp_path / f"{tag}{sim}.csv"),
                                    **kw)
                for sim, tag in ((False, kw.get("name", "p")),
                                 (True, kw.get("name", "p")))]

    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jparams, _ = j_init_model(j_bert_tiny(), seed=seed)
        return params_from_numpy(numpy_tree(jparams), device=device), {}

    monkeypatch.setattr(PS, "init_model", jax_init)
    real, sim = (PPR.run_prune_retrain(c, verbose=False, device="cpu")
                 for c in cfgs(PPS))
    j_sim = JPR.run_prune_retrain(cfgs(JPS, name="j")[1], verbose=False)
    assert len(real) == len(sim) == len(j_sim) == 2
    full = model_from_reference(j_bert_tiny()).widths()
    for r, s, j in zip(real, sim, j_sim):
        assert r.layer == s.layer == j.layer
        assert r.n_dropped == s.n_dropped == j.n_dropped > 0
        assert s.widths == full == j.widths and r.widths != full
        assert s.n_params == j.n_params
        assert abs(r.post_acc - s.post_acc) <= 1e-6
        assert abs(r.post_loss - s.post_loss) <= 1e-5
        for f in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            assert abs(getattr(s, f) - getattr(j, f)) <= 1e-4, f


def test_simulate_with_finetune_still_raises():
    kw = dict(name="sim", dataset="synthetic", method="sensitivity",
              policy="fraction", fraction=0.25, log_path=os.devnull)
    assert ExperimentConfig(**kw, simulate=True).unported() == []
    for cls in (ExperimentConfig, JExperimentConfig):
        with pytest.raises(ValueError, match="masked_update"):
            cls(**kw, simulate=True, finetune_epochs=1)


# -- the kernels' launch plan and build ----------------------------------

#: phase 10's shapes and mfu_llama's GatedDense sites at B 8 x S 1024
#: (wg / wu: 1024 -> 4096 half the outputs kept; down: 4096 -> 1024 half
#: the inputs kept): (R, D, F, block, kept in-blocks, kept out-blocks);
#: bf16, and f32 (the 3xTF32 body) for the shapes named ``*_f32``
PLAN_SHAPES = {
    "fc1": (4096, 768, 3072, 128, 6, 12),
    "fc2": (4096, 3072, 768, 128, 12, 6),
    "both_axes": (1024, 4096, 4096, 128, 16, 16),
    "ragged": (4099, 768, 3072, 128, 6, 12),
    "block32": (1000, 256, 384, 32, 4, 6),
    "mfu_gate": (8192, 1024, 4096, 128, 8, 16),
    "mfu_down": (8192, 4096, 1024, 128, 16, 8),
}
PLAN_SHAPES.update({f"{k}_f32": PLAN_SHAPES[k]
                    for k in ("fc1", "fc2", "ragged", "block32")})
#: (body, tile_m, tile_n, stages, split, kept tiles) per shape and mode
PLAN_WANT = {
    ("fc1", "fwd"): ("wgmma", 128, 192, 4, 1, 256),
    ("fc1", "dx"): ("wgmma", 128, 192, 4, 1, 128),
    ("fc1", "dw"): ("wgmma", 128, 192, 4, 2, 48),
    ("fc2", "fwd"): ("wgmma", 128, 192, 4, 1, 128),
    ("fc2", "dx"): ("wgmma", 128, 192, 4, 1, 256),
    ("fc2", "dw"): ("wgmma", 128, 192, 4, 2, 48),
    ("both_axes", "fwd"): ("wgmma", 128, 128, 6, 1, 128),
    ("both_axes", "dx"): ("wgmma", 128, 128, 6, 1, 128),
    ("both_axes", "dw"): ("wgmma", 128, 128, 6, 1, 256),
    ("ragged", "fwd"): ("wgmma", 128, 192, 4, 1, 264),
    ("ragged", "dx"): ("wgmma", 128, 192, 4, 1, 132),
    ("ragged", "dw"): ("wgmma", 128, 192, 4, 2, 48),
    ("block32", "fwd"): ("wmma", 64, 32, 1, 1, 192),
    ("block32", "dx"): ("wmma", 64, 32, 1, 1, 128),
    ("block32", "dw"): ("wmma", 32, 32, 1, 1, 96),
    ("mfu_gate", "fwd"): ("wgmma", 128, 192, 4, 1, 704),
    ("mfu_gate", "dx"): ("wgmma", 128, 192, 4, 1, 384),
    ("mfu_gate", "dw"): ("wgmma", 128, 128, 6, 1, 128),
    ("mfu_down", "fwd"): ("wgmma", 128, 192, 4, 1, 384),
    ("mfu_down", "dx"): ("wgmma", 128, 192, 4, 1, 704),
    ("mfu_down", "dw"): ("wgmma", 128, 128, 6, 1, 128),
    ("fc1_f32", "fwd"): ("tf32x3", 128, 128, 3, 1, 384),
    ("fc1_f32", "dx"): ("tf32x3", 128, 128, 3, 1, 192),
    ("fc1_f32", "dw"): ("tf32x3", 128, 128, 3, 8, 72),
    ("fc2_f32", "fwd"): ("tf32x3", 128, 128, 3, 1, 192),
    ("fc2_f32", "dx"): ("tf32x3", 128, 128, 3, 1, 384),
    ("fc2_f32", "dw"): ("tf32x3", 128, 128, 3, 8, 72),
    ("ragged_f32", "fwd"): ("tf32x3", 128, 128, 3, 1, 396),
    ("ragged_f32", "dx"): ("tf32x3", 128, 128, 3, 1, 198),
    ("ragged_f32", "dw"): ("tf32x3", 128, 128, 3, 8, 72),
    ("block32_f32", "fwd"): ("tf32x3", 128, 32, 3, 1, 48),
    ("block32_f32", "dx"): ("tf32x3", 128, 32, 3, 1, 32),
    ("block32_f32", "dw"): ("tf32x3", 32, 32, 3, 4, 24),
}


@pytest.mark.parametrize("shape,mode", sorted(PLAN_WANT))
def test_plan_at_the_path_shapes(shape, mode):
    """The plan a call takes at phase 10's and mfu_llama's shapes (bf16,
    and f32 for the ``*_f32`` shapes), and what holds for every plan:
    tiles cover the kept output, the ring fits in 227 KB, wgmma's fwd /
    dx run at most 132 CTAs, dW one cluster (of 1, 2, 4 or 8) per tile
    with at least 4 ring stages a rank; the 3xTF32 body one CTA (dW: one
    cluster) per output tile of the whole output, inside one block."""
    R, D, F, block, n_in, n_out = PLAN_SHAPES[shape]
    dtype = torch.float32 if shape.endswith("_f32") else torch.bfloat16
    p = PBS.plan(mode, R, D, F, block, n_in, n_out, dtype)
    assert (p.body, p.tile_m, p.tile_n, p.stages, p.split, p.tiles) \
        == PLAN_WANT[(shape, mode)]
    rows = D if mode == "dw" else R
    cols = D if mode == "dx" else F
    if p.body == "wmma":  # the earlier wmma body: static shared memory
        assert p.smem_bytes == 0 and p.ctas == p.tiles
        assert p.tiles == -(-rows // p.tile_m) * (cols // p.tile_n)
        return
    kept_rows = n_in * block if mode == "dw" else R
    kept_cols = (n_in if mode == "dx" else n_out) * block
    assert p.tiles == -(-kept_rows // p.tile_m) * -(-kept_cols // p.tile_n)
    assert p.smem_bytes <= 232448
    if mode == "dw":
        assert p.split in (1, 2, 4, 8)
        steps = -(-R // (64 if p.body == "wgmma" else 32))
        assert steps >= 4 * p.split or p.split == 1
    if p.body == "tf32x3":
        assert block % p.tile_n == 0 and p.stages == 3
        assert mode != "dw" or block % p.tile_m == 0
        assert p.ctas == -(-rows // p.tile_m) * (cols // p.tile_n) * p.split
        assert p.smem_bytes == 4 * 3 * PBS.tf_stage_floats(
            mode, p.tile_m, p.tile_n)
        assert p.smem_bytes >= p.tile_m * p.tile_n * 4  # dW's partial
        return
    assert 2 <= p.stages <= 8
    stage = (p.tile_m + p.tile_n) * 64 * 2
    assert p.smem_bytes >= p.stages * stage + p.tile_m * p.tile_n * 2
    if mode == "dw":
        assert p.ctas == p.tiles * p.split
        assert p.stages * stage >= p.tile_m * p.tile_n * 4  # the partial
    else:
        assert p.split == 1 and p.ctas == 132


@pytest.mark.parametrize("mode", ["fwd", "dx", "dw"])
def test_plan_bodies_by_dtype_and_block(mode):
    """f32 takes the 3xTF32 body at every block that is a multiple of 32,
    its tiles inside one block (128 x 128 at fc1; at most 64 or 32
    columns on blocks that 128 or 64 does not divide); bf16 takes the wgmma body on every
    multiple of 64 (64, 192: 64-wide chunks) and the wmma body on odd
    multiples of 32; a shape no body takes raises."""
    f32 = PBS.plan(mode, 4096, 768, 3072, 128, 6, 12, torch.float32)
    assert f32.body == "tf32x3" and f32.stages == 3
    assert (f32.tile_m, f32.tile_n) == (128, 128)
    assert f32.split == (8 if mode == "dw" else 1)
    for block, width in ((64, 64), (192, 64), (32, 32), (96, 32)):
        p = PBS.plan(mode, 300, 768, 1536, block, 1, 2, torch.float32)
        assert p.body == "tf32x3" and p.tile_n <= width
        assert block % p.tile_n == 0
        assert block % p.tile_m == 0 if mode == "dw" else p.tile_m == 128
    for block in (64, 192, 256):
        p = PBS.plan(mode, 300, 768, 1536, block, 1, 2)
        assert p.body == "wgmma" and p.tile_m == 128
    for block in (32, 96):
        p = PBS.plan(mode, 300, 768, 1536, block, 1, 2)
        assert p.body == "wmma"
        assert (p.tile_m, p.tile_n) == ((32, 32) if mode == "dw"
                                        else (64, 32))
    for bad in ((0, 768, 1536, 128, 1, 1), (64, 768, 1536, 48, 1, 1),
                (64, 768, 1536, 128, 7, 1), (64, 768, 1000, 128, 1, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="no block-sparse body"):
                PBS.plan(mode, *bad, dtype)


def test_plan_width_and_split_follow_the_cost_model():
    """The tile width and dW's split minimize rounds of 132 CTAs x (ring
    stages x (128 + width) + a fixed cost) over widths 64 / 128 / 192
    and splits 1 / 2 / 4 / 8: spelled out at fc1's dW, where 48 tiles of
    192 split 2 fill one round of 96 CTAs."""
    steps, fixed = 4096 // 64, 6 * 256
    cost = {}
    for bn in (64, 128, 192):
        tiles = (768 // 128) * (1536 // bn)
        for s in (1, 2, 4, 8):
            cost[(bn, s)] = -(-tiles * s // 132) * (
                -(-steps // s) * (128 + bn) + fixed)
    best = min(cost, key=lambda k: (cost[k], k[0], k[1]))
    p = PBS.plan("dw", 4096, 768, 3072, 128, 6, 12)
    assert best == (192, 2) == (p.tile_n, p.split)
    # a row count too short to give each of two ranks 4 stages is not split
    assert PBS.plan("dw", 64 * 7, 768, 3072, 128, 6, 12).split == 1


def test_f32_plan_tile_and_split_follow_the_cost_model():
    """The 3xTF32 body's tile and dW split minimize the same cost as the
    wgmma body's, over stages of 32 contracted elements: spelled out at
    fc1's dW, where 72 tiles of 128 x 128 split 8 (5 rounds of 132 CTAs
    of 16 stages) beat split 4 (3 rounds of 32) and no split (1 round of
    128); a 64-wide block leaves only the 64 x 64 tile."""
    steps, fixed = 4096 // 32, 6 * 256
    cost = {}
    for bm, bn in ((128, 128), (128, 64), (64, 64), (32, 32)):
        tiles = (768 // bm) * (1536 // bn)
        for s in (1, 2, 4, 8):
            cost[(bm, bn, s)] = -(-tiles * s // 132) * (
                -(-steps // s) * (bm + bn) + fixed)
    best = min(cost, key=lambda k: (cost[k], -k[0], -k[1], k[2]))
    p = PBS.plan("dw", 4096, 768, 3072, 128, 6, 12, torch.float32)
    assert best == (128, 128, 8) == (p.tile_m, p.tile_n, p.split)
    p = PBS.plan("dw", 4096, 768, 3072, 64, 12, 24, torch.float32)
    assert (p.tile_m, p.tile_n) == (64, 64)
    # a row count too short to give each of two ranks 4 stages is not split
    assert PBS.plan("dw", 32 * 7, 768, 3072, 128, 6, 12,
                    torch.float32).split == 1


def _banks_distinct(words, width=1):
    """A warp's shared read of ``width`` consecutive 4-byte words from
    each lane's ``words[lane]`` runs in phases of 32 / width lanes; True
    when each phase hits 32 distinct banks."""
    lanes = 32 // width
    for p0 in range(0, 32, lanes):
        banks = [(w + i) % 32 for w in words[p0:p0 + lanes]
                 for i in range(width)]
        if len(set(banks)) != 32:
            return False
    return True


@pytest.mark.parametrize("mode", ["fwd", "dx", "dw"])
@pytest.mark.parametrize("tile", [(128, 128), (128, 64), (128, 32),
                                  (64, 64), (32, 32)])
def test_tf32x3_fragment_reads_hit_distinct_banks(mode, tile):
    """Every shared-memory fragment read of the 3xTF32 body, lane by lane
    (g = lane // 4, t = lane % 4; contracted elements k2 = 8 kk + 2t and
    k2 + 1 are k-indices t and t + 4), at the pitches of
    ``tf_pitches``: a K-contiguous operand (fwd / dx A, dx B) as one
    8-byte load of rows g (+ 8), the others (dW A, fwd / dW B) as 4-byte
    loads of rows k2 and k2 + 1."""
    bm, bn = tile
    pa, pb = PBS.tf_pitches(mode, bm, bn)
    assert PBS.tf_stage_floats(mode, bm, bn) == (
        (32 if mode == "dw" else bm) * pa + (bn if mode == "dx" else 32) * pb)
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for kk in range(4):
        for g8 in (0, 8):  # rows g and g + 8 of each m16 tile
            wtm = 64 if min(bm, bn) >= 64 else 32  # a warp's rows
            for m in range(0, wtm, 16):  # a warp's m16 tiles
                if mode == "dw":
                    for e in (0, 1):
                        assert _banks_distinct(
                            [(8 * kk + 2 * t + e) * pa + m + g + g8
                             for g, t in lanes])
                else:
                    assert _banks_distinct(
                        [(m + g + g8) * pa + 8 * kk + 2 * t
                         for g, t in lanes], 2)
        for n in range(0, 32, 8):  # a warp's n8 tiles: columns n + g
            if mode == "dx":
                assert _banks_distinct([(n + g) * pb + 8 * kk + 2 * t
                                        for g, t in lanes], 2)
            else:
                for e in (0, 1):
                    assert _banks_distinct(
                        [(8 * kk + 2 * t + e) * pb + n + g
                         for g, t in lanes])
    # every row starts 16-byte aligned (whole 16-byte cp.async copies)
    assert pa % 4 == 0 and pb % 4 == 0


def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by a digest of its source, every ``csrc/*.cuh``
    header and the flags: editing a header the source includes must
    change the library's name, so a stale build is never loaded."""
    from torchpruner_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    first = _build._target("k")
    assert first.parent == tmp_path / "_build"
    assert _build._target("k") == first  # a pure function of the files
    (csrc / "h.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (csrc / "other.cuh").write_text("// a new header\n")
    assert _build._target("k") not in (first, second)
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k").name.startswith("libk-")


def test_ab_build_refuses_an_old_source_without_its_headers(tmp_path,
                                                            monkeypatch):
    """An A/B's earlier source compiles against the headers beside it,
    never the package's ``csrc/``: one whose quoted include (directly or
    through a header) is not beside it is refused before ``nvcc`` runs."""
    from torchpruner_tpu_torch.experiments import _ab
    from torchpruner_tpu_torch.ops import _build

    def no_nvcc():
        raise AssertionError("nvcc ran on a source missing its header")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    old = tmp_path / "rev"
    old.mkdir()
    src = old / "k.cu"
    src.write_text('#include <cstdint>\n#include "h.cuh"\n')
    assert _ab.missing_includes(src) == [str(old / "h.cuh")]
    with pytest.raises(FileNotFoundError, match="h.cuh"):
        _ab.build_library(str(src), "k_old")
    (old / "h.cuh").write_text('#pragma once\n#include "deep.cuh"\n')
    assert _ab.missing_includes(src) == [str(old / "deep.cuh")]
    (old / "deep.cuh").write_text('#include "h.cuh"\n')  # a cycle ends
    assert _ab.missing_includes(src) == []
