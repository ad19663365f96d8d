"""The port's remat, gradient accumulation and multi-step training
against the JAX package's, and against the port's own plain step, on the
CPU.

Seeded numpy inputs and the JAX init weights (carried over with
``convert.params_from_numpy``) go through both packages:

- ``accum_steps=4`` against the full batch (the port's own step) and
  against the JAX package's ``accum_steps=4``; a batch that does not
  divide raises "divisible";
- remat on ``llama_tiny(depth=2)`` against the JAX package's remat and
  the port without it; with the MoE aux loss (``llama_moe_tiny``); with
  BatchNorm inside a recomputed block (running statistics updated
  once); at dropout > 0 (the same masks, gradients and final generator
  state as without remat);
- ``multi_step`` against sequential steps and against the JAX package's
  ``multi_step`` (BatchNorm state threading through the steps);
- the prune loop's retrain drops a ragged tail batch under
  ``accum_steps`` > 1, as the JAX loop does.

Tolerances: trajectories agree to rtol 1e-5 (and atol 1e-6 on params)
across the packages, as the JAX package's own remat and accumulation
tests hold them; remat against no remat and ``multi_step`` against
sequential steps in the port are bit-equal (the same operations in the
same order); records of the prune loop to 1e-4, as its other tests.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core.segment import SegmentedModel as JModel
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.data import synthetic_dataset
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.models import llama_moe_tiny as j_llama_moe_tiny
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.train.loop import Trainer as JTrainer
from torchpruner_tpu.utils.config import ExperimentConfig as JConfig
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu.utils.losses import lm_cross_entropy_loss as j_lm
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.data import load_dataset
from torchpruner_tpu_torch.experiments import prune_retrain as PPR
from torchpruner_tpu_torch.train import optim
from torchpruner_tpu_torch.train.loop import Trainer
from torchpruner_tpu_torch.utils.config import ExperimentConfig
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss as p_lm
from torchpruner_tpu_torch.utils.tree import tree_leaves, tree_map

RTOL = 1e-5
ATOL = 1e-6


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_tree(tree):
    return params_from_numpy(numpy_tree(tree), device="cpu")


def _trees_close(got, want, rtol=RTOL, atol=ATOL):
    """A port tree against a JAX tree, leaf by leaf under the same
    keys."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_close(got[k], want[k], rtol, atol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def _mlp():
    return JModel((JL.Dense("fc1", 32), JL.Activation("r1", "relu"),
                   JL.Dense("out", 4)), (8,))


def _bn_mlp():
    return JModel((JL.Dense("fc1", 16), JL.BatchNorm("bn1"),
                   JL.Activation("r1", "relu"), JL.Dense("out", 4)), (8,))


def _pair(jm, seed=0):
    """``(port model, JAX params, JAX state)`` from the JAX init."""
    jparams, jstate = j_init_model(jm, seed=seed)
    return model_from_reference(jm), jparams, jstate


def _port_trainer(pm, jparams, jstate, tx, loss, **kw):
    return Trainer.create(pm, tx, loss, seed=0, params=torch_tree(jparams),
                          state=torch_tree(jstate), device="cpu", **kw)


def _jax_trainer(jm, jparams, jstate, tx, loss, **kw):
    """A JAX trainer on copies (its step donates the params' buffers)."""
    copy = functools.partial(jax.tree_util.tree_map, jnp.copy)
    return JTrainer.create(jm, tx, loss, seed=0, params=copy(jparams),
                           state=copy(jstate), **kw)


def test_accumulation_matches_full_batch_and_jax():
    """``accum_steps=4`` on a 64-row batch: 3 SGD-momentum steps equal
    the full-batch steps (rtol 1e-5: the summed microbatch gradients
    differ from the full batch's by rounding) and the JAX package's
    ``accum_steps=4``."""
    jm = _mlp()
    pm, jparams, jstate = _pair(jm)
    x, y = synthetic_dataset((8,), 4, 64, seed=0).batches(64)[0]

    def port(accum):
        t = _port_trainer(pm, jparams, jstate,
                          optim.sgd(1e-2, momentum=0.9), p_ce,
                          accum_steps=accum)
        return [float(t.step(x, y)) for _ in range(3)], t.params

    l1, p1 = port(1)
    l4, p4 = port(4)
    jt = _jax_trainer(jm, jparams, jstate, optax.sgd(1e-2, momentum=0.9),
                      j_ce, accum_steps=4)
    jl = [float(jt.step(jnp.asarray(x), jnp.asarray(y))) for _ in range(3)]
    np.testing.assert_allclose(l4, l1, rtol=RTOL)
    np.testing.assert_allclose(l4, jl, rtol=RTOL)
    for a, b in zip(tree_leaves(p4), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    _trees_close(p4, jt.params)
    t = _port_trainer(pm, jparams, jstate, optim.sgd(1e-2), p_ce,
                      accum_steps=3)
    with pytest.raises(ValueError, match="divisible"):
        t.step(x, y)


def test_accumulation_threads_batchnorm_state_in_order():
    """BatchNorm's running statistics go through the 4 microbatches in
    order, as the JAX package's scan carries them (rtol 1e-5).  SGD: the
    bias ahead of BatchNorm has a gradient of exactly 0 in exact
    arithmetic, which Adam would turn from rounding noise into +-lr
    steps that differ between the packages."""
    jm = _bn_mlp()
    pm, jparams, jstate = _pair(jm)
    x, y = synthetic_dataset((8,), 4, 32, seed=1).batches(32)[0]
    t = _port_trainer(pm, jparams, jstate, optim.sgd(1e-2, momentum=0.9),
                      p_ce, accum_steps=4)
    jt = _jax_trainer(jm, jparams, jstate, optax.sgd(1e-2, momentum=0.9),
                      j_ce, accum_steps=4)
    for _ in range(2):
        np.testing.assert_allclose(
            float(t.step(x, y)),
            float(jt.step(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)
    _trees_close(t.params, jt.params)
    _trees_close(t.state, jt.state)


def _tokens(n=4, s=16, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(n, s)).astype(np.int32)


def test_remat_matches_jax_remat_and_no_remat():
    """3 Adam steps on ``llama_tiny(depth=2)``: remat in the port is
    bit-equal to no remat, and within rtol 1e-5 of the JAX package's
    remat."""
    jm = j_llama_tiny(depth=2)
    pm, jparams, jstate = _pair(jm)
    x = _tokens()

    def port(remat):
        t = _port_trainer(pm, jparams, jstate, optim.adam(1e-3), p_lm,
                          remat=remat)
        return [float(t.step(x, x)) for _ in range(3)], t.params

    l0, p0 = port(False)
    l1, p1 = port(True)
    assert l0 == l1
    _trees_equal(p0, p1)
    jt = _jax_trainer(jm, jparams, jstate, optax.adam(1e-3), j_lm,
                      remat=True)
    jl = [float(jt.step(jnp.asarray(x), jnp.asarray(x))) for _ in range(3)]
    np.testing.assert_allclose(l1, jl, rtol=RTOL)
    _trees_close(p1, jt.params, atol=RTOL)


def test_remat_recomputes_each_block_in_the_backward():
    """The structural check: with remat a step runs each Residual
    block's forward twice (once in the backward), without it once."""
    pm, jparams, jstate = _pair(j_llama_tiny(depth=2))
    x = torch.from_numpy(_tokens())
    calls = {"n": 0}
    from torchpruner_tpu_torch.core import layers as PL

    orig = PL.attention_core

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    def run(remat):
        calls["n"] = 0
        params = torch_tree(jparams)
        for t in tree_leaves(params):
            t.requires_grad_()
        out, _ = pm.apply(params, x, train=True, remat=remat)
        p_lm(out, x).mean().backward()
        return calls["n"]

    PL.attention_core = counted
    try:
        assert run(False) == 2 and run(True) == 4  # 2 blocks
    finally:
        PL.attention_core = orig


def test_remat_keeps_the_moe_aux_loss():
    """``llama_moe_tiny``: the aux losses are block outputs under remat,
    equal to those without it, and the training loss and gradients with
    ``moe_aux_weight`` are bit-equal; the JAX package's remat gives the
    same aux losses (rtol 1e-5)."""
    jm = j_llama_moe_tiny()
    pm, jparams, _ = _pair(jm)
    x = _tokens(seed=3)
    xt = torch.from_numpy(x)

    def port(remat):
        params = torch_tree(jparams)
        for t in tree_leaves(params):
            t.requires_grad_()
        out, _, aux = pm.apply(params, xt, train=True, collect_aux=True,
                               remat=remat)
        loss = p_lm(out, xt).mean() + 0.5 * sum(aux.values())
        loss.backward()
        return ({k: float(v.detach()) for k, v in aux.items()},
                float(loss.detach()),
                [t.grad for t in tree_leaves(params)])

    aux0, l0, g0 = port(False)
    aux1, l1, g1 = port(True)
    assert aux0 == aux1 and set(aux1) == {"block1_moe/experts",
                                          "block2_moe/experts"}
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    _, _, jaux = jm.apply(jparams, jnp.asarray(x), train=True,
                          collect_aux=True, remat=True)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux1[k], float(v), rtol=RTOL)


def _bn_block_model():
    from torchpruner_tpu_torch.core import layers as PL

    return PS.SegmentedModel((
        PL.Dense("fc1", 16),
        PL.Residual("blk", body=(PL.Dense("inner", 16), PL.BatchNorm("bn"),
                                 PL.Activation("r", "relu"),
                                 PL.Dropout("drop", 0.3),
                                 PL.Dense("proj", 16))),
        PL.Dense("out", 4)), (8,))


def test_remat_updates_batchnorm_statistics_once():
    """BatchNorm inside a recomputed block: after a step the running
    statistics are ``decay * running + (1 - decay) * batch`` of the
    first forward, once (the recomputation's are discarded), and equal
    to those without remat; so are the losses and params (bit-equal)."""
    model = _bn_block_model()
    x, y = synthetic_dataset((8,), 4, 32, seed=2).batches(32)[0]

    def run(remat):
        t = Trainer.create(model, optim.adam(1e-2), p_ce, seed=0,
                           device="cpu", remat=remat)
        start = {k: v.clone() for k, v in t.state["blk"]["bn"].items()}
        with torch.no_grad():
            h = model.apply(t.params, torch.from_numpy(x),
                            to_layer="fc1")[0]
            z = h @ t.params["blk"]["inner"]["w"] \
                + t.params["blk"]["inner"]["b"]
        loss = float(t.step(x, y))
        return t, start, z, loss

    t0, _, _, l0 = run(False)
    t1, start, z, l1 = run(True)
    d = model.layer("blk/bn").decay
    want = {"mean": d * start["mean"] + (1 - d) * z.mean(0),
            "var": d * start["var"] + (1 - d) * z.var(0, correction=0)}
    for k in ("mean", "var"):
        torch.testing.assert_close(t1.state["blk"]["bn"][k], want[k],
                                   rtol=1e-6, atol=1e-7)
        assert torch.equal(t1.state["blk"]["bn"][k], t0.state["blk"]["bn"][k])
    assert l0 == l1
    _trees_equal(t0.params, t1.params)


def test_remat_replays_the_dropout_masks():
    """At dropout 0.3 inside a recomputed block: the forward's output,
    every gradient (the backward uses the recomputation's mask) and the
    generator's state afterwards are bit-equal to those without remat;
    a different mask would move all three."""
    model = _bn_block_model()
    params, state = PS.init_model(model, seed=0, device="cpu")
    x = torch.from_numpy(
        synthetic_dataset((8,), 4, 32, seed=4).batches(32)[0][0])

    def run(remat, seed=7):
        p = tree_map(lambda t: t.clone().requires_grad_(), params)
        gen = torch.Generator().manual_seed(seed)
        y, _ = model.apply(p, x, state=state, train=True, rng=gen,
                           remat=remat)
        y.square().sum().backward()
        return y.detach(), [t.grad for t in tree_leaves(p)], gen.get_state()

    y0, g0, s0 = run(False)
    y1, g1, s1 = run(True)
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)
    # another seed draws other masks: the output moves
    assert not torch.equal(y0, run(True, seed=8)[0])


def test_multi_step_matches_sequential_steps_and_jax():
    """3 SGD steps on a BatchNorm MLP as ``multi_step`` over stacked
    batches: bit-equal to 3 ``step`` calls in the port, and within rtol
    1e-5 of the JAX package's ``multi_step`` (losses, params, state)."""
    jm = _bn_mlp()
    pm, jparams, jstate = _pair(jm)
    batches = synthetic_dataset((8,), 4, 96, seed=0).batches(32)
    xs = np.stack([b[0] for b in batches])
    ys = np.stack([b[1] for b in batches])
    tx = optim.sgd(1e-2, momentum=0.9)
    seq = _port_trainer(pm, jparams, jstate, tx, p_ce)
    seq_losses = torch.stack([seq.step(x, y) for x, y in batches])
    multi = _port_trainer(pm, jparams, jstate, tx, p_ce)
    losses = multi.multi_step(xs, ys)
    assert torch.equal(losses, seq_losses)
    _trees_equal(multi.params, seq.params)
    _trees_equal(multi.state, seq.state)
    assert torch.equal(multi.rng.get_state(), seq.rng.get_state())
    assert multi.step_count == 3
    jt = _jax_trainer(jm, jparams, jstate, optax.sgd(1e-2, momentum=0.9),
                      j_ce)
    jl = jt.multi_step(jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=RTOL)
    _trees_close(multi.params, jt.params)
    _trees_close(multi.state, jt.state)


def test_prune_retrain_drops_a_ragged_tail_under_accumulation(monkeypatch):
    """Taylor on the digits MLP, one fine-tune epoch a target on 69
    training examples at B 32 and ``accum_steps`` 2: the 5-example tail
    would not split in two, so both loops drop it (2 steps an epoch)
    and their records agree to 1e-4, from the JAX initial weights."""
    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jp, js = j_init_model(JPR.MODEL_REGISTRY["digits_fc_tiny"][0](),
                              seed=seed)
        return torch_tree(jp), torch_tree(js)

    monkeypatch.setattr(PS, "init_model", jax_init)
    kw = dict(name="accum", model="digits_fc_tiny", dataset="digits_flat",
              method="taylor", fraction=0.25, finetune_epochs=1,
              batch_size=32, accum_steps=2, optimizer="sgd", lr=0.05,
              momentum=0.9, score_examples=64, eval_batch_size=64)
    datasets = tuple(load_dataset("digits_flat", split, n=n)
                     for split, n in (("train", 69), ("val", 64),
                                      ("test", 128)))
    batch_rows = []
    orig = Trainer.step

    def step(self, x, y):
        batch_rows.append(len(x))
        return orig(self, x, y)

    monkeypatch.setattr(Trainer, "step", step)
    got = PPR.run_prune_retrain(ExperimentConfig(**kw), datasets=datasets,
                                verbose=False, device="cpu")
    want = JPR.run_prune_retrain(JConfig(**kw), datasets=datasets,
                                 verbose=False)
    assert batch_rows == [32, 32] * len(got)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.layer == w.layer and g.n_dropped == w.n_dropped
        assert g.widths == w.widths
        for k in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            assert abs(getattr(g, k) - getattr(w, k)) <= 1e-4, k


def test_config_runs_remat_accumulation_and_augment():
    """``remat``, ``accum_steps`` > 1 and ``augment`` are no longer
    unported settings."""
    cfg = ExperimentConfig(remat=True, accum_steps=4, augment=True)
    assert cfg.unported() == []
    assert dataclasses.replace(cfg, run_dir="x").unported() == []
    # the sweep's figures are ported too: no setting is left unported
    assert dataclasses.replace(cfg, plot_dir="x").unported() == []
