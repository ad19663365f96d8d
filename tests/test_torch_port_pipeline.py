"""The port's pipeline parallelism (``parallel/pipeline.py`` and
``parallel/pp_spmd.py``) against the JAX package's on the CPU.

- ``balance_stages``, ``_layer_param_count`` and ``_1f1b_schedule``
  equal to the JAX functions' exactly;
- ``PipelineParallel`` (stages on CPU devices in this process) from the
  JAX init: the forward, SGD and Adam training, the 1F1B issue order and
  ``max_live_residuals[s] <= n_stages - s``, BatchNorm state threaded
  through the microbatches, against the JAX ``PipelineParallel``;
- ``pp_spmd_apply`` / ``pp_spmd_train_step`` in a spawned world of 4
  gloo ranks (meshes ``{"pp": 4}`` and ``{"pp": 2, "data": 2}``) against
  the JAX functions on the conftest's CPU devices: forwards at V 1 and
  V 2 (the ragged wave too), gradients, train steps at V 1 and V 2,
  remat, a data axis, ViT and BERT stacks, a uniform prune, Dropout
  with and without an rng, the refusals;
- the two-process pipeline of ``test_multiprocess.py``: 2 gloo ranks on
  ``{"pp": 2}``, depth 4 and depth 8 interleaved, against the JAX
  single-device trajectories.

Tolerances are the JAX tests' own (``test_pp_spmd.py``,
``test_pipeline.py``): pp_spmd forwards rtol / atol 2e-5 against the
port's plain forward (the JAX test's check) and rtol 2e-5 of the output
scale against the JAX pipelined forward (eight blocks of f32 sums in
other orders sit a few 1e-5 apart at the smallest logits), gradients
rtol 2e-4 / atol 2e-5, train-step losses rtol 1e-4 / atol 1e-6;
``PipelineParallel`` forwards 2e-5, losses and params after SGD 1e-5,
BatchNorm state 1e-5, Adam LM losses rtol 1e-4.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

from test_torch_port_parallel_train import _flat, _np_tree, run_world

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6


def _tokens(batch, seed=0, vocab=256, S=16):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, S)).astype(np.int32)


def _j_llama(depth):
    from torchpruner_tpu.core.segment import init_model
    from torchpruner_tpu.models import llama_tiny

    model = llama_tiny(depth=depth)
    params, _ = init_model(model, seed=0)
    return model, _np_tree(params)


# ------------------------------------------------ stage plans, in process


def _plan(fn, model, n):
    """``fn(model, n)``, or the message it raised."""
    try:
        return fn(model, n)
    except ValueError as e:
        return str(e)


def test_balance_stages_and_schedule_equal_jax():
    from torchpruner_tpu import models as JM
    from torchpruner_tpu.parallel import pipeline as JP
    from torchpruner_tpu_torch import models as PM
    from torchpruner_tpu_torch.parallel import pipeline as PP

    for name, kw in (("llama_tiny", {"depth": 4}), ("bert_tiny", {}),
                     ("vit_tiny", {}), ("fmnist_convnet", {}),
                     ("llama_moe_tiny", {})):
        jm, pm = getattr(JM, name)(**kw), getattr(PM, name)(**kw)
        assert [PP._layer_param_count(s, shp[0])
                for s, shp in zip(pm.layers, pm.shapes)] == [
            JP._layer_param_count(s, shp[0])
            for s, shp in zip(jm.layers, jm.shapes)]
        for n in range(1, min(len(pm.layers), 6) + 1):
            assert _plan(PP.balance_stages, pm, n) == _plan(
                JP.balance_stages, jm, n)
    fc = (12, (16, 16, 16), 3)
    assert PP.balance_stages(PM.fc_net(*fc), 3) == JP.balance_stages(
        JM.fc_net(*fc), 3)
    for S, M in [(2, 4), (4, 8), (3, 2), (4, 1), (1, 3), (5, 7)]:
        assert PP._1f1b_schedule(S, M) == [
            list(s) for s in JP._1f1b_schedule(S, M)]
    with pytest.raises(ValueError, match="out of range"):
        PP.balance_stages(PM.fc_net(*fc), 99)


def _pp_pair(n_stages, n_micro, tx_name=None, lr=0.1, *, jax_model,
             port_model, loss=None):
    """The JAX and the port ``PipelineParallel`` from the JAX init."""
    import jax

    from torchpruner_tpu.core.segment import init_model
    from torchpruner_tpu.parallel.pipeline import PipelineParallel as JPP
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.parallel.pipeline import PipelineParallel

    jm, pm = jax_model, port_model
    params, state = init_model(jm, seed=0)
    jtx = ptx = None
    if tx_name is not None:
        import optax

        from torchpruner_tpu_torch.train import optim

        jtx, ptx = getattr(optax, tx_name)(lr), getattr(optim, tx_name)(lr)
    jl, pl = loss if loss is not None else (None, None)
    j = JPP.create(jm, n_stages, loss_fn=jl, tx=jtx,
                   devices=jax.devices()[:n_stages], params=params,
                   state=state, n_microbatches=n_micro)
    p = PipelineParallel.create(
        pm, n_stages, loss_fn=pl, tx=ptx, devices=["cpu"] * n_stages,
        params=params_from_numpy(_np_tree(params), device="cpu"),
        state=params_from_numpy(_np_tree(state), device="cpu"),
        n_microbatches=n_micro)
    return j, p


def test_pipeline_parallel_forward_matches_jax():
    from torchpruner_tpu import models as JM
    from torchpruner_tpu_torch import models as PM

    fc = (20, (32, 32, 32), 5)
    x = np.random.default_rng(1).normal(size=(8, 20)).astype(np.float32)
    j, p = _pp_pair(4, 2, jax_model=JM.fc_net(*fc),
                    port_model=PM.fc_net(*fc))
    np.testing.assert_allclose(p.forward(x).numpy(),
                               np.asarray(j.forward(x)), atol=FWD_TOL)
    j, p = _pp_pair(3, 2, jax_model=JM.llama_tiny(depth=4),
                    port_model=PM.llama_tiny(depth=4))
    t = _tokens(4)
    np.testing.assert_allclose(p.forward(t).numpy(),
                               np.asarray(j.forward(t)), atol=FWD_TOL)
    assert p.spans == j.spans


def test_pipeline_parallel_training_matches_jax():
    """One SGD step of ``fc_net`` over 2 stages and 4 microbatches (loss
    and every param), then 8 microbatches: the issued 1F1B order and the
    live residual bound; Adam on llama_tiny for 5 steps."""
    from torchpruner_tpu import models as JM
    from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
    from torchpruner_tpu.utils.losses import lm_cross_entropy_loss as j_lm
    from torchpruner_tpu_torch import models as PM
    from torchpruner_tpu_torch.parallel.pipeline import _1f1b_schedule
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss as p_lm

    fc = (12, (16, 16), 3)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = (np.arange(8) % 3).astype(np.int32)
    j, p = _pp_pair(2, 4, "sgd", jax_model=JM.fc_net(*fc),
                    port_model=PM.fc_net(*fc), loss=(j_ce, p_ce))
    lj, lp = j.train_step(x, y), p.train_step(x, y)
    assert abs(lp - lj) < 1e-5
    got, want = _flat(_np_tree(p.gather_params())), _flat(
        _np_tree(j.gather_params()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                   err_msg=str(k))

    fc = (12, (16, 16, 16), 3)
    x = rng.normal(size=(16, 12)).astype(np.float32)
    y = (np.arange(16) % 3).astype(np.int32)
    j, p = _pp_pair(2, 8, "sgd", jax_model=JM.fc_net(*fc),
                    port_model=PM.fc_net(*fc), loss=(j_ce, p_ce))
    assert abs(p.train_step(x, y) - j.train_step(x, y)) < 1e-5
    stats = p.last_step_stats
    assert stats["schedule"] == "1f1b" and stats["host_syncs"] == 1
    assert stats["issued"] == _1f1b_schedule(2, 8) == [
        list(s) for s in j.last_step_stats["issued"]]
    assert stats["max_live_residuals"] == j.last_step_stats[
        "max_live_residuals"]
    for s, peak in enumerate(stats["max_live_residuals"]):
        assert peak <= 2 - s

    t = _tokens(4)
    j, p = _pp_pair(2, 2, "adam", lr=1e-2,
                    jax_model=JM.llama_tiny(depth=2),
                    port_model=PM.llama_tiny(depth=2), loss=(j_lm, p_lm))
    lj = [j.train_step(t, t) for _ in range(5)]
    lp = [p.train_step(t, t) for _ in range(5)]
    np.testing.assert_allclose(lp, lj, rtol=STEP_RTOL)
    assert lp[-1] < lp[0]


def test_pipeline_parallel_threads_batchnorm_state_like_jax():
    from torchpruner_tpu.core import layers as JL
    from torchpruner_tpu.core.segment import SegmentedModel as JS
    from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
    from torchpruner_tpu_torch.convert import model_from_reference
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce

    jm = JS((JL.Conv("conv1", 4, kernel_size=(3, 3), padding="SAME"),
             JL.BatchNorm("bn1"), JL.Activation("act1", "relu"),
             JL.Flatten("flatten"), JL.Dense("fc1", 16),
             JL.BatchNorm("bn2"), JL.Activation("act2", "relu"),
             JL.Dense("out", 3)), (8, 8, 2))
    x = np.random.default_rng(3).normal(size=(8, 8, 8, 2)).astype(
        np.float32)
    y = (np.arange(8) % 3).astype(np.int32)
    j, p = _pp_pair(2, 4, "sgd", lr=0.05, jax_model=jm,
                    port_model=model_from_reference(jm), loss=(j_ce, p_ce))
    j.train_step(x, y)
    p.train_step(x, y)
    got, want = _flat(_np_tree(p.gather_state())), _flat(
        _np_tree(j.gather_state()))
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)


def test_split_pipeline_refusals_and_stacking():
    from torchpruner_tpu.parallel import pp_spmd as JS
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core.pruner import prune
    from torchpruner_tpu_torch.models import llama_moe_tiny, llama_tiny
    from torchpruner_tpu_torch.parallel import pp_spmd as PS

    model = llama_tiny(depth=4)
    pre, groups, post = PS.split_pipeline(model)
    assert [s.name for s in pre] == ["tok_emb"] and len(groups) == 4
    assert [s.name for s in post] == ["final_norm", "lm_head"]
    jm, jp = _j_llama(4)
    assert PS.canonical_group(groups[0]) == tuple(
        PS.canonical_group(g) for g in groups)[3]
    want = _flat(_np_tree(JS.stack_block_params(
        jp, JS.split_pipeline(jm)[1])))
    got = _flat(_np_tree(PS.stack_block_params(
        params_from_numpy(jp, device="cpu"), groups)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    params = params_from_numpy(jp, device="cpu")
    res = prune(model, params, "block2_ffn/gate", list(range(16)))
    with pytest.raises(ValueError, match="non-uniform"):
        PS.split_pipeline(res.model)
    with pytest.raises(ValueError, match="aux loss"):
        PS.split_pipeline(llama_moe_tiny())


# ------------------------------------------------ pp_spmd, spawned ranks


def _image(batch, seed=0):
    return np.random.default_rng(seed).normal(
        size=(batch, 16, 16, 3)).astype(np.float32)


#: forward cases: (name, model, depth, mesh, M, V, data_axis, batch)
FWD_CASES = [
    ("v1_pp4", "llama", 4, {"pp": 4}, 4, 1, None, 8),
    ("v1_pp2", "llama", 4, {"pp": 2, "data": 2}, 8, 1, None, 8),
    ("v2_2_4", "llama", 8, {"pp": 2, "data": 2}, 4, 2, None, 8),
    ("v2_4_8", "llama", 8, {"pp": 4}, 8, 2, None, 8),
    ("v4_2_4", "llama", 8, {"pp": 2, "data": 2}, 4, 4, None, 8),
    ("ragged", "llama", 8, {"pp": 2, "data": 2}, 3, 2, None, 6),
    ("data", "llama", 2, {"pp": 2, "data": 2}, 2, 1, "data", 8),
    ("vit", "vit", 2, {"pp": 2, "data": 2}, 2, 1, None, 4),
    ("bert", "bert", 2, {"pp": 2, "data": 2}, 2, 1, None, 4),
    ("pruned", "pruned", 2, {"pp": 2, "data": 2}, 2, 1, None, 8),
]
#: train-step cases: (name, depth, mesh, M, V, data_axis, steps)
STEP_CASES = [
    ("v1", 4, {"pp": 4}, 4, 1, None, 3),
    ("v2", 4, {"pp": 2, "data": 2}, 4, 2, None, 2),
    ("v1_data", 4, {"pp": 2, "data": 2}, 4, 1, "data", 2),
]
#: (block, drops) pruning every block's FFN to one width
UNIFORM_PRUNE = [("block1_ffn/gate", [0, 3, 9, 20, 31, 40, 51, 60,
                                       62, 5, 7, 11, 13, 17, 19, 23]),
                 ("block2_ffn/gate", [1, 2, 4, 6, 8, 10, 12, 14, 16,
                                       18, 22, 24, 26, 28, 30, 63])]


def _models(kind, depth):
    """``(jax model, port model)``."""
    from torchpruner_tpu import models as JM
    from torchpruner_tpu_torch import models as PM

    if kind in ("llama", "pruned"):
        return JM.llama_tiny(depth=depth), PM.llama_tiny(depth=depth)
    if kind == "vit":
        return JM.vit_tiny(depth=depth), PM.vit_tiny(depth=depth)
    return JM.bert_tiny(), PM.bert_tiny()


def _inputs(kind, batch):
    if kind == "vit":
        return _image(batch)
    if kind == "bert":
        return _tokens(batch, vocab=128)
    return _tokens(batch)


def _init(kind, depth):
    """The JAX init of the (unpruned) model."""
    from torchpruner_tpu.core.segment import init_model

    params, _ = init_model(_models(kind, depth)[0], seed=0)
    return _np_tree(params)


def _jax_params(kind, depth):
    """The JAX model and params of a forward case (pruned for
    ``"pruned"``)."""
    from torchpruner_tpu.core.pruner import prune

    jm, params = _models(kind, depth)[0], _init(kind, depth)
    if kind == "pruned":
        for layer, drops in UNIFORM_PRUNE:
            res = prune(jm, params, layer, drops)
            jm, params = res.model, _np_tree(res.params)
    return jm, params


def _shifts(rank):
    """What this rank of the world's one group receives from
    ``collectives.shift`` at both offsets, with and without the wrap,
    for two tensors of other shapes, and from ``ppermute`` with its
    backward."""
    import torch.distributed as dist

    from torchpruner_tpu_torch.parallel import collectives as C

    group = dist.group.WORLD
    ts = [torch.full((2, 3), float(rank)), torch.full((5,), 10.0 + rank)]
    got = {f"{off}:{wrap}": [t.tolist() for t in C.shift(ts, group, off,
                                                           wrap)]
           for off in (1, -1) for wrap in (True, False)}
    x = torch.full((3,), float(rank), requires_grad=True)
    (y,) = C.ppermute([x], group)
    (y * (1.0 + rank)).sum().backward()
    got["ppermute"] = [y.tolist(), x.grad.tolist()]
    return got


def _w_pp(rank, inits):
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core.pruner import prune
    from torchpruner_tpu_torch.models import vit
    from torchpruner_tpu_torch.parallel import (
        make_mesh,
        pp_spmd_apply,
        pp_spmd_train_step,
        stage_params,
    )
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss

    out = {"fwd": {}, "plain": {}, "step": {}, "errors": {}}
    meshes = {}
    out["shift"] = _shifts(rank)

    def mesh(axes):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = make_mesh(axes, device="cpu")
        return meshes[key]

    def model_params(kind, depth):
        _, pm = _models(kind, depth)
        params = params_from_numpy(inits[(kind, depth)], device="cpu")
        if kind == "pruned":
            for layer, drops in UNIFORM_PRUNE:
                res = prune(pm, params, layer, drops)
                pm, params = res.model, res.params
        return pm, params

    for name, kind, depth, axes, M, V, data_axis, batch in FWD_CASES:
        pm, params = model_params(kind, depth)
        m = mesh(axes)
        with torch.no_grad():
            y = pp_spmd_apply(pm, stage_params(pm, params, mesh=m,
                                               interleave=V),
                              _inputs(kind, batch), mesh=m,
                              n_microbatches=M, interleave=V,
                              data_axis=data_axis)
            out["fwd"][name] = y.numpy()
            x = _inputs(kind, batch)
            out["plain"][name] = pm.apply(
                params, torch.from_numpy(x))[0].numpy()
            if name == "data":
                out["fwd"]["remat"] = pp_spmd_apply(
                    pm, params, _inputs(kind, batch), mesh=m,
                    n_microbatches=M, data_axis=data_axis,
                    remat=True).numpy()

    # gradients of the mean LM loss, {"pp": 4}, every rank's own leaves
    pm, params = model_params("llama", 4)
    m = mesh({"pp": 4})
    local = stage_params(pm, params, mesh=m)
    leaves = {k: {n: t.detach().requires_grad_() for n, t in
                  _flat_items(v)} for k, v in local.items()}
    tree = {k: _unflat(v) for k, v in leaves.items()}
    tokens = _tokens(8)
    logits = pp_spmd_apply(pm, tree, tokens, mesh=m, n_microbatches=4)
    loss = lm_cross_entropy_loss(logits, torch.from_numpy(tokens)).mean()
    loss.backward()
    out["grads"] = {k: {n: t.grad.numpy() for n, t in v.items()}
                    for k, v in leaves.items()}
    out["grad_loss"] = float(loss.detach())

    for name, depth, axes, M, V, data_axis, steps in STEP_CASES:
        pm, params = model_params("llama", depth)
        m = mesh(axes)
        tx = optim.adam(1e-3)
        step = pp_spmd_train_step(pm, tx, lm_cross_entropy_loss, mesh=m,
                                  n_microbatches=M, interleave=V,
                                  data_axis=data_axis)
        p = stage_params(pm, params, mesh=m, interleave=V)
        s = tx.init(p)
        losses = []
        for _ in range(steps):
            p, s, l = step(p, s, _tokens(8))
            losses.append(float(l))
        out["step"][name] = {"losses": losses, "params": _np_tree(p)}

    # Dropout: the same generator gives the same masks, train differs
    # from eval, eval is the plain forward; two equal microbatches draw
    # different masks; no generator raises the Dropout rule's error
    pm = vit(image_size=16, patch_size=4, dim=32, depth=2, num_heads=4,
             mlp_dim=64, n_classes=10, dropout=0.2)
    params = params_from_numpy(inits["vit_dropout"], device="cpu")
    m = mesh({"pp": 2, "data": 2})
    x = _image(4)
    x[2:] = x[:2]

    def run(**kw):
        with torch.no_grad():
            return pp_spmd_apply(pm, params, x, mesh=m, n_microbatches=2,
                                 **kw).numpy()

    out["dropout"] = {
        "t1": run(train=True, rng=torch.Generator().manual_seed(7)),
        "t2": run(train=True, rng=torch.Generator().manual_seed(7)),
        "eval": run()}
    try:
        run(train=True)
    except ValueError as e:
        out["errors"]["dropout"] = str(e)
    tx = optim.adam(1e-3)
    step = pp_spmd_train_step(
        pm, tx, lambda lg, _x: -torch.log_softmax(lg, -1)[:, 0], mesh=m,
        n_microbatches=2)
    p = stage_params(pm, params, mesh=m)
    s = tx.init(p)
    p, s, l1 = step(p, s, x, torch.Generator().manual_seed(0))
    p, s, l2 = step(p, s, x, torch.Generator().manual_seed(1))
    out["dropout"]["losses"] = [float(l1), float(l2)]
    try:
        pp_spmd_apply(pm, params, x, mesh=m, n_microbatches=2,
                      interleave=3)
    except ValueError as e:
        out["errors"]["interleave"] = str(e)
    return out


def _flat_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, prefix + (k,))
    else:
        yield prefix, tree


def _unflat(items):
    out = {}
    for path, t in items.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return out


def _vit_dropout_init():
    from torchpruner_tpu.core.segment import init_model
    from torchpruner_tpu.models import vit

    params, _ = init_model(vit(image_size=16, patch_size=4, dim=32,
                               depth=2, num_heads=4, mlp_dim=64,
                               n_classes=10, dropout=0.2), seed=0)
    return _np_tree(params)


@pytest.fixture(scope="module")
def pp_world(tmp_path_factory):
    # the pruned model starts from the unpruned JAX init on both sides
    inits = {(kind, depth): _init(kind, depth)
             for _, kind, depth, *_ in FWD_CASES}
    inits["vit_dropout"] = _vit_dropout_init()
    return run_world(4, _w_pp, tmp_path_factory.mktemp("pp"), inits,
                     timeout=300)


def _jax_mesh(axes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c[0])
def test_pp_spmd_forward_matches_jax(pp_world, case):
    import jax.numpy as jnp

    from torchpruner_tpu.parallel.pp_spmd import pp_spmd_apply

    import jax

    name, kind, depth, axes, M, V, data_axis, batch = case
    jm, params = _jax_params(kind, depth)
    mesh = _jax_mesh(axes)
    # one program: eager shard_map dispatch takes far longer on the CPU
    fwd = jax.jit(lambda p, x: pp_spmd_apply(
        jm, p, x, mesh=mesh, n_microbatches=M, interleave=V,
        data_axis=data_axis))
    want = np.asarray(fwd(params, jnp.asarray(_inputs(kind, batch))))
    scale = float(np.abs(want).max())
    for res in pp_world:
        # the JAX test's check, in the port: the pipelined forward is the
        # plain forward
        np.testing.assert_allclose(res["fwd"][name], res["plain"][name],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(res["fwd"][name], want, rtol=FWD_TOL,
                                   atol=FWD_TOL * scale)
        if name == "data":  # remat recomputes the same forward
            np.testing.assert_allclose(res["fwd"]["remat"],
                                       res["fwd"][name], rtol=1e-5,
                                       atol=1e-6)


def test_pp_spmd_grads_match_jax(pp_world):
    """Each rank's own blocks, ``post`` on every rank and ``pre`` on
    stage 0 against ``jax.grad`` through the JAX ``pp_spmd_apply``."""
    import jax
    import jax.numpy as jnp

    from torchpruner_tpu.parallel.pp_spmd import pp_spmd_apply
    from torchpruner_tpu.utils.losses import lm_cross_entropy_loss

    jm, params = _j_llama(4)
    tokens = jnp.asarray(_tokens(8))

    def loss(p):
        logits = pp_spmd_apply(jm, p, tokens, mesh=_jax_mesh({"pp": 4}),
                               n_microbatches=4)
        return lm_cross_entropy_loss(logits, tokens).mean()

    lj, gj = jax.jit(jax.value_and_grad(loss))(jax.tree_util.tree_map(
        jnp.asarray, params))
    want = _flat(_np_tree(gj))
    for rank, res in enumerate(pp_world):
        np.testing.assert_allclose(res["grad_loss"], float(lj),
                                   rtol=FWD_TOL)
        seen = 0
        for layer, leaves in res["grads"].items():
            if layer == "tok_emb" and rank != 0:
                assert all(not g.any() for g in leaves.values())
                continue
            for path, g in leaves.items():
                np.testing.assert_allclose(
                    g, want[(layer,) + path], rtol=GRAD_RTOL,
                    atol=GRAD_ATOL, err_msg=f"{rank} {layer} {path}")
                seen += 1
        assert seen


def _jax_step_losses(depth, axes, M, V, data_axis, steps):
    import jax
    import jax.numpy as jnp
    import optax

    from torchpruner_tpu.parallel.pp_spmd import pp_spmd_train_step
    from torchpruner_tpu.utils.losses import lm_cross_entropy_loss

    jm, params = _j_llama(depth)
    opt = optax.adam(1e-3)
    step = pp_spmd_train_step(jm, opt, lm_cross_entropy_loss,
                              mesh=_jax_mesh(axes), n_microbatches=M,
                              interleave=V, data_axis=data_axis)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = opt.init(p)
    losses = []
    for _ in range(steps):
        p, s, l = step(p, s, jnp.asarray(_tokens(8)))
        losses.append(float(l))
    return losses, _np_tree(jax.device_get(p))


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_pp_spmd_train_step_matches_jax(pp_world, case):
    name, depth, axes, M, V, data_axis, steps = case
    want, wparams = _jax_step_losses(depth, axes, M, V, data_axis, steps)
    wflat = _flat(wparams)
    for res in pp_world:
        got = res["step"][name]
        np.testing.assert_allclose(got["losses"], want, rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
        # the rank holds pre, post and its own blocks, near the JAX ones
        for path, a in _flat(got["params"]).items():
            np.testing.assert_allclose(a, wflat[path], rtol=5e-4,
                                       atol=1e-5, err_msg=str(path))


def test_shift_and_ppermute_over_four_ranks(pp_world):
    """Each rank receives its neighbour's tensors whole, an edge rank
    zeros without the wrap; ``ppermute``'s gradient goes back to the
    sender (the receiver's weight ``1 + r``)."""
    n = len(pp_world)
    for r, res in enumerate(pp_world):
        got = res["shift"]
        for off in (1, -1):
            for wrap in (True, False):
                src = r - off
                if not wrap and not 0 <= src < n:
                    want = [[[0.0] * 3] * 2, [0.0] * 5]
                else:
                    src %= n
                    want = [[[float(src)] * 3] * 2, [10.0 + src] * 5]
                assert got[f"{off}:{wrap}"] == want, (r, off, wrap)
        y, g = got["ppermute"]
        assert y == [float((r - 1) % n)] * 3
        assert g == [1.0 + (r + 1) % n] * 3


def test_pp_spmd_dropout_and_refusals(pp_world):
    import jax
    import jax.numpy as jnp

    from torchpruner_tpu.core.segment import init_model
    from torchpruner_tpu.models import vit

    jm = vit(image_size=16, patch_size=4, dim=32, depth=2, num_heads=4,
             mlp_dim=64, n_classes=10, dropout=0.2)
    params, _ = init_model(jm, seed=0)
    x = _image(4)
    x[2:] = x[:2]
    want, _ = jax.jit(lambda p, x_: jm.apply(p, x_))(params, jnp.asarray(x))
    for res in pp_world:
        d = res["dropout"]
        np.testing.assert_array_equal(d["t1"], d["t2"])
        assert np.abs(d["t1"] - d["eval"]).max() > 1e-4
        # microbatches 0 and 1 hold the same images: other masks
        assert np.abs(d["t1"][:2] - d["t1"][2:]).max() > 1e-4
        np.testing.assert_allclose(d["eval"], np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert all(np.isfinite(d["losses"]))
        assert "needs an rng" in res["errors"]["dropout"]
        assert "virtual chunks" in res["errors"]["interleave"]


# ----------------------------------- the two-process pipeline trajectory


def _w_two(rank, inits):
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.models import llama_tiny
    from torchpruner_tpu_torch.parallel import (
        make_mesh,
        pp_spmd_train_step,
        stage_params,
    )
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss

    m = make_mesh({"pp": 2}, device="cpu")
    out = {}
    for depth, V, steps in ((4, 1, 3), (8, 2, 2)):
        pm = llama_tiny(depth=depth)
        tx = optim.adam(1e-3)
        step = pp_spmd_train_step(pm, tx, lm_cross_entropy_loss, mesh=m,
                                  n_microbatches=4, interleave=V)
        p = stage_params(pm, params_from_numpy(inits[depth], device="cpu"),
                         mesh=m, interleave=V)
        s = tx.init(p)
        losses = []
        for _ in range(steps):
            p, s, l = step(p, s, _tokens(8))
            losses.append(float(l))
        out[depth] = losses
    return out


def test_two_process_spmd_pipeline_matches_single_device(tmp_path):
    """Two gloo ranks on ``{"pp": 2}``: depth 4 (3 Adam steps) and depth
    8 interleaved (V 2, 2 steps) against the JAX single-device gradient
    steps (rtol 1e-4 / atol 1e-6), and the two ranks' losses equal."""
    import jax
    import jax.numpy as jnp
    import optax

    from torchpruner_tpu.utils.losses import lm_cross_entropy_loss

    inits = {d: _j_llama(d)[1] for d in (4, 8)}
    res = run_world(2, _w_two, tmp_path, inits, timeout=240)
    tokens = jnp.asarray(_tokens(8))
    for depth, steps in ((4, 3), (8, 2)):
        jm, params = _j_llama(depth)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        opt = optax.adam(1e-3)
        s = opt.init(p)

        def loss_fn(p_, _jm=jm):
            logits, _ = _jm.apply(p_, tokens)
            return lm_cross_entropy_loss(logits, tokens).mean()

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
        ref = []
        for _ in range(steps):
            l, g = grad_fn(p)
            updates, s = opt.update(g, s, p)
            p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
            ref.append(float(l))
        assert res[0][depth] == res[1][depth]
        np.testing.assert_allclose(res[0][depth], ref, rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
