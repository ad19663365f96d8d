"""The port's sharded trainer and distributed scorer, in spawned worlds
of 2 and 4 CPU ranks over gloo, against the JAX package's on a JAX mesh
of the same shape.

- ``ShardedTrainer`` on ``{"data": 2, "model": 2}`` (bert_tiny): ``fsdp``
  and ``tp``, ZeRO off and on, ``accum_steps`` 1 and 2 — three SGD
  steps from the JAX init against the JAX ``ShardedTrainer``: losses,
  final params, every rank's piece shapes against
  ``NamedSharding.shard_shape``, ``evaluate`` with a padded last batch,
  and ``rebuild`` after a prune followed by one more step;
- ``DistributedScorer`` on ``{"data": 2}`` against the JAX one: Taylor
  with ``mean``, ``mean+2std`` and ``none``, Shapley fed the JAX
  permutations, the drop indices equal; a mesh ``ActivationCache``
  serving the scorer the same scores;
- a BatchNorm net and a MoE block (with its balancing loss) under
  ``data`` 2 against the port's single-device ``Trainer``, which catches
  batch statistics taken over a rank's half of the batch.

Each rank joins its group through a ``file://`` store under
``tmp_path`` (xdist workers run at once) and runs one thread.

Tolerances (those of ``test_torch_port_prune.py``): losses, params
after SGD and gradients rtol 1e-5 of the output scale; scores rtol 1e-4.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import os
import traceback

import numpy as np
import pytest
import torch

F32_RTOL = 1e-5
SCORE_RTOL = 1e-4
#: small enough that bert_tiny's leaves shard
MIN_SIZE = 64
MESH = {"data": 2, "model": 2}
#: (partition, zero, accum_steps)
TRAINER_CASES = [("fsdp", False, 1), ("fsdp", True, 2), ("tp", False, 2),
                 ("tp", True, 1)]
#: the prune applied before rebuild: block1's fc1, these units dropped
PRUNE = ("block1_mlp/fc1", [1, 5, 6, 30, 41, 63])


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _close_tree(got, want, rtol):
    """Every leaf within ``rtol`` of the whole tree's scale (a leaf whose
    exact gradient is 0, like an attention key bias, moves by rounding
    noise alone, so its own scale is no yardstick)."""
    want, got = _flat(want), _flat(got)
    assert set(got) == set(want)
    scale = max((float(np.abs(a).max()) for a in want.values()), default=0)
    for path, arr in want.items():
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(arr, np.float64), rtol=rtol,
                                   atol=rtol * scale, err_msg=str(path))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


# ------------------------------------------------------ spawned worlds


def _rank_main(rank, world, store, out, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {"ok": fn(rank, *args)}
    except BaseException:  # reported to the parent, which fails the test
        res = {"error": traceback.format_exc()}
    torch.save(res, out)
    dist.destroy_process_group()


def run_world(world, fn, tmp_path, *args, timeout=240):
    """``fn(rank, *args)`` on ``world`` spawned ranks; their results."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tag = f"{fn.__name__}_{len(list(tmp_path.iterdir()))}"
    store = str(tmp_path / f"{tag}.store")
    outs = [str(tmp_path / f"{tag}.{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, outs[r], fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert not p.is_alive()
        assert os.path.exists(out), f"rank {r} exited {p.exitcode}"
        res = torch.load(out, weights_only=False)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res["ok"])
    return results


# ----------------------------------------------------- the JAX references


def _bert_case():
    from torchpruner_tpu.core.segment import init_model as j_init
    from torchpruner_tpu.models import bert_tiny as j_bert_tiny

    model = j_bert_tiny()
    params, _ = j_init(model, seed=0)
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 128, size=(4, 8, 16)).astype(np.int32)
    ys = rng.integers(0, 2, size=(4, 8)).astype(np.int32)
    return model, _np_tree(params), xs, ys


def _jax_trainer_run(partition, zero, accum):
    import jax
    import optax
    from jax.sharding import Mesh

    from torchpruner_tpu.core.pruner import prune as j_prune
    from torchpruner_tpu.parallel import ShardedTrainer
    from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce

    model, params, xs, ys = _bert_case()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    t = ShardedTrainer.create(
        model, optax.sgd(0.1, momentum=0.9), j_ce, mesh,
        params=jax.tree_util.tree_map(jax.numpy.asarray, params),
        state={}, partition=partition, zero=zero, accum_steps=accum,
        min_shard_size=MIN_SIZE)
    shapes = {}
    flat_sh = _flat_sharding(t._placements[0])
    for path, arr in _flat(jax.device_get(t.params)).items():
        shapes[path] = tuple(flat_sh[path].shard_shape(arr.shape))
    losses = [float(t.step(xs[i], ys[i])) for i in range(3)]
    out = {"losses": losses, "params": _np_tree(jax.device_get(t.params)),
           "shapes": shapes,
           "eval": t.evaluate([(xs[3][:7], ys[3][:7])])}
    res = j_prune(t.model, jax.device_get(t.params), PRUNE[0], PRUNE[1],
                  state=jax.device_get(t.state),
                  opt_state=jax.device_get(t.opt_state))
    t = t.rebuild(res.model, res.params, res.state, res.opt_state)
    out["rebuild_loss"] = float(t.step(xs[3], ys[3]))
    out["rebuild_params"] = _np_tree(jax.device_get(t.params))
    return out


def _flat_sharding(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_sharding(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ------------------------------------------------------------- the ranks


def _w_trainer(rank, cases, params_np, xs, ys):
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core.pruner import prune
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.parallel import ShardedTrainer, make_mesh
    from torchpruner_tpu_torch.parallel.memory import held_bytes
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    out = {}
    for partition, zero, accum in cases:
        mesh = make_mesh(MESH, device="cpu")
        t = ShardedTrainer.create(
            bert_tiny(), optim.sgd(0.1, momentum=0.9), cross_entropy_loss,
            mesh, params=params_from_numpy(params_np, device="cpu"),
            state={}, partition=partition, zero=zero, accum_steps=accum,
            min_shard_size=MIN_SIZE, device="cpu")
        rec = {"shapes": {p: tuple(a.shape)
                          for p, a in _flat(_np_tree(t.params)).items()}}
        plan = t.memory_plan()
        rec["bytes"] = (held_bytes(t.params), held_bytes(t.opt_state),
                        plan.params_bytes, plan.opt_bytes)
        rec["losses"] = [float(t.step(xs[i], ys[i])) for i in range(3)]
        rec["params"] = _np_tree(t.full_params())
        rec["eval"] = t.evaluate([(xs[3][:7], ys[3][:7])])
        res = prune(t.model, t.full_params(), PRUNE[0], PRUNE[1],
                    state=t.state, opt_state=t.full_opt_state())
        t = t.rebuild(res.model, res.params, res.state, res.opt_state)
        rec["rebuild_loss"] = float(t.step(xs[3], ys[3]))
        rec["rebuild_params"] = _np_tree(t.full_params())
        out[(partition, zero, accum)] = rec
    return out


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    _, params, xs, ys = _bert_case()
    return run_world(4, _w_trainer, tmp_path_factory.mktemp("trainer"),
                     TRAINER_CASES, params, xs, ys)


@pytest.mark.parametrize("case", TRAINER_CASES,
                         ids=lambda c: f"{c[0]}-zero{int(c[1])}-acc{c[2]}")
def test_sharded_trainer_matches_jax(trainer_world, case):
    want = _jax_trainer_run(*case)
    for rank, res in enumerate(trainer_world):
        got = res[case]
        _close(got["losses"], want["losses"], F32_RTOL)
        _close_tree(got["params"], want["params"], F32_RTOL)
        assert got["eval"][1] == want["eval"][1]
        _close(got["eval"][0], want["eval"][0], F32_RTOL)
        _close(got["rebuild_loss"], want["rebuild_loss"], F32_RTOL)
        _close_tree(got["rebuild_params"], want["rebuild_params"], F32_RTOL)
    # every rank holds the piece JAX's placement gives a device, the
    # bytes the memory plan says
    for res in trainer_world:
        assert res[case]["shapes"] == want["shapes"]
        held_p, held_o, plan_p, plan_o = res[case]["bytes"]
        assert (held_p, held_o) == (plan_p, plan_o)


def test_sharded_trainer_world_of_one_is_the_trainer(tmp_path):
    """At world size one the sharded step is the single-device step,
    bit for bit."""
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    _, params, xs, ys = _bert_case()
    (got,) = run_world(1, _w_one, tmp_path, params, xs, ys)
    t = Trainer.create(bert_tiny(), optim.adam(1e-3), cross_entropy_loss,
                       params=params_from_numpy(params, device="cpu"),
                       device="cpu")
    want = [float(t.step(xs[i], ys[i])) for i in range(3)]
    assert got["losses"] == want
    for path, arr in _flat(_np_tree(t.params)).items():
        np.testing.assert_array_equal(_flat(got["params"])[path], arr)


def _w_one(rank, params_np, xs, ys):
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.parallel import ShardedTrainer, make_mesh
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    t = ShardedTrainer.create(
        bert_tiny(), optim.adam(1e-3), cross_entropy_loss,
        make_mesh({"data": 1}, device="cpu"),
        params=params_from_numpy(params_np, device="cpu"), state={},
        device="cpu")
    return {"losses": [float(t.step(xs[i], ys[i])) for i in range(3)],
            "params": _np_tree(t.full_params())}


def _w_coalesced(rank):
    import torch.distributed as dist

    from torchpruner_tpu_torch.parallel import collectives as C

    g = dist.group.WORLD
    gen = torch.Generator().manual_seed(rank)
    ts = [torch.randn(6, 4, generator=gen),
          torch.randn(8, generator=gen, dtype=torch.float64),
          torch.randn(2, 6, 2, generator=gen), torch.randn(1000, generator=gen)]
    items = list(zip(ts, (1, 0, 2, 0)))
    summed = [C.all_reduce_(t.clone(), g) for t in ts]
    # 200 bytes: the f32 pairs share buckets, the largest goes alone, the
    # f64 tensor has a bucket of its own
    return {"one": [summed,
                    [C.all_gather_dim(t, d, g) for t, d in items],
                    [s.chunk(2, d)[rank].contiguous()
                     for s, (_, d) in zip(summed, items)]],
            "many": [C.all_reduce_many_([t.clone() for t in ts], g,
                                        bucket_bytes=200),
                     C.all_gather_many(items, g, bucket_bytes=200),
                     C.reduce_scatter_many(items, g, bucket_bytes=200)]}


def test_coalesced_collectives_are_the_per_tensor_ones(tmp_path):
    """Bucketed all-reduce, all-gather and reduce-scatter give each
    tensor what its own all-reduce or all-gather gives it (the
    reduce-scatter: its rank's piece of the all-reduced sum), bit for bit
    over two ranks."""
    for got in run_world(2, _w_coalesced, tmp_path):
        for one, many in zip(got["one"], got["many"]):
            assert len(one) == len(many) == 4
            for a, b in zip(one, many):
                assert a.dtype == b.dtype and a.is_contiguous()
                assert b.is_contiguous()
                torch.testing.assert_close(b, a, rtol=0, atol=0)


def _w_remat_bn(rank):
    import threading

    import torch.distributed as dist

    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.segment import SegmentedModel, init_model
    from torchpruner_tpu_torch.parallel import collectives as C
    from torchpruner_tpu_torch.utils.tree import tree_leaves, tree_map

    model = SegmentedModel((
        L.Dense("fc1", 16),
        L.Residual("block", body=(L.Dense("fc", 16), L.BatchNorm("bn"),
                                  L.Activation("act", "relu"))),
        L.Dense("out", 3)), (8,))
    params, state = init_model(model, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 8)).astype(np.float32))[4 * rank:4 * (rank + 1)]
    out = {}
    for remat in (False, True):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _t: next(it), params)
        got = []
        with C.batch_stats_over(dist.group.WORLD):
            y, _ = model.apply(p, x, state=state, train=True, remat=remat)
            loss = y.square().sum()
            # a CUDA backward runs on autograd's device thread, which sees
            # none of the caller's context variables: take the backward on
            # a thread of its own likewise
            th = threading.Thread(target=lambda: got.append(
                torch.autograd.grad(loss, leaves)))
            th.start()
            th.join(60)
        out[remat] = [g.numpy() for g in got[0]]
    return out


def test_remat_recompute_keeps_the_data_axis_statistics(tmp_path):
    """A remat block's recompute in the backward takes BatchNorm's
    moments over the data axis as its forward did, on whatever thread
    the backward runs (a CUDA backward runs on autograd's device
    thread): the gradients equal the ones without remat."""
    for res in run_world(2, _w_remat_bn, tmp_path):
        for a, b in zip(res[True], res[False]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- scoring


def _w_scorer(rank, params_np, batches, perms):
    from torchpruner_tpu_torch import attributions as PA
    from torchpruner_tpu_torch.attributions.base import ActivationCache
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.parallel import DistributedScorer, make_mesh
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss
    from torchpruner_tpu_torch.utils.reductions import mean_plus_2std

    mesh = make_mesh({"data": 2}, device="cpu")
    model = bert_tiny()
    params = params_from_numpy(params_np, device="cpu")
    out = {}
    for red in ("mean", "mean+2std", "none"):
        m = PA.TaylorAttributionMetric(
            model, params, batches, cross_entropy_loss,
            reduction=mean_plus_2std if red == "mean+2std" else red)
        out[("taylor", red)] = DistributedScorer(m, mesh).run(
            "block1_mlp/fc1", find_best_evaluation_layer=True)
    PA.ShapleyAttributionMetric._draw_perms = \
        lambda self, n, S: torch.from_numpy(perms)
    m = PA.ShapleyAttributionMetric(model, params, batches,
                                    cross_entropy_loss, sv_samples=2)
    out[("shapley", "mean")] = DistributedScorer(m, mesh).run(
        "block2_mlp/fc1", find_best_evaluation_layer=True)
    # a mesh cache serves the scorer this rank's slices (a flat model:
    # nested sites are not cached)
    flat = _flat_model()
    fparams, _ = init_model(flat, seed=2, device="cpu")
    fbatches = [(x.astype(np.float32) / 64.0, y) for x, y in
                ((np.asarray(b[0])[:, :6], b[1]) for b in batches)]
    cache = ActivationCache(flat, fparams, fbatches, sites=("relu",),
                            mesh=mesh)
    for cached in (False, True):
        m = PA.TaylorAttributionMetric(flat, fparams, fbatches,
                                       cross_entropy_loss)
        m.capture_cache = cache if cached else None
        out[("flat", cached)] = DistributedScorer(m, mesh).run(
            "fc1", find_best_evaluation_layer=True)
    out["cache_hits"] = cache.hits
    # weight-only metrics fall through to their own run
    m = PA.WeightNormAttributionMetric(model, params, batches,
                                       cross_entropy_loss)
    out["weight_norm"] = DistributedScorer(m, mesh).run("block1_mlp/fc1")
    return out


@pytest.fixture(scope="module")
def scorer_world(tmp_path_factory):
    from torchpruner_tpu import attributions as JA

    _, params, xs, ys = _bert_case()
    batches = [(xs[0], ys[0]), (xs[1], ys[1])]
    m = JA.ShapleyAttributionMetric(None, None, None, None, seed=0)
    m._calls = 0
    perms = np.array(m._draw_perms(64, 2)).astype(np.int64)
    res = run_world(2, _w_scorer, tmp_path_factory.mktemp("scorer"),
                    params, batches, perms)
    return res, params, batches


@pytest.mark.parametrize("key", [("taylor", "mean"),
                                 ("taylor", "mean+2std"),
                                 ("taylor", "none"),
                                 ("shapley", "mean")],
                         ids=lambda k: "-".join(k))
def test_distributed_scorer_matches_jax(scorer_world, key):
    import jax
    from jax.sharding import Mesh

    from torchpruner_tpu import attributions as JA
    from torchpruner_tpu.core.pruner import score_drop_indices
    from torchpruner_tpu.models import bert_tiny as j_bert_tiny
    from torchpruner_tpu.parallel import DistributedScorer
    from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
    from torchpruner_tpu.utils.reductions import mean_plus_2std

    res, params, batches = scorer_world
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    method, red = key
    if method == "taylor":
        m = JA.TaylorAttributionMetric(
            j_bert_tiny(), jparams, batches, j_ce,
            reduction=mean_plus_2std if red == "mean+2std" else red)
        layer = "block1_mlp/fc1"
    else:
        m = JA.ShapleyAttributionMetric(j_bert_tiny(), jparams, batches,
                                        j_ce, sv_samples=2, seed=0)
        layer = "block2_mlp/fc1"
    want = np.asarray(DistributedScorer(m, mesh).run(
        layer, find_best_evaluation_layer=True))
    for rank_res in res:
        got = rank_res[key]
        _close(got, want, SCORE_RTOL)
        if red != "none":
            np.testing.assert_array_equal(
                score_drop_indices(got, policy="fraction", fraction=0.3),
                score_drop_indices(want, policy="fraction", fraction=0.3))


def test_distributed_scorer_cache_and_weight_only(scorer_world):
    from torchpruner_tpu_torch import attributions as PA
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    res, params, batches = scorer_world
    for r in res:
        assert r["cache_hits"] == 1
        _close(r[("flat", True)], r[("flat", False)], F32_RTOL)
    want = PA.WeightNormAttributionMetric(
        bert_tiny(), params_from_numpy(params, device="cpu"), batches,
        cross_entropy_loss).run("block1_mlp/fc1")
    for r in res:
        np.testing.assert_array_equal(r["weight_norm"], want)


# ---------------------------------------------- batch statistics, MoE


def _flat_model():
    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.segment import SegmentedModel

    return SegmentedModel((L.Dense("fc1", 16), L.Activation("relu", "relu"),
                           L.Dense("out", 2)), (6,))


def _bn_model():
    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.segment import SegmentedModel

    return SegmentedModel((L.Dense("fc1", 16), L.BatchNorm("bn"),
                           L.Activation("relu", "relu"),
                           L.Dense("out", 3)), (6,))


def _moe_model():
    from torchpruner_tpu_torch.models import llama_moe_tiny

    return llama_moe_tiny(depth=1)


def _stats_case(name):
    rng = np.random.default_rng(1)
    if name == "bn":
        xs = rng.normal(size=(2, 8, 6)).astype(np.float32) * 3 + 1
        ys = rng.integers(0, 3, size=(2, 8)).astype(np.int64)
    else:
        xs = rng.integers(0, 256, size=(2, 4, 16)).astype(np.int64)
        ys = rng.integers(0, 256, size=(2, 4, 16)).astype(np.int64)
    return xs, ys


def _stats_trainer(name, mesh=None):
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import (
        cross_entropy_loss,
        lm_cross_entropy_loss,
    )

    model = _bn_model() if name == "bn" else _moe_model()
    loss = cross_entropy_loss if name == "bn" else lm_cross_entropy_loss
    aux = 0.0 if name == "bn" else 0.5
    params, state = init_model(model, seed=3, device="cpu")
    if mesh is None:
        return Trainer.create(model, optim.sgd(0.1), loss, params=params,
                              state=state, device="cpu",
                              moe_aux_weight=aux)
    from torchpruner_tpu_torch.parallel import ShardedTrainer

    return ShardedTrainer.create(model, optim.sgd(0.1), loss, mesh,
                                 params=params, state=state, device="cpu",
                                 moe_aux_weight=aux, min_shard_size=MIN_SIZE)


def _w_stats(rank):
    from torchpruner_tpu_torch.parallel import make_mesh

    out = {}
    for name in ("bn", "moe"):
        t = _stats_trainer(name, make_mesh({"data": 2}, device="cpu"))
        xs, ys = _stats_case(name)
        out[name] = {"losses": [float(t.step(xs[i], ys[i]))
                                for i in range(2)],
                     "params": _np_tree(t.full_params()),
                     "state": _np_tree(t.state)}
    return out


@pytest.fixture(scope="module")
def stats_world(tmp_path_factory):
    return run_world(2, _w_stats, tmp_path_factory.mktemp("stats"))


@pytest.mark.parametrize("name", ["bn", "moe"])
def test_batch_statistics_are_global_on_the_data_axis(stats_world, name):
    res = stats_world
    t = _stats_trainer(name)
    xs, ys = _stats_case(name)
    want = [float(t.step(xs[i], ys[i])) for i in range(2)]
    for r in res:
        got = r[name]
        _close(got["losses"], want, F32_RTOL)
        _close_tree(got["params"], _np_tree(t.params), F32_RTOL)
        _close_tree(got["state"], _np_tree(t.state), F32_RTOL)


# ------------------------------------------ the trainer's other options


def _w_options(rank, params_np, xs, ys):
    """On ``{"data": 2}``: remat, ``multi_step``, the guard and the
    gradient-norm telemetry of the sharded trainer."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.parallel import ShardedTrainer, make_mesh
    from torchpruner_tpu_torch.resilience.guards import StepGuard
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    mesh = make_mesh({"data": 2}, device="cpu")

    def trainer(**kw):
        return ShardedTrainer.create(
            bert_tiny(), optim.sgd(0.1, momentum=0.9), cross_entropy_loss,
            mesh, params=params_from_numpy(params_np, device="cpu"),
            state={}, device="cpu", min_shard_size=MIN_SIZE, **kw)

    out = {}
    t = trainer(remat=True)
    out["remat"] = [float(t.step(xs[i], ys[i])) for i in range(2)]
    a, b = trainer(), trainer()
    out["steps"] = [float(a.step(xs[i], ys[i])) for i in range(3)]
    out["multi"] = [float(v) for v in b.multi_step(xs[:3], ys[:3])]
    out["multi_params"] = _np_tree(b.full_params())
    out["steps_params"] = _np_tree(a.full_params())
    norms = []
    real = obs.record_grad_norm
    obs.record_grad_norm = lambda v: norms.append(float(v))
    try:
        t = trainer(grad_norm=True)
        t.step(xs[0], ys[0])
    finally:
        obs.record_grad_norm = real
    out["grad_norm"] = norms
    guard = StepGuard(3)
    t = trainer(guard=guard)
    before = _np_tree(t.full_params())
    bad = xs[0].copy()
    # a token id past the vocabulary would raise: poison through the
    # embedding instead, one non-finite weight row hit by token 0
    t.params["tok_emb"]["emb"][0] = float("nan")
    bad[:] = 0
    loss = float(t.step(bad, ys[0]))
    out["guard"] = (loss, guard.consecutive,
                    all(np.array_equal(np.asarray(p1), np.asarray(p2),
                                       equal_nan=True)
                        for p1, p2 in zip(_flat(_np_tree(t.full_params())
                                                ).values(),
                                          _flat(before).values())))
    return out


def test_sharded_trainer_options_match_the_trainer(tmp_path):
    """Remat and ``multi_step`` against the single-device trainer's and
    its own steps, the global gradient norm against the single-device
    one, and a non-finite step skipped with the params kept."""
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer, global_norm
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss
    from torchpruner_tpu_torch.utils.tree import tree_leaves

    _, params, xs, ys = _bert_case()
    res = run_world(2, _w_options, tmp_path, params, xs, ys)

    def single(**kw):
        return Trainer.create(bert_tiny(), optim.sgd(0.1, momentum=0.9),
                              cross_entropy_loss,
                              params=params_from_numpy(params, device="cpu"),
                              device="cpu", **kw)

    t = single(remat=True)
    want_remat = [float(t.step(xs[i], ys[i])) for i in range(2)]
    t = single()
    _, grads, _ = t.loss_and_grads(xs[0], ys[0])
    want_norm = float(global_norm(tree_leaves(grads)))
    for r in res:
        _close(r["remat"], want_remat, F32_RTOL)
        assert r["multi"] == r["steps"]
        _close_tree(r["multi_params"], r["steps_params"], 0)
        assert len(r["grad_norm"]) == 1
        _close(r["grad_norm"][0], want_norm, F32_RTOL)
        loss, streak, kept = r["guard"]
        assert not np.isfinite(loss) and streak == 1 and kept
