"""The port's placement rules (``torchpruner_tpu_torch/parallel``)
against the JAX package's, on the CPU and without spawning a process.

- ``make_mesh``'s ``-1`` and product errors; ``mesh_factorizations``;
- ``fsdp_spec`` (one axis and the full-mesh tuple), ``zero_update_spec``,
  ``tp_specs`` / ``tp_sharding`` on the miniature BERT, Llama, MoE and
  conv models: for every leaf, the port's spec equals the JAX
  function's on a JAX mesh of the same shape, and so does every leaf's
  piece shape (``NamedSharding.shard_shape``);
- ``training_memory`` byte for byte against JAX's, with and without
  ZeRO, SGD with momentum and Adam;
- which rank holds which piece (model-major tuple entries), the batch
  slices, the tensor-parallel compute plan, the config and CLI surface.

Tolerances: none — these are integer shape and byte rules, held equal.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import types

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from torchpruner_tpu.models import bert_tiny as j_bert_tiny
from torchpruner_tpu.models import digits_convnet as j_digits_convnet
from torchpruner_tpu.models import llama_moe_tiny as j_llama_moe_tiny
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.parallel import memory as JM
from torchpruner_tpu.parallel import sharding as JS
from torchpruner_tpu.parallel import train as JT
from torchpruner_tpu.parallel.mesh import make_mesh as j_make_mesh
from torchpruner_tpu_torch.models import bert_tiny as p_bert_tiny
from torchpruner_tpu_torch.models import digits_convnet as p_digits_convnet
from torchpruner_tpu_torch.models import llama_moe_tiny as p_llama_moe_tiny
from torchpruner_tpu_torch.models import llama_tiny as p_llama_tiny
from torchpruner_tpu_torch.parallel import memory as PM
from torchpruner_tpu_torch.parallel import mesh as PMesh
from torchpruner_tpu_torch.parallel import sharding as PS
from torchpruner_tpu_torch.parallel import train as PT
from torchpruner_tpu_torch.train import optim as PO
from torchpruner_tpu_torch.utils.config import ExperimentConfig

MODELS = {
    "bert": (j_bert_tiny, p_bert_tiny),
    "llama": (j_llama_tiny, p_llama_tiny),
    "moe": (j_llama_moe_tiny, p_llama_moe_tiny),
    "conv": (j_digits_convnet, p_digits_convnet),
}
MESHES = [{"data": 2, "model": 2}, {"data": 4, "model": 2},
          {"data": 1, "model": 4}, {"data": 8}]
#: small enough that the miniature models' leaves shard
MIN_SIZE = 64


def j_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def j_params(name):
    model = MODELS[name][0]()
    params, _ = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return model, params


def p_meta(name):
    model = MODELS[name][1]()
    return model, PM._meta_tree(model.param_shapes())


def flat_specs(tree, prefix=()):
    """``{path: spec tuple}`` of a JAX sharding tree or a port spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, prefix + (k,)))
        return out
    spec = tree.spec if hasattr(tree, "spec") else tree
    return {prefix: normalize(spec)}


def normalize(spec):
    """A spec as a plain tuple, trailing ``None``s dropped."""
    out = [tuple(e) if isinstance(e, (tuple, list)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def flat_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def fake_mesh(axes, coord):
    """A stand-in for a ``DeviceMesh``: axis names, sizes and this rank's
    coordinate."""
    return types.SimpleNamespace(
        mesh_dim_names=tuple(axes), mesh=torch.empty(tuple(axes.values())),
        get_coordinate=lambda: list(coord))


# ---------------------------------------------------------------- meshes


@pytest.mark.parametrize("axes,n", [({"data": -1, "model": 2}, 8),
                                    ({"data": 2, "model": 2}, 4),
                                    ({"data": -1}, 3)])
def test_resolve_axes_matches_jax(axes, n):
    got = PMesh.resolve_axes(axes, n)
    want = dict(j_make_mesh(axes, devices=jax.devices()[:n]).shape)
    assert got == want


@pytest.mark.parametrize("axes,n,match", [
    ({"data": -1, "model": -1}, 8, "at most one"),
    ({"data": -1, "model": 3}, 8, "not divisible by 3"),
    ({"data": 2, "model": 2}, 8, "needs 4 devices, have 8"),
])
def test_resolve_axes_errors_match_jax(axes, n, match):
    with pytest.raises(ValueError, match=match):
        PMesh.resolve_axes(axes, n)
    with pytest.raises(ValueError, match=match):
        j_make_mesh(axes, devices=jax.devices()[:n])


def test_make_mesh_names_both_sizes_outside_torchrun():
    """Without a process group the world is one process: a mesh of 2
    raises with both numbers, before any group is made."""
    assert PMesh.world_size() == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        PMesh.make_mesh({"data": 2}, device="cpu")
    assert not torch.distributed.is_initialized()
    assert PMesh.initialize_distributed("cpu") is False


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 64])
@pytest.mark.parametrize("max_model", [None, 4])
def test_mesh_factorizations_match_jax(n, max_model):
    assert PT.mesh_factorizations(n, max_model=max_model) == \
        JT.mesh_factorizations(n, max_model=max_model)


# ------------------------------------------------------- placement rules


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("axis", ["model", ("model", "data")],
                         ids=["model", "model_data"])
def test_fsdp_and_zero_specs_match_jax(name, axes, axis):
    jm = j_mesh(axes)
    jmodel, jparams = j_params(name)
    pmodel, pparams = p_meta(name)
    want = flat_specs(JS.fsdp_sharding(jparams, jm, axis, MIN_SIZE))
    got = flat_specs(PS.fsdp_sharding(pparams, axes, axis, MIN_SIZE))
    assert got == want
    shapes = flat_shapes(pparams)
    assert shapes == flat_shapes(jparams)
    for path, spec in flat_specs(
            PS.fsdp_sharding(pparams, axes, axis, MIN_SIZE)).items():
        jspec = jax.sharding.PartitionSpec(*spec)
        zp = PS.zero_update_spec(shapes[path], PS.P(*spec), axes)
        zj = JS.zero_update_spec(shapes[path], jspec, dict(jm.shape))
        assert normalize(zp) == normalize(zj), path
        for s in (spec, normalize(zp)):
            assert PS.local_shape(shapes[path], s, axes) == NamedSharding(
                jm, jax.sharding.PartitionSpec(*s)).shard_shape(
                    shapes[path]), (path, s)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("axes", MESHES[:3], ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_tp_specs_and_sharding_match_jax(name, axes):
    jm = j_mesh(axes)
    jmodel, jparams = j_params(name)
    pmodel, pparams = p_meta(name)
    jt = {k: normalize(v) for k, v in JS.tp_specs(jmodel, jm).items()}
    pt = {k: normalize(v) for k, v in PS.tp_specs(pmodel, axes).items()}
    assert pt == jt
    want = flat_specs(JS.tp_sharding(jmodel, jparams, jm,
                                     min_size=MIN_SIZE))
    got = flat_specs(PS.tp_sharding(pmodel, pparams, axes,
                                    min_size=MIN_SIZE))
    assert got == want
    shapes = flat_shapes(pparams)
    for path, spec in got.items():
        assert PS.local_shape(shapes[path], spec, axes) == NamedSharding(
            jm, jax.sharding.PartitionSpec(*spec)).shard_shape(shapes[path])


def test_tp_sharding_refuses_a_tuple_axis():
    pmodel, pparams = p_meta("bert")
    with pytest.raises(ValueError, match="single mesh axis"):
        PS.tp_sharding(pmodel, pparams, {"data": 2, "model": 2},
                       axis=("model", "data"))


@pytest.mark.parametrize("tx_name", ["sgd", "adam"])
@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("partition", ["fsdp", "tp"])
@pytest.mark.parametrize("name", ["bert", "llama", "moe"])
def test_training_memory_matches_jax(tx_name, zero, partition, name):
    axes = {"data": 2, "model": 2}
    jm = j_mesh(axes)
    jmodel, jparams = j_params(name)
    pmodel, pparams = p_meta(name)
    if partition == "tp":
        jsh = JS.tp_sharding(jmodel, jparams, jm, min_size=MIN_SIZE)
        psh = PS.tp_sharding(pmodel, pparams, axes, min_size=MIN_SIZE)
    else:
        jsh = JS.fsdp_sharding(jparams, jm, min_size=MIN_SIZE)
        psh = PS.fsdp_sharding(pparams, axes, min_size=MIN_SIZE)
    jtx = (optax.sgd(0.1, momentum=0.9) if tx_name == "sgd"
           else optax.adam(1e-3))
    ptx = (PO.sgd(0.1, momentum=0.9) if tx_name == "sgd"
           else PO.adam(1e-3))
    want = JM.training_memory(jmodel, jsh, axes, tx=jtx, batch_per_chip=4,
                              params=jparams, zero=zero)
    got = PM.training_memory(pmodel, psh, axes, tx=ptx, batch_per_chip=4,
                             zero=zero)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_training_memory_remat_and_bf16_match_jax():
    axes = {"data": 2, "model": 2}
    jmodel, jparams = j_params("bert")
    pmodel, pparams = p_meta("bert")
    want = JM.training_memory(
        jmodel, JS.fsdp_sharding(jparams, j_mesh(axes)), axes,
        tx=optax.adam(1e-3), batch_per_chip=8, params=jparams,
        compute_dtype=jax.numpy.bfloat16, remat=True)
    got = PM.training_memory(pmodel, PS.fsdp_sharding(pparams, axes), axes,
                             tx=PO.adam(1e-3), batch_per_chip=8,
                             compute_dtype=torch.bfloat16, remat=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_placements_opt_state_follows_params():
    """Adam's moments take their param's spec (the ZeRO domain's with
    zero), its count replicates."""
    axes = {"data": 2, "model": 2}
    pmodel, pparams = p_meta("bert")
    tx = PO.adam(1e-3)
    opt = tx.init(pparams)
    ps, ss, os_, zs = PT.plan_placements(pmodel, pparams, {}, opt, tx, axes,
                                         zero=True, min_shard_size=MIN_SIZE)
    assert zs is not None and ss == {}
    flat_z = flat_specs(zs)
    for moment in ("mu", "nu"):
        assert flat_specs(os_[0][moment]) == flat_z
    assert os_[0]["count"] == PS.P()
    assert any("data" in str(s) for s in flat_z.values())
    _, _, os2, zs2 = PT.plan_placements(pmodel, pparams, {}, opt, tx, axes,
                                        min_shard_size=MIN_SIZE)
    assert zs2 is None and flat_specs(os2[0]["mu"]) == flat_specs(ps)


# ------------------------------------------------- which rank holds what


def test_tuple_entries_split_model_major():
    """Under ``("model", "data")`` the rank at (data d, model m) holds
    piece ``m * |data| + d``, as JAX lays a tuple entry out."""
    axes = {"data": 2, "model": 2}
    full = torch.arange(8.0)
    spec = PS.P(("model", "data"))
    for d in range(2):
        for m in range(2):
            got = PS.local_shard(full, spec, fake_mesh(axes, (d, m)))
            i = m * 2 + d
            assert torch.equal(got, full[2 * i:2 * i + 2])
    jm = j_mesh(axes)
    arr = jax.device_put(np.arange(8.0), NamedSharding(
        jm, jax.sharding.PartitionSpec(("model", "data"))))
    for shard in arr.addressable_shards:
        d, m = (int(np.argwhere(jm.devices == shard.device)[0][k])
                for k in (0, 1))
        got = PS.local_shard(full, spec, fake_mesh(axes, (d, m)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_shard_batch_slices_and_refuses_an_indivisible_batch():
    axes = {"data": 2, "model": 2}
    x, y = np.arange(12).reshape(6, 2), np.arange(6)
    for d in range(2):
        xs, ys = PS.shard_batch((x, y), fake_mesh(axes, (d, 1)))
        np.testing.assert_array_equal(xs, x[3 * d:3 * d + 3])
        np.testing.assert_array_equal(ys, y[3 * d:3 * d + 3])
    with pytest.raises(ValueError, match="not divisible by mesh axis "
                                         "data=2"):
        PS.shard_batch((x[:5], y[:5]), fake_mesh(axes, (0, 0)))


def test_shard_params_warns_on_the_replication_fallback(caplog):
    axes = {"model": 3}
    tree = {"a": {"w": torch.zeros(128, 128)}, "b": {"w": torch.zeros(96)}}
    with caplog.at_level("WARNING"):
        local, specs = PS.shard_params(tree, fake_mesh(axes, (1,)),
                                       min_size=64)
    assert specs["a"]["w"] == PS.P() and specs["b"]["w"] == PS.P("model")
    assert local["b"]["w"].shape == (32,)
    assert "replicated-fallback" in caplog.text and "a/w" in caplog.text


@pytest.mark.parametrize("rank_m", [0, 1])
def test_tp_compute_plan_on_llama(rank_m):
    """The local model's attention layers carry the rank's heads; every
    claimed column / row pair computes locally."""
    axes = {"data": 1, "model": 2}
    pmodel, pparams = p_meta("llama")
    specs = PS.tp_sharding(pmodel, pparams, axes, min_size=MIN_SIZE)
    local, kinds = PT.tp_compute(pmodel, specs,
                                 fake_mesh(axes, (0, rank_m)))
    attn = pmodel.layer("block1_attn/attn")
    la = local.layer("block1_attn/attn")
    assert (la.num_heads, la.kv_heads) == (attn.num_heads // 2,
                                           attn.kv_heads // 2)
    assert kinds[("block1_attn", "attn", "wq")] == "col"
    assert kinds[("block1_attn", "attn", "wo")] == "row"
    assert kinds[("block1_ffn", "gate", "wg")] == "col"
    assert kinds[("block1_ffn", "down", "w")] == "row"
    # an irregular head grouping keeps K/V gathered, indexed globally
    pruned = pmodel.replace_layer("block1_attn/attn", dataclasses.replace(
        attn, kv_group=(0, 0, 1, 1)))
    local2, kinds2 = PT.tp_compute(pruned, specs,
                                   fake_mesh(axes, (0, rank_m)))
    la2 = local2.layer("block1_attn/attn")
    assert la2.kv_group == ((0, 0) if rank_m == 0 else (1, 1))
    assert ("block1_attn", "attn", "wk") not in kinds2


# ------------------------------------------------------ config and CLI


def test_config_runs_mesh_and_zero():
    cfg = ExperimentConfig(mesh={"data": 2, "model": 2}, zero=True)
    assert cfg.unported() == []
    with pytest.raises(ValueError, match="data"):
        ExperimentConfig(mesh={"model": 2}, zero=True)


def test_cli_zero_needs_a_data_axis(capsys):
    from torchpruner_tpu_torch import __main__ as cli

    with pytest.raises(SystemExit):
        cli.main(["--preset", "bert_glue_sensitivity", "--smoke", "--cpu",
                  "--zero"])
    assert "--zero needs a config mesh" in capsys.readouterr().err


def test_hbm_table_names_the_h100():
    assert set(PM.HBM_BYTES) == {"NVIDIA H100 80GB HBM3"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="HBM_BYTES"):
            PM.hbm_bytes()
