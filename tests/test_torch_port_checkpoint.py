"""The port's checkpoint format against the JAX package's, on the CPU.

A checkpoint written by either package restores in the other:

- every restored leaf equals the writer's byte for byte (int payloads,
  scales and float leaves alike), QTensor metadata and BatchNorm state
  included;
- the restoring package's forward equals the writing package's on the
  same inputs: within 1e-6 x max|output| for the MLP and the BatchNorm
  convnet, 4e-6 for ``llama_tiny`` and ``llama_moe_tiny`` float32 (two
  attention blocks compound sums taken in another order: the gap
  measured is 1.2e-6), and 2**-6 (4 bf16 ulps) for the int4 / int8
  Llama trees, whose bf16 activations round at other points in the two
  frameworks; quantized MoE trees decode at an f32 cache (widened
  weights, f32 activations: 4e-6; the gap measured is 1.1e-6), because
  bf16 rounding can swap a token's experts at a near-tie;
- MoE (``llama_moe_tiny``): dense and sparse dispatch in float32, int8,
  int4, and int4 after one of four experts was pruned (the odd count
  makes ``wo`` pack along F: ``pack_axis`` crosses with the leaf);
- both packages seal the same ``arrays/`` digest for the same tree, with
  byte-identical ``index.json``.

Within the port: corruption, truncation, atomic overwrite and an
interrupted re-save (mirrored from ``tests/test_checkpoint.py``),
optimizer state for SGD and Adam, the refusal of a cross-optimizer
restore (also of a JAX-written optimizer state: it does not cross),
bfloat16 leaves without ``ml_dtypes``, ``run_train`` resumed from
``checkpoint_path`` equal to an uninterrupted run, and the robustness
sweep restoring its model from ``checkpoint_path``.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu import checkpoint as JC
from torchpruner_tpu.core.pruner import prune as j_prune
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.generate import _decode_seq as j_decode_seq
from torchpruner_tpu.generate import init_cache as j_init_cache
from torchpruner_tpu.models import convnet as JCN
from torchpruner_tpu.models import llama_moe_tiny as j_llama_moe_tiny
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.models import mlp as JMLP
from torchpruner_tpu.ops.quant import QTensor as JQTensor
from torchpruner_tpu.ops.quant import quantize_params as j_quantize_params
from torchpruner_tpu_torch import checkpoint as PC
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core.segment import init_model as p_init_model
from torchpruner_tpu_torch.generate import _decode_seq as p_decode_seq
from torchpruner_tpu_torch.generate import init_cache as p_init_cache
from torchpruner_tpu_torch.models import mlp as PMLP
from torchpruner_tpu_torch.ops.quant import QTensor as PQTensor
from torchpruner_tpu_torch.train import optim as PO

CASES = ["llama_f32", "llama_int4", "llama_int8", "bn_convnet",
         "mlp_pruned", "moe_f32", "moe_sparse_f32", "moe_int8", "moe_int4",
         "moe_odd_int4"]
#: forward tolerance, x max|output| (see the module docstring)
FWD_TOL = {"llama_f32": 4e-6, "llama_int4": 2 ** -6, "llama_int8": 2 ** -6,
           "bn_convnet": 1e-6, "mlp_pruned": 1e-6, "moe_f32": 4e-6,
           "moe_sparse_f32": 4e-6, "moe_int8": 4e-6, "moe_int4": 4e-6,
           "moe_odd_int4": 4e-6}


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


def _case(kind):
    """``(JAX model, params, state, input)`` of one case tree."""
    rng = np.random.default_rng(7)
    if kind.startswith("moe"):
        model = j_llama_moe_tiny(
            dispatch="sparse" if "sparse" in kind else "dense")
        params, state = j_init_model(model, seed=0)
        if kind == "moe_odd_int4":  # 4 -> 3 experts, then quantize
            res = j_prune(model, params, "block1_moe/experts", [2])
            model, params = res.model, res.params
        if kind.endswith(("int4", "int8")):
            params = j_quantize_params(model, params, bits=int(kind[-1]))
        return model, params, state, rng.integers(0, 256, size=(2, 12))
    if kind.startswith("llama"):
        model = j_llama_tiny()
        params, state = j_init_model(model, seed=0)
        if kind != "llama_f32":
            params = j_quantize_params(model, params,
                                       bits=int(kind[-1]))
        return model, params, state, rng.integers(0, 256, size=(2, 12))
    if kind == "bn_convnet":
        model = JCN.digits_convnet()
        params, state = j_init_model(model, seed=0)
        x = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
        # one train-mode pass: running statistics other than 0 / 1
        _, state = model.apply(params, jnp.asarray(x), state=state,
                               train=True, rng=jax.random.PRNGKey(0))
        return model, params, state, x
    model = JMLP.fc_net(8, hidden=(16, 12), n_classes=3)
    params, state = j_init_model(model, seed=0)
    res = j_prune(model, params, "fc1", [0, 3, 5, 9], state=state)
    res = j_prune(res.model, res.params, "fc2", [1, 2], state=res.state)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    return res.model, res.params, res.state, x


def _bf16_cache(model, params) -> bool:
    """Quantized Llama trees decode at their serving config, a bf16
    cache.  MoE trees decode at an f32 cache: a router logit rounded to
    bf16 at another point in each framework can swap a token's experts
    where two logits nearly tie (a discrete choice), so the forwards
    would not be comparable."""
    return isinstance(params["lm_head"]["w"], (JQTensor, PQTensor)) \
        and not any("moe" in k for k in params)


def _j_forward(model, params, state, x):
    if model.input_dtype == "int32":
        dt = jnp.bfloat16 if _bf16_cache(model, params) else jnp.float32
        cache = j_init_cache(model, x.shape[0], x.shape[1], dt)
        y, _ = j_decode_seq(model.layers, params, cache, jnp.asarray(x), 0)
    else:
        y, _ = model.apply(params, jnp.asarray(x), state=state)
    return np.asarray(y.astype(jnp.float32))


def _p_forward(model, params, state, x):
    with torch.no_grad():
        if model.input_dtype == "int32":
            dt = torch.bfloat16 if _bf16_cache(model, params) \
                else torch.float32
            cache = p_init_cache(model, x.shape[0], x.shape[1], dt,
                                 device="cpu")
            y, _ = p_decode_seq(model.layers, params, cache,
                                torch.from_numpy(x).long(), 0)
        else:
            y, _ = model.apply(params, torch.from_numpy(x), state=state,
                               train=False)
    return y.float().numpy()


def _leaves(tree, path=""):
    """``{path: numpy}`` of a tree of either package (QTensors as their
    payload and scale)."""
    if isinstance(tree, (JQTensor, PQTensor)):
        return {f"{path}/q": _np(tree.q), f"{path}/scale": _np(tree.scale)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    return {path: _np(tree)}


def _np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_leaves(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_forward_close(got, want, kind):
    tol = FWD_TOL[kind] * float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol, kind


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", CASES)
def test_checkpoint_crosses_packages(tmp_path, kind, direction):
    """A checkpoint written by one package restores in the other: the
    same spec, leaves byte-equal to the writer's, QTensor metadata kept,
    and the reader's forward equal to the writer's."""
    jmodel, jparams, jstate, x = _case(kind)
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        JC.save_checkpoint(path, jmodel, jparams, jstate, step=5,
                           prune_history=[{"layer": "fc1"}])
        model, params, state, opt, meta = PC.restore_checkpoint(
            path, device="cpu")
        assert model == model_from_reference(jmodel)
        _assert_same_leaves(params, jparams)
        _assert_same_leaves(state, jstate)
        got = _p_forward(model, params, state, x)
        want = _j_forward(jmodel, jparams, jstate, x)
    else:
        pmodel = model_from_reference(jmodel)
        pparams = params_from_numpy(numpy_tree(jparams), device="cpu")
        pstate = params_from_numpy(numpy_tree(jstate), device="cpu")
        PC.save_checkpoint(path, pmodel, pparams, pstate, step=5,
                           prune_history=[{"layer": "fc1"}])
        model, params, state, opt, meta = JC.restore_checkpoint(path)
        assert model == jmodel
        _assert_same_leaves(params, pparams)
        _assert_same_leaves(state, pstate)
        got = _j_forward(model, params, state, x)
        want = _p_forward(pmodel, pparams, pstate, x)
    assert opt is None
    assert meta["step"] == 5 and meta["prune_history"] == [{"layer": "fc1"}]
    assert meta["widths"] == jmodel.widths()
    if kind.startswith("llama_int"):
        leaf = params["block1_ffn"]["gate"]["wg"]
        assert leaf.bits == int(kind[-1])
        assert tuple(leaf.in_axes) == (0,)
    if kind.startswith("moe") and kind.endswith(("int4", "int8")):
        leaf = params["block1_moe"]["experts"]["wo"]
        assert leaf.bits == int(kind[-1])
        assert tuple(leaf.in_axes) == (0, 1)
        assert leaf.pack_axis == (1 if kind == "moe_odd_int4" else 0)
    _assert_forward_close(got, want, kind)


@pytest.mark.parametrize("kind", CASES)
def test_same_tree_same_digest(tmp_path, kind):
    """The same params and state give byte-identical ``index.json`` and
    ``data.bin`` in both packages, so the sealed digests are equal."""
    jmodel, jparams, jstate, _ = _case(kind)
    JC.save_checkpoint(str(tmp_path / "j"), jmodel, jparams, jstate)
    PC.save_checkpoint(str(tmp_path / "p"), model_from_reference(jmodel),
                       params_from_numpy(numpy_tree(jparams), device="cpu"),
                       params_from_numpy(numpy_tree(jstate), device="cpu"))
    for name in ("index.json", "data.bin"):
        assert (tmp_path / "j" / "arrays" / name).read_bytes() \
            == (tmp_path / "p" / "arrays" / name).read_bytes(), name
    metas = [json.loads((tmp_path / d / "spec.json").read_text())
             for d in ("j", "p")]
    assert metas[0]["digest"] == metas[1]["digest"] \
        == PC._tree_digest(str(tmp_path / "p" / "arrays"))
    assert metas[0] == metas[1]


@pytest.mark.parametrize("make", ["fc_net", "digits_convnet", "llama_tiny",
                                  "vit_tiny", "resnet20_cifar",
                                  "llama_moe_tiny", "llama_moe_sparse"])
def test_spec_roundtrip(make):
    from torchpruner_tpu_torch import models as PM

    model = {"fc_net": lambda: PMLP.fc_net(8, hidden=(16,), n_classes=3),
             "digits_convnet": PM.digits_convnet,
             "llama_tiny": PM.llama_tiny, "vit_tiny": PM.vit_tiny,
             "resnet20_cifar": PM.resnet20_cifar,
             "llama_moe_tiny": PM.llama_moe_tiny,
             "llama_moe_sparse": lambda: PM.llama_moe_tiny(
                 dispatch="sparse", capacity_factor=2.0)}[make]()
    d = PC.spec_to_dict(model)
    assert PC.spec_from_dict(json.loads(json.dumps(d))) == model


# -- integrity (mirrors tests/test_checkpoint.py) -----------------------------


def _mlp():
    model = PMLP.fc_net(8, hidden=(8,), n_classes=3)
    params, state = p_init_model(model, seed=0, device="cpu")
    return model, params, state


def _corrupt_largest_array_file(path):
    arrays = os.path.join(path, "arrays")
    victim = max((os.path.join(arrays, f) for f in os.listdir(arrays)),
                 key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupted_checkpoint_raises_descriptive_error(tmp_path):
    model, params, state = _mlp()
    path = str(tmp_path / "ckpt")
    PC.save_checkpoint(path, model, params, state)
    PC.restore_checkpoint(path, device="cpu")  # intact: verifies clean
    _corrupt_largest_array_file(path)
    with pytest.raises(PC.CheckpointCorruptError, match="digest"):
        PC.restore_checkpoint(path, device="cpu")


def test_truncated_spec_and_data_raise_descriptive_errors(tmp_path):
    model, params, state = _mlp()
    path = str(tmp_path / "ckpt")
    PC.save_checkpoint(path, model, params, state)
    data = os.path.join(path, "arrays", "data.bin")
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) - 4)
    with pytest.raises(PC.CheckpointCorruptError, match="digest"):
        PC.restore_checkpoint(path, device="cpu")
    spec = os.path.join(path, "spec.json")
    with open(spec, "r+b") as f:
        f.truncate(os.path.getsize(spec) // 2)
    with pytest.raises(PC.CheckpointCorruptError,
                       match="unreadable|truncated"):
        PC.restore_checkpoint(path, device="cpu")
    with pytest.raises(PC.CheckpointCorruptError, match="no spec.json"):
        PC.restore_checkpoint(str(tmp_path / "nope"), device="cpu")


def test_atomic_save_preserves_previous_on_overwrite(tmp_path):
    model, params, state = _mlp()
    path = str(tmp_path / "ckpt")
    PC.save_checkpoint(path, model, params, state, step=1)
    PC.save_checkpoint(path, model, params, state, step=2)
    _, _, _, _, meta = PC.restore_checkpoint(path, device="cpu")
    assert meta["step"] == 2
    assert [e for e in os.listdir(path) if e.startswith(".arrays.")
            or e.endswith(".tmp")] == []


def test_interrupted_resave_recovers_displaced_old_tree(tmp_path):
    model, params, state = _mlp()
    path = str(tmp_path / "ckpt")
    PC.save_checkpoint(path, model, params, state, step=1)
    # the crash window: arrays displaced, spec.json still the step-1
    # commit (its digest seals the displaced tree)
    os.rename(os.path.join(path, "arrays"),
              os.path.join(path, ".arrays.old.99999"))
    _, _, _, _, meta = PC.restore_checkpoint(path, device="cpu")
    assert meta["step"] == 1
    assert os.path.isdir(os.path.join(path, "arrays"))
    PC.save_checkpoint(path, model, params, state, step=2)
    assert [e for e in os.listdir(path)
            if e.startswith((".arrays.old.", ".arrays.tmp."))] == []
    assert PC.restore_checkpoint(path, device="cpu")[4]["step"] == 2


# -- optimizer state ----------------------------------------------------------


def _stepped_opt_state(tx, model, params):
    grads = {k: {n: torch.full_like(t, 0.1) for n, t in v.items()}
             for k, v in params.items()}
    state = tx.init(params)
    for _ in range(2):
        _, state = tx.update(grads, state, params)
    return state


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_opt_state_roundtrip_within_the_port(tmp_path, opt):
    model, params, state = _mlp()
    tx = {"sgd": lambda: PO.sgd(PO.cosine_decay_schedule(0.1, 10),
                                momentum=0.9),
          "adam": lambda: PO.adam(1e-3)}[opt]()
    opt_state = _stepped_opt_state(tx, model, params)
    path = str(tmp_path / "ckpt")
    PC.save_checkpoint(path, model, params, state, opt_state)
    _, p2, _, o2, meta = PC.restore_checkpoint(path, tx=tx, device="cpu")
    assert meta["opt_treedef"].endswith(PC.opt_structure(opt_state))
    assert PC.opt_structure(o2) == PC.opt_structure(opt_state)
    for a, b in zip(PC._opt_leaves(o2), PC._opt_leaves(opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the restored state keeps stepping as the original does
    g = {k: {n: torch.full_like(t, -0.2) for n, t in v.items()}
         for k, v in params.items()}
    u1, _ = tx.update(g, o2, p2)
    u2, _ = tx.update(g, opt_state, params)
    for k in params:
        for n in params[k]:
            assert torch.equal(u1[k][n], u2[k][n])


def test_cross_optimizer_restore_is_refused(tmp_path):
    """sgd(momentum) and adam states differ in structure: restoring under
    the wrong optimizer raises instead of cross-wiring slots, and so
    does a JAX-written (optax) optimizer state, which does not cross."""
    import optax

    model, params, state = _mlp()
    path = str(tmp_path / "ckpt")
    sgd = PO.sgd(0.1, momentum=0.9)
    PC.save_checkpoint(path, model, params, state, sgd.init(params))
    assert PC.restore_checkpoint(path, tx=PO.sgd(0.1, momentum=0.9),
                                 device="cpu")[3] is not None
    with pytest.raises(ValueError, match="structure mismatch"):
        PC.restore_checkpoint(path, tx=PO.adam(1e-3), device="cpu")
    jmodel = JMLP.fc_net(8, hidden=(8,), n_classes=3)
    jparams, jstate = j_init_model(jmodel, seed=0)
    jtx = optax.sgd(0.1, momentum=0.9)
    JC.save_checkpoint(str(tmp_path / "j"), jmodel, jparams, jstate,
                       jtx.init(jparams))
    with pytest.raises(ValueError, match="structure mismatch"):
        PC.restore_checkpoint(str(tmp_path / "j"),
                              tx=PO.sgd(0.1, momentum=0.9), device="cpu")
    # params and state still cross without the optimizer
    _, p2, _, _, _ = PC.restore_checkpoint(str(tmp_path / "j"),
                                           device="cpu")
    _assert_same_leaves(p2, jparams)


def test_bfloat16_leaves_without_ml_dtypes(tmp_path):
    """bf16 leaves are written and read through torch: a fresh
    interpreter in which ``ml_dtypes`` cannot be imported saves and
    restores them, and the JAX package reads them back."""
    path = str(tmp_path / "ckpt")
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from torchpruner_tpu_torch import checkpoint as PC\n"
        "from torchpruner_tpu_torch.models import mlp\n"
        "from torchpruner_tpu_torch.core.segment import init_model\n"
        "m = mlp.fc_net(8, hidden=(8,), n_classes=3)\n"
        "p, s = init_model(m, seed=0, device='cpu')\n"
        "p = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}"
        " for k, v in p.items()}\n"
        f"PC.save_checkpoint({path!r}, m, p, s)\n"
        f"_, q, _, _, _ = PC.restore_checkpoint({path!r}, device='cpu')\n"
        "assert q['fc1']['w'].dtype == torch.bfloat16\n"
        "assert all(torch.equal(q[k][n], p[k][n]) for k in p for n in p[k])\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    _, jp, _, _, _ = JC.restore_checkpoint(path)
    assert jp["fc1"]["w"].dtype == jnp.bfloat16
    _, pp, _, _, _ = PC.restore_checkpoint(path, device="cpu")
    _assert_same_leaves(pp, jp)


# -- training and the sweep from checkpoint_path ------------------------------


@pytest.mark.parametrize("recipe", [("adam", "constant"), ("sgd", "cosine")])
def test_run_train_resumes_from_checkpoint_path(tmp_path, monkeypatch,
                                                recipe):
    """A run killed right after its epoch-1 checkpoint and started again
    with the same config resumes from ``checkpoint_path`` and ends where
    an uninterrupted run ends: the same epoch-1 record, params and
    optimizer state (schedule position included)."""
    from torchpruner_tpu_torch.experiments import presets as PPS
    from torchpruner_tpu_torch.experiments import train_model as PTM

    optimizer, schedule = recipe
    cfg = dataclasses.replace(
        PPS.get_preset("vgg16_digits32_layerwise", smoke=True),
        model="digits_fc_tiny", dataset="digits_flat", epochs=2,
        optimizer=optimizer, lr_schedule=schedule,
        lr=1e-3 if optimizer == "adam" else 0.05,
        log_path=str(tmp_path / "a.csv"))
    full, full_hist = PTM.run_train(cfg, verbose=False, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    cfg = dataclasses.replace(cfg, checkpoint_path=ckpt,
                              checkpoint_every_epochs=1,
                              log_path=str(tmp_path / "b.csv"))

    class Killed(Exception):
        pass

    def save_then_die(*a, **kw):
        PC.save_checkpoint(*a, **kw)
        raise Killed

    monkeypatch.setattr(PTM, "save_checkpoint", save_then_die)
    with pytest.raises(Killed):
        PTM.run_train(cfg, verbose=False, device="cpu")
    monkeypatch.undo()
    assert PC.restore_checkpoint(ckpt, device="cpu")[4]["extra"] \
        == {"epoch": 1}
    resumed, hist = PTM.run_train(cfg, verbose=False, device="cpu")
    assert [h["epoch"] for h in hist] == [1]
    for k in ("train_loss", "test_loss", "test_acc"):
        assert hist[0][k] == full_hist[1][k], k
    for tree in ("params", "opt_state"):
        got = PC._opt_leaves(getattr(resumed, tree))
        want = PC._opt_leaves(getattr(full, tree))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), tree
    assert PC.restore_checkpoint(ckpt, device="cpu")[4]["extra"] \
        == {"epoch": 2}


def test_robustness_sweep_restores_checkpoint_path(tmp_path):
    """Without params the sweep restores model, params and state from
    ``cfg.checkpoint_path``; a missing path raises instead of sweeping
    random weights."""
    from torchpruner_tpu_torch.experiments import presets as PPS
    from torchpruner_tpu_torch.experiments.robustness import (
        run_robustness_config,
    )
    from torchpruner_tpu_torch.models import digits_convnet

    model = digits_convnet()
    params, state = p_init_model(model, seed=3, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    PC.save_checkpoint(ckpt, model, params, state)
    cfg = dataclasses.replace(
        PPS.get_preset("vgg16_digits32_layerwise", smoke=True),
        model="digits_convnet", dataset="digits", method="weight_norm",
        method_kwargs={},
        target_filter=("fc1",), score_examples=32, eval_batch_size=32,
        checkpoint_path=ckpt)
    got = run_robustness_config(cfg, verbose=False, device="cpu")
    want = run_robustness_config(
        dataclasses.replace(cfg, checkpoint_path=""), params=params,
        state=state, verbose=False, device="cpu")
    assert got == want
    with pytest.raises(FileNotFoundError):
        run_robustness_config(
            dataclasses.replace(cfg, checkpoint_path=str(tmp_path / "no")),
            verbose=False, device="cpu")
