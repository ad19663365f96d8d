"""The port's sequence parallelism (``parallel/ring.py``, ``ulysses.py``,
``sp.py`` and the attention rule's sequence-parallel branch) against the
JAX package's on the CPU.

The port runs in one spawned world of 4 gloo ranks (``file://`` store
under ``tmp_path``), the JAX package on the conftest's 8 CPU devices, as
its own tests run it:

- ``ring_attention`` and ``ulysses_attention`` on global tensors at
  ``seq`` 2 (mesh ``{"data": 2, "seq": 2}``) and 4 (``{"seq": 4}``),
  causal and not: outputs and gradients against the JAX functions;
  ``sequence_parallel_attention``'s dispatch and the refusals;
- ``SPTrainer`` from the JAX initial params (``rebuild``), ring at
  ``{"data": 1, "seq": 4}`` and Ulysses at ``{"data": 2, "seq": 2}``:
  three Adam steps against the JAX ``SPTrainer`` on the same mesh
  shape (losses, and the JAX test's weight), every rank's params
  bit-identical after each step; a head prune then ``rebuild`` and one
  more step; ``evaluate``; remat and bf16;
- the refusals: BatchNorm, a mesh without ``seq``, attribution taps,
  and an SP model applied outside a seq group.

Tolerances are the JAX tests' own: ring and Ulysses outputs and
gradients 1e-5; SP losses rtol 1e-4 and weights rtol 1e-3 / atol 1e-5
(``test_sp_trainer.py``); ``evaluate`` rtol 1e-5.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

from test_torch_port_parallel_train import _flat, _np_tree, run_world

ATT_TOL = 1e-5
LOSS_RTOL = 1e-4
W_RTOL, W_ATOL = 1e-3, 1e-5
#: (impl, mesh) of the trainer cases
SP_CASES = [("ring", {"data": 1, "seq": 4}), ("ulysses", {"data": 2, "seq": 2})]
#: the head prune before rebuild: block1's attention, query head 1
HEAD_PRUNE = ("block1_attn/attn", [1])


def _toks(seed, B=4, S=16):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S)).astype(
        np.int32)


def _qkv(H, S=16, B=2, Dh=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, Dh)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the output cotangent


#: (strategy, mesh, heads, causal) of the attention cases
ATT_CASES = [(s, m, H, c) for s, H in (("ring", 2), ("ulysses", 8))
             for m in ({"data": 2, "seq": 2}, {"seq": 4})
             for c in (False, True)]


# ------------------------------------------------------------- the ranks


def _w_sp(rank, jax_init):
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core.pruner import prune
    from torchpruner_tpu_torch.models import llama_tiny
    from torchpruner_tpu_torch.parallel import (
        SPTrainer,
        choose_sp_strategy,
        make_mesh,
        ring_attention,
        sequence_parallel_attention,
        ulysses_attention,
    )
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss

    out = {"att": {}, "sp": {}, "errors": {}}
    meshes = {}

    def mesh(axes):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = make_mesh(axes, device="cpu")
        return meshes[key]

    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    for strategy, axes, H, causal in ATT_CASES:
        q, k, v, g = (torch.from_numpy(a).requires_grad_() for a in
                      _qkv(H))
        o = fns[strategy](q, k, v, mesh(axes), causal=causal)
        dq, dk, dv = torch.autograd.grad((o * g.detach()).sum(), (q, k, v))
        out["att"][(strategy, tuple(axes.items()), causal)] = [
            t.detach().numpy() for t in (o, dq, dk, dv)]
    m4 = mesh({"seq": 4})
    out["auto"] = {H: (choose_sp_strategy(H, m4),
                       sequence_parallel_attention(
                           *(torch.from_numpy(a) for a in _qkv(H)[:3]), m4,
                           causal=True).numpy()) for H in (8, 6)}

    def raises(tag, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the refusal under test
            out["errors"][tag] = (type(e).__name__, str(e))
        else:
            out["errors"][tag] = None

    q6 = [torch.from_numpy(a) for a in _qkv(6)[:3]]
    q30 = [torch.from_numpy(a) for a in _qkv(8, S=30)[:3]]
    raises("ulysses_heads", lambda: ulysses_attention(*q6, m4))
    raises("ulysses_seq", lambda: ulysses_attention(*q30, m4))
    raises("ring_seq", lambda: ring_attention(*q30, m4))
    raises("strategy", lambda: sequence_parallel_attention(
        *q6, m4, strategy="nope"))

    tx = optim.adam(1e-2)
    for impl, axes in SP_CASES:
        m = mesh(axes)
        t = SPTrainer.create(llama_tiny(), tx, m, seed=0, impl=impl)
        params = params_from_numpy(jax_init, device="cpu")
        t = t.rebuild(t.model, params, {}, tx.init(params))
        rec = {"losses": [], "same": []}
        for s in range(3):
            rec["losses"].append(float(t.step(_toks(s))))
            rec["same"].append(_np_tree(t.params))
        rec["params"] = _np_tree(t.params)
        rec["eval"] = t.evaluate([(_toks(0), _toks(0))],
                                 lm_cross_entropy_loss)
        if impl == "ring":
            res = prune(t.model, t.params, HEAD_PRUNE[0], HEAD_PRUNE[1],
                        state=t.state, opt_state=t.opt_state)
            t = t.rebuild(res.model, res.params, res.state, res.opt_state)
            rec["rebuild_loss"] = float(t.step(_toks(3)))
            rec["rebuild_params"] = _np_tree(t.params)
            rec["rebuild_heads"] = t.model.layer(HEAD_PRUNE[0]).num_heads
        out["sp"][impl] = rec
    # remat leaves the loss as it is; bf16 runs close to f32
    m = mesh(SP_CASES[0][1])
    base = [float(SPTrainer.create(llama_tiny(), optim.adam(1e-3), m,
                                   seed=0, **kw).step(_toks(0)))
            for kw in ({}, {"remat": True},
                       {"compute_dtype": torch.bfloat16})]
    out["remat_bf16"] = base

    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.models import fmnist_convnet
    from torchpruner_tpu_torch.parallel import collectives as C
    from torchpruner_tpu_torch.parallel.sp import sp_model

    raises("batchnorm", lambda: SPTrainer.create(
        fmnist_convnet(), optim.adam(1e-3), m))
    raises("axes", lambda: SPTrainer.create(
        llama_tiny(), optim.adam(1e-3), mesh({"data": 4})))
    sm = sp_model(llama_tiny(), "ring")
    params, state = init_model(llama_tiny(), 0, device="cpu")
    x = torch.from_numpy(_toks(0, B=1, S=4))

    def taps():
        with C.sequence_parallel_over(m.get_group("seq")):
            sm.apply(params, x, state=state,
                     unit_mask=("block1_attn/attn", torch.ones(4)))

    raises("taps", taps)
    raises("outside", lambda: sm.apply(params, x, state=state))
    out["layer_impl"] = sm.layer("block2_attn/attn").impl
    return out


# ----------------------------------------------------- the JAX references


def _jax_init():
    from torchpruner_tpu.core.segment import init_model
    from torchpruner_tpu.models import llama_tiny

    params, _ = init_model(llama_tiny(), seed=0)
    return _np_tree(params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(4, _w_sp, tmp_path_factory.mktemp("sp"), _jax_init(),
                     timeout=300)


def _jax_mesh(axes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


@pytest.mark.parametrize("strategy,axes,H,causal", ATT_CASES,
                         ids=lambda c: str(c))
def test_ring_and_ulysses_match_jax(world, strategy, axes, H, causal):
    """Outputs and the gradients of ``sum(out * g)`` with respect to the
    global q, k, v, on every rank, against the JAX function."""
    import jax
    import jax.numpy as jnp

    from torchpruner_tpu.parallel.ring import ring_attention
    from torchpruner_tpu.parallel.ulysses import ulysses_attention

    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[strategy]
    mesh = _jax_mesh(axes)
    q, k, v, g = (jnp.asarray(a) for a in _qkv(H))

    @jax.jit  # one program: eager shard_map dispatch takes ~20x longer
    def out_and_grads(q_, k_, v_):
        o, vjp = jax.vjp(lambda *a: fn(*a, mesh, causal=causal), q_, k_, v_)
        return (o,) + vjp(g)

    want = [np.asarray(t) for t in out_and_grads(q, k, v)]
    for res in world:
        got = res["att"][(strategy, tuple(axes.items()), causal)]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=ATT_TOL, rtol=ATT_TOL)


def test_dispatch_and_refusals(world):
    from torchpruner_tpu.ops.flash_attention import _xla_attention
    from torchpruner_tpu_torch.parallel import choose_sp_strategy

    for res in world:
        for H, expected in ((8, "ulysses"), (6, "ring")):
            strategy, out = res["auto"][H]
            assert strategy == expected
            ref = _xla_attention(*_qkv(H)[:3], causal=True)
            np.testing.assert_allclose(out, np.asarray(ref), atol=ATT_TOL)
        e = res["errors"]
        assert e["ulysses_heads"][0] == "ValueError" \
            and "heads" in e["ulysses_heads"][1]
        assert e["ulysses_seq"][0] == "ValueError" \
            and "sequence" in e["ulysses_seq"][1]
        assert e["ring_seq"][0] == "ValueError"
        assert "strategy" in e["strategy"][1]
        assert e["batchnorm"][0] == "NotImplementedError" \
            and "BatchNorm" in e["batchnorm"][1]
        assert e["axes"][0] == "ValueError" and "seq" in e["axes"][1]
        assert e["taps"][0] == "NotImplementedError" \
            and "taps" in e["taps"][1]
        assert e["outside"][0] == "RuntimeError" \
            and "sp_model" in e["outside"][1]
        assert res["layer_impl"] == "ring"
    assert choose_sp_strategy(8, {"seq": 8}) == "ulysses"
    assert choose_sp_strategy(6, {"seq": 8}) == "ring"


def _jax_sp_run(impl, axes):
    import jax
    import jax.numpy as jnp
    import optax

    from torchpruner_tpu.core.pruner import prune
    from torchpruner_tpu.models import llama_tiny
    from torchpruner_tpu.parallel import SPTrainer
    from torchpruner_tpu.utils.losses import lm_cross_entropy_loss

    t = SPTrainer.create(llama_tiny(), optax.adam(1e-2), _jax_mesh(axes),
                         seed=0, impl=impl)
    out = {"losses": [float(t.step(_toks(s))) for s in range(3)],
           "params": _np_tree(jax.device_get(t.params)),
           "eval": t.evaluate([(_toks(0), _toks(0))], lm_cross_entropy_loss)}
    if impl == "ring":
        res = prune(t.model, jax.device_get(t.params), HEAD_PRUNE[0],
                    HEAD_PRUNE[1], state=jax.device_get(t.state),
                    opt_state=jax.device_get(t.opt_state))
        t = t.rebuild(res.model, jax.tree_util.tree_map(jnp.asarray,
                                                        res.params),
                      res.state, res.opt_state)
        out["rebuild_loss"] = float(t.step(_toks(3)))
        out["rebuild_params"] = _np_tree(jax.device_get(t.params))
    return out


def _params_close(got, want):
    """Every leaf's shape, and the JAX test's leaf (``block1_ffn``'s gate)
    within its bound: Adam moves a weight whose gradient is at rounding
    level by +-lr in either package, so other leaves hold a few such
    elements."""
    got, want = _flat(got), _flat(want)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    path = ("block1_ffn", "gate", "wg")
    np.testing.assert_allclose(got[path], want[path], rtol=W_RTOL,
                               atol=W_ATOL)


@pytest.mark.parametrize("impl,axes", SP_CASES, ids=["ring", "ulysses"])
def test_sp_trainer_matches_jax(world, impl, axes):
    """Three Adam steps from the JAX init against the JAX SPTrainer on
    the same mesh shape: losses, the JAX test's weight, ``evaluate``;
    every rank
    holds the same params bit for bit after every step; ring then
    prunes a head, rebuilds and steps once more."""
    want = _jax_sp_run(impl, axes)
    for res in world:
        got = res["sp"][impl]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        _params_close(got["params"], want["params"])
        np.testing.assert_allclose(got["eval"][0], want["eval"][0],
                                   rtol=1e-5)
        assert got["eval"][1] == want["eval"][1]
        for s, tree in enumerate(got["same"]):
            for path, a in _flat(tree).items():
                np.testing.assert_array_equal(
                    a, _flat(world[0]["sp"][impl]["same"][s])[path])
        if impl == "ring":
            assert got["rebuild_heads"] == 3
            np.testing.assert_allclose(got["rebuild_loss"],
                                       want["rebuild_loss"], rtol=LOSS_RTOL)
            _params_close(got["rebuild_params"], want["rebuild_params"])


def test_sp_trainer_remat_and_bf16(world):
    """remat leaves the loss as it is (rtol 1e-5); bf16 runs, within 0.1
    of f32 (the JAX test's bounds)."""
    for res in world:
        base, rem, b16 = res["remat_bf16"]
        np.testing.assert_allclose(rem, base, rtol=1e-5)
        assert np.isfinite(b16) and abs(b16 - base) < 0.1


@pytest.mark.parametrize("causal", [False, True])
def test_chunk_streaming_matches_jax(causal):
    """The streamed chunk (KV blocks of 16, queries inside the chunk)
    against the JAX ``_chunk_stats``, values and gradients, and against
    the port's one-block statistics."""
    import jax
    import jax.numpy as jnp

    from torchpruner_tpu.parallel.ring import _chunk_stats as j_chunk
    from torchpruner_tpu_torch.parallel.ring import (
        _block_stats,
        _chunk_stats,
    )

    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 8, 2, 4)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 4)).astype(np.float32)

    def j_loss(q_, k_, v_):
        m, l, acc = j_chunk(q_, k_, v_, 32, 0, causal, block_k=16)
        return jnp.sum(acc / l[..., None])

    want = j_chunk(*(jnp.asarray(a) for a in (q, k, v)), 32, 0, causal,
                   block_k=16)
    want_g = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = _chunk_stats(qt, kt, vt, 32, 0, causal, block_k=16)
    one = _block_stats(qt, kt, vt, 32, 0, causal)
    got_g = torch.autograd.grad((got[2] / got[1][..., None]).sum(),
                                (qt, kt, vt))
    for g, w, o in zip(got, want, one):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.detach().numpy(), o.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_sp_model_converts_nested_attention():
    from torchpruner_tpu_torch.models import llama_tiny
    from torchpruner_tpu_torch.parallel import sp_model
    from torchpruner_tpu_torch.parallel.sp import aligned_targets

    m = sp_model(llama_tiny(), "ulysses")
    assert m.layer("block1_attn/attn").impl == "ulysses"
    assert sp_model(m, "auto").layer("block2_attn/attn").impl == "auto"
    with pytest.raises(ValueError, match="impl"):
        sp_model(llama_tiny(), "nope")
    tgt, mask = aligned_targets(_toks(0))
    np.testing.assert_array_equal(tgt[:, :-1], _toks(0)[:, 1:])
    assert (tgt[:, -1] == 0).all() and (mask[:, -1] == 0).all()
    assert mask[:, :-1].all()
