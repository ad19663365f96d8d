"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs as its own tests run it: the decode kernel in Pallas
interpret mode, the dequant kernel with ``fused_matmul.INT8_KERNEL``
forced on and (D, F) multiples of 128 so the Pallas kernel tiles.  On
the CPU the port runs its plain versions (the CUDA kernels are compared
with those on the card: tests/test_torch_port_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpruner_tpu.ops import decode_attention as JDA
from torchpruner_tpu.ops import fused_matmul as JFM
from torchpruner_tpu.ops import int4_matmul as JI4
from torchpruner_tpu.ops import quant as JQ
from torchpruner_tpu_torch.ops import decode_attention as PDA
from torchpruner_tpu_torch.ops import fused_matmul as PFM
from torchpruner_tpu_torch.ops import int4_matmul as PI4
from torchpruner_tpu_torch.ops import quant as PQ


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# -- (a) decode attention ----------------------------------------------------


def _decode_inputs(B, T, H, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_kernel_ragged_and_poisoned(dtype):
    """Tolerance: f32 caches agree to rtol 1e-5 (sums in another order);
    bf16 caches store the output in bf16, so one bf16 ulp (2**-8
    relative) may separate the two."""
    B, T, H, Dh = 3, 64, 2, 16
    q, k, v = _decode_inputs(B, T, H, Dh)
    pos = np.array([0, 29, T - 1], np.int32)
    for b, p in enumerate(pos):  # stale rows past pos: poisoned
        k[b, p + 1:] = 1e4
        v[b, p + 1:] = -1e4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(JDA.decode_attention(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos)).astype(jnp.float32))
    got = PDA.decode_attention(_t(q), _t(k).to(tdt), _t(v).to(tdt),
                               _t(pos)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def test_decode_scalar_pos_matches_jax_and_vector_form():
    B, T, H, Dh = 2, 40, 2, 8  # T = 40: block 8, as in JAX
    q, k, v = _decode_inputs(B, T, H, Dh, seed=1)
    want = np.asarray(JDA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 17))
    got = PDA.decode_attention(_t(q), _t(k), _t(v), 17).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    vec = PDA.decode_attention(_t(q), _t(k), _t(v),
                               torch.tensor([17, 17], dtype=torch.int32))
    assert torch.equal(vec, torch.from_numpy(got))


@pytest.mark.parametrize("pos", [0, 5, "ragged"])
def test_masked_prefill_path_matches_xla_decode_attention(pos):
    """s > 1: the port's fixed-block online softmax against the JAX
    masked einsum (f32: rtol 1e-5)."""
    rng = np.random.default_rng(2)
    B, s, T, H, Dh = 2, 21, 48, 2, 8
    q = rng.normal(size=(B, s, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    if pos == "ragged":
        jpos, tpos = jnp.asarray([3, 20], jnp.int32), torch.tensor([3, 20])
    else:
        jpos, tpos = pos, pos
    want = np.asarray(JDA.xla_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos))
    got = PDA.xla_decode_attention(_t(q), _t(k), _t(v), tpos).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_masked_prefill_rows_independent_of_prompt_and_cache_length():
    """The bit-identity the engine's bucket prefill needs: a row's result
    does not change with the number of rows or the cache length."""
    rng = np.random.default_rng(3)
    H, Dh = 2, 8
    q = _t(rng.normal(size=(1, 40, H, Dh)).astype(np.float32))
    k = _t(rng.normal(size=(1, 96, H, Dh)).astype(np.float32))
    v = _t(rng.normal(size=(1, 96, H, Dh)).astype(np.float32))
    long = PDA.xla_decode_attention(q, k, v, 0)
    short = PDA.xla_decode_attention(q[:, :23], k[:, :40], v[:, :40], 0)
    assert torch.equal(long[:, :23], short)


def test_decode_block_rule_matches_jax():
    for T in (8, 24, 64, 96, 100, 512, 20):
        assert PDA.decode_block(T) == JDA.decode_block(T)


# -- (b) int4 / int8 bytes and the dequant matmul -----------------------------


def test_pack_unpack_bytes_equal_jax():
    rng = np.random.default_rng(4)
    vals = rng.integers(-8, 8, size=(64, 48)).astype(np.int8)
    jp = np.asarray(JI4.pack_int4(jnp.asarray(vals)))
    tp = PI4.pack_int4(_t(vals)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(PI4.unpack_int4(_t(jp)).numpy(), vals)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    jq, js = JI4.quantize_int4(jnp.asarray(w))
    tq, ts = PI4.quantize_int4(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits,shape,in_axes", [
    (8, (32, 24), (0,)), (4, (32, 24), (0,)), (8, (16, 4, 8), (0,)),
    (4, (16, 4, 8), (0,)), (4, (4, 8, 16), (0, 1)), (8, (4, 8, 16), (0, 1)),
])
def test_quantize_tensor_bytes_and_scales_equal_jax(bits, shape, in_axes):
    w = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jt = JQ.quantize_tensor(jnp.asarray(w), in_axes=in_axes, bits=bits)
    pt = PQ.quantize_tensor(_t(w), in_axes=in_axes, bits=bits)
    np.testing.assert_array_equal(pt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(jt.scale))
    assert (pt.in_axes, pt.bits, pt.pack_axis) == \
        (jt.in_axes, jt.bits, jt.pack_axis)
    assert pt.shape == tuple(jt.shape)
    np.testing.assert_array_equal(pt.dequantize().numpy(),
                                  np.asarray(jt.dequantize()))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("with_scale", [False, True])
def test_dequant_plain_matches_jax_kernel(bits, with_scale):
    """(D, F) = (256, 384) tiles the Pallas kernel.  Tolerance rtol 1e-5
    of the output scale: both take exact bf16 x int products and f32
    sums, in different orders."""
    rng = np.random.default_rng(6)
    D, F, M = 256, 384, 8
    x = rng.normal(size=(M, D)).astype(np.float32)
    w = rng.normal(size=(D, F)).astype(np.float32)
    jt = JQ.quantize_tensor(jnp.asarray(w), in_axes=(0,), bits=bits)
    scale = np.asarray(jt.out_scale()) if with_scale else None
    want = np.asarray(JFM.dequant_matmul(
        jnp.asarray(x), jt.q, None if scale is None else jnp.asarray(scale),
        bits=bits))
    got = PFM.dequant_matmul(
        _t(x), _t(np.asarray(jt.q)), None if scale is None else _t(scale),
        bits=bits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits", [4, 8])
def test_qdot_oscale_matches_jax_with_kernel_forced(bits, monkeypatch):
    """The qdot routing of both packages on bf16 activations, with the
    int8 kernel forced on in both: bf16 outputs agree to one bf16 ulp."""
    monkeypatch.setattr(JFM, "INT8_KERNEL", True)
    monkeypatch.setattr(PFM, "INT8_KERNEL", True)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    w = rng.normal(size=(256, 2, 128)).astype(np.float32)
    jt = JQ.quantize_tensor(jnp.asarray(w), in_axes=(0,), bits=bits)
    pt = PQ.quantize_tensor(_t(w), in_axes=(0,), bits=bits)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JQ.oscale(JQ.qdot(jx, jt), jt).astype(jnp.float32))
    got = PQ.oscale(PQ.qdot(_t(x).to(torch.bfloat16), pt), pt).float()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())
