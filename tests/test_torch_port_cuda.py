"""The PyTorch/CUDA port's hand-written kernels against their plain
versions, on the card.  Every test here needs an NVIDIA GPU and nvcc and
skips without them (decided in the fixture, never at import).  Run on
the GPU machine (which has no JAX, hence no conftest) with
``python -m pytest --noconftest tests/test_torch_port_cuda.py``.

Tolerances: the kernels and the plain versions take their f32 sums in
different orders, so they agree to f32 rounding (rtol 1e-5 relative to
the output scale), except where the output is stored in bf16, where one
bf16 ulp (2**-8 relative) can separate them.  Batch invariance and
stale-row masking are asserted bit for bit.
"""

import numpy as np
import pytest
import torch

from torchpruner_tpu_torch.ops import decode_attention as DA
from torchpruner_tpu_torch.ops import fused_matmul as FM
from torchpruner_tpu_torch.ops.int4_matmul import quantize_int4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dq_case(M, D, F, bits, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(D, F)).astype(np.float32))
    if bits == 4:
        q, scale = quantize_int4(w)
    else:
        scale = w.abs().amax(0) / 127
        q = torch.round(w / scale).to(torch.int8)
    return x.to(torch.bfloat16), q, scale


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,D,F", [
    (1, 256, 384), (5, 4096, 1024), (64, 512, 200), (9, 14336, 256),
    # llama_tiny's D 32 / F 16, one and two row tiles
    (1, 32, 16), (5, 32, 16), (130, 32, 16),
    # ragged F and K: 1-byte weight loads (F odd), 4-byte x loads (D 30,
    # 34), a contracted length that is no multiple of the 64-row stage
    (3, 30, 7), (17, 34, 33), (300, 96, 200),
])
def test_dequant_kernel_matches_plain(dev, bits, M, D, F):
    """Every shape launches, with and without a scale, and agrees with
    the plain version to 1e-5 of the output scale (tensor-core sums over
    each k16 in the hardware's order, f32 sums in another order than the
    plain version's)."""
    x, q, scale = _dq_case(M, D, F, bits)
    x, q, scale = x.to(dev), q.to(dev), scale.to(dev)
    n0 = FM.dequant_matmul.launches
    for sc in (None, scale):
        got = FM.dequant_matmul(x, q, sc, bits=bits)
        want = FM.dequant_matmul_plain(x, q, sc, bits=bits)
        torch.cuda.synchronize()
        assert got.shape == (M, F) and got.dtype == torch.float32
        tol = 1e-5 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= tol
    assert FM.dequant_matmul.launches == n0 + 2


#: rows of x in the batch-invariance cases (decode slots, ragged groups
#: of 8, the prefill buckets, one and three row tiles)
DQ_BATCH_ROWS = (1, 2, 4, 7, 8, 9, 16, 17, 48, 100, 104, 128, 129, 300)
_solo_rows = {}


def _dq_solo(dev, bits, D, F):
    """300 rows of x, the weight, and each row's product computed alone
    (M = 1), made once per (bits, D, F)."""
    key = (bits, D, F)
    if key not in _solo_rows:
        x, q, _ = _dq_case(max(DQ_BATCH_ROWS), D, F, bits, seed=1)
        x, q = x.to(dev), q.to(dev)
        solo = torch.cat([FM.dequant_matmul(x[m:m + 1], q, bits=bits)
                          for m in range(x.shape[0])])
        ref = FM.dequant_matmul(x[:104], q, bits=bits)
        _solo_rows[key] = (x, q, solo, ref)
    return _solo_rows[key]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("D,F", [(4096, 1024), (4096, 14336), (32, 16)])
@pytest.mark.parametrize("M", DQ_BATCH_ROWS)
def test_dequant_kernel_rows_batch_invariant(dev, bits, D, F, M):
    """Bit for bit: each row of an M-row call equals the row computed
    alone, and the first rows equal those of the 104-row call (so a row
    at M = 100 equals the same row at M = 104)."""
    x, q, solo, ref = _dq_solo(dev, bits, D, F)
    full = FM.dequant_matmul(x[:M], q, bits=bits)
    assert torch.equal(full, solo[:M])
    n = min(M, 104)
    assert torch.equal(full[:n], ref[:n])


def _decode_case(B, T, H, Dh, dtype, dev, seed=2):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, Dh)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, T, H, Dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, T, H, Dh)).astype(np.float32))
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [512, 100])
def test_decode_kernel_matches_plain_and_masks_stale(dev, dtype, T):
    B, H, Dh = 4, 8, 128
    q, k, v = _decode_case(B, T, H, Dh, dtype, dev)
    pos = torch.tensor([0, 37, T // 2, T - 1], dtype=torch.int32,
                       device=dev)
    n0 = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, pos)
    want = DA.decode_attention_plain(q, k, v, pos)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (B, 1, H, Dh)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    tol = rel * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    kp, vp = k.clone(), v.clone()
    for b, p in enumerate(pos.tolist()):
        kp[b, p + 1:] = 1e4
        vp[b, p + 1:] = -1e4
    assert torch.equal(DA.decode_attention(q, kp, vp, pos), got)
    for b in range(B):  # a row alone gives the batched row's bits
        solo = DA.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   pos[b:b + 1])
        assert torch.equal(solo[0], got[b])


#: the split-KV cases: T across one chunk (8), a ragged chunk (100), the
#: serving cache (512) and 16-chunk plans (4096, 8192)
DECODE_T = (8, 100, 512, 4096, 8192)


def _decode_positions(T):
    """0, both sides of a chunk edge (where the plan has one), T - 1."""
    chunk, n = DA.decode_plan(T)
    edge = chunk if n > 1 else T // 2
    return [0, max(0, edge - 1), min(T - 1, edge), T - 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", DECODE_T)
def test_decode_split_kv_matches_plain_bitstable_one_launch(dev, T, Dh,
                                                            dtype):
    B, H = 4, 4
    q, k, v = _decode_case(B, T, H, Dh, dtype, dev, seed=T + Dh)
    pos = torch.tensor(_decode_positions(T), dtype=torch.int32, device=dev)
    n0 = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == n0 + 1  # one launch a call
    want = DA.decode_attention_plain(q, k, v, pos)
    assert got.dtype == dtype and got.shape == (B, 1, H, Dh)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    tol = rel * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(DA.decode_attention(q, k, v, pos), got)  # two runs
    kp, vp = k.clone(), v.clone()
    for b, p in enumerate(pos.tolist()):
        kp[b, p + 1:] = 1e4
        vp[b, p + 1:] = -1e4
    assert torch.equal(DA.decode_attention(q, kp, vp, pos), got)
    for b in range(B):  # a row alone gives the batched row's bits
        solo = DA.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   pos[b:b + 1])
        assert torch.equal(solo[0], got[b])


def test_decode_plan_entry_matches_the_mirror(dev):
    import ctypes

    from torchpruner_tpu_torch.ops import _build

    fn = _build.function("decode_attention", "tp_decode_plan",
                         [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_int)])
    for T in (*range(1, 300), 511, 512, 513, 1000, 4095, 4096, 8192,
              DA.MAX_CACHE_LEN):
        chunk, n = ctypes.c_int(), ctypes.c_int()
        assert fn(T, ctypes.byref(chunk), ctypes.byref(n)) == 0
        assert (chunk.value, n.value) == DA.decode_plan(T)
    assert fn(DA.MAX_CACHE_LEN + 1, ctypes.byref(chunk), ctypes.byref(n))


def test_serve_int4_verify_on_card(dev):
    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
    )
    from torchpruner_tpu_torch.models import llama
    from torchpruner_tpu_torch.serve.engine import ServeEngine
    from torchpruner_tpu_torch.serve.frontend import verify_against_solo
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        synthetic_requests,
    )

    model = llama(vocab_size=1024, dim=256, depth=2, num_heads=4,
                  num_kv_heads=2, head_dim=64, ffn_dim=512, seq_len=64)
    params, _ = quantized_random_params(model, bits=4, device=dev)
    eng = ServeEngine(model, params, n_slots=4, max_len=128,
                      cache_dtype=torch.bfloat16, device=dev)
    reqs = synthetic_requests(6, vocab=1024, prompt_lens=[16, 40, 70],
                              max_new=[8, 12], seed=0)
    d0, a0 = FM.dequant_matmul.launches, DA.decode_attention.launches
    summary = eng.run(open_loop(reqs))
    assert summary["requests_completed"] == 6
    assert FM.dequant_matmul.launches > d0
    assert DA.decode_attention.launches > a0
    assert verify_against_solo(eng) == 0


# -- block-sparse matmul ------------------------------------------------------


def _bs_case(R, D, F, block, in_frac, out_frac, dtype, dev, seed=3):
    """x, w (dropped blocks zeroed), g and the keep lists; every other
    block dropped on an axis whose fraction is 0.5, none where it is 0."""
    rng = np.random.default_rng(seed)
    ik = tuple(i for i in range(D // block)
               if not (in_frac and i % 2 == 1))
    ok = tuple(j for j in range(F // block)
               if not (out_frac and j % 2 == 0))
    x = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(D, F)).astype(np.float32)) * 0.05
    w = w * torch.from_numpy(np.kron(
        np.isin(np.arange(D // block), ik)[:, None]
        & np.isin(np.arange(F // block), ok)[None, :],
        np.ones((block, block), bool)))
    g = torch.from_numpy(rng.normal(size=(R, F)).astype(np.float32))
    return (x.to(dev, dtype), w.to(dev, dtype), g.to(dev, dtype), ik, ok)


def _bs_check(x, w, g, ik, ok, block):
    from torchpruner_tpu_torch.ops import blocksparse as BS

    dtype = x.dtype
    n0 = (BS.blocksparse_fwd.launches, BS.blocksparse_dx.launches,
          BS.blocksparse_dw.launches)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = BS.blocksparse_matmul(xk, wk, in_keep=ik, out_keep=ok, block=block)
    dx, dw = torch.autograd.grad(y, (xk, wk), g)
    # the reference: autograd of the plain version in f32 on the same
    # (for bf16: bf16-rounded) inputs
    xp, wp = x.float().requires_grad_(), w.float().requires_grad_()
    yp = BS.blocksparse_matmul_plain(xp, wp, in_keep=ik, out_keep=ok,
                                     block=block)
    dxp, dwp = torch.autograd.grad(yp, (xp, wp), g.float())
    yp = yp.detach()
    torch.cuda.synchronize()
    assert (BS.blocksparse_fwd.launches, BS.blocksparse_dx.launches,
            BS.blocksparse_dw.launches) == tuple(n + 1 for n in n0)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    for got, want in ((y, yp), (dx, dxp), (dw, dwp)):
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        tol = rel * float(want.abs().max())
        assert float((got.float() - want).abs().max()) <= tol
    D, F = w.shape
    in_m = BS._unit_mask(D, ik, block, x.device)
    out_m = BS._unit_mask(F, ok, block, x.device)
    assert bool((y[:, ~out_m] == 0).all())
    assert bool((dx[:, ~in_m] == 0).all())
    assert bool((dw[~in_m] == 0).all()) and bool((dw[:, ~out_m] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D,F,block,in_frac,out_frac", [
    (512, 256, 512, 128, 0, 0.5),     # fc1-like: output blocks dropped
    (512, 512, 256, 128, 0.5, 0),     # fc2-like: input blocks dropped
    (300, 256, 256, 128, 0.5, 0.5),   # both axes, ragged rows
    (1, 128, 128, 128, 0, 0),         # one row, all kept
    (131, 192, 320, 64, 0.5, 0.5),    # block 64, ragged rows
    (77, 96, 160, 32, 0.5, 0.5),      # block 32, ragged rows
    (64, 192, 96, 96, 0.5, 0),        # a block that is 3 x 32
])
def test_blocksparse_kernels_match_plain(dev, dtype, R, D, F, block,
                                         in_frac, out_frac):
    x, w, g, ik, ok = _bs_case(R, D, F, block, in_frac, out_frac, dtype, dev)
    _bs_check(x, w, g, ik, ok, block)


def test_blocksparse_unsorted_keep_lists_and_leading_axes(dev):
    from torchpruner_tpu_torch.ops import blocksparse as BS

    x, w, _, _, _ = _bs_case(48, 256, 256, 64, 0, 0, torch.float32, dev)
    ik, ok = (3, 0), (2, 3, 1)
    got = BS.blocksparse_matmul(x.reshape(4, 12, 256), w, in_keep=ik,
                                out_keep=ok, block=64)
    want = BS.blocksparse_matmul_plain(x, w, in_keep=ik, out_keep=ok,
                                       block=64).reshape(4, 12, 256)
    assert got.shape == (4, 12, 256)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_blocksparse_empty_keep_list_and_refusals(dev):
    from torchpruner_tpu_torch.ops import blocksparse as BS

    x, w, _, _, _ = _bs_case(8, 128, 128, 32, 0, 0, torch.float32, dev)
    n0 = BS.blocksparse_fwd.launches
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = BS.blocksparse_matmul(xg, wg, in_keep=(), out_keep=(0, 1), block=32)
    assert y.shape == (8, 128) and bool((y == 0).all())
    gx, gw = torch.autograd.grad(y.sum(), (xg, wg))
    assert bool((gx == 0).all()) and bool((gw == 0).all())
    assert BS.blocksparse_fwd.launches == n0  # zeros without a launch
    with pytest.raises(ValueError, match="must divide"):
        BS.blocksparse_matmul(x, w, block=48)  # 48 does not divide 128
    with pytest.raises(ValueError, match="multiples of 32"):
        BS.blocksparse_matmul(x, w, block=16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        BS.blocksparse_matmul(x.half(), w.half(), block=32)
    with pytest.raises(ValueError, match="distinct block indices"):
        BS.blocksparse_matmul(x, w, in_keep=(0, 9), block=32)


def test_blocksparse_weight_through_a_dense_layer(dev):
    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.ops import blocksparse as BS

    x, w, _, ik, ok = _bs_case(40, 128, 256, 64, 0, 0.5, torch.bfloat16, dev)
    b = torch.zeros(256, dtype=torch.bfloat16, device=dev)
    n0 = BS.blocksparse_fwd.launches
    bsw = BS.BlockSparseWeight(w, None, ok, 64)
    got, _ = L.apply_layer(L.Dense("fc", 256), {"w": bsw, "b": b}, {}, x)
    want, _ = L.apply_layer(L.Dense("fc", 256), {"w": bsw.dense(), "b": b},
                            {}, x)
    assert BS.blocksparse_fwd.launches == n0 + 1
    tol = 2 ** -7 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


# -- the bf16 wgmma body -------------------------------------------------------


def _bs_case_keep(R, D, F, block, ik, ok, dtype, dev, seed=5):
    """x, w (blocks outside in_keep x out_keep zeroed), g for given keep
    lists (any order)."""
    x, w, g, _, _ = _bs_case(R, D, F, block, 0, 0, dtype, dev, seed)
    keep = np.kron(np.isin(np.arange(D // block), ik)[:, None]
                   & np.isin(np.arange(F // block), ok)[None, :],
                   np.ones((block, block), bool))
    return x, w * torch.from_numpy(keep).to(dev, dtype), g


@pytest.mark.parametrize("R", [4096, 4099])
def test_blocksparse_dw_bit_equal_across_runs(dev, R):
    """dW sums its cluster's partials in rank order, with no atomics: two
    runs at BERT-base's fc1 (split 2) give the same bits."""
    from torchpruner_tpu_torch.ops import blocksparse as BS

    x, w, g, ik, ok = _bs_case(R, 768, 3072, 128, 0, 0.5, torch.bfloat16,
                               dev)
    assert BS.plan("dw", R, 768, 3072, 128, len(ik), len(ok)).split > 1
    first = BS.blocksparse_dw(x, g, ik, ok, 128)
    for _ in range(3):
        assert torch.equal(BS.blocksparse_dw(x, g, ik, ok, 128), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocksparse_plan_entry_matches_the_mirror(dev, dtype):
    """``tp_bs_plan`` of the built library equals ``plan`` at every
    shape the CPU tests pin and at small and ragged ones."""
    from torchpruner_tpu_torch.ops import blocksparse as BS

    shapes = [(4096, 768, 3072, 128, 6, 12), (4096, 3072, 768, 128, 12, 6),
              (1024, 4096, 4096, 128, 16, 16), (4099, 768, 3072, 128, 6, 12),
              (1000, 256, 384, 32, 4, 6), (8192, 1024, 4096, 128, 8, 16),
              (8192, 4096, 1024, 128, 16, 8), (1, 128, 128, 128, 1, 1),
              (63, 384, 576, 192, 1, 2), (131, 192, 320, 64, 2, 2),
              (77, 96, 160, 32, 2, 3), (448, 768, 3072, 128, 6, 12)]
    for shape in shapes:
        for mode in ("fwd", "dx", "dw"):
            assert BS.plan_on_card(mode, *shape, dtype) \
                == BS.plan(mode, *shape, dtype), (mode, shape)


@pytest.mark.parametrize("R", [1, 63, 4099, 8192])
def test_blocksparse_wgmma_rows(dev, R):
    """All three bf16 modes against the plain version where the row count
    is one, below a wgmma's 64, ragged, and mfu_llama's 8192."""
    x, w, g, ik, ok = _bs_case(R, 768, 3072, 128, 0.5, 0.5, torch.bfloat16,
                               dev)
    _bs_check(x, w, g, ik, ok, 128)


@pytest.mark.parametrize("block", [64, 128, 192])
def test_blocksparse_wgmma_every_block_kept(dev, block):
    x, w, g, ik, ok = _bs_case(777, 384 * 2, 384 * 3, block, 0, 0,
                               torch.bfloat16, dev)
    assert len(ik) == 768 // block and len(ok) == 1152 // block
    _bs_check(x, w, g, ik, ok, block)


def test_blocksparse_wgmma_unsorted_keep_lists(dev):
    """Keep lists in any order gather the same blocks: a tile may span
    two kept blocks that lie far apart."""
    ik, ok = (5, 0, 3), (17, 2, 9, 4, 11)
    x, w, g = _bs_case_keep(1000, 768, 3072, 128, ik, ok, torch.bfloat16,
                            dev)
    _bs_check(x, w, g, ik, ok, 128)


@pytest.mark.parametrize("ik,ok", [((4,), tuple(range(24))),
                                   (tuple(range(6)), (17,)),
                                   ((4,), (17,))])
def test_blocksparse_wgmma_single_kept_block(dev, ik, ok):
    """One kept block on an axis: a tile whose columns (or dW rows) are
    half past the kept width loads the last real chunk again and stores
    only the real ones."""
    x, w, g = _bs_case_keep(4099, 768, 3072, 128, ik, ok, torch.bfloat16,
                            dev)
    _bs_check(x, w, g, ik, ok, 128)
