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
@pytest.mark.parametrize("M,D,F", [(1, 256, 384), (5, 4096, 1024),
                                   (64, 512, 200), (9, 14336, 256)])
def test_dequant_kernel_matches_plain(dev, bits, M, D, F):
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


@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_kernel_rows_batch_invariant(dev, bits):
    x, q, _ = _dq_case(6, 4096, 1024, bits, seed=1)
    x, q = x.to(dev), q.to(dev)
    full = FM.dequant_matmul(x, q, bits=bits)
    for m in range(6):
        solo = FM.dequant_matmul(x[m:m + 1], q, bits=bits)
        assert torch.equal(solo[0], full[m])


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
