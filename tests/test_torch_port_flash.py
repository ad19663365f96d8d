"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU: ``flash_attention_plain`` and its autograd against the JAX
kernels run in interpret mode (``FORCE_PALLAS``, blocks of 8 x 16 so
several blocks run): the output, the LSE (``_flash_fwd``'s first lane)
and dq/dk/dv, causal and not, f32 and bf16, and a GQA-expanded case.
On the card (``cuda`` marker, skipped here): the three CUDA kernels
against the plain version, and a bert_tiny forward and backward that
must never reach the plain version.

Tolerances: f32 agrees to rtol 1e-5 of the output scale (the same math,
sums in other orders); on the card the kernels' gradients agree to 1e-4,
since their sums run over 64-key tiles in another order than a single
matrix product.  The f32 forward and dK/dV compute their products in
3xTF32 on the tensor cores; a single TF32 pass (2**-11 a product) would
fail these f32 tolerances, which the CPU test
``test_tf32x3_error_budget_fits_the_f32_tolerance`` shows by emulation.
bf16 agrees to 2**-7 of the scale: both round their inputs to bf16
identically, but the Pallas kernel keeps the softmax weights in f32
where the plain version (the einsum path's semantics) rounds them to
bf16 before the value product, and the gradients pass through bf16
products in the plain version.

The JAX package is imported inside the CPU tests, so the file collects
without it; on the GPU machine run only the card's tests, with
``python -m pytest --noconftest tests/test_torch_port_flash.py -m cuda``.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import chip_smoke
from torchpruner_tpu_torch.ops import flash_attention as PF

F32_RTOL = 1e-5
BF16_REL = 2 ** -7


@pytest.fixture
def jflash(monkeypatch):
    pytest.importorskip("jax")
    from torchpruner_tpu.ops import flash_attention as JF

    monkeypatch.setattr(JF, "FORCE_PALLAS", True)
    return JF


def _qkv(B, S, H, Dh, seed=0, kv_heads=None):
    rng = np.random.default_rng(seed)
    kv = kv_heads or H
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, kv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, kv, Dh)).astype(np.float32)
    g = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    if kv != H:  # GQA: K/V expanded to the query heads, as the layer does
        idx = np.arange(H) // (H // kv)
        k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v, g


def _close(got, want, rel, zero_scale=None):
    """max|got - want| <= rel * max|want|; a reference that is identically
    0 (dq and dk at S 1: one key, so the softmax passes no gradient to
    the scores) is held to rel * ``zero_scale`` instead."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    tol = rel * (float(np.abs(want).max()) or (zero_scale or 0.0))
    assert float(np.abs(got - want).max()) <= tol, (
        float(np.abs(got - want).max()), tol)


def _jax_ref(JF, q, k, v, g, causal, dtype):
    import jax
    import jax.numpy as jnp

    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    qj, kj, vj, gj = (jnp.asarray(a, jd) for a in (q, k, v, g))
    out = JF.flash_attention(qj, kj, vj, causal=causal, block_q=8,
                             block_k=16)
    qt, kt, vt = (jnp.moveaxis(t, 2, 1) for t in (qj, kj, vj))
    _, lse = JF._flash_fwd(qt, kt, vt, causal, 8, 16, True)

    def loss(a, b, c):
        o = JF.flash_attention(a, b, c, causal=causal, block_q=8,
                               block_k=16)
        return jnp.sum(o.astype(jnp.float32) * gj.astype(jnp.float32))

    grads = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    as_np = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    return as_np(out), np.asarray(lse[..., 0]), [as_np(t) for t in grads]


def _port(q, k, v, g, causal, dtype):
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    qt, kt, vt = (torch.tensor(a).to(td).requires_grad_() for a in (q, k, v))
    out, lse = PF.flash_attention_plain(qt, kt, vt, causal=causal,
                                        with_lse=True)
    (out.float() * torch.tensor(g).to(td).float()).sum().backward()
    return (out.detach().float().numpy(), lse.detach().numpy(),
            [t.grad.float().numpy() for t in (qt, kt, vt)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_kernels(jflash, dtype, causal):
    q, k, v, g = _qkv(2, 64, 3, 16, seed=1)
    rel = F32_RTOL if dtype == "float32" else BF16_REL
    j_out, j_lse, j_grads = _jax_ref(jflash, q, k, v, g, causal, dtype)
    p_out, p_lse, p_grads = _port(q, k, v, g, causal, dtype)
    _close(p_out, j_out, rel)
    _close(p_lse, j_lse, F32_RTOL if dtype == "float32" else BF16_REL)
    for pg, jg in zip(p_grads, j_grads):
        _close(pg, jg, F32_RTOL if dtype == "float32" else BF16_REL)


def test_plain_matches_pallas_kernels_gqa_expanded(jflash):
    q, k, v, g = _qkv(1, 48, 4, 8, seed=2, kv_heads=2)
    j_out, j_lse, j_grads = _jax_ref(jflash, q, k, v, g, True, "float32")
    p_out, p_lse, p_grads = _port(q, k, v, g, True, "float32")
    _close(p_out, j_out, F32_RTOL)
    _close(p_lse, j_lse, F32_RTOL)
    for pg, jg in zip(p_grads, j_grads):
        _close(pg, jg, F32_RTOL)


def test_cpu_dispatch_is_plain_and_cross_attention_plain():
    q, k, v, _ = _qkv(1, 24, 2, 8, seed=3)
    qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
    n = (PF.flash_fwd.launches, PF.flash_dq.launches, PF.flash_dkv.launches)
    assert torch.equal(PF.flash_attention(qt, kt, vt, causal=True),
                       PF.flash_attention_plain(qt, kt, vt, causal=True))
    # a query chunk against a longer KV prefix: bottom-right causal mask
    out = PF.flash_attention(qt[:, -4:], kt, vt, causal=True)
    full = PF.flash_attention_plain(qt, kt, vt, causal=True)
    assert torch.allclose(out, full[:, -4:], rtol=1e-5, atol=1e-6)
    assert (PF.flash_fwd.launches, PF.flash_dq.launches,
            PF.flash_dkv.launches) == n
    assert not PF.kernel_active(64, torch.float32, "cpu")
    assert PF.kernel_active(64, torch.bfloat16, "cuda")
    assert not PF.kernel_active(136, torch.float32, "cuda")
    assert not PF.kernel_active(60, torch.float32, "cuda")
    assert not PF.kernel_active(64, torch.float16, "cuda")


# ------------------------------------- the bf16 kernels' launch plan (CPU)


def test_copy_route_follows_tma_alignment_rules():
    bf = torch.bfloat16
    t = torch.zeros((2, 40, 3, 16), dtype=bf)
    assert PF.copy_route(t, t, t) == "tma"
    # (B, H, S, Dh) storage read through strides, and q/k/v as views of
    # one fused (B, S, 3, H, Dh) tensor: every stride a multiple of 16 B
    assert PF.copy_route(t.transpose(1, 2).contiguous().transpose(1, 2)) \
        == "tma"
    qkv = torch.zeros((2, 40, 3, 3, 16), dtype=bf)
    assert PF.copy_route(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) == "tma"
    # a base 2 bytes past a 16-byte boundary, a row stride of 49 elements
    buf = torch.zeros(2 * 40 * 49 + 8, dtype=bf)
    assert PF.copy_route(buf[1:].as_strided((2, 40, 3, 16),
                                            (40 * 49, 49, 16, 1))) == "copy"
    assert PF.copy_route(buf[8:].as_strided((2, 40, 3, 16),
                                            (40 * 48, 48, 16, 1))) == "tma"
    assert PF.copy_route(buf[8:].as_strided((2, 40, 3, 16),
                                            (40 * 49, 49, 16, 1))) == "copy"
    # Dh a multiple of 8: every contiguous input is TMA's, Dh 8 included
    assert PF.copy_route(torch.zeros((1, 5, 3, 8), dtype=bf)) == "tma"
    assert PF.copy_route(torch.zeros((3, 5, 1, 8), dtype=bf)) == "tma"
    # an axis of extent 1 is never stepped, whatever its stride; a
    # broadcast (stride 0) axis longer than 1 is not TMA's
    one = buf[8:8 + 40 * 48].as_strided((1, 40, 3, 16), (7, 48, 16, 1))
    assert PF.copy_route(one) == "tma"
    assert PF.copy_route(t[:, :, :1].expand(2, 40, 3, 16)) == "copy"


def test_smem_fits_the_card_and_pads_head_dim_to_chunks():
    card = 232448  # bytes of shared memory a block may use on an H100
    for Dh in range(8, PF.MAX_HEAD_DIM + 1, 8):
        Dp = PF.padded_head_dim(Dh)
        assert Dp in (64, 128) and Dh <= Dp and (Dp == 64 or Dh > 64)
        for kernel in ("fwd", "dq", "dkv"):
            assert 0 < PF.smem_bytes(kernel, Dh) <= card
    # forward: Q and two K and V stages of 128 rows at 256-byte rows;
    # dK/dV: K, V and three stages of 64-row Q/dO tiles with their LSE
    # and delta rows; 8-byte barriers, 1024 bytes of alignment slack
    assert PF.smem_bytes("fwd", 128) == 128 * 256 * 5 + 40 + 1024
    assert PF.smem_bytes("dkv", 128) == \
        2 * 128 * 256 + 3 * (2 * 64 * 256 + 512) + 56 + 1024
    assert PF.smem_bytes("fwd", 64) < PF.smem_bytes("fwd", 72)
    with pytest.raises(ValueError):
        PF.smem_bytes("dx", 64)


@pytest.mark.parametrize("Dh,want", [
    # Q, dO and O tiles of 128 rows, three stages of 64-key K and V tiles,
    # 7 barriers and 1024 bytes of alignment slack, at 128- or 256-byte
    # rows (Dh padded to 64 or 128)
    (8, (3 * 128 + 2 * 3 * 64) * 128 + 56 + 1024),
    (64, 99384),
    (72, (3 * 128 + 2 * 3 * 64) * 256 + 56 + 1024),
    (128, 197688),
])
def test_smem_dq_pinned(Dh, want):
    assert PF.smem_bytes("dq", Dh) == want
    assert want <= 232448  # one CTA an SM: the consumers' registers fill it


def test_copy_route_for_dq_tensors():
    """dQ reads q, k, v, o and dO: one tensor off TMA's rules sends all
    five through the producer's copies (dq itself is allocated
    contiguous, and always stored by TMA)."""
    bf = torch.bfloat16
    qkv = torch.zeros((2, 40, 3, 3, 16), dtype=bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, do = torch.zeros((2, 40, 3, 16), dtype=bf), torch.zeros(
        (2, 40, 3, 16), dtype=bf)
    assert PF.copy_route(q, k, v, o, do) == "tma"
    buf = torch.zeros(2 * 40 * 49 + 8, dtype=bf)
    odd = buf[1:].as_strided((2, 40, 3, 16), (40 * 49, 49, 16, 1))
    assert PF.copy_route(q, k, v, odd, do) == "copy"
    assert PF.copy_route(q, k, v, o, odd) == "copy"
    assert PF.copy_route(q, k, v, o, do.transpose(1, 2).contiguous()
                         .transpose(1, 2)) == "tma"


# ------------------------------------------ the f32 kernels' plan (CPU)


def _tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """``x`` as a TF32 value, on the int32 view: ``cvt.rna.tf32.f32``
    (add 0x1000, mask 0xffffe000: nearest, ties away from zero), or, with
    ``rounded=False``, the 13 low mantissa bits dropped, as the tensor
    core reads an f32 register given as a TF32 operand."""
    i = x.view(torch.int32)
    return (((i + 0x1000) if rounded else i) & -0x2000).view(torch.float32)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels' tensor cores take it: one TF32 pass (operands
    rounded), or three (small * big + big * small + big * big, each
    operand split into big = tf32(x) and small = x - big, which the tensor
    core truncates); products of TF32 values are exact in f32, sums in
    f32."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return (_tf32(a - ab, False) @ bb + ab @ _tf32(b - bb, False)
            + ab @ bb)


def test_tf32x3_error_budget_fits_the_f32_tolerance():
    """The arithmetic the f32 kernels rest on, emulated on the CPU at the
    scoring shape's S 128 and Dh 64 (B * H cut to 4), against f64.  The
    forward: logits and P V in 3xTF32 land at least 10x inside the port's
    f32 tolerance (1e-5 of the output's scale, and of the LSE's); one
    TF32 pass does not.  dQ's chain (S = Q K^T, P = exp(S scale - LSE),
    dP = dO V^T, dS = P (dP - delta) scale, dQ = dS K, where dP - delta
    cancels, so dS itself is split): in 3xTF32 at least 10x inside the
    gradients' tolerance (1e-4 of max|dQ|); one TF32 pass does not."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.tensor(rng.normal(size=(4, 128, 64))
                                .astype(np.float32)) for _ in range(4))
    scale = 1.0 / 8.0
    s64 = q.double() @ k.double().transpose(1, 2) * scale
    p64 = torch.softmax(s64, -1)
    o64 = p64 @ v.double()
    lse64 = torch.logsumexp(s64, -1)
    delta64 = (do.double() * o64).sum(-1, keepdim=True)
    dq64 = (p64 * (do.double() @ v.double().transpose(1, 2) - delta64)
            * scale) @ k.double()
    # dQ's kernel takes the forward's LSE and delta as given
    lse, delta = lse64.float()[..., None], delta64.float()
    errs, dq_errs = {}, {}
    for passes in (1, 3):
        s = _tf32_mm(q, k.transpose(1, 2).contiguous(), passes) * scale
        p = torch.softmax(s, -1)
        o = _tf32_mm(p, v, passes)
        errs[passes] = (
            float((o.double() - o64).abs().max() / o64.abs().max()),
            float((torch.logsumexp(s, -1).double() - lse64).abs().max()
                  / lse64.abs().max()))
        dp = _tf32_mm(do, v.transpose(1, 2).contiguous(), passes)
        ds = torch.exp(s - lse) * (dp - delta) * scale
        dq = _tf32_mm(ds, k, passes)
        dq_errs[passes] = float((dq.double() - dq64).abs().max()
                                / dq64.abs().max())
    assert max(errs[3]) <= F32_RTOL / 10, errs
    assert errs[1][0] > F32_RTOL, errs
    assert dq_errs[3] <= 1e-4 / 10, dq_errs
    assert dq_errs[1] > 1e-4, dq_errs


def test_tf32x3_error_budget_fits_the_blocksparse_dw_tolerance():
    """The f32 block-sparse dW (``bs_tf32x3``) contracts all of R in
    3xTF32: emulated on the CPU at BERT-base's R 4096 for a (128, 128)
    tile, against f64, it lands at least 10x inside the kernels' f32
    tolerance (1e-5 of max|dW|); one TF32 pass does not."""
    rng = np.random.default_rng(1)
    x, g = (torch.tensor(rng.normal(size=(4096, 128)).astype(np.float32))
            for _ in range(2))
    dw64 = x.double().t() @ g.double()
    xt = x.t().contiguous()
    errs = {p: float((_tf32_mm(xt, g, p).double() - dw64).abs().max()
                     / dw64.abs().max()) for p in (1, 3)}
    assert errs[3] <= 1e-5 / 10, errs
    assert errs[1] > 1e-5, errs


def test_f32_smem_fits_two_ctas_an_sm_and_pitches_align():
    card = 232448  # bytes of shared memory a block may use on an H100
    for Dh in range(8, PF.MAX_HEAD_DIM + 1, 8):
        # two kernel copies, tiles 64 and 128 columns wide
        w = 64 if Dh <= 64 else 128
        p = PF.f32_pitches(Dh)
        assert p["qk"] >= w and p["qk"] % 32 == 8 and p["qk"] - w < 32
        assert p["v"] == w + 4 and p["v"] % 8 == 4
        for kernel in ("fwd", "dq", "dkv"):
            assert 0 < PF.f32_smem_bytes(kernel, Dh) <= card
    # at BERT's Dh 64 two CTAs share an SM (228 KB, 1 KB reserved each):
    # Q, K, K, V, V at 72 and 68 floats; K, V and two stages of Q and dO
    # at 68 floats with 2 x 64 LSE and delta rows; three dQ CTAs: Q, dO
    # and one stage of K and V at 68 floats (O is never staged), two
    # stages above Dh 64
    assert PF.f32_smem_bytes("fwd", 64) == 4 * 64 * (3 * 72 + 2 * 68)
    assert PF.f32_smem_bytes("dq", 64) == 4 * 64 * 4 * 68
    assert PF.f32_smem_bytes("dq", 128) == 4 * 64 * 6 * 132
    assert PF.f32_smem_bytes("dkv", 64) == 4 * 64 * (6 * 68 + 4)
    for kernel in ("fwd", "dq", "dkv"):
        assert 2 * (PF.f32_smem_bytes(kernel, 64) + 1024) <= 233472
    assert 3 * (PF.f32_smem_bytes("dq", 64) + 1024) <= 233472
    with pytest.raises(ValueError):
        PF.f32_smem_bytes("dx", 64)


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


@pytest.mark.parametrize("Dh", range(8, 129, 8))
def test_f32_fragment_reads_hit_distinct_banks(Dh):
    """Every shared-memory fragment read of the f32 kernels, lane by lane
    (g = lane // 4, t = lane % 4), at the pitches of ``f32_pitches``."""
    p = PF.f32_pitches(Dh)
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for kk in range(Dh // 8):
        # forward: Q (A) and K (B^T), columns 8 kk + 2t and + 1 in one
        # 8-byte load of rows g (+ 8 n)
        assert _banks_distinct([g * p["qk"] + 8 * kk + 2 * t
                                for g, t in lanes], 2)
        # dQ: Q, dO (A) and K^T, V^T (B^T); dK/dV: K, V (A) and Q^T,
        # dO^T (B^T): rows g (+ 8, + 8 n), columns 8 kk + t (and + 4)
        for col in (0, 4):
            assert _banks_distinct([g * p["v"] + 8 * kk + t + col
                                    for g, t in lanes])
    for c in range(Dh // 8):
        # forward V, dQ's K (its second role) and dK/dV's dO and Q as B:
        # rows 2t (and 2t + 1) of each block of 8 keys (queries), columns
        # 8 c + g
        for n in range(8):
            for row in (0, 1):
                assert _banks_distinct([(8 * n + 2 * t + row) * p["v"]
                                        + 8 * c + g for g, t in lanes])


def test_flash_ab_plain_route_swaps_only_the_attention_core():
    """``flash_ab.py``'s scoring leg holds the kernels' Sensitivity
    scores against the model with every attention layer on the plain
    einsum core (``impl="xla"``): the same layers otherwise, and on the
    CPU, where flash attention is its plain version, the same output."""
    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments.flash_ab import plain_attention
    from torchpruner_tpu_torch.models import bert_tiny

    model = bert_tiny()
    plain = plain_attention(model)

    def attn(m):
        return [c for spec in m.layers if isinstance(spec, L.Residual)
                for c in spec.body if isinstance(c, L.MultiHeadAttention)]

    assert [a.impl for a in attn(model)] == ["auto"] * 2
    assert [a.impl for a in attn(plain)] == ["xla"] * 2
    assert plain.names == model.names
    params, _ = init_model(model, seed=0, device="cpu")
    x = torch.randint(0, 128, (2, 16))
    want, _ = model.apply(params, x)
    got, _ = plain.apply(params, x)
    _close(got.detach().numpy(), want.detach().numpy(), F32_RTOL)


# ------------------------------------------------------------- on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layout(ts, layout):
    """q, k, v, g in storage of the given layout, as strided views (the
    layouts of ``chip_smoke.py`` phase 6, and (B, H, S, Dh) storage)."""
    if layout == "bhsd":
        return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]
    return [*chip_smoke.flash_layout(*ts[:3], layout), ts[3]]


def _kernel_vs_plain(dev, B, S, H, Dh, dtype, causal, layout="bshd"):
    q, k, v, g = _qkv(B, S, H, Dh, seed=S + Dh)
    ts = _layout([torch.tensor(a, device=dev).to(dtype)
                  for a in (q, k, v, g)], layout)
    qt, kt, vt, gt = ts
    # the reference: autograd of the plain version in f32 on the same
    # (possibly bf16-rounded) inputs
    ref = [t.detach().float().requires_grad_() for t in (qt, kt, vt)]
    r_out, r_lse = PF.flash_attention_plain(*ref, causal=causal,
                                            with_lse=True)
    (r_out * gt.float()).sum().backward()
    n0 = (PF.flash_fwd.launches, PF.flash_dq.launches, PF.flash_dkv.launches)
    # detached views keep the layout's strides (a clone of a view with
    # gaps would be contiguous)
    got = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    out = PF.flash_attention(*got, causal=causal)
    (out.float() * gt.float()).sum().backward()
    o2, lse = PF.flash_fwd(qt, kt, vt, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert (PF.flash_fwd.launches, PF.flash_dq.launches,
            PF.flash_dkv.launches) == (n0[0] + 2, n0[1] + 1, n0[2] + 1)
    assert out.dtype == dtype and out.shape == (B, S, H, Dh)
    assert torch.equal(o2, out.detach())
    f32 = dtype == torch.float32
    _close(out.detach().float().cpu(), r_out.detach().cpu(),
           F32_RTOL if f32 else BF16_REL)
    _close(lse.cpu(), r_lse.detach().cpu(), F32_RTOL)
    dv_scale = float(ref[2].grad.abs().max())
    for a, b in zip(got, ref):
        _close(a.grad.float().cpu(), b.grad.cpu(), 1e-4 if f32 else BF16_REL,
               zero_scale=dv_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Dh,dtype,causal", [
    (4, 128, 12, 64, torch.float32, False),    # BERT-base scoring shape
    (4, 128, 12, 64, torch.bfloat16, False),   # BERT-base retrain
    (2, 1024, 8, 128, torch.bfloat16, True),   # mfu_llama training
    (2, 200, 3, 40, torch.float32, True),      # ragged S, odd Dh / 16
    (3, 77, 2, 8, torch.bfloat16, False),      # one ragged tile, Dh 8
    (1, 130, 2, 128, torch.float32, True),     # ragged causal, max Dh
    (2, 150, 3, 24, torch.bfloat16, True),     # ragged causal bf16, Dh 24
    (2, 333, 4, 64, torch.bfloat16, True),     # ragged causal bf16
    (2, 160, 3, 72, torch.bfloat16, True),     # Dh 72: not a multiple of 16
    (1, 257, 2, 128, torch.bfloat16, False),   # one row past two tiles
    (3, 1, 2, 64, torch.bfloat16, True),       # S = 1
    (2, 1, 2, 128, torch.bfloat16, False),     # S = 1, Dh 128
    (3, 1, 2, 64, torch.float32, True),        # S = 1, f32 (3xTF32)
    (2, 256, 2, 128, torch.float32, False),    # f32 Dh 128, non-causal
    (2, 333, 4, 64, torch.float32, True),      # f32 ragged causal S 333
    (2, 160, 3, 72, torch.float32, True),      # f32 Dh 72: 9 of 16 blocks
    (3, 77, 2, 8, torch.float32, False),       # f32 Dh 8: 1 of 8 blocks
])
def test_flash_kernels_match_plain(dev, B, S, H, Dh, dtype, causal):
    _kernel_vs_plain(dev, B, S, H, Dh, dtype, causal)


@pytest.mark.cuda
def test_flash_kernels_read_strided_layout(dev):
    _kernel_vs_plain(dev, 2, 96, 4, 32, torch.float32, True, layout="bhsd")


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,causal", [(64, True), (40, False)])
def test_flash_f32_rows_only_4_byte_aligned(dev, Dh, causal):
    """Rows one element past a 16-byte boundary: the f32 kernels copy
    4 bytes at a time and store outputs element by element."""
    _kernel_vs_plain(dev, 2, 96, 3, Dh, torch.float32, causal,
                     layout="offset")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,route", [
    ("bhsd", "tma"), ("fused", "tma"), ("offset", "copy")])
@pytest.mark.parametrize("Dh,causal", [(64, False), (128, True), (40, True)])
def test_flash_bf16_layouts_take_their_route(dev, layout, route, Dh, causal):
    q = _layout([torch.zeros((2, 96, 3, Dh), dtype=torch.bfloat16,
                             device=dev) for _ in range(4)], layout)
    assert PF.copy_route(*q[:3]) == route
    _kernel_vs_plain(dev, 2, 96, 3, Dh, torch.bfloat16, causal, layout=layout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_dkv_bit_equal_across_runs(dev, causal, dtype):
    q, k, v, g = (torch.tensor(a, device=dev).to(dtype)
                  for a in _qkv(2, 384, 4, 128, seed=7))
    o, lse = PF.flash_fwd(q, k, v, causal=causal, with_lse=True)
    _, delta = PF.flash_dq(q, k, v, o, g, lse, causal=causal)
    dk, dv = PF.flash_dkv(q, k, v, g, lse, delta, causal=causal)
    for _ in range(3):
        dk2, dv2 = PF.flash_dkv(q, k, v, g, lse, delta, causal=causal)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


#: the bf16 dQ kernel's cases: retrain, causal_train (B cut to 2), a
#: ragged causal S, Dh 72, q/k/v views of one fused tensor (TMA), rows
#: only 2-byte aligned (the copy route), S 1
DQ_CASES = [
    (4, 128, 12, 64, False, "bshd"),
    (2, 1024, 8, 128, True, "bshd"),
    (2, 333, 4, 64, True, "bshd"),
    (2, 256, 4, 72, True, "bshd"),
    (2, 512, 4, 64, True, "fused"),
    (2, 256, 4, 64, True, "offset"),
    (4, 1, 4, 128, False, "bshd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Dh,causal,layout", DQ_CASES)
def test_flash_dq_bf16_delta_bit_equal_and_feeds_dkv(dev, B, S, H, Dh,
                                                     causal, layout):
    """dQ and delta against autograd of the plain version (dQ to 2**-7 of
    its scale; delta, an f32 row sum, to rtol 1e-5 of the same sum
    taken by PyTorch on the kernel's own O); dQ bit-equal across runs;
    dK/dV computed from the kernel's delta equal, to 2**-7 of the plain
    version's gradient scale, to dK/dV computed from that reference
    delta."""
    _dq_delta_and_dkv(dev, B, S, H, Dh, causal, layout, torch.bfloat16)


#: the f32 dQ kernel's cases (``dq_tf32x3``): the scoring shape (B cut
#: to 4), a ragged causal S, Dh 72 and 128 (the guarded and the 128-wide
#: exact copies), rows only 4-byte aligned (4-byte copies), S 1
DQ_CASES_F32 = [
    (4, 128, 12, 64, False, "bshd"),
    (2, 333, 4, 64, True, "bshd"),
    (2, 256, 4, 72, True, "bshd"),
    (2, 256, 4, 128, False, "bshd"),
    (2, 256, 3, 64, True, "offset"),
    (3, 1, 2, 64, True, "bshd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Dh,causal,layout", DQ_CASES_F32)
def test_flash_dq_f32_delta_bit_equal_and_feeds_dkv(dev, B, S, H, Dh,
                                                    causal, layout):
    """The f32 twin: dQ to 1e-4 of its scale, delta to rtol 1e-5, both
    bit-equal across runs, and dK/dV from the kernel's delta equal to
    dK/dV from the reference delta to 1e-4 of the gradient scale."""
    _dq_delta_and_dkv(dev, B, S, H, Dh, causal, layout, torch.float32)


def _dq_delta_and_dkv(dev, B, S, H, Dh, causal, layout, dtype):
    f32 = dtype == torch.float32
    grel = 1e-4 if f32 else BF16_REL
    ts = _layout([torch.tensor(a, device=dev).to(dtype)
                  for a in _qkv(B, S, H, Dh, seed=S + Dh)], layout)
    qt, kt, vt, gt = ts
    ref = [t.detach().float().requires_grad_() for t in (qt, kt, vt)]
    r_grads = torch.autograd.grad(
        PF.flash_attention_plain(*ref, causal=causal), ref, gt.float())
    dv_scale = float(r_grads[2].abs().max())
    o, lse = PF.flash_fwd(qt, kt, vt, causal=causal, with_lse=True)
    if not f32:
        assert PF.copy_route(qt, kt, vt, o, gt) == (
            "copy" if layout == "offset" else "tma")
    n0 = PF.flash_dq.launches
    dq, delta = PF.flash_dq(qt, kt, vt, o, gt, lse, causal=causal)
    torch.cuda.synchronize()
    assert PF.flash_dq.launches == n0 + 1
    assert dq.dtype == dtype and dq.shape == (B, S, H, Dh)
    assert delta.dtype == torch.float32 and delta.shape == (B, H, S)
    _close(dq.float().cpu(), r_grads[0].cpu(), grel, zero_scale=dv_scale)
    want_delta = (gt.float() * o.float()).sum(-1).transpose(1, 2)
    _close(delta.cpu(), want_delta.cpu(), F32_RTOL)
    for _ in range(2):
        dq2, delta2 = PF.flash_dq(qt, kt, vt, o, gt, lse, causal=causal)
        assert torch.equal(dq2, dq) and torch.equal(delta2, delta)
    # held to the scale of the plain version's gradients (at S 1 dK is
    # rounding noise about 0 either way: held to dV's scale)
    dk, dv = PF.flash_dkv(qt, kt, vt, gt, lse, delta, causal=causal)
    dk_r, dv_r = PF.flash_dkv(qt, kt, vt, gt, lse, want_delta.contiguous(),
                              causal=causal)
    dk_scale = float(r_grads[1].abs().max()) or dv_scale
    assert float((dk.float() - dk_r.float()).abs().max()) <= grel * dk_scale
    assert float((dv.float() - dv_r.float()).abs().max()) <= grel * dv_scale


@pytest.mark.cuda
def test_flash_host_mirrors_match_the_library(dev):
    import ctypes

    from torchpruner_tpu_torch.ops import _build

    lib = _build.library("flash_attention")
    lib.tp_flash_smem_bytes.restype = ctypes.c_longlong
    for Dh in range(8, 129, 8):
        for code, kernel in ((0, "fwd"), (1, "dkv"), (2, "dq")):
            assert lib.tp_flash_smem_bytes(code, Dh) == \
                PF.smem_bytes(kernel, Dh)
        for code, kernel in ((3, "fwd"), (4, "dkv"), (5, "dq")):
            assert lib.tp_flash_smem_bytes(code, Dh) == \
                PF.f32_smem_bytes(kernel, Dh)
    route = lib.tp_flash_tma_route
    route.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
    for layout in ("bshd", "bhsd", "fused", "offset"):
        ts = _layout([torch.zeros((2, 40, 3, 16), dtype=torch.bfloat16,
                                  device=dev) for _ in range(4)], layout)[:3]
        ptrs = (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])
        want = route(ptrs, PF._strides(*ts), 3, 2, 3, 40)
        assert PF.copy_route(*ts) == ("tma" if want else "copy")


@pytest.mark.cuda
def test_flash_rejects_unsupported_on_card(dev):
    q = torch.zeros((1, 16, 2, 12), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PF.flash_attention(q, q, q)
    h = torch.zeros((1, 16, 2, 16), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        PF.flash_attention(h, h, h)


@pytest.mark.cuda
def test_bert_tiny_forward_backward_never_plain_on_card(dev, monkeypatch):
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.models import bert_tiny

    def boom(*a, **k):
        raise AssertionError("the plain attention ran on the card")

    monkeypatch.setattr(PF, "flash_attention_plain", boom)
    model = bert_tiny()
    params, _ = init_model(model, seed=0, device=dev)
    for p in _leaves(params):
        p.requires_grad_()
    x = torch.randint(0, 128, (4, 16), device=dev)
    n0 = (PF.flash_fwd.launches, PF.flash_dq.launches, PF.flash_dkv.launches)
    out, _ = model.apply(params, x)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert out.shape == (4, 2) and bool(torch.isfinite(out).all())
    assert (PF.flash_fwd.launches - n0[0], PF.flash_dq.launches - n0[1],
            PF.flash_dkv.launches - n0[2]) == (2, 2, 2)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
