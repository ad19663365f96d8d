"""The dequant matmul's launch plan and plain version, on the CPU.

The Hopper kernel (``csrc/dequant_matmul.cu``) runs only on the card
(tests/test_torch_port_cuda.py holds it against the plain version there).
What decides its numbers is reachable here: the launch plan
(``fused_matmul.plan``) fixes each output element's reduction order from
the weight's shape alone, so these tests check that it never depends on
M, that its K segments cover the contracted rows once and in order, and
that its tiles fit the kernel at every site the main path calls it with.
The plain version is held against the JAX package's ``dequant_matmul``,
run as the JAX tests run it on the CPU (Pallas interpret mode where the
shape tiles, its unpack-then-matmul path where it does not).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from torchpruner_tpu.ops import fused_matmul as JFM
from torchpruner_tpu.ops import quant as JQ
from torchpruner_tpu_torch.experiments.llama8b_decode import (
    quantized_random_params,
)
from torchpruner_tpu_torch.models import llama_tiny
from torchpruner_tpu_torch.ops import fused_matmul as FM
from torchpruner_tpu_torch.ops.quant import QTensor

#: the row counts the card tests use, and a long prefill
ROWS = (1, 2, 4, 7, 8, 9, 16, 17, 48, 100, 104, 128, 129, 300, 4096)

#: H100: shared memory one CTA may use, and one SM holds (bytes)
SMEM_PER_CTA = 232448
SMEM_PER_SM = 233472


def _tiny_sites(bits):
    """(D, F) of every quantized site of ``llama_tiny`` as ``qdot``
    hands it to the kernel (payload rows x flattened output axes)."""
    params, _ = quantized_random_params(llama_tiny(), bits=bits,
                                        device="cpu")
    sites = set()

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, QTensor) and v.in_axes == (0,):
                pack = 2 if v.bits == 4 else 1
                sites.add((v.q.shape[0] * pack,
                           int(np.prod(v.q.shape[1:]))))

    walk(params)
    return sorted(sites)


def _all_shapes():
    return sorted(set(chip_smoke.DQ_SHAPES) | set(_tiny_sites(4))
                  | set(_tiny_sites(8)))


def test_tiny_sites_include_the_smallest_shapes():
    sites = _tiny_sites(4)
    assert (32, 16) in sites and len(sites) >= 4
    assert _tiny_sites(8) == sites


@pytest.mark.parametrize("bits", [4, 8])
def test_plan_reduction_fields_do_not_depend_on_rows(bits):
    """Everything the kernel takes from the plan except M itself is the
    same for every M at a fixed (D, F, bits)."""
    for D, F in _all_shapes():
        p = FM.plan(D, F, bits)
        fixed = {p.args(M)[1:] for M in ROWS}
        assert len(fixed) == 1
        assert p.args(7)[0] == 7
        assert fixed.pop()[:5] == (D, F, bits, p.segments, p.seg_stages)


@pytest.mark.parametrize("bits", [4, 8])
def test_plan_segments_cover_contracted_rows_once_in_order(bits):
    shapes = _all_shapes() + [(D, F) for D in (2, 30, 64, 66, 130, 4094,
                                               8192, 28672)
                              for F in (1, 7, 200, 1024, 50000)]
    for D, F in shapes:
        p = FM.plan(D, F, bits)
        bounds = p.segment_bounds()
        assert len(bounds) == p.segments
        assert bounds[0][0] == 0 and bounds[-1][1] == D
        for (b0, e0), (b1, e1) in zip(bounds, bounds[1:]):
            assert e0 == b1  # no gap, no overlap, ascending
        for b, e in bounds:
            assert b < e and b % p.k_step == 0
        covered = np.zeros(D, np.int64)
        for b, e in bounds:
            covered[b:e] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("bits", [4, 8])
def test_plan_tiles_meet_kernel_constraints(bits):
    """The tiles the kernel was built for: 4 warps of 32 columns, 16
    groups of 8 rows, k16 steps that take whole int4 bytes, a cluster of
    at most 16 segments, shared memory that holds the segments' partial
    tile, three CTAs per SM, and grid dimensions the card launches."""
    for D, F in _all_shapes():
        p = FM.plan(D, F, bits)
        assert (p.strip, p.row_tile, p.k_step, p.stages) == (
            FM.STRIP, FM.ROW_TILE, FM.K_STEP, FM.STAGES)
        assert p.strip == 4 * 32 and p.row_tile == 16 * 8
        assert p.k_step % 16 == 0 and p.stages >= 3
        assert 1 <= p.segments <= FM.MAX_SEGMENTS
        assert p.seg_stages >= 1
        n_stages = -(-D // p.k_step)
        assert (p.segments - 1) * p.seg_stages < n_stages \
            <= p.segments * p.seg_stages
        assert 3 * (p.smem_bytes() + 1024) <= SMEM_PER_SM  # 1 KB each kept
        assert p.smem_bytes() <= SMEM_PER_CTA
        assert p.row_tile * (p.strip + 4) * 4 <= p.smem_bytes()
        assert p.strips < 2 ** 31 and p.row_tiles(300) == 3
        assert p.row_tiles(4096) <= 65535
        if bits == 4:
            assert D % 2 == 0


def test_plan_fills_the_card_at_decode():
    """At the Llama-3-8B sites the grid holds between one CTA per SM and
    two (the kernel streams the weight with every SM busy)."""
    for (D, F) in chip_smoke.DQ_SHAPES:
        p = FM.plan(D, F, 4)
        ctas = p.strips * p.segments
        if F >= 4096:
            assert 132 <= ctas, (D, F, ctas)
        if p.strips < 264:
            assert ctas <= 2 * 132 or p.segments == 1


def _jax_case(D, F, bits, M=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w = rng.normal(size=(D, F)).astype(np.float32)
    jt = JQ.quantize_tensor(jnp.asarray(w), in_axes=(0,), bits=bits)
    return x, jt


#: the Llama-3-8B sites; the lm_head (4096, 128256) with its columns cut
#: to 2048, since its widened f32 weight (2.1 GB) is no CPU test's size
#: (columns are independent: a column slice of the product is the
#: product with the column slice)
_JAX_SHAPES = sorted({(D, min(F, 2048)) for (D, F) in chip_smoke.DQ_SHAPES})


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("D,F", _JAX_SHAPES + [(32, 16), (32, 64),
                                               (64, 32), (32, 256)])
def test_dequant_plain_matches_jax_at_main_path_shapes(bits, D, F):
    """Tolerance 1e-5 of the output scale: both take exact bf16 x int
    products and f32 sums, in different orders."""
    x, jt = _jax_case(D, F, bits)
    scale = np.array(jt.out_scale())
    want = np.asarray(JFM.dequant_matmul(jnp.asarray(x), jt.q,
                                         jnp.asarray(scale), bits=bits))
    got = FM.dequant_matmul(torch.from_numpy(x),
                            torch.from_numpy(np.array(jt.q)),
                            torch.from_numpy(scale), bits=bits).numpy()
    assert got.shape == (3, F)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
