"""The port's split-KV decode attention on the CPU: its launch plan and its
plain version against the JAX package.

``decode_plan(T)`` is the partition of a length-T cache into the chunks
the CUDA kernel runs as one CTA each (``csrc/decode_attention.cu``
``make_plan``, which the C entry checks; the card tests in
``tests/test_torch_port_cuda.py`` hold the two equal).  The plain version
computes on the same partition, and is held here against the JAX
``decode_attention`` (its Pallas kernel in interpret mode where the JAX
block rule finds a block, its einsum path where it does not).

Tolerances: f32 caches agree to rtol 1e-5 (the same math, sums in
another order); bf16 caches store the output in bf16, so one bf16 ulp
(2**-8 relative) may separate the two: 2**-7 of the output scale.
"""

import numpy as np
import pytest
import torch

from torchpruner_tpu_torch.ops import decode_attention as PDA


@pytest.mark.parametrize("T,want", [
    (1, (64, 1)), (7, (64, 1)), (8, (64, 1)), (100, (64, 2)),
    (512, (64, 8)), (4096, (256, 16)), (8192, (512, 16)),
])
def test_decode_plan_pinned(T, want):
    chunk, n = PDA.decode_plan(T)
    assert (chunk, n) == want
    assert PDA.decode_plan(T) == (chunk, n)  # T alone decides it
    # the chunks cover 0..T-1 once, in order, none empty
    spans = [range(c * chunk, min((c + 1) * chunk, T)) for c in range(n)]
    assert [t for sp in spans for t in sp] == list(range(T))
    assert all(len(sp) > 0 for sp in spans)
    # the C limits: a cluster of at most 16 CTAs, chunks a multiple of 64
    # positions up to 4096 (the scores' shared memory)
    assert 1 <= n <= PDA.MAX_SPLIT == 16
    assert chunk % PDA.MIN_CHUNK == 0 and chunk <= PDA.MAX_CHUNK == 4096


def test_decode_plan_refuses_lengths_outside_the_kernel():
    assert PDA.decode_plan(PDA.MAX_CACHE_LEN) == (4096, 16)
    for T in (0, PDA.MAX_CACHE_LEN + 1):
        with pytest.raises(ValueError):
            PDA.decode_plan(T)
    assert not PDA.kernel_active(PDA.MAX_CACHE_LEN + 1, 128, torch.bfloat16)
    assert PDA.kernel_active(8192, 128, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,pos", [
    (130, [0, 63, 64, 129]),    # 3 chunks of 64, the last 2 positions
    (512, [0, 127, 128, 511]),  # 8 chunks: both sides of an edge, T - 1
])
def test_decode_plain_matches_jax_at_chunk_edges(dtype, T, pos):
    import jax.numpy as jnp

    from torchpruner_tpu.ops import decode_attention as JDA

    B, H, Dh = len(pos), 2, 16
    rng = np.random.default_rng(T)
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    for b, p in enumerate(pos):  # stale rows past pos: poisoned
        k[b, p + 1:] = 1e4
        v[b, p + 1:] = -1e4
    pos = np.asarray(pos, np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(JDA.decode_attention(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos)).astype(jnp.float32))
    kt, vt = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    got = PDA.decode_attention_plain(torch.from_numpy(q), kt, vt,
                                     torch.from_numpy(pos))
    assert got.dtype == tdt and got.shape == (B, 1, H, Dh)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())
    # each row alone gives the batched row's bits
    for b in range(B):
        solo = PDA.decode_attention_plain(
            torch.from_numpy(q[b:b + 1]), kt[b:b + 1], vt[b:b + 1],
            torch.from_numpy(pos[b:b + 1]))
        assert np.array_equal(solo[0].float().numpy(), got[b])
