"""The PyTorch port's Llama decode path against the JAX package's, on the
CPU: ``llama_tiny`` with the JAX params converted through
``torchpruner_tpu_torch.convert`` — prefill logits and teacher-forced
decode logits against JAX ``_decode_seq``, and greedy tokens against JAX
``generate``; dense, GQA-head-pruned (``kv_group``), int4 and int8.

Tolerances: float32 models agree to rtol 1e-4 (the same math, sums in
other orders, compounded over two blocks).  Quantized models run bf16
activations, where each op rounds to 8 bits and the two frameworks round
at different points; their logits agree to 4 bf16 ulps (2**-6) of the
logit scale.  A greedy token may differ only where the JAX top-2 margin
is below that tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.generate import _decode_seq as j_decode_seq
from torchpruner_tpu.generate import generate as j_generate
from torchpruner_tpu.generate import init_cache as j_init_cache
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.ops.quant import QTensor as JQTensor
from torchpruner_tpu.ops.quant import quantize_params as j_quantize_params
from torchpruner_tpu.utils.dtypes import cast_floats as j_cast_floats
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.generate import _decode_seq as p_decode_seq
from torchpruner_tpu_torch.generate import generate as p_generate
from torchpruner_tpu_torch.generate import init_cache as p_init_cache

F32_RTOL = 1e-4
BF16_REL = 2 ** -6


def numpy_tree(tree):
    """A JAX params tree as numpy, QTensors as plain dicts."""
    if isinstance(tree, JQTensor):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "in_axes": tuple(tree.in_axes), "bits": tree.bits,
                "pack_axis": tree.pack_axis}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _pruned_gqa(model, params):
    """Query heads 1 of block1 pruned away: the surviving heads keep
    their KV groups through ``kv_group`` = (0, 1, 1)."""
    keep = [0, 2, 3]
    spec = model.layer("block1_attn/attn")
    model = model.replace_layer("block1_attn/attn",
                                JL.pruned_spec(spec, keep))
    p = jax.tree_util.tree_map(lambda a: a, params)
    attn = dict(p["block1_attn"]["attn"])
    attn["wq"] = attn["wq"][:, np.asarray(keep)]
    attn["wo"] = attn["wo"][np.asarray(keep)]
    p["block1_attn"] = {**p["block1_attn"], "attn": attn}
    return model, p


def _case(kind):
    model = j_llama_tiny()
    params, _ = j_init_model(model, seed=0)
    cache_dtype = (jnp.float32, torch.float32)
    if kind == "pruned":
        model, params = _pruned_gqa(model, params)
        assert model.layer("block1_attn/attn").kv_group == (0, 1, 1)
    elif kind in ("int4", "int8"):
        params = j_quantize_params(
            model, j_cast_floats(params, jnp.bfloat16),
            bits=4 if kind == "int4" else 8)
        cache_dtype = (jnp.bfloat16, torch.bfloat16)
    return model, params, cache_dtype


def _tol(kind, ref):
    if kind in ("dense", "pruned"):
        return dict(rtol=F32_RTOL, atol=F32_RTOL * np.abs(ref).max())
    return dict(rtol=BF16_REL, atol=BF16_REL * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["dense", "pruned", "int4", "int8"])
def test_prefill_and_teacher_forced_decode_logits_match_jax(kind):
    model, jparams, (jdt, tdt) = _case(kind)
    pmodel = model_from_reference(model)
    pparams = params_from_numpy(numpy_tree(jparams), device="cpu")
    rng = np.random.default_rng(0)
    B, S, n, T = 2, 6, 4, 16
    toks = rng.integers(0, 256, size=(B, S + n)).astype(np.int32)
    jc = j_init_cache(model, B, T, jdt)
    pc = p_init_cache(pmodel, B, T, tdt, device="cpu")
    jstep = jax.jit(lambda p, c, x, pos: j_decode_seq(model.layers, p, c,
                                                      x, pos))
    jx, jc = jstep(jparams, jc, jnp.asarray(toks[:, :S]), 0)
    with torch.no_grad():
        px, pc = p_decode_seq(pmodel.layers, pparams, pc,
                              torch.from_numpy(toks[:, :S]).long(), 0)
    want = np.asarray(jx.astype(jnp.float32))
    np.testing.assert_allclose(px.float().numpy(), want, **_tol(kind, want))
    for i in range(n):  # teacher-forced single-token steps
        jx, jc = jstep(jparams, jc, jnp.asarray(toks[:, S + i:S + i + 1]),
                       S + i)
        with torch.no_grad():
            px, pc = p_decode_seq(
                pmodel.layers, pparams, pc,
                torch.from_numpy(toks[:, S + i:S + i + 1]).long(), S + i)
        want = np.asarray(jx.astype(jnp.float32))
        np.testing.assert_allclose(px.float().numpy(), want,
                                   **_tol(kind, want))


@pytest.mark.parametrize("kind", ["dense", "pruned", "int4", "int8"])
def test_greedy_tokens_match_jax_generate(kind):
    model, jparams, (jdt, tdt) = _case(kind)
    pmodel = model_from_reference(model)
    pparams = params_from_numpy(numpy_tree(jparams), device="cpu")
    prompt = np.random.default_rng(1).integers(0, 256, size=(2, 5))
    n_new = 8
    want = np.asarray(j_generate(model, jparams, jnp.asarray(prompt), n_new,
                                 cache_dtype=jdt))
    got = p_generate(pmodel, pparams, prompt, n_new, cache_dtype=tdt,
                     device="cpu").numpy()
    # JAX logits along the JAX tokens: where the two disagree first, the
    # JAX top-2 margin must be inside the logit tolerance
    full = np.concatenate([prompt, want], axis=1).astype(np.int32)
    jc = j_init_cache(model, 2, full.shape[1], jdt)
    jx, _ = j_decode_seq(model.layers, jparams, jc, jnp.asarray(full), 0)
    logits = np.asarray(jx.astype(jnp.float32))[:, prompt.shape[1] - 1:-1]
    for b in range(2):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size == 0:
            continue
        i = diff[0]
        top2 = np.sort(logits[b, i])[-2:]
        rel = F32_RTOL if kind in ("dense", "pruned") else BF16_REL
        assert top2[1] - top2[0] <= 2 * rel * np.abs(logits[b, i]).max(), \
            f"row {b} step {i}: tokens differ at a clear margin"


def test_model_from_reference_keeps_every_field():
    model, _ = _pruned_gqa(j_llama_tiny(),
                           j_init_model(j_llama_tiny(), seed=0)[0])
    pmodel = model_from_reference(model)
    ref = model.layer("block1_attn/attn")
    got = pmodel.layers[1].body[1]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert pmodel.input_shape == model.input_shape
    assert pmodel.input_dtype == "int32"
