"""The port's MoE decode, serving and prune loop against the JAX
package's, on the CPU (the layer itself: ``test_torch_port_moe.py``).

- greedy ``generate`` tokens of ``llama_moe_tiny`` from the JAX init
  weights, dense and sparse (capacity factor E / top_k), against the JAX
  ``generate``; a token may differ only where the JAX top-2 margin is
  inside 1e-4 of the logit scale;
- the prune-retrain loop from the JAX initial weights (Taylor on both
  blocks' experts, fraction 0.25, one Adam fine-tune epoch with
  ``moe_aux_weight`` 0.01): layers, widths, units dropped, params, and
  losses and accuracies to 1e-4.

Inside the port: ragged slot decode of an MoE model equals each row
decoded alone, bit for bit, and the serving engine's tokens (f32, and
int4 weights with a bf16 cache) equal a solo replay.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.data import datasets as JD
from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.generate import _decode_seq as j_decode_seq
from torchpruner_tpu.generate import generate as j_generate
from torchpruner_tpu.generate import init_cache as j_init_cache
from torchpruner_tpu.models import llama_moe_tiny as j_llama_moe_tiny
from torchpruner_tpu_torch.convert import (
    model_from_reference,
    params_from_numpy,
)
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.data import datasets as PD
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.experiments import prune_retrain as PPR
from torchpruner_tpu_torch.generate import generate as p_generate
from torchpruner_tpu_torch.models import llama_moe_tiny as p_llama_moe_tiny


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_tree(tree):
    return params_from_numpy(numpy_tree(tree), device="cpu")


# -- decode -------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_greedy_generate_matches_jax(dispatch):
    jm = j_llama_moe_tiny(dispatch=dispatch, capacity_factor=2.0)
    jparams, _ = j_init_model(jm, seed=0)
    pm = model_from_reference(jm)
    pparams = torch_tree(jparams)
    prompt = np.random.default_rng(1).integers(0, 256, size=(2, 5))
    n_new = 8
    want = np.asarray(j_generate(jm, jparams, jnp.asarray(prompt), n_new))
    got = p_generate(pm, pparams, prompt, n_new, device="cpu").numpy()
    full = np.concatenate([prompt, want], axis=1).astype(np.int32)
    jc = j_init_cache(jm, 2, full.shape[1], jnp.float32)
    jx, _ = j_decode_seq(jm.layers, jparams, jc, jnp.asarray(full), 0)
    logits = np.asarray(jx)[:, prompt.shape[1] - 1:-1]
    for b in range(2):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            top2 = np.sort(logits[b, diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * 1e-4 * np.abs(
                logits[b, diff[0]]).max(), f"row {b}: clear-margin flip"


def test_ragged_slot_decode_bit_identical_to_solo():
    """Each row of a slot step (other rows at other positions, stale K/V
    everywhere) equals that row decoded alone, bit for bit."""
    from torchpruner_tpu_torch.generate import (
        init_cache,
        make_decode_step,
        make_slot_decode_step,
    )

    model = p_llama_moe_tiny()
    params, _ = PS.init_model(model, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    cache = init_cache(model, 3, 32, device="cpu")
    for entry in cache.values():
        for buf in entry.values():
            buf.copy_(torch.from_numpy(
                rng.normal(size=buf.shape).astype(np.float32)) * 50)
    tok = torch.tensor([[3], [7], [11]])
    pos = torch.tensor([5, 9, 30], dtype=torch.int32)
    logits, _ = make_slot_decode_step(model)(
        params, {k: {n: b.clone() for n, b in e.items()}
                 for k, e in cache.items()}, tok, pos)
    for r in range(3):
        solo_cache = {k: {n: b[r:r + 1].clone() for n, b in e.items()}
                      for k, e in cache.items()}
        solo, _ = make_decode_step(model)(params, solo_cache, tok[r:r + 1],
                                          int(pos[r]))
        assert torch.equal(logits[r], solo[0])


@pytest.mark.parametrize("quant", ["float32", "int4_bf16"])
def test_engine_serves_moe_equal_to_solo_replay(quant):
    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
    )
    from torchpruner_tpu_torch.serve.engine import ServeEngine
    from torchpruner_tpu_torch.serve.frontend import verify_against_solo
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        synthetic_requests,
    )

    model = p_llama_moe_tiny()
    if quant == "float32":
        params, _ = PS.init_model(model, seed=0, device="cpu")
        cache_dtype = None
    else:
        params, _ = quantized_random_params(model, bits=4, device="cpu")
        cache_dtype = torch.bfloat16
    eng = ServeEngine(model, params, n_slots=2, max_len=48,
                      cache_dtype=cache_dtype, device="cpu")
    reqs = synthetic_requests(4, vocab=256, prompt_lens=[4, 9],
                              max_new=[5, 7], seed=2)
    summary = eng.run(open_loop(reqs, stagger_steps=1))
    assert summary["requests_completed"] == 4
    assert verify_against_solo(eng) == 0


# -- the loop -------------------------------------------------------------------


def test_prune_retrain_loop_matches_jax(tmp_path, monkeypatch):
    """Taylor on both blocks' experts (fraction 0.25: 4 -> 3), one Adam
    fine-tune epoch with ``moe_aux_weight`` 0.01, from the JAX initial
    weights: layers, widths, units dropped and losses to 1e-4."""
    over = dict(name="llama_moe_tiny_taylor", target_filter=("_moe/",),
                finetune_epochs=1, moe_aux_weight=0.01, optimizer="adam",
                lr=1e-3, score_examples=16)
    cfg_j = dataclasses.replace(
        JPS.get_preset("llama3_ffn_taylor", smoke=True), **over,
        log_path=str(tmp_path / "j.csv"))
    cfg_p = dataclasses.replace(
        PPS.get_preset("llama3_ffn_taylor", smoke=True), **over,
        log_path=str(tmp_path / "p.csv"))
    splits = (("train", 64), ("val", 16), ("test", 32))
    jm = j_llama_moe_tiny()
    j_hist = JPR.run_prune_retrain(
        cfg_j, model=jm, verbose=False,
        datasets=tuple(JD.load_dataset("lm_tiny", s, n=n, seed=cfg_j.seed)
                       for s, n in splits))

    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jparams, _ = j_init_model(jm, seed=seed)
        return params_from_numpy(numpy_tree(jparams), device=device), {}

    monkeypatch.setattr(PS, "init_model", jax_init)
    p_hist = PPR.run_prune_retrain(
        cfg_p, model=model_from_reference(jm), verbose=False, device="cpu",
        datasets=tuple(PD.load_dataset("lm_tiny", s, n=n, seed=cfg_p.seed)
                       for s, n in splits))
    assert [r.layer for r in p_hist] == [r.layer for r in j_hist] == [
        "block2_moe/experts", "block1_moe/experts"]
    for p, j in zip(p_hist, j_hist):
        assert p.widths == j.widths and p.n_dropped == j.n_dropped == 1
        assert p.n_params == j.n_params
        for f in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            assert abs(getattr(p, f) - getattr(j, f)) <= 1e-4, (
                f, getattr(p, f), getattr(j, f))
