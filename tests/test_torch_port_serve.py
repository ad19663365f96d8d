"""The PyTorch port's serving engine and package rules, on the CPU.

- the port's ``ServeEngine`` emits exactly the tokens of the port's solo
  ``generate`` replay (greedy and seeded sampling; float32 and int4
  weights; slots recycled mid-run);
- no module of the port imports JAX or the JAX package;
- entry points called without a device on a machine without CUDA raise
  instead of running on the CPU.
"""

import importlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchpruner_tpu_torch
from torchpruner_tpu_torch.core.segment import init_model
from torchpruner_tpu_torch.experiments.llama8b_decode import (
    quantized_random_params,
)
from torchpruner_tpu_torch.models import llama, llama_tiny
from torchpruner_tpu_torch.serve.engine import ServeEngine
from torchpruner_tpu_torch.serve.frontend import verify_against_solo
from torchpruner_tpu_torch.serve.traffic import open_loop, synthetic_requests


def _serve(model, params, *, n, vocab, temperature=0.0, cache_dtype=None,
           max_len=64, slots=2, prompt_lens=(4, 9, 21), max_new=(5, 8, 3)):
    eng = ServeEngine(model, params, n_slots=slots, max_len=max_len,
                      cache_dtype=cache_dtype, device="cpu")
    reqs = synthetic_requests(n, vocab=vocab, prompt_lens=list(prompt_lens),
                              max_new=list(max_new), seed=3,
                              temperature=temperature)
    summary = eng.run(open_loop(reqs, stagger_steps=1))
    return eng, summary


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_engine_tokens_equal_solo_generate_float32(temperature):
    model = llama_tiny()
    params, _ = init_model(model, seed=0, device="cpu")
    eng, summary = _serve(model, params, n=6, vocab=256,
                          temperature=temperature)
    assert summary["requests_completed"] == 6
    assert summary["evictions"] == 6  # both slots were recycled
    assert all(len(r.tokens) == r.max_new for r in eng.results())
    assert verify_against_solo(eng) == 0


def test_engine_tokens_equal_solo_generate_int4_bf16():
    model = llama(vocab_size=512, dim=256, depth=2, num_heads=4,
                  num_kv_heads=2, head_dim=64, ffn_dim=512, seq_len=64)
    params, _ = quantized_random_params(model, bits=4, device="cpu")
    eng, summary = _serve(model, params, n=5, vocab=512, slots=3,
                          cache_dtype=torch.bfloat16, max_len=80,
                          prompt_lens=(16, 40), max_new=(6, 9))
    assert summary["requests_completed"] == 5
    assert verify_against_solo(eng) == 0


def test_engine_decode_logits_rows_batch_invariant():
    """The slot step's per-row logits equal a one-row step bit for bit,
    with other rows at other positions holding stale K/V."""
    from torchpruner_tpu_torch.generate import (
        init_cache,
        make_decode_step,
        make_slot_decode_step,
    )

    model = llama_tiny()
    params, _ = init_model(model, seed=1, device="cpu")
    step = make_slot_decode_step(model)
    rng = np.random.default_rng(0)
    cache = init_cache(model, 3, 32, device="cpu")
    for entry in cache.values():  # stale junk everywhere
        for buf in entry.values():
            buf.copy_(torch.from_numpy(
                rng.normal(size=buf.shape).astype(np.float32)) * 50)
    solo_cache = {k: {n: b[1:2].clone() for n, b in e.items()}
                  for k, e in cache.items()}
    tok = torch.tensor([[3], [7], [11]])
    pos = torch.tensor([5, 9, 30], dtype=torch.int32)
    logits, _ = step(params, cache, tok, pos)
    solo, _ = make_decode_step(model)(params, solo_cache, tok[1:2], 9)
    assert torch.equal(logits[1], solo[0])


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``jax`` and ``torchpruner_tpu`` out of ``sys.modules``."""
    names = [m.name for m in pkgutil.walk_packages(
        torchpruner_tpu_torch.__path__, "torchpruner_tpu_torch.")]
    for sub in ("serve.engine", "attributions.activation", "train.loop",
                "train.optim", "data.datasets", "core.pruner",
                "experiments.prune_retrain", "ops.flash_attention"):
        assert f"torchpruner_tpu_torch.{sub}" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'torchpruner_tpu' or m.startswith('torchpruner_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(
                             torchpruner_tpu_torch.__file__).parents[1]))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_without_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core.layers import init_layer
    from torchpruner_tpu_torch.generate import generate, init_cache
    from torchpruner_tpu_torch.__main__ import main as cli_main
    from torchpruner_tpu_torch.models import bert_tiny
    from torchpruner_tpu_torch.serve.frontend import serve_main
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.train.optim import sgd
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    model = llama_tiny()
    params, _ = init_model(model, seed=0, device="cpu")
    calls = [
        lambda: init_model(model),
        lambda: model.init(torch.Generator().manual_seed(0)),
        lambda: init_layer(model.layers[0], torch.Generator(), (8,)),
        lambda: init_cache(model, 1, 8),
        lambda: generate(model, params, np.zeros((1, 3), np.int64), 2),
        lambda: ServeEngine(model, params),
        lambda: quantized_random_params(model),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: serve_main(["llama3_ffn_taylor", "--smoke",
                            "--synthetic", "1"]),
        lambda: init_model(bert_tiny()),
        lambda: Trainer.create(bert_tiny(), sgd(0.1), cross_entropy_loss),
        lambda: cli_main(["--preset", "bert_glue_sensitivity", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A wrapper falls back to nothing: CPU tensors take the plain
    version, anything else must be CUDA or the call raises."""
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    x = torch.zeros((2, 8), dtype=torch.bfloat16, device="meta")
    q = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FM.dequant_matmul(x, q, bits=4)
    qq = torch.zeros((1, 1, 2, 8), device="meta")
    kv = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        DA.decode_attention(qq, kv, kv, 3)
    n0 = FM.dequant_matmul.launches, DA.decode_attention.launches
    FM.dequant_matmul(torch.zeros((2, 8)), torch.zeros((4, 3),
                                                       dtype=torch.int8),
                      bits=4)
    assert (FM.dequant_matmul.launches, DA.decode_attention.launches) == n0


@pytest.mark.parametrize("module", [
    "torchpruner_tpu_torch.serve.allocator",
    "torchpruner_tpu_torch.serve.scheduler",
    "torchpruner_tpu_torch.serve.qos",
])
def test_host_copies_keep_the_reference_behaviour(module):
    """The copied host modules answer like the JAX package's originals
    on a scripted admit/evict sequence."""
    ref = importlib.import_module(module.replace("torchpruner_tpu_torch",
                                                 "torchpruner_tpu"))
    port = importlib.import_module(module)
    if module.endswith("allocator"):
        for m in (ref, port):
            assert m.prefill_buckets(512) == ref.prefill_buckets(512)
            assert m.bucket_for(100, m.prefill_buckets(512)) == 104
    elif module.endswith("qos"):
        for m in (ref, port):
            b = m.TokenBucket(2.0, 2.0, now=0.0)
            got = [b.take(now=t) for t in (0.0, 0.0, 0.0, 0.6)]
            assert got == [True, True, False, True]
    else:
        from torchpruner_tpu.serve.allocator import KVCacheAllocator as RA
        from torchpruner_tpu.serve.request import Request as RR
        from torchpruner_tpu_torch.serve.allocator import (
            KVCacheAllocator as PA,
        )
        from torchpruner_tpu_torch.serve.request import Request as PR

        traces = []
        for m, A, R in ((ref, RA, RR), (port, PA, PR)):
            s = m.Scheduler(A(2, 32))
            reqs = [R(prompt_ids=np.arange(n) + 1, max_new=4)
                    for n in (3, 30, 5)]
            for r in reqs:
                s.submit(r)
            first = [r.slot for r in s.admit()]
            s.evict(reqs[0])
            second = [r.slot for r in s.admit()]
            traces.append((first, second, s.queue_depth))
        assert traces[0] == traces[1]


def test_scheduler_qos_matches_reference():
    """Priority admission, preemption of the youngest batch request and
    a tenant's token-bucket shed follow the JAX package's scheduler step
    for step."""
    from torchpruner_tpu.serve import qos as RQ
    from torchpruner_tpu.serve import scheduler as RS
    from torchpruner_tpu.serve.allocator import KVCacheAllocator as RA
    from torchpruner_tpu.serve.request import Request as RR
    from torchpruner_tpu_torch.serve import qos as PQ
    from torchpruner_tpu_torch.serve import scheduler as PS
    from torchpruner_tpu_torch.serve.allocator import KVCacheAllocator as PA
    from torchpruner_tpu_torch.serve.request import Request as PR

    table = {"chat": {"priority": "interactive", "rate": 1.0, "burst": 1},
             "bulk": {"priority": "batch"}}
    traces = []
    for S, Q, A, R in ((RS, RQ, RA, RR), (PS, PQ, PA, PR)):
        s = S.Scheduler(A(2, 32), qos=Q.QoS.from_dict(table, now=0.0))
        bulk = [R(prompt_ids=np.arange(4) + 1, max_new=4, tenant="bulk")
                for _ in range(3)]
        for r in bulk:
            s.submit(r)
        trace = [[r.slot for r in s.admit()]]
        chat = [R(prompt_ids=np.arange(3) + 1, max_new=4, tenant="chat")
                for _ in range(2)]
        for r in chat:  # the second is throttled: one token, no refill
            s.submit(r)
        trace.append([(r.tenant, r.slot) for r in s.admit()])
        trace.append([r.state for r in bulk + chat])
        trace.append([r.preemptions for r in bulk])
        s.evict(chat[0])
        trace.append([(r.tenant, r.slot) for r in s.admit()])
        trace.append((s.preempted_total, s.shed_total, s.queue_depth))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1][-1][:2] == (1, 1)


def test_engine_preemption_keeps_tokens_equal_solo_generate():
    """Interactive requests preempt running batch requests at a step
    boundary; the preempted requests restart and still emit their solo
    tokens."""
    from torchpruner_tpu_torch.serve.qos import QoS

    model = llama_tiny()
    params, _ = init_model(model, seed=0, device="cpu")
    eng = ServeEngine(model, params, n_slots=2, max_len=64, device="cpu",
                      qos=QoS.from_dict({"chat": {"priority": "interactive"},
                                         "bulk": {"priority": "batch"}}))
    reqs = synthetic_requests(5, vocab=256, prompt_lens=[6, 11],
                              max_new=[12], seed=5)
    for i, r in enumerate(reqs):
        r.tenant = "bulk" if i < 3 else "chat"
    summary = eng.run(open_loop(reqs, stagger_steps=1))
    assert summary["requests_completed"] == 5
    assert summary["preemptions"] >= 1
    assert any(r.preemptions for r in reqs[:3])
    assert verify_against_solo(eng) == 0
