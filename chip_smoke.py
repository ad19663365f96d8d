"""On-card smoke test of the PyTorch/CUDA port (``torchpruner_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. Environment: the card's name and power limit (``nvidia-smi``); build
   the four CUDA sources of ``torchpruner_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together) and print the build time.
2. Kernel vs plain: the dequant matmul (int4 and int8, M in {1, 4, 64,
   128, 300} and the prefill buckets {16, 48, 104} of phase 3's prompts,
   at the Llama-3-8B projection shapes; every row of every call equal bit
   for bit to the same row computed alone) and split-KV decode attention
   (B=4, T=512, H=32, Dh=128, and a long cache B=4, T=8192, H=8, Dh=128;
   f32 and bf16 cache, ragged positions incl. 0 and T-1, stale rows
   poisoned, every row alone and a second run bit-equal, one launch a
   call, each case's ``decode_plan`` printed) against their plain
   PyTorch versions; CUDA-event times of kernel, plain version, one
   PyTorch library call, and the least time the card could take (bound).
3. Serve Llama-3-8B at full width and depth with int4 weights through
   ``ServeEngine`` (4 slots, max_len 512, bf16 activations and KV) on 8
   greedy requests, replay each alone through ``generate``; launch
   counts of both kernels are read around the serve run (decode
   attention: one launch a layer a decode step).
4. The same at int8 with 4 blocks (the int8 mode of the dequant kernel).
5. The CLI: ``python -m torchpruner_tpu_torch serve llama3_ffn_taylor
   --smoke --synthetic 8 --verify``.
6. Flash attention (forward, dQ, dK/dV kernels) against autograd of the
   plain version at the prune loop's shapes: f32 B 128 S 128 H 12 Dh 64
   (scoring), bf16 B 32 (retraining), bf16 causal B 8 S 1024 H 8 Dh 128
   (mfu_llama training) and a causal f32 case whose S is not a multiple
   of the 64-row tile; for the bf16 wgmma kernels also a ragged causal S
   333, Dh 72, q/k/v as views of one fused (B, S, 3, H, Dh) tensor (TMA),
   rows only 2-byte aligned (the copy route) and S 1, and f32 rows only
   4-byte aligned (4-byte copies); dQ (with delta) and dK/dV run twice
   must be bit-equal; f32 cases at Dh 128 and 72 (the 128-wide copies
   of the f32 bodies, exact and guarded); a ViT-B/16 scoring batch (f32,
   B 64, S 197, H 12, Dh 64, not causal); the bodies that ran, as the
   profiler names them, must be the dtype's (f32: ``fwd_tf32x3`` /
   ``dq_tf32x3`` / ``dkv_tf32x3``, bf16 the three ``*_wgmma``) and are
   printed with the route;
   CUDA-event times of each kernel, the plain version and
   ``scaled_dot_product_attention`` (timed only), and the bound (f32 at
   3xTF32's rate, the FMA units' bound printed beside it).
7. The paper's loop at full width:
   ``python -m torchpruner_tpu_torch --preset bert_glue_sensitivity``
   (BERT-base, Sensitivity on all 12 ``_mlp/fc1`` targets, f32
   scoring), in process; 12 records at the fraction policy's widths,
   finite losses, launches of the three flash kernels > 0, and no
   fixed-order chunk call on the full-sequence path.
8. Retraining: the same preset through ``--config`` with one fine-tune
   epoch on ``block12_mlp/`` in bf16; finite step losses, step time.
9. Causal training: 3 ``Trainer`` steps on mfu_llama (B 8, S 1024, bf16,
   Adam, lm_mfu); finite losses, step time.
10. Block-sparse matmul (forward, dx, dW kernels) against autograd of the
    plain version, f32 and bf16, at BERT-base's ``fc1`` (R 4096, D 768,
    F 3072, half the output blocks kept) and ``fc2`` (D 3072, F 768, half
    the input blocks kept), at R 1024, D 4096, F 4096 with both axes half
    kept, at a ragged R (4099) and at block 32; dropped columns and
    blocks exactly 0; dW bit-equal across two runs; each call's launch
    plan from the library's ``tp_bs_plan`` equal to ``ops/blocksparse.py
    plan`` and printed (body: ``wgmma`` for bf16 on multiple-of-64
    blocks, ``wmma`` for bf16 block 32, ``tf32x3`` for f32: the library
    dispatches on that plan alone; tile, ring stages, dW split);
    CUDA-event times of each kernel, of the same kernel with every block
    kept, of the plain version and of ``torch.matmul`` on the dense
    masked weight (timed only), and the bound (f32 at 3xTF32's rate, the
    FMA units' bound printed beside it).
11. Masked block-sparse retraining at full width: BERT-base, Sensitivity
    on every ``block{i}_mlp/fc1``, ``score_drop_indices(fraction=0.5,
    granularity=128)``, ``drop_masks`` / ``apply_masks``, Adam chained
    with ``masked_update``, 30 bf16 ``Trainer`` steps (B 32) with
    ``param_transform=blocksparse_transform(...)`` and the same 30 steps
    masked dense; finite losses that agree, 24 forward / 24 dx / 24 dW
    launches per step (every wrapped site; a CUDA tensor launches or
    raises), masked entries exactly 0 after training, NaN written into a
    dropped block leaves the block-sparse loss bit-equal and turns the
    masked-dense loss NaN, then ``prune`` with the same indices
    (3072 -> 1536) whose forward equals the masked forward.
12. ``simulate`` through the CLI: ``--config`` of the phase 7 preset with
    ``simulate=true``; 12 records, the units dropped and the post-prune
    losses of phase 7, widths unchanged.
13. GatedDense: 3 masked block-sparse mfu_llama steps (phase 9's set-up,
    every ``block{i}_ffn/gate`` half dropped at granularity 128), so
    ``wg`` / ``wu`` and the down projection go through the kernels.

14. Shapley on the MLP: ``--preset mnist_mlp_shapley`` in process at
    full width (784-2024-2024-10 on ``mnist_flat``'s synthetic fallback,
    sv_samples 5, 1000 scoring examples, one fine-tune epoch a target);
    2 records with finite losses, each dropping exactly the units its own
    scores put below 0; one ``fc2`` batch of Shapley rows (the fast path)
    on the card equal to the CPU's for the same batch and permutations
    within 1e-5 x the batch's loss; the scoring wall a target and a unit
    step.
15. Shapley on ViT-B/16 at full width and depth: the
    ``vit_head_mlp_shapley`` recipe cut to its 12 head targets
    (``target_filter=("_attn/",)``), 64 scoring examples, synthetic
    ImageNet injected (train 256, test 512); 12 records with finite
    losses and at most 12 heads each, drops exactly the negative scores,
    flash forward launches > 0; ``block1_attn/attn``'s scores through the
    kernel equal to those through the plain version within 1e-5 x the
    batch's loss; one masking-path unit step of ``block12_mlp/fc1`` at
    5 x 64 rows timed, and the full preset's scoring time estimated from
    it (12 head targets + 12 x 3072 MLP unit steps a scoring batch).
16. The layerwise-robustness sweep at full width:
    ``vgg16_digits32_layerwise``'s training leg (VGG16-bn, 12 epochs on
    digits32, Adam, B 128, bf16 with f32 masters) through ``run_train``,
    test accuracy at least 0.80; then ``layerwise_robustness`` with the
    8-method ``method_panel`` (14 rankings a layer) on ``conv1``,
    ``conv13`` and ``fc1``, bf16 scoring over the 300 test examples: every
    curve ``n_units`` finite entries, the 14 walks of a layer ending
    within 2**-7 of each other (all units removed, the order no longer
    matters), 3 distinct random rankings, 1 run of each deterministic
    method; one batch of f32 Shapley rows at ``fc1`` (from the initial
    weights, as phase 14) on the card equal to the CPU's within 1e-5 x
    the batch's loss; each method's scoring
    time and each layer's walk time, and the full 15-layer sweep
    estimated from them.
17. ResNet-50 at full width through the prune loop:
    ``resnet50_taylor`` cut to its six stage-4 targets, synthetic
    ImageNet injected (train 256, test 512, the preset's 1000 scoring
    examples); 6 records at the fraction policy's widths, finite losses,
    each attached BatchNorm's scale, bias and running statistics sliced
    with its conv; the stem's 3x3 / 2 SAME max-pool (pads 0 / 1) on the
    card equal to the CPU's.

18. Serve v2 at full width and depth: Llama-3-8B int4 (phase 3's model
    and weights), 4 slots, max_len 512, pages of 16, chunks of 64 (cap
    128 prefill tokens a step), a 64-page prefix pool; 12 shared-prefix
    requests (two 256-token system prompts, suffixes 8 / 24 / 64, 32
    greedy tokens, an arrival every 2 steps), then the same traffic with
    sharing off: every request done, 0 mismatches against solo
    ``generate``, identical tokens on and off, prefix hits > 0 and hit
    tokens >= 256, no step over the cap, hit + prefilled tokens = prompt
    length per request, launches of both kernels (decode attention: one
    a layer a decode step); ttft / token p50 and p99 and the wall, on and
    off.
19. Checkpoints: A is phase 4's model (int8, full width, 4 blocks) saved
    with ``save_checkpoint`` (restored and compared leaf for leaf); B is
    A with each block's FFN pruned by a quarter through ``prune``
    (WeightNorm scores on the dequantized weights), int8 again; both
    under a temporary directory, removed after phase 20; bytes, save
    and restore seconds.  Then ``serve llama3_ffn_taylor --checkpoint A
    --swap-checkpoint B --swap-after 8 --synthetic 8 --rate 1
    --shared-prefixes 2 --prefix-len 64 --prompt-lens 8,24 --verify``
    with the serve-v2 flags: device cuda, 8 requests, 1 swap, 0
    mismatches, both kernels launched.
20. HTTP: ``serve --checkpoint B --http 0``: four concurrent ``POST
    /v1/generate`` answered with tokens, ``/healthz`` ready, ``POST
    /swap`` to A answered 202 with ``/healthz`` through
    ``staging_swap`` back to ready, one generation after the swap,
    ``GET /metrics`` 200 with the server's obs counters (5 requests) and
    ``POST /profile`` 409 (no ``--obs-dir``, so no profiler), then
    SIGTERM: exit code 0 and the drained summary (5 completed, 1 swap,
    both kernels launched).

21-23 run in a child process (``python3 chip_smoke.py --moe-slice`` runs
them alone, the kernels built or loaded first): a fresh profiler session
for phase 21's trace, and the card's memory to themselves.

21. Mixtral-8x7B int4 at full width and depth (``llama_moe()``, dense
    dispatch, 23.3 GB of weights built leaf by leaf on the card):
    phase 3's engine and traffic (4 slots, max_len 512, bf16 KV; 8
    greedy requests at prompt lengths 16 / 40 / 100, 32 tokens), every
    request replayed alone (0 mismatches), decode attention 32 launches
    a decode step, dequant launches > 0; the gates of one 4-row decode
    step on the card against the plain ops on the CPU on the same rows
    (within 2**-6; a token's experts may differ only at a near-tie);
    one decode step's wall, profiler kernel time and idle share, and the
    CUDA-event time of widening the expert planes.
22. Expert pruning at full width: ``run_prune_retrain`` on
    ``llama_moe(depth=2, seq_len=512)`` (depth cut for memory) with
    synthetic LM data injected, f32 Taylor on both blocks' experts,
    fraction 0.25 (8 -> 6), one bf16 SGD epoch a target with
    ``moe_aux_weight`` 0.01: 2 records at 6 experts, finite losses,
    every aux loss >= 0.99, flash launches > 0; then one full-width MoE
    layer: sparse dispatch at capacity E / top_k against dense (1e-4 x
    max|dense|, f32) and the capacity-1.25 dispatch plan on the card
    equal to the CPU's, pairs dropped.
23. Phase 22's pruned model cast to bf16, quantized to int4 and saved
    with ``save_checkpoint``, then ``serve llama3_ffn_taylor
    --checkpoint DIR --synthetic 8 --verify`` with phase 19's serve-v2
    flags: device cuda, 8 requests, 0 mismatches, both serving kernels
    launched.

24. Remat, gradient accumulation and ``multi_step`` on the flash
    kernels, in a child process (a fresh profiler session): mfu_llama at
    full width (dim 1024, 8 blocks, Dh 128, S 1024, B 8, bf16, Adam,
    ``lm_mfu``), 3 steps each way from one start: remat off, remat on,
    remat on at ``accum_steps`` 4; then ``multi_step`` (K 3) against
    the first way's 3 sequential steps.  Losses finite; remat against
    off: losses within 2**-7 relative and final params within 2**-7 x
    the largest move a param made; accumulation against the full batch:
    losses within 2**-7 relative and one gradient from the start within
    2**-7 of each leaf's largest entry (final params recorded: each
    microbatch's bf16 gradient rounds on its own, and Adam turns a
    near-zero gradient's difference into a step of up to lr);
    ``multi_step`` bit-equal; flash forward launches 2x a block a step
    under remat (dQ and dK/dV 1x), 4x more with the microbatches; the
    steps' peak memory (above what was held before them) lower with
    remat.  Each way's step ms, peak memory and idle share (one
    profiled step) printed.
25. Phase 11's masked recipe (its start, drops and batches) for 5
    block-sparse steps at ``accum_steps`` 2 against the same 5 steps at
    ``accum_steps`` 1, both at dropout 0 (BERT-base's dropout draws
    other masks for two microbatches than for their batch): 48 / 48 /
    48 launches a step (twice phase 11's), masked entries exactly 0,
    losses within 2**-5 of the largest full-batch loss.
26. The cached sweep: phase 16's three-layer panel on its trained
    VGG16-bn with the capture engine on, then off, and phase 14's
    ``fc1`` Shapley rows (one batch of 250, initial weights) with and
    without an ``ActivationCache``; cuDNN deterministic, without
    benchmarking, for the phase.  Curves and AUCs within 1e-5 relative,
    rows within 1e-5 x the batch's loss, hits > 0 and prefix FLOPs
    saved > 0; both walls, hits and misses printed.

27. Observability on serving, in this process after phases 1-26: phase
    3's model and the first 4 of its 8 greedy requests (traced, as a
    fleet router mints trace ids) through ``ServeEngine`` inside ``obs.configure(dir,
    profile_every=4, profile_steps=3)``, 3 windows at most, one armed on
    demand once the first has closed; the same serve with no session
    and with a session that opens no window (tokens equal phase 3's
    every way, walls printed).  3 windows (2 cadence, 1 on demand),
    each with device kernel events, ``profile_empty_windows_total`` and
    ``profile_missing_kernel_events_total`` 0; each window's table names
    ``decode_split`` (32 launches a step) and ``dq_mma`` (the wrappers'
    launches a step of ``trace_step``'s step, plus one a projection for
    each prefill inside the window), exactly, and every group's kernel
    events equal the wrappers' launches inside the window (in memory and
    in the exported trace); ``trace_step``'s own session sees every
    launch of its steps; in the windows without a
    prefill both kernels' ms a step within 0.75-1.33x of
    ``experiments/step_trace.py trace_step``'s in this process; coverage
    and ``1 - coverage`` printed beside ``trace_step``'s idle share;
    ``metrics.prom``'s ``serve_*`` counters equal ``summary()``; a
    prefill span per request; each request's trace passes admission,
    prefill, first_token, decode and complete in order; ``trace.json``
    holds spans and kernel events.
28. Observability on the prune loop: phase 7's preset on its first 2
    targets through ``--config`` with ``--obs-dir``, in process: the
    units dropped and the widths equal phase 7's first 2, the span tree
    ``run`` -> ``prune_retrain`` -> ``setup`` / ``attribution`` /
    ``eval`` / ``prune`` / ``retrain`` per target, 2 ledgered rounds
    with finite score distributions, ``obs report`` renders them; one
    Sensitivity scoring pass of the first target inside an on-demand
    window names ``fwd_tf32x3`` with every launch the wrapper made in
    the pass; phase 8's bf16 fine-tune with ``obs_grad_norm`` and
    ``--profile-every 150 --profile-steps 2``: its windows name
    ``fwd_wgmma``, ``dq_wgmma`` and ``dkv_wgmma``, none empty, each
    holding exactly the wrappers' launches inside it, and the
    ``grad_norm`` gauge is finite and > 0.

``python3 chip_smoke.py --obs-slice`` runs phases 3, 7, 8, 27 and 28
alone (the kernels built first).

The last three stdout lines: the ``nvidia-smi`` name/power line, one JSON
``{"kernels": [...]}`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s,
#: bf16 tensor-core FLOP/s, float32 non-tensor FLOP/s, and the f32
#: FLOP/s of 3xTF32 (three TF32 tensor-core products, at 494.7 TFLOP/s,
#: for each f32 product)
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 494.7e12 / 3

#: Llama-3-8B dequant matmul sites: (D, F) -> calls per decode step
#: (32 blocks x wq / wk+wv / wg+wu / down, plus the lm_head)
DQ_SHAPES = {(4096, 4096): 32, (4096, 1024): 64, (4096, 14336): 64,
             (14336, 4096): 32, (4096, 128256): 1}
DEPTH = 32
#: rows of a dequant call: decode at 1 and 4 slots, a 64-row case, the
#: prefill buckets of phase 3's prompts (16, 40, 100 tokens), one full
#: row tile of the kernel (128) and three (300)
DQ_ROWS = (1, 4, 16, 48, 64, 104, 128, 300)
PREFILL_BUCKETS = (16, 48, 104)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean CUDA-event milliseconds of ``fn(i)`` over ``iters`` calls, as
    the device runs them: the card is held busy (``torch.cuda._sleep``)
    while the host enqueues the calls, so host launch overhead does not
    leave the device idle between them."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time at ~2 GHz
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def copies_for(nbytes: int) -> int:
    """Weight copies to cycle through so the working set exceeds the
    50 MB L2 (a decode step finds each layer's weight cold)."""
    return max(1, min(256, math.ceil(200e6 / max(1, nbytes))))


# -- phase 2 ----------------------------------------------------------------


def dequant_cases(dev):
    import torch

    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.ops.quant import quantize_tensor

    cases = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for (D, F) in DQ_SHAPES:
        w = torch.randn((D, F), generator=gen, device=dev,
                        dtype=torch.bfloat16) * 0.02
        for bits in (4, 8):
            qt = quantize_tensor(w, in_axes=(0,), bits=bits)
            q, scale = qt.q, qt.out_scale()
            w_lib = qt.dequantize(torch.bfloat16)  # library yardstick
            n = copies_for(q.numel())
            qs = [q] + [q.clone() for _ in range(n - 1)]
            n_lib = copies_for(w_lib.numel() * 2)
            libs = [w_lib] + [w_lib.clone() for _ in range(n_lib - 1)]
            # every row alone (M = 1), held bit for bit against the same
            # row in each batched call below
            x_all = torch.randn((max(DQ_ROWS), D), generator=gen,
                                device=dev, dtype=torch.bfloat16)
            solo = torch.cat([FM.dequant_matmul(x_all[m:m + 1], q, scale,
                                                bits=bits)
                              for m in range(x_all.shape[0])])
            for M in DQ_ROWS:
                x = x_all[:M]
                got = FM.dequant_matmul(x, q, scale, bits=bits)
                want = FM.dequant_matmul_plain(x, q, scale, bits=bits)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = 1e-5 * float(want.abs().max()) + 1e-6
                if not (err <= tol and bool(torch.isfinite(got).all())):
                    fail(f"dequant bits={bits} M={M} D={D} F={F}: max "
                         f"abs err {err} > tol {tol}")
                if not torch.equal(got, solo[:M]):
                    bad = int((got != solo[:M]).any(dim=1).sum())
                    fail(f"dequant bits={bits} M={M} D={D} F={F}: {bad} "
                         f"rows differ from the same row computed alone")
                ms = event_ms(lambda i: FM.dequant_matmul(
                    x, qs[i % n], scale, bits=bits), 20)
                plain = event_ms(lambda i: FM.dequant_matmul_plain(
                    x, qs[i % n], scale, bits=bits), 2)
                lib = event_ms(lambda i: torch.matmul(
                    x, libs[i % n_lib]), 20)
                nbytes = x.numel() * 2 + q.numel() + F * 4 + M * F * 4
                b, by = bound_ms(nbytes, 2.0 * M * D * F, BF16_FLOPS)
                cases.append({"bits": bits, "M": M, "D": D, "F": F,
                              "max_abs_err": err, "tol": tol,
                              "rows_equal_solo": True, "ms": ms,
                              "plain_ms": plain, "library_ms": lib,
                              "bound_ms": b, "bound_by": by})
                log(f"  dequant int{bits} M={M:<3d} D={D:<6d} F={F:<7d} "
                    f"kernel {ms:.4f} ms  plain {plain:.3f} ms  "
                    f"library {lib:.4f} ms  bound {b:.4f} ms ({by})  "
                    f"err {err:.3g} (tol {tol:.3g})")
            del qs, libs, w_lib, qt, solo, x_all
        del w
    torch.cuda.empty_cache()
    return cases


#: decode attention's cases: (B, T, H, Dh, positions) — the serving
#: cache of phase 3 at the Llama-3-8B attention width, and a long cache
#: (16 chunks of 512) with spread positions
DECODE_CASES = ((4, 512, 32, 128, (0, 100, 300, 511)),
                (4, 8192, 8, 128, (100, 2900, 5600, 8191)))


def decode_cases(dev):
    import torch
    import torch.nn.functional as Fn

    from torchpruner_tpu_torch.ops import decode_attention as DA

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for B, T, H, Dh, positions in DECODE_CASES:
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        plan = DA.decode_plan(T)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, 1, H, Dh), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k = torch.randn((B, T, H, Dh), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, T, H, Dh), generator=gen,
                            device=dev).to(dtype)
            n0 = DA.decode_attention.launches
            got = DA.decode_attention(q, k, v, pos)
            want = DA.decode_attention_plain(q, k, v, pos)
            torch.cuda.synchronize()
            if DA.decode_attention.launches != n0 + 1:
                fail(f"decode attention T={T}: "
                     f"{DA.decode_attention.launches - n0} launches a call")
            rel = 1e-5 if dtype == torch.float32 else 2 ** -7
            tol = rel * float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            if not err <= tol:
                fail(f"decode attention T={T} {dtype}: max abs err {err} > "
                     f"tol {tol}")
            if not torch.equal(DA.decode_attention(q, k, v, pos), got):
                fail(f"decode attention T={T} {dtype}: two runs differ")
            for b in range(B):
                if not torch.equal(DA.decode_attention(
                        q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1])[0],
                        got[b]):
                    fail(f"decode attention T={T} {dtype}: row {b} alone "
                         f"differs from the batched row")
            kp, vp = k.clone(), v.clone()
            for b, p in enumerate(positions):
                kp[b, p + 1:] = 1e4
                vp[b, p + 1:] = -1e4
            if not torch.equal(DA.decode_attention(q, kp, vp, pos), got):
                fail(f"decode attention T={T} {dtype}: stale rows changed "
                     f"a result")
            del kp, vp
            n = copies_for(k.numel() * k.element_size() * 2)
            kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n - 1)]
            ms = event_ms(lambda i: DA.decode_attention(
                q, kvs[i % n][0], kvs[i % n][1], pos), 50)
            plain = event_ms(lambda i: DA.decode_attention_plain(
                q, k, v, pos), 2)
            t = torch.arange(T, device=dev)
            mask = (t[None, :] <= pos[:, None].long())[:, None, None, :]
            qs = q.to(dtype).permute(0, 2, 1, 3)
            lib = event_ms(lambda i: Fn.scaled_dot_product_attention(
                qs, kvs[i % n][0].permute(0, 2, 1, 3),
                kvs[i % n][1].permute(0, 2, 1, 3), attn_mask=mask), 50)
            live = sum(p + 1 for p in positions)
            nbytes = (q.numel() * q.element_size()
                      + 2 * live * H * Dh * k.element_size()
                      + pos.numel() * 4 + got.numel() * got.element_size())
            b_ms, by = bound_ms(nbytes, 4.0 * live * H * Dh, FP32_FLOPS)
            cases.append({"cache_dtype": str(dtype).replace("torch.", ""),
                          "B": B, "T": T, "H": H, "Dh": Dh,
                          "pos": list(positions),
                          "plan": {"chunk": plan[0], "n_split": plan[1]},
                          "max_abs_err": err, "tol": tol,
                          "rows_equal_solo": True, "runs_bit_equal": True,
                          "ms": ms, "plain_ms": plain, "library_ms": lib,
                          "bound_ms": b_ms, "bound_by": by})
            log(f"  decode B={B} T={T} H={H} Dh={Dh} cache={dtype} plan "
                f"{plan[1]} x {plan[0]}: kernel {ms:.4f} ms  plain "
                f"{plain:.3f} ms  library {lib:.4f} ms  bound {b_ms:.4f} ms "
                f"({by})  err {err:.3g} (tol {tol:.3g})")
            del kvs, k, v
    torch.cuda.empty_cache()
    return cases


# -- phases 3-4 -------------------------------------------------------------


def serve_phase(dev, *, bits: int, depth: int) -> dict:
    import numpy as np
    import torch

    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
        weight_bytes,
    )
    from torchpruner_tpu_torch.generate import _decode_seq, init_cache
    from torchpruner_tpu_torch.models import llama3_8b
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.serve.engine import ServeEngine
    from torchpruner_tpu_torch.serve.frontend import verify_against_solo
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        synthetic_requests,
    )

    model = llama3_8b(depth=depth)
    t0 = time.perf_counter()
    params, _ = quantized_random_params(model, bits=bits, seed=0,
                                        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = ServeEngine(model, params, n_slots=4, max_len=512,
                         cache_dtype=torch.bfloat16, device=dev)
    vocab = 128256
    reqs = synthetic_requests(8, vocab=vocab, prompt_lens=[16, 40, 100],
                              max_new=[16, 24, 32], seed=0)
    FM.dequant_matmul.launches = 0
    DA.decode_attention.launches = 0
    summary = engine.run(open_loop(reqs))
    torch.cuda.synchronize()
    launches = {"dequant_matmul": FM.dequant_matmul.launches,
                "decode_attention": DA.decode_attention.launches}
    mism = verify_against_solo(engine)
    bad = [r.id for r in engine.results()
           if not all(0 <= t < vocab for t in r.tokens)
           or len(r.tokens) != r.max_new]
    # a reference forward on a small input: finite logits of the shape
    cache = init_cache(model, 1, 16, torch.bfloat16, device=dev)
    with torch.no_grad():
        logits, _ = _decode_seq(model.layers, params, cache,
                                torch.as_tensor(reqs[0].prompt_ids[None, :16]
                                                .astype(np.int64),
                                                device=dev), 0)
    ok_logits = (tuple(logits.shape) == (1, 16, vocab)
                 and bool(torch.isfinite(logits.float()).all()))
    out = {"bits": bits, "depth": depth,
           "weight_gb": weight_bytes(params) / 1e9,
           "params_build_s": build_s,
           "requests_completed": summary["requests_completed"],
           "gen_tokens": summary["gen_tokens"],
           "sustained_gen_tok_s": summary["sustained_gen_tok_s"],
           "ttft_p50_ms": summary["ttft_p50_ms"],
           "token_p50_ms": summary["token_p50_ms"],
           "decode_steps": summary["decode_steps"],
           "verify_mismatches": mism, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"serve int{bits} depth {depth}: {json.dumps(out)}")
    # phase 27 serves the same traffic again, telemetry on
    out["tokens"] = [list(r.tokens) for r in
                     sorted(engine.results(), key=lambda r: r.id)]
    if summary["requests_completed"] != 8:
        fail(f"int{bits} serve completed "
             f"{summary['requests_completed']}/8 requests")
    if mism:
        fail(f"int{bits} serve: {mism} requests diverged from solo decode")
    if bad:
        fail(f"int{bits} serve: bad token lists for requests {bad}")
    if not ok_logits:
        fail(f"int{bits}: prefill logits not finite or wrong shape")
    for name, n in launches.items():
        if n <= 0:
            fail(f"int{bits} serve never launched the {name} kernel")
    # split-KV decode attention stays one launch a layer a decode step
    if launches["decode_attention"] != depth * summary["decode_steps"]:
        fail(f"int{bits} serve: {launches['decode_attention']} decode "
             f"attention launches for {summary['decode_steps']} steps of "
             f"{depth} layers")
    del engine, params
    torch.cuda.empty_cache()
    return out


def cli_phase() -> dict:
    cmd = [sys.executable, "-m", "torchpruner_tpu_torch", "serve",
           "llama3_ffn_taylor", "--smoke", "--synthetic", "8", "--verify"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        fail(f"CLI exited {res.returncode}:\n{res.stdout}\n{res.stderr}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    if summary.get("verify_mismatches") != 0 \
            or summary.get("requests_completed") != 8 \
            or summary.get("device") != "cuda":
        fail(f"CLI summary: {summary}")
    log(f"cli: {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)")
    return summary


# -- phase 6 ----------------------------------------------------------------

#: (label, B, S, H, Dh, dtype, causal[, layout]): the attention shapes of
#: the prune loop — BERT-base scoring (f32) and retraining (bf16),
#: mfu_llama causal training, a causal S that is not a multiple of the
#: tile — and the bf16 kernels where they break: a ragged causal S, a Dh
#: that is not a multiple of 16, q/k/v as views of one fused (B, S, 3, H,
#: Dh) tensor (TMA route), rows only 2-byte aligned (the copy route), S 1;
#: the f32 kernels' 4-byte copies (rows only 4-byte aligned); and a
#: ViT-B/16 scoring batch (B 64, S 197 = 196 patches + CLS; phase 15's
#: Shapley unit steps run 5 such copies at once), the f32 forward's ragged
#: non-causal S on a main path
FLASH_CASES = (
    ("scoring", 128, 128, 12, 64, "float32", False),
    ("retrain", 32, 128, 12, 64, "bfloat16", False),
    ("causal_train", 8, 1024, 8, 128, "bfloat16", True),
    ("ragged_causal", 4, 333, 12, 64, "float32", True),
    ("ragged_causal_bf16", 4, 333, 12, 64, "bfloat16", True),
    ("dh72_bf16", 4, 256, 8, 72, "bfloat16", True),
    ("fused_qkv_bf16", 8, 512, 12, 64, "bfloat16", True, "fused"),
    ("copy_route_bf16", 2, 256, 8, 64, "bfloat16", True, "offset"),
    ("s1_bf16", 8, 1, 8, 128, "bfloat16", False),
    ("unaligned_f32", 2, 256, 8, 64, "float32", True, "offset"),
    ("dh128_f32", 4, 512, 8, 128, "float32", False),
    ("dh72_f32", 4, 256, 8, 72, "float32", True),
    ("vit_scoring", 64, 197, 12, 64, "float32", False),
)
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
BS_KERNELS = ("blocksparse_fwd", "blocksparse_dx", "blocksparse_dw")


def flash_launches():
    from torchpruner_tpu_torch.ops import flash_attention as FA

    return {n: getattr(FA, n).launches for n in FLASH_KERNELS}


def reset_launches():
    from torchpruner_tpu_torch.ops import blocksparse as BS
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import flash_attention as FA
    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.ops.fixed_order import per_rows

    for n in FLASH_KERNELS:
        getattr(FA, n).launches = 0
    for n in BS_KERNELS:
        getattr(BS, n).launches = 0
    FM.dequant_matmul.launches = 0
    DA.decode_attention.launches = 0
    per_rows.calls = 0


def flash_layout(q, k, v, layout):
    """q, k, v in ``layout``: ``"bshd"`` as they are, ``"fused"`` views of
    one (B, S, 3, H, Dh) tensor, ``"offset"`` views whose rows start one
    element past a 16-byte boundary (the bf16 kernels' copy route, the
    f32 kernels' 4-byte copies)."""
    import torch

    if layout == "fused":
        qkv = torch.stack((q, k, v), dim=2)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if layout == "offset":
        out = []
        for t in (q, k, v):
            B, S, H, Dh = t.shape
            row = H * Dh + 1
            buf = torch.zeros(B * S * row + 1, dtype=t.dtype, device=t.device)
            view = buf[1:].as_strided((B, S, H, Dh), (S * row, row, Dh, 1))
            view.copy_(t)
            out.append(view)
        return tuple(out)
    return q, k, v


def flash_bodies(calls) -> dict:
    """The kernel each flash call ran, as the profiler names it (a
    demangled name without its namespaces and parameters), by kernel;
    grouped by ``prune_trace.py``'s name fragments."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchpruner_tpu_torch.experiments.prune_trace import _group

    # a session that lost the kernel events (the profiler on the H100
    # can, ROADMAP C3) is asked again, at most three times; the first
    # session that sees the kernels decides
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
        ran = {kernel: set() for kernel in calls}
        seen = set()
        for e in prof.events():
            seen.add(e.name)
            if _group(e.name) in ran:
                m = re.search(r"(\w+(?:<[^()]*>)?)\(", e.name)
                ran[_group(e.name)].add(m.group(1) if m else e.name)
        if any(ran.values()):
            break
    for kernel, names in ran.items():
        if len(names) != 1:
            fail(f"flash {kernel}: the profiler saw kernels "
                 f"{sorted(names)} (events {sorted(seen)[:12]})")
    return {kernel: names.pop() for kernel, names in ran.items()}


def flash_case(dev, label, B, S, H, Dh, dtn, causal, layout="bshd") -> dict:
    import torch
    import torch.nn.functional as Fn

    from torchpruner_tpu_torch.ops import flash_attention as FA

    dtype = getattr(torch, dtn)
    f32 = dtype == torch.float32
    gen = torch.Generator(device=dev).manual_seed(S + Dh)
    q, k, v, g = (torch.randn((B, S, H, Dh), generator=gen,
                              device=dev).to(dtype) for _ in range(4))
    q, k, v = flash_layout(q, k, v, layout)
    # the reference: autograd of the plain version, in f32, on the same
    # (for bf16: bf16-rounded) inputs
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    r_out, r_lse = FA.flash_attention_plain(*ref, causal=causal,
                                            with_lse=True)
    r_grads = torch.autograd.grad(r_out, ref, g.float())
    r_out, r_lse = r_out.detach(), r_lse.detach()
    o, lse = FA.flash_fwd(q, k, v, causal=causal, with_lse=True)
    dq, delta = FA.flash_dq(q, k, v, o, g, lse, causal=causal)
    dk, dv = FA.flash_dkv(q, k, v, g, lse, delta, causal=causal)
    dk2, dv2 = FA.flash_dkv(q, k, v, g, lse, delta, causal=causal)
    dq2, delta2 = FA.flash_dq(q, k, v, o, g, lse, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        fail(f"flash {label}: dK/dV differ between two runs")
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        fail(f"flash {label}: dQ or delta differ between two runs")
    del dk2, dv2, dq2, delta2
    rel, grel = (1e-5, 1e-4) if f32 else (2 ** -7, 2 ** -7)
    errs = {}
    dv_scale = float(r_grads[2].abs().max())
    for name, got, want, r in (("out", o, r_out, rel),
                               ("lse", lse, r_lse, 1e-5),
                               ("dq", dq, r_grads[0], grel),
                               ("dk", dk, r_grads[1], grel),
                               ("dv", dv, r_grads[2], grel)):
        err = float((got.float() - want.float()).abs().max())
        # an identically-zero reference (dq, dk at S 1: one key, so the
        # softmax passes no gradient) is held to the backward's scale
        tol = r * (float(want.float().abs().max()) or dv_scale)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            fail(f"flash {label} {name}: max abs err {err} > tol {tol}")
        errs[name] = {"max_abs_err": err, "tol": tol}
    del ref, r_out, r_lse, r_grads
    torch.cuda.empty_cache()
    case = {"label": label, "B": B, "S": S, "H": H, "Dh": Dh, "dtype": dtn,
            "causal": causal, "layout": layout,
            "route": None if f32 else FA.copy_route(q, k, v, g),
            # the route dQ's q, k, v, o, dO take
            "dq_route": None if f32 else FA.copy_route(q, k, v, o, g),
            "dkv_bit_equal": True, "dq_bit_equal": True, "errors": errs}
    case["body"] = flash_bodies({
        "flash_fwd": lambda: FA.flash_fwd(q, k, v, causal=causal,
                                          with_lse=True),
        "flash_dq": lambda: FA.flash_dq(q, k, v, o, g, lse, causal=causal),
        "flash_dkv": lambda: FA.flash_dkv(q, k, v, g, lse, delta,
                                          causal=causal)})
    want = (("fwd_tf32x3", "dq_tf32x3", "dkv_tf32x3") if f32
            else ("fwd_wgmma", "dq_wgmma", "dkv_wgmma"))
    for name, body in zip(FLASH_KERNELS, want):
        if body not in case["body"][name]:
            fail(f"flash {label}: {name} ran {case['body'][name]}, not "
                 f"{body}")
    case["ms"] = {
        "flash_fwd": event_ms(lambda i: FA.flash_fwd(
            q, k, v, causal=causal, with_lse=True), 10),
        "flash_dq": event_ms(lambda i: FA.flash_dq(
            q, k, v, o, g, lse, causal=causal), 10),
        "flash_dkv": event_ms(lambda i: FA.flash_dkv(
            q, k, v, g, lse, delta, causal=causal), 10)}
    pq = [t.detach().requires_grad_() for t in (q, k, v)]
    case["plain_fwd_ms"] = event_ms(lambda i: FA.flash_attention_plain(
        *pq, causal=causal), 3)
    p_out = FA.flash_attention_plain(*pq, causal=causal)
    case["plain_bwd_ms"] = event_ms(lambda i: torch.autograd.grad(
        p_out, pq, g, retain_graph=True), 3)
    del p_out
    torch.cuda.empty_cache()
    # the library yardstick, timed only: SDPA on (B, H, S, Dh) views (of
    # contiguous copies for the offset layout, whose rows its f32 kernel
    # refuses)
    lq = [(t.contiguous() if layout == "offset" else t).detach()
          .transpose(1, 2).requires_grad_() for t in (q, k, v)]
    gl = g.transpose(1, 2)
    case["library_fwd_ms"] = event_ms(
        lambda i: Fn.scaled_dot_product_attention(*lq, is_causal=causal), 10)
    l_out = Fn.scaled_dot_product_attention(*lq, is_causal=causal)
    case["library_bwd_ms"] = event_ms(lambda i: torch.autograd.grad(
        l_out, lq, gl, retain_graph=True), 10)
    case["library_fwd_bwd_ms"] = event_ms(lambda i: torch.autograd.grad(
        Fn.scaled_dot_product_attention(*lq, is_causal=causal), lq, gl), 10)
    # bounds: each input read once, each output written once; the
    # operations this run's mask needs (causal: the visible pairs) at the
    # card's peak for the type (f32: 3xTF32; the FMA units' bound kept
    # beside it)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    n, rows, es = B * S * H * Dh, B * H * S, q.element_size()
    work = {"flash_fwd": (4 * n * es + 4 * rows, 4.0 * pairs * Dh),
            "flash_dq": (6 * n * es + 8 * rows, 6.0 * pairs * Dh + 2.0 * n),
            "flash_dkv": (6 * n * es + 8 * rows, 8.0 * pairs * Dh)}
    case["bound"] = {k: bound_ms(*w, TF32X3_FLOPS if f32 else BF16_FLOPS)
                     for k, w in work.items()}
    if f32:
        case["bound_fma"] = {k: bound_ms(*w, FP32_FLOPS)
                             for k, w in work.items()}
    ms = case["ms"]
    log(f"  flash {label} {dtn} B{B} S{S} H{H} Dh{Dh} causal={causal} "
        f"{layout} route={case['route']} bodies "
        + " / ".join(case["body"][k] for k in FLASH_KERNELS) + " dq route="
        f"{case['dq_route']}: "
        f"fwd {ms['flash_fwd']:.4f} / dq {ms['flash_dq']:.4f} / dkv "
        f"{ms['flash_dkv']:.4f} ms  bounds "
        + "/".join(f"{case['bound'][k][0]:.4f}" for k in FLASH_KERNELS)
        + ("  (fma " + "/".join(f"{case['bound_fma'][k][0]:.4f}"
                                for k in FLASH_KERNELS) + ")" if f32 else "")
        + f" ms  plain fwd {case['plain_fwd_ms']:.3f} bwd "
        f"{case['plain_bwd_ms']:.3f} ms  sdpa fwd "
        f"{case['library_fwd_ms']:.4f} bwd {case['library_bwd_ms']:.4f} "
        f"fwd+bwd {case['library_fwd_bwd_ms']:.4f} ms  errs "
        + " ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in errs.items()))
    del q, k, v, g, o, lse, dq, dk, dv, delta, pq, lq, l_out
    torch.cuda.empty_cache()
    return case


# -- phases 7-9 -------------------------------------------------------------


def _csv_rows(path: str) -> list:
    import csv

    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _cli(argv) -> str:
    """Run the port's CLI in process; its stdout, echoed."""
    import contextlib
    import io

    from torchpruner_tpu_torch import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    log(text.rstrip())
    if rc != 0:
        fail(f"CLI {argv} exited {rc}")
    return text


def _dropped_counts(text: str) -> list:
    """The unit counts of the loop's "pruned N units from ..." lines."""
    import re

    return [int(n) for n in re.findall(r"pruned (\d+) units from", text)]


def preset_phase(dev):
    """Phase 7: ``--preset bert_glue_sensitivity`` in process; returns
    its summary and the ``(target, dropped units)`` of every round."""
    import torch

    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.ops.fixed_order import per_rows

    cfg = get_preset("bert_glue_sensitivity")
    n_before = len(_csv_rows(cfg.log_path))
    reset_launches()
    t0 = time.perf_counter()
    with _recorded_prunes() as drops:  # phase 28 holds its first 2
        text = _cli(["--preset", "bert_glue_sensitivity"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fixed = flash_launches(), per_rows.calls
    summary = json.loads(text.strip().splitlines()[-1])
    rows = _csv_rows(cfg.log_path)[n_before:]
    kept = 3072 - int(3072 * cfg.fraction)
    for i, r in enumerate(rows):
        fc1 = [int(w) for w in r["widths"].split("-")][1:36:3]
        if sorted(fc1) != [kept] * (i + 1) + [3072] * (11 - i):
            fail(f"preset record {i} ({r['layer']}): fc1 widths {fc1}")
        losses = [float(r[k]) for k in ("test_loss", "test_loss_pp")]
        if not all(math.isfinite(x) for x in losses):
            fail(f"preset record {i}: losses {losses}")
    if summary.get("steps") != 12 or len(rows) != 12:
        fail(f"preset: {len(rows)} records, summary {summary}")
    if min(launches.values()) <= 0:
        fail(f"preset never launched a flash kernel: {launches}")
    if fixed:
        fail(f"the full-sequence path made {fixed} fixed-order chunk calls")
    out = {"records": len(rows), "fc1_kept": kept, "wall_s": wall,
           "n_dropped": _dropped_counts(text),
           "post_losses": [float(r["test_loss_pp"]) for r in rows],
           "launches": launches, "fixed_order_calls": fixed,
           "final_acc": summary["final_acc"],
           "final_params": summary["final_params"],
           "layers": [r["layer"] for r in rows],
           "widths": [r["widths"] for r in rows],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"preset: {json.dumps(out)}")
    return out, drops


def _timed_steps():
    """Record every ``Trainer.step`` (loss, seconds to the card's end)
    while the context is open."""
    import contextlib

    import torch

    from torchpruner_tpu_torch.train.loop import Trainer

    steps = []
    orig = Trainer.step

    def step(self, x, y):
        t0 = time.perf_counter()
        loss = orig(self, x, y)
        torch.cuda.synchronize()
        steps.append((float(loss), time.perf_counter() - t0))
        return loss

    @contextlib.contextmanager
    def ctx():
        Trainer.step = step
        try:
            yield steps
        finally:
            Trainer.step = orig

    return ctx()


def _step_stats(steps, what) -> dict:
    import statistics

    if not steps or not all(math.isfinite(l) for l, _ in steps):
        fail(f"{what}: step losses {[l for l, _ in steps][:8]}...")
    times = [t * 1e3 for _, t in steps[1:]] or [steps[0][1] * 1e3]
    return {"steps": len(steps), "first_loss": steps[0][0],
            "last_loss": steps[-1][0], "first_step_ms": steps[0][1] * 1e3,
            "step_ms_median": statistics.median(times)}


def retrain_phase(dev) -> dict:
    import dataclasses

    from torchpruner_tpu_torch.experiments.presets import get_preset

    cfg = dataclasses.replace(
        get_preset("bert_glue_sensitivity"), finetune_epochs=1,
        target_filter=("block12_mlp/",),
        log_path="logs/chip_smoke_retrain.csv")
    os.makedirs("logs", exist_ok=True)
    path = os.path.join("logs", "chip_smoke_retrain.json")
    cfg.to_json(path)
    reset_launches()
    t0 = time.perf_counter()
    with _timed_steps() as steps:
        _cli(["--config", path])
    out = {"wall_s": time.perf_counter() - t0, "launches": flash_launches(),
           **_step_stats(steps, "retrain")}
    if min(out["launches"].values()) <= 0:
        fail(f"retrain never launched a flash kernel: {out['launches']}")
    log(f"retrain: {json.dumps(out)}")
    return out


def causal_phase(dev) -> dict:
    import torch

    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.models import mfu_llama
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss

    ds = load_dataset("lm_mfu", "train", n=24, seed=0)
    trainer = Trainer.create(mfu_llama(), optim.adam(1e-4),
                             lm_cross_entropy_loss, seed=0,
                             compute_dtype=torch.bfloat16, device=dev)
    reset_launches()
    with _timed_steps() as steps:
        for x, y in ds.batches(8):
            trainer.step(x, y)
    out = {"model": "mfu_llama", "batch": 8, "seq": 1024,
           "launches": flash_launches(), **_step_stats(steps, "causal")}
    if min(out["launches"].values()) <= 0:
        fail(f"causal training never launched a flash kernel: "
             f"{out['launches']}")
    log(f"causal: {json.dumps(out)}")
    del trainer
    torch.cuda.empty_cache()
    return out


# -- phase 10 ---------------------------------------------------------------

#: (label, R, D, F, block, input axis half kept, output axis half kept):
#: BERT-base's two MLP products at B 32 x S 128 rows, the JAX package's
#: bench shape, a ragged row count and a block-32 case
BS_CASES = (
    ("fc1", 4096, 768, 3072, 128, False, True),
    ("fc2", 4096, 3072, 768, 128, True, False),
    ("both_axes", 1024, 4096, 4096, 128, True, True),
    ("ragged", 4099, 768, 3072, 128, False, True),
    ("block32", 1000, 256, 384, 32, True, True),
)


def blocksparse_case(dev, label, R, D, F, block, half_in, half_out,
                     dtn) -> dict:
    import torch

    from torchpruner_tpu_torch.ops import blocksparse as BS

    dtype = getattr(torch, dtn)
    f32 = dtype == torch.float32
    gen = torch.Generator(device=dev).manual_seed(R + D + F + block)
    # every second block dropped on a half-kept axis
    ik = tuple(i for i in range(D // block) if not (half_in and i % 2))
    ok = tuple(j for j in range(F // block) if not (half_out and j % 2 == 0))
    in_m = BS._unit_mask(D, ik, block, dev)
    out_m = BS._unit_mask(F, ok, block, dev)
    x = torch.randn((R, D), generator=gen, device=dev).to(dtype)
    w = (torch.randn((D, F), generator=gen, device=dev) * 0.02
         * in_m[:, None] * out_m[None, :]).to(dtype)  # the masked weight
    g = torch.randn((R, F), generator=gen, device=dev).to(dtype)
    # the reference: autograd of the plain version, in f32, on the same
    # (for bf16: bf16-rounded) inputs
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    yr = BS.blocksparse_matmul_plain(xr, wr, in_keep=ik, out_keep=ok,
                                     block=block)
    dxr, dwr = torch.autograd.grad(yr, (xr, wr), g.float())
    y = BS.blocksparse_fwd(x, w, ik, ok, block)
    dx = BS.blocksparse_dx(g, w, ik, ok, block)
    dw = BS.blocksparse_dw(x, g, ik, ok, block)
    dw_again = BS.blocksparse_dw(x, g, ik, ok, block)
    torch.cuda.synchronize()
    if not torch.equal(dw, dw_again):
        fail(f"blocksparse {label} {dtn}: dW differs between two runs")
    del dw_again
    # the launch plan each call took, as the library computes it, must be
    # the one ops/blocksparse.py's mirror says
    plans = {}
    for name in BS_KERNELS:
        args = (name[12:], R, D, F, block, len(ik), len(ok), dtype)
        got_plan = BS.plan_on_card(*args)
        if got_plan != BS.plan(*args):
            fail(f"blocksparse {label} {dtn} {name}: tp_bs_plan "
                 f"{got_plan} != plan() {BS.plan(*args)}")
        plans[name] = dataclasses.asdict(got_plan)
    # the library dispatches on its own plan alone: the plan's body is
    # the one that runs (the profiler, asked after phases 7-9, saw no
    # kernel events on the H100)
    want_body = "tf32x3" if f32 else "wgmma" if block % 64 == 0 else "wmma"
    if any(p["body"] != want_body for p in plans.values()):
        fail(f"blocksparse {label} {dtn}: plan bodies "
             f"{[p['body'] for p in plans.values()]}, not {want_body}")
    rel = 1e-5 if f32 else 2 ** -7
    errs = {}
    for name, got, want in (("blocksparse_fwd", y, yr.detach()),
                            ("blocksparse_dx", dx, dxr),
                            ("blocksparse_dw", dw, dwr)):
        err = float((got.float() - want).abs().max())
        tol = rel * float(want.abs().max())
        if not (err <= tol and bool(torch.isfinite(got).all())):
            fail(f"blocksparse {label} {dtn} {name}: max abs err {err} > "
                 f"tol {tol}")
        errs[name] = {"max_abs_err": err, "tol": tol}
    if not (bool((y[:, ~out_m] == 0).all()) and bool((dx[:, ~in_m] == 0).all())
            and bool((dw[~in_m] == 0).all())
            and bool((dw[:, ~out_m] == 0).all())):
        fail(f"blocksparse {label} {dtn}: a dropped column or block is not "
             f"exactly 0")
    del xr, wr, yr, dxr, dwr
    torch.cuda.empty_cache()
    all_in, all_out = tuple(range(D // block)), tuple(range(F // block))
    case = {"label": label, "R": R, "D": D, "F": F, "block": block,
            "dtype": dtn, "in_kept": len(ik), "in_blocks": D // block,
            "out_kept": len(ok), "out_blocks": F // block, "errors": errs,
            "plan": plans}
    case["ms"] = {
        "blocksparse_fwd": event_ms(lambda i: BS.blocksparse_fwd(
            x, w, ik, ok, block), 20),
        "blocksparse_dx": event_ms(lambda i: BS.blocksparse_dx(
            g, w, ik, ok, block), 20),
        "blocksparse_dw": event_ms(lambda i: BS.blocksparse_dw(
            x, g, ik, ok, block), 20)}
    # the same kernels with every block kept (a dense blocked product)
    case["all_kept_ms"] = {
        "blocksparse_fwd": event_ms(lambda i: BS.blocksparse_fwd(
            x, w, all_in, all_out, block), 10),
        "blocksparse_dx": event_ms(lambda i: BS.blocksparse_dx(
            g, w, all_in, all_out, block), 10),
        "blocksparse_dw": event_ms(lambda i: BS.blocksparse_dw(
            x, g, all_in, all_out, block), 10)}
    # the plain version (it masks the weight, then one dense product)
    # and its autograd, one gradient at a time
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    yp = BS.blocksparse_matmul_plain(xp, wp, in_keep=ik, out_keep=ok,
                                     block=block)
    case["plain_ms"] = {
        "blocksparse_fwd": event_ms(lambda i: BS.blocksparse_matmul_plain(
            x, w, in_keep=ik, out_keep=ok, block=block), 10),
        "blocksparse_dx": event_ms(lambda i: torch.autograd.grad(
            yp, xp, g, retain_graph=True), 10),
        "blocksparse_dw": event_ms(lambda i: torch.autograd.grad(
            yp, wp, g, retain_graph=True), 10)}
    del xp, wp, yp
    # the library yardstick, timed only: torch.matmul on the dense masked
    # weight (all of D and F)
    case["library_ms"] = {
        "blocksparse_fwd": event_ms(lambda i: torch.matmul(x, w), 20),
        "blocksparse_dx": event_ms(lambda i: torch.matmul(g, w.t()), 20),
        "blocksparse_dw": event_ms(lambda i: torch.matmul(x.t(), g), 20)}
    # bounds: the kept columns of the inputs and the kept blocks of the
    # weight read once, the whole output (its zeros too) written once;
    # the operations of the kept blocks at the card's peak for the type
    # (f32: 3xTF32; the FMA units' bound kept beside it)
    es = x.element_size()
    kd, kf = len(ik) * block, len(ok) * block
    ops = 2.0 * R * kd * kf
    nbytes = {"blocksparse_fwd": (R * kd + kd * kf + R * F) * es,
              "blocksparse_dx": (R * kf + kd * kf + R * D) * es,
              "blocksparse_dw": (R * kd + R * kf + D * F) * es}
    case["bound"] = {k: bound_ms(b, ops, TF32X3_FLOPS if f32 else BF16_FLOPS)
                     for k, b in nbytes.items()}
    if f32:
        case["bound_fma"] = {k: bound_ms(b, ops, FP32_FLOPS)
                             for k, b in nbytes.items()}
    log(f"  blocksparse {label} {dtn} R{R} D{D} F{F} block {block} kept "
        f"{len(ik)}/{D // block} x {len(ok)}/{F // block}, plan "
        + " / ".join(f"{p['body']} {p['tile_m']}x{p['tile_n']} "
                     f"{p['stages']} stages split {p['split']}"
                     for p in plans.values()) + ": "
        + "  ".join(
            f"{k[12:]} {case['ms'][k]:.4f} ms (all kept "
            f"{case['all_kept_ms'][k]:.4f}, plain {case['plain_ms'][k]:.4f}, "
            f"matmul {case['library_ms'][k]:.4f}, bound "
            f"{case['bound'][k][0]:.4f} {case['bound'][k][1]}"
            + (f" (fma {case['bound_fma'][k][0]:.4f})" if f32 else "")
            + f", err {errs[k]['max_abs_err']:.3g})" for k in BS_KERNELS))
    del x, w, g, y, dx, dw
    torch.cuda.empty_cache()
    return case


# -- phases 11-13 -----------------------------------------------------------


def bs_launches() -> dict:
    from torchpruner_tpu_torch.ops import blocksparse as BS

    return {n: getattr(BS, n).launches for n in BS_KERNELS}


def masked_retrain_phase(dev, n_steps: int = 30):
    """The masked-retrain recipe on BERT-base: block-granular Sensitivity
    drops, masks, Adam + masked_update, block-sparse steps against the
    same steps masked dense, then one structural prune.  Returns the
    phase's record and, for phase 25, its set-up: the masked start
    params (on the host), the drops, the batches and the block-sparse
    step losses."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.attributions import (
        SensitivityAttributionMetric,
    )
    from torchpruner_tpu_torch.core import masking, segment
    from torchpruner_tpu_torch.core.pruner import prune, score_drop_indices
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.models import bert_base
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.ops import blocksparse as BS
    from torchpruner_tpu_torch.train.loop import (
        Trainer,
        make_loss_closure,
        to_device,
    )
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss
    from torchpruner_tpu_torch.utils.tree import tree_leaves, tree_map

    model = bert_base()
    params, state = segment.init_model(model, 0, device=dev)
    val = load_dataset("glue_sst2", "val", n=256, seed=0)
    train = load_dataset("glue_sst2", "train", n=32 * n_steps, seed=0)
    targets = [f"block{i}_mlp/fc1" for i in range(1, 13)]
    t0 = time.perf_counter()
    metric = SensitivityAttributionMetric(
        model, params, val.batches(128), cross_entropy_loss, state=state,
        seed=0)
    drops = {t: score_drop_indices(metric.run(t), policy="fraction",
                                   fraction=0.5, granularity=128)
             for t in targets}
    score_s = time.perf_counter() - t0
    if any(len(d) != 1536 or (np.diff(d.reshape(-1, 128), axis=1) != 1).any()
           for d in drops.values()):
        fail("masked retrain: drops are not 12 whole 128-blocks per layer")
    masks, _ = masking.drop_masks(model, params, drops, state=state)
    start = masking.apply_masks(params, masks)
    tx = optim.chain(optim.adam(1e-4), masking.masked_update(masks))
    batches = list(train.batches(32))[:n_steps]

    def run(transform):
        trainer = Trainer.create(model, tx, cross_entropy_loss, seed=0,
                                 params=start, state=state,
                                 compute_dtype=torch.bfloat16, device=dev,
                                 param_transform=transform)
        reset_launches()
        with _timed_steps() as steps:
            for x, y in batches:
                trainer.step(x, y)
        return trainer, steps, bs_launches()

    sparse, s_steps, s_launch = run(
        masking.blocksparse_transform(model, drops))
    dense, d_steps, d_launch = run(None)
    out = {"model": "bert_base", "batch": 32, "seq": 128, "steps": n_steps,
           "score_s": score_s, "launches": s_launch,
           "launches_masked_dense": d_launch,
           "blocksparse": _step_stats(s_steps, "block-sparse retrain"),
           "masked_dense": _step_stats(d_steps, "masked dense retrain")}
    want = {n: 24 * n_steps for n in BS_KERNELS}
    if s_launch != want:
        fail(f"masked retrain: launches {s_launch}, expected {want} "
             f"(24 forward, 24 dx, 24 dW per step: every wrapped site)")
    if any(d_launch.values()):
        fail(f"masked dense steps reached the block-sparse wrappers: "
             f"{d_launch}")
    # bf16 products round in another order in the kernels than in the
    # library's, and Adam carries the difference on: the two loss
    # sequences agree to 2**-5 of the largest loss
    s_loss = [l for l, _ in s_steps]
    d_loss = [l for l, _ in d_steps]
    tol = 2 ** -5 * max(abs(l) for l in d_loss)
    out["loss_max_abs_diff"] = max(abs(a - b) for a, b in zip(s_loss, d_loss))
    out["params_max_abs_diff"] = max(
        float((a - b).abs().max()) for a, b in zip(
            tree_leaves(sparse.params), tree_leaves(dense.params)))
    out["loss_tol"] = tol
    if not out["loss_max_abs_diff"] <= tol:
        fail(f"masked retrain: block-sparse and masked-dense losses differ "
             f"by {out['loss_max_abs_diff']} > {tol}")
    for name, t in (("block-sparse", sparse), ("masked dense", dense)):
        for target, drop in drops.items():
            mlp = t.params[target.split("/")[0]]
            idx = torch.as_tensor(drop, device=dev)
            if not (bool((mlp["fc1"]["w"][:, idx] == 0).all())
                    and bool((mlp["fc1"]["b"][idx] == 0).all())
                    and bool((mlp["fc2"]["w"][idx] == 0).all())):
                fail(f"{name}: a masked entry of {target} moved off 0")
    if not any(bool((sparse.params[t.split("/")[0]]["fc1"]["w"]
                     != start[t.split("/")[0]]["fc1"]["w"]).any())
               for t in targets):
        fail("masked retrain: no kept weight trained")
    # the discriminator: both runs could agree by computing the same
    # thing through one route, so hold the routes apart directly.  NaN in
    # the dropped columns of one trained fc1 weight: the block-sparse
    # step's loss must not move by a bit (its kernels never read a
    # dropped block, forward or in fc2's contraction), the masked-dense
    # loss must turn NaN (the library's product reads them)
    x, y = (to_device(a, dev) for a in batches[0])
    t1 = targets[0].split("/")[0]
    idx = torch.as_tensor(drops[targets[0]], device=dev)
    poisoned = tree_map(lambda t: t, sparse.params)
    poisoned[t1]["fc1"]["w"] = poisoned[t1]["fc1"]["w"].clone()
    poisoned[t1]["fc1"]["w"][:, idx] = float("nan")

    def loss_of(params, transform):
        closure = make_loss_closure(model, cross_entropy_loss,
                                    torch.bfloat16, transform)
        gen = torch.Generator(device=dev).manual_seed(0)  # same dropout
        with torch.no_grad():
            return float(closure(params, sparse.state, x, y, gen)[0])

    tf = masking.blocksparse_transform(model, drops)
    probe = {"blocksparse": loss_of(sparse.params, tf),
             "blocksparse_poisoned": loss_of(poisoned, tf),
             "masked_dense": loss_of(sparse.params, None),
             "masked_dense_poisoned": loss_of(poisoned, None)}
    # and one product: the fc1 kernel against the library's on the same
    # bf16 tensors (how far apart the two routes' roundings are)
    gen = torch.Generator(device=dev).manual_seed(11)
    xb = torch.randn((4096, 768), generator=gen, device=dev).bfloat16()
    wb = sparse.params[t1]["fc1"]["w"].bfloat16()
    keep = BS.keep_blocks_from_drop(3072, drops[targets[0]])
    y_k = BS.BlockSparseWeight(wb, None, keep).matmul(xb)
    y_l = xb @ wb
    probe["fc1_kernel_vs_library_max_abs_diff"] = float(
        (y_k.float() - y_l.float()).abs().max())
    probe["fc1_output_scale"] = float(y_l.float().abs().max())
    out["probe"] = probe
    if not (math.isfinite(probe["blocksparse"])
            and probe["blocksparse_poisoned"] == probe["blocksparse"]):
        fail(f"masked retrain: NaN in a dropped block moved the "
             f"block-sparse loss: {probe}")
    if not (math.isfinite(probe["masked_dense"])
            and math.isnan(probe["masked_dense_poisoned"])):
        fail(f"masked retrain: NaN in a dropped block did not reach the "
             f"masked-dense loss: {probe}")
    # materialize: one structural prune with the same indices
    with torch.no_grad():
        y_masked, _ = model.apply(sparse.params, x, state=sparse.state)
        pm, pp, ps = model, sparse.params, sparse.state
        for target, drop in drops.items():
            res = prune(pm, pp, target, drop, state=ps)
            pm, pp, ps = res.model, res.params, res.state
        y_pruned, _ = pm.apply(pp, x, state=ps)
    widths = [pm.widths()[t] for t in targets]
    err = float((y_masked - y_pruned).abs().max())
    ptol = 1e-4 * float(y_masked.abs().max())
    out.update(pruned_fc1_widths=widths, pruned_max_abs_err=err,
               pruned_tol=ptol)
    if widths != [1536] * 12:
        fail(f"masked retrain: pruned fc1 widths {widths}")
    if not (err <= ptol and bool(torch.isfinite(y_pruned).all())):
        fail(f"masked retrain: pruned forward differs from the masked "
             f"forward by {err} > {ptol}")
    log(f"masked retrain: {json.dumps(out)}")
    setup = {"state": state, "drops": drops, "batches": batches,
             "losses": s_loss,
             "start": tree_map(lambda t: t.cpu(), start)}
    del sparse, dense, metric, params, start, masks
    torch.cuda.empty_cache()
    return out, setup


def simulate_phase(dev, pr: dict) -> dict:
    """Phase 7's preset with ``simulate=true`` through ``--config``,
    held against phase 7's structural records ``pr``."""
    import dataclasses

    from torchpruner_tpu_torch.experiments.presets import get_preset

    cfg = dataclasses.replace(
        get_preset("bert_glue_sensitivity"), simulate=True,
        log_path="logs/chip_smoke_simulate.csv")
    os.makedirs("logs", exist_ok=True)
    path = os.path.join("logs", "chip_smoke_simulate.json")
    cfg.to_json(path)
    n_before = len(_csv_rows(cfg.log_path))
    t0 = time.perf_counter()
    text = _cli(["--config", path])
    wall = time.perf_counter() - t0
    rows = _csv_rows(cfg.log_path)[n_before:]
    dropped = _dropped_counts(text)
    losses = [float(r["test_loss_pp"]) for r in rows]
    if len(rows) != 12 or json.loads(
            text.strip().splitlines()[-1]).get("steps") != 12:
        fail(f"simulate: {len(rows)} records")
    if dropped != pr["n_dropped"] or len(dropped) != 12:
        fail(f"simulate dropped {dropped}, the structural run "
             f"{pr['n_dropped']}")
    for i, r in enumerate(rows):
        fc1 = [int(w) for w in r["widths"].split("-")][1:36:3]
        if fc1 != [3072] * 12:
            fail(f"simulate record {i}: fc1 widths changed: {fc1}")
    # the masked model computes what the pruned one does, f32, in sums
    # of another length and order: losses agree to 1e-3
    diff = max(abs(a - b) for a, b in zip(losses, pr["post_losses"]))
    if not (diff <= 1e-3 and all(math.isfinite(l) for l in losses)):
        fail(f"simulate: post-prune losses {losses} differ from the "
             f"structural run's {pr['post_losses']} by {diff} > 1e-3")
    out = {"records": len(rows), "n_dropped": dropped, "wall_s": wall,
           "post_loss_max_abs_diff": diff, "post_loss_tol": 1e-3}
    log(f"simulate: {json.dumps(out)}")
    return out


def gated_phase(dev) -> dict:
    """Phase 9's mfu_llama steps with every ``block{i}_ffn/gate`` half
    dropped at granularity 128 and the block-sparse transform."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.core import masking, segment
    from torchpruner_tpu_torch.core.pruner import score_drop_indices
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.models import mfu_llama
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss

    model = mfu_llama()
    params, state = segment.init_model(model, 0, device=dev)
    rng = np.random.default_rng(0)
    targets = [t for t in model.widths() if t.endswith("_ffn/gate")]
    drops = {t: score_drop_indices(rng.normal(size=model.widths()[t]),
                                   policy="fraction", fraction=0.5,
                                   granularity=128) for t in targets}
    masks, _ = masking.drop_masks(model, params, drops, state=state)
    tx = optim.chain(optim.adam(1e-4), masking.masked_update(masks))
    trainer = Trainer.create(
        model, tx, lm_cross_entropy_loss, seed=0,
        params=masking.apply_masks(params, masks), state=state,
        compute_dtype=torch.bfloat16, device=dev,
        param_transform=masking.blocksparse_transform(model, drops))
    ds = load_dataset("lm_mfu", "train", n=24, seed=0)
    reset_launches()
    with _timed_steps() as steps:
        for x, y in ds.batches(8):
            trainer.step(x, y)
    launches = bs_launches()
    out = {"model": "mfu_llama", "batch": 8, "seq": 1024,
           "ffn_width": model.widths()[targets[0]], "sites": 3 * len(targets),
           "launches": launches, **_step_stats(steps, "gated")}
    want = {n: 3 * len(targets) * len(steps) for n in BS_KERNELS}
    if launches != want or not targets:
        fail(f"gated: launches {launches}, expected {want}")
    for t, drop in drops.items():
        ffn = trainer.params[t.split("/")[0]]
        idx = torch.as_tensor(drop, device=dev)
        if not (bool((ffn["gate"]["wg"][:, idx] == 0).all())
                and bool((ffn["gate"]["wu"][:, idx] == 0).all())
                and bool((ffn["down"]["w"][idx] == 0).all())):
            fail(f"gated: a masked entry of {t} moved off 0")
    log(f"gated: {json.dumps(out)}")
    del trainer, params
    torch.cuda.empty_cache()
    return out


# -- phases 14-15 -----------------------------------------------------------


def _shapley_watch():
    """While open: every Shapley scoring request (target, scores, wall to
    the card's end, batches scored) and every structural prune (target,
    units dropped) of the prune loop."""
    import contextlib

    import numpy as np
    import torch

    from torchpruner_tpu_torch.attributions.shapley import (
        ShapleyAttributionMetric as SM,
    )
    from torchpruner_tpu_torch.experiments import prune_retrain as PR

    seen = {"scored": [], "dropped": []}
    orig_prune = PR.prune

    def run(self, layer, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = super(SM, self).run(layer, **kw)
        torch.cuda.synchronize()
        seen["scored"].append({
            "layer": layer, "scores": np.asarray(scores),
            "wall_s": time.perf_counter() - t0,
            "batches": sum(1 for _ in self.batches())})
        return scores

    def prune(model, params, layer, drop, **kw):
        seen["dropped"].append((layer, np.asarray(drop)))
        return orig_prune(model, params, layer, drop, **kw)

    @contextlib.contextmanager
    def ctx():
        SM.run, PR.prune = run, prune
        try:
            yield seen
        finally:
            del SM.run
            PR.prune = orig_prune

    return ctx()


def _negative_drops(seen, what) -> list:
    """Each record's drops must be exactly the units its own scores put
    below 0 (the ``negative`` policy, which keeps a layer's first unit
    when every score is negative); the per-target scoring walls."""
    import numpy as np

    if len(seen["scored"]) != len(seen["dropped"]):
        fail(f"{what}: {len(seen['scored'])} scorings, "
             f"{len(seen['dropped'])} prunes")
    out = []
    for s, (layer, drop) in zip(seen["scored"], seen["dropped"]):
        want = np.flatnonzero(s["scores"] < 0)[:len(s["scores"]) - 1]
        if layer != s["layer"] or not np.array_equal(np.sort(drop), want):
            fail(f"{what} {layer}: dropped {drop.tolist()[:16]}..., the "
                 f"scores below 0 are {want.tolist()[:16]}...")
        n = len(s["scores"])
        out.append({"layer": layer, "units": n, "dropped": len(drop),
                    "batches": s["batches"], "score_wall_s": s["wall_s"],
                    "unit_step_ms": s["wall_s"] * 1e3 / (n * s["batches"])})
    return out


def mlp_shapley_phase(dev) -> dict:
    """``--preset mnist_mlp_shapley`` at full width, in process; then one
    ``fc2`` batch of Shapley rows on the card against the CPU's."""
    import torch

    from torchpruner_tpu_torch.attributions.shapley import (
        ShapleyAttributionMetric,
        shapley_rows_fn,
    )
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.experiments.presets import (
        MODEL_REGISTRY,
        get_preset,
    )
    from torchpruner_tpu_torch.train.loop import to_device
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    cfg = get_preset("mnist_mlp_shapley")
    n_before = len(_csv_rows(cfg.log_path))
    t0 = time.perf_counter()
    with _shapley_watch() as seen:
        text = _cli(["--preset", "mnist_mlp_shapley"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = _csv_rows(cfg.log_path)[n_before:]
    if len(rows) != 2 or json.loads(
            text.strip().splitlines()[-1]).get("steps") != 2:
        fail(f"mlp shapley: {len(rows)} records")
    for r in rows:
        losses = [float(r[k]) for k in ("test_loss", "test_loss_pp")]
        if not all(math.isfinite(v) for v in losses):
            fail(f"mlp shapley {r['layer']}: losses {losses}")
    targets = _negative_drops(seen, "mlp shapley")
    # one fc2 batch (its shifted site act2, the 2024 -> 10 suffix) from
    # the initial weights, on the card and on the CPU, same permutations
    model = MODEL_REGISTRY[cfg.model][0]()
    params, _ = init_model(model, seed=cfg.seed, device=dev)
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    ds = load_dataset(cfg.dataset, "val", n=cfg.score_examples,
                      seed=cfg.seed)
    x, y = (to_device(a, dev) for a in
            ds.batches(cfg.eval_batch_size)[0])
    metric = ShapleyAttributionMetric(model, params, [], cross_entropy_loss,
                                      seed=cfg.seed, **cfg.method_kwargs)
    perms = metric._draw_perms(metric.n_units("act2"),
                               metric.sv_samples).to(dev)
    fn = shapley_rows_fn(model, "act2", cross_entropy_loss, True)
    with torch.no_grad():
        base = float(cross_entropy_loss(model.apply(params, x)[0], y).mean())
    card = fn(params, {}, x, y, perms).cpu()
    want = fn(cpu_params, {}, x.cpu(), y.cpu(), perms.cpu())
    atol = 1e-5 * base
    err = float((card - want).abs().max())
    if not (err <= atol and bool(torch.isfinite(card).all())):
        fail(f"mlp shapley fc2: card rows differ from the CPU's by {err} "
             f"> {atol}")
    held = {"rows": list(card.shape), "max_abs_err": err, "atol": atol,
            "base_loss": base}
    out = {"records": len(rows), "wall_s": wall, "targets": targets,
           "post_losses": [float(r["test_loss_pp"]) for r in rows],
           "fc2_rows_card_vs_cpu": held}
    log(f"mlp shapley: {json.dumps(out)}")
    return out


def vit_shapley_phase(dev) -> dict:
    """The ``vit_head_mlp_shapley`` recipe on ViT-B/16 at full width and
    depth, cut to its 12 head targets and 64 scoring examples; one head
    target's scores through the flash kernel against the plain version;
    one masking-path unit step of ``block12_mlp/fc1`` timed."""
    import contextlib
    import dataclasses

    import torch

    from torchpruner_tpu_torch.attributions.shapley import (
        ShapleyAttributionMetric,
    )
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.experiments.presets import (
        MODEL_REGISTRY,
        get_preset,
    )
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        run_prune_retrain,
    )
    from torchpruner_tpu_torch.ops import flash_attention as FA
    from torchpruner_tpu_torch.train.loop import to_device
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    preset = get_preset("vit_head_mlp_shapley")
    reduced = {"target_filter": ("_attn/",), "score_examples": 64,
               "train_examples": 256, "test_examples": 512}
    cfg = dataclasses.replace(preset, target_filter=("_attn/",),
                              score_examples=64,
                              log_path="logs/chip_smoke_vit.csv")
    t0 = time.perf_counter()
    datasets = tuple(load_dataset(cfg.dataset, split, n=n, seed=cfg.seed)
                     for split, n in (("train", 256),
                                      ("val", cfg.score_examples),
                                      ("test", 512)))
    data_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    with _shapley_watch() as seen:
        hist = run_prune_retrain(cfg, datasets=datasets, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_launches()
    model = MODEL_REGISTRY[cfg.model][0]()
    depth = sum(1 for spec in model.layers if spec.name.endswith("_attn"))
    n_heads = model.layer("block1_attn/attn").num_heads
    if len(hist) != depth:
        fail(f"vit shapley: {len(hist)} records, not {depth}")
    for r in hist:
        heads = [r.widths[f"block{i}_attn/attn"]
                 for i in range(1, depth + 1)]
        if not (all(math.isfinite(v) for v in (r.pre_loss, r.post_loss))
                and max(heads) <= n_heads):
            fail(f"vit shapley {r.layer}: losses {r.pre_loss} / "
                 f"{r.post_loss}, heads {heads}")
    if launches["flash_fwd"] <= 0:
        fail(f"vit shapley never launched the flash forward: {launches}")
    targets = _negative_drops(seen, "vit shapley")
    # one head target from the initial weights, through the kernel and
    # through the plain version (which must launch nothing)
    params, _ = init_model(model, seed=cfg.seed, device=dev)
    val = datasets[1].batches(cfg.eval_batch_size)
    x, y = (to_device(a, dev) for a in val[0])
    with torch.no_grad():
        base = float(cross_entropy_loss(model.apply(params, x)[0], y).mean())
    site = "block1_attn/attn"

    def scores():
        return ShapleyAttributionMetric(
            model, params, val, cross_entropy_loss, seed=cfg.seed,
            **cfg.method_kwargs).run(site)

    @contextlib.contextmanager
    def plain_flash():
        orig = FA.flash_attention
        FA.flash_attention = lambda q, k, v, causal=False: \
            FA.flash_attention_plain(q, k, v, causal=causal)
        try:
            yield
        finally:
            FA.flash_attention = orig

    n0 = FA.flash_fwd.launches
    kernel = scores()
    n1 = FA.flash_fwd.launches
    with plain_flash():
        plain = scores()
    if n1 == n0 or FA.flash_fwd.launches != n1:
        fail(f"vit shapley: flash forward launches {n0} -> {n1} -> "
             f"{FA.flash_fwd.launches} (kernel run, then plain run)")
    # within atol, a unit's sign may differ only where |score| < atol
    atol = 1e-5 * base
    err = float(abs(kernel - plain).max())
    if not err <= atol:
        fail(f"vit shapley {site}: kernel vs plain scores differ by {err} "
             f"> {atol}")
    # one masking-path unit step of the last block's fc1 at 5 x 64 rows
    S = cfg.method_kwargs["sv_samples"]
    mlp_site = f"block{depth}_mlp/fc1"
    mlp_n = model.layer(mlp_site).features
    xs, ys = x.repeat(S, 1, 1, 1), y.repeat(S)
    mask = torch.ones((S * x.shape[0], mlp_n), device=dev)
    mask[:, ::2] = 0

    @torch.no_grad()
    def step(i):
        preds, _ = model.apply(params, xs, unit_mask=(mlp_site, mask))
        return cross_entropy_loss(preds, ys)

    step_ms = event_ms(step, 3)
    head_s = sorted(t["score_wall_s"] for t in targets)[len(targets) // 2]
    per_batch_s = depth * head_s + depth * mlp_n * step_ms / 1e3
    batches = math.ceil(preset.score_examples / x.shape[0])
    out = {"model": cfg.model, "reduced": reduced, "records": len(hist),
           "wall_s": wall, "data_s": data_s, "launches": launches,
           "targets": targets,
           "post_losses": [r.post_loss for r in hist],
           "heads": {r.layer: r.widths[r.layer] for r in hist},
           "kernel_vs_plain": {"site": site, "max_abs_err": err,
                               "atol": atol, "base_loss": base},
           "mlp_unit_step_ms": step_ms, "mlp_site": mlp_site,
           "rows": S * x.shape[0],
           "head_target_median_s": head_s,
           "full_preset_estimate": {
               "per_scoring_batch_s": per_batch_s,
               "scoring_batches": batches,
               "scoring_s": per_batch_s * batches,
               "what": f"{depth} head targets + {depth} x {mlp_n} MLP "
                       f"unit steps a scoring batch of {x.shape[0]} "
                       f"examples ({S} x {x.shape[0]} rows), times the "
                       f"batches of {x.shape[0]} in the preset's "
                       f"{preset.score_examples} examples; evaluation "
                       f"and surgery not counted"}}
    log(f"vit shapley: {json.dumps(out)}")
    del model, params, datasets, xs, mask
    torch.cuda.empty_cache()
    return out


# -- phases 16-17 -----------------------------------------------------------

#: the layers phase 16 sweeps with the full panel, bracketing the cost:
#: the longest suffix (a 32x32x64 site), the smallest conv suffix (512
#: units at 2x2) and the Dense after the Flatten
VGG_LAYERS = ("conv1", "conv13", "fc1")


def all_launches() -> dict:
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    return {**flash_launches(), **bs_launches(),
            "dequant_matmul": FM.dequant_matmul.launches,
            "decode_attention": DA.decode_attention.launches}


def suffix_flops(model, site: str) -> float:
    """Multiply-add FLOPs per example of the forward after ``site``
    (convs and Dense layers; the elementwise layers not counted)."""
    from torchpruner_tpu_torch.core import layers as L

    flops = 0.0
    for spec, (i_shape, o_shape) in zip(model.layers[model.index(site) + 1:],
                                        model.shapes[model.index(site) + 1:]):
        if isinstance(spec, L.Conv):
            kh, kw = spec.kernel_size
            flops += 2.0 * math.prod(o_shape) * kh * kw * i_shape[-1]
        elif isinstance(spec, L.Dense):
            flops += 2.0 * i_shape[-1] * spec.features
    return flops


def vgg_sweep_phase(dev) -> dict:
    """``vgg16_digits32_layerwise`` at full width: train VGG16-bn (12
    epochs, bf16, Adam, B 128) on digits32, then the 8-method panel (14
    rankings a layer) on conv1, conv13 and fc1 over the 300 test
    examples; one batch of f32 Shapley rows at fc1 (initial weights) on
    the card against the CPU's; the full 15-layer sweep estimated from
    the three."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.attributions.shapley import (
        ShapleyAttributionMetric,
        shapley_rows_fn,
    )
    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.graph import (
        find_best_evaluation_layer,
        pruning_graph,
    )
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments import robustness as R
    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        compute_dtype,
        resolve_model_and_data,
    )
    from torchpruner_tpu_torch.experiments.train_model import run_train
    from torchpruner_tpu_torch.train.loop import to_device

    cfg = dataclasses.replace(get_preset("vgg16_digits32_layerwise"),
                              log_path="logs/chip_smoke_vgg.csv")
    loss_fn = LOSS_REGISTRY[cfg.loss]
    sdtype = compute_dtype(cfg.score_dtype)
    t0 = time.perf_counter()
    model, datasets = resolve_model_and_data(cfg)
    test = datasets[2]
    if len(test) > cfg.score_examples:
        test = test.subset(cfg.score_examples, seed=cfg.seed)
    test_batches = test.batches(cfg.eval_batch_size)
    data_s = time.perf_counter() - t0
    reset_launches()
    t1 = time.perf_counter()
    trainer, hist = run_train(cfg, model=model, datasets=datasets,
                              verbose=True, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    acc = hist[-1]["test_acc"]
    if not (acc >= 0.80 and datasets[0].name == "digits32:train"):
        fail(f"vgg sweep: trained on {datasets[0].name}, test accuracy "
             f"{acc} < 0.80")
    walks = {}
    orig_walk = R.ablation_curves_batch

    def timed_walk(model_, params, state, layer, rankings, *a, **kw):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out = orig_walk(model_, params, state, layer, rankings, *a, **kw)
        torch.cuda.synchronize()
        walks[layer] = {"s": time.perf_counter() - w0,
                        "rankings": len(rankings)}
        return out

    methods = R.method_panel(model, trainer.params, test_batches, loss_fn,
                             state=trainer.state, compute_dtype=sdtype,
                             seed=cfg.seed, **cfg.method_kwargs)
    R.ablation_curves_batch = timed_walk
    try:
        t1 = time.perf_counter()
        results = R.layerwise_robustness(
            model, trainer.params, trainer.state, test_batches, methods,
            loss_fn, layers=VGG_LAYERS, compute_dtype=sdtype, verbose=False)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t1
    finally:
        R.ablation_curves_batch = orig_walk
    launches = all_launches()
    # what every walk must show
    rows = test_batches[0][0].shape[0]
    per_layer = {}
    for layer in VGG_LAYERS:
        n = L.n_units(model.layer(layer))
        runs = results[layer]
        counts = {m: len(r) for m, r in runs.items()}
        want = {"random": 3, "weight_norm": 1, "apoz": 1, "sensitivity": 1,
                "taylor": 1, "taylor_signed": 1, "sv": 3, "sv_mean+2std": 3}
        if counts != want:
            fail(f"vgg sweep {layer}: runs {counts}")
        flat = [r for rs in runs.values() for r in rs]
        for r in flat:
            if not (len(r["loss"]) == len(r["acc"]) == n
                    and np.isfinite(r["loss"]).all()
                    and np.isfinite(r["acc"]).all()):
                fail(f"vgg sweep {layer}: a curve of {len(r['loss'])} "
                     f"entries, not {n} finite ones")
        # all units removed: the output no longer depends on the order
        ends = np.array([r["loss"][-1] for r in flat])
        end_tol = 2.0 ** -7 * float(abs(ends[0]))
        if np.abs(ends - ends[0]).max() > end_tol:
            fail(f"vgg sweep {layer}: walks end at {ends.tolist()}, "
                 f"spread > {end_tol}")
        if len({tuple(np.argsort(r["scores"])) for r in runs["random"]}) \
                != 3:
            fail(f"vgg sweep {layer}: the 3 random runs repeat a ranking")
        walk = walks[layer]
        score_s = {m: [r["seconds"] - walk["s"] / len(flat) for r in rs]
                   for m, rs in runs.items()}
        site = find_best_evaluation_layer(model, layer)
        per_layer[layer] = {
            "units": n, "site": site, "suffix_flops": suffix_flops(model,
                                                                   site),
            "walk_s": walk["s"], "walk_rows": walk["rankings"] * rows,
            "walk_step_ms": walk["s"] * 1e3 / n,
            "score_s": score_s,
            "sv_step_ms": float(np.mean(score_s["sv"])) * 1e3 / n,
            "end_spread": float(np.abs(ends - ends[0]).max()),
            "end_tol": end_tol,
            "auc": {m: float(np.mean([r["auc"] for r in rs]))
                    for m, rs in runs.items()}}
    # one batch of f32 Shapley rows at fc1 (site relu_fc1) from the
    # initial weights and statistics, as phase 14 does, on the card and on
    # the CPU, same permutations
    params, state = init_model(model, seed=cfg.seed, device=dev)
    site = find_best_evaluation_layer(model, "fc1")
    x, y = (to_device(a[:64], dev) for a in test_batches[0])
    metric = ShapleyAttributionMetric(model, params, [], loss_fn,
                                      seed=cfg.seed, **cfg.method_kwargs)
    perms = metric._draw_perms(metric.n_units(site), metric.sv_samples)
    fn = shapley_rows_fn(model, site, loss_fn, True)

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    with torch.no_grad():
        base = float(loss_fn(model.apply(params, x, state=state)[0],
                             y).mean())
    card = fn(params, state, x, y, perms.to(dev)).cpu()
    want = fn(cpu(params), cpu(state), x.cpu(), y.cpu(), perms)
    atol = 1e-5 * base
    err = float((card - want).abs().max())
    if not (err <= atol and bool(torch.isfinite(card).all())):
        fail(f"vgg sweep fc1: card rows differ from the CPU's by {err} "
             f"> {atol}")
    # the full sweep, estimated: per unit step a + b x suffix FLOPs, fit
    # on conv1 and conv13 (Shapley steps on S x B rows, walk steps on
    # 14 x B), times every layer's units; the data-light methods at the
    # three layers' mean
    fits = {}
    for key in ("sv_step_ms", "walk_step_ms"):
        (f1, t1_), (f2, t2_) = ((per_layer[k]["suffix_flops"],
                                 per_layer[k][key])
                                for k in ("conv1", "conv13"))
        b = (t1_ - t2_) / (f1 - f2)
        fits[key] = (t2_ - b * f2, b)
    light = [m for m in per_layer["conv1"]["score_s"]
             if m not in ("sv", "sv_mean+2std")]
    light_s = float(np.mean([sum(np.sum(per_layer[k]["score_s"][m])
                                 for m in light) for k in VGG_LAYERS]))
    est = {}
    for g in pruning_graph(model):
        site = find_best_evaluation_layer(model, g.target)
        n, f = L.n_units(model.layer(g.target)), suffix_flops(model, site)
        sv = n * (fits["sv_step_ms"][0] + fits["sv_step_ms"][1] * f) / 1e3
        wk = n * (fits["walk_step_ms"][0]
                  + fits["walk_step_ms"][1] * f) / 1e3
        est[g.target] = 6 * sv + wk + light_s
    fc1 = per_layer["fc1"]
    out = {"model": cfg.model, "train_s": train_s,
           "data_s": data_s,
           "epochs": len(hist), "test_acc": acc,
           "history": [{k: h[k] for k in ("epoch", "train_loss",
                                          "test_acc", "seconds")}
                       for h in hist],
           "sweep_s": sweep_s, "layers": per_layer, "launches": launches,
           "fc1_rows_card_vs_cpu": {"rows": list(card.shape),
                                    "max_abs_err": err, "atol": atol,
                                    "base_loss": base},
           "fit": {k: {"ms": a, "ms_per_gflop": b * 1e9}
                   for k, (a, b) in fits.items()},
           "fc1_fit_check": {
               "sv_step_ms": fc1["sv_step_ms"],
               "sv_step_ms_fit": fits["sv_step_ms"][0]
               + fits["sv_step_ms"][1] * fc1["suffix_flops"],
               "walk_step_ms": fc1["walk_step_ms"],
               "walk_step_ms_fit": fits["walk_step_ms"][0]
               + fits["walk_step_ms"][1] * fc1["suffix_flops"]},
           "full_sweep_estimate": {
               "by_layer_s": est, "sweep_s": sum(est.values()),
               "with_training_s": sum(est.values()) + train_s,
               "what": "15 layers x (6 Shapley runs + the 14-ranking walk "
                       "at the fit's step time, + the other methods at the "
                       "three layers' mean); evaluation beside the walk "
                       "not counted"}}
    log(f"vgg sweep: {json.dumps(out)}")
    setup = {"model": model, "params": trainer.params,
             "state": trainer.state, "batches": test_batches,
             "loss_fn": loss_fn, "sdtype": sdtype, "seed": cfg.seed,
             "method_kwargs": cfg.method_kwargs}
    return out, setup


def resnet_phase(dev) -> dict:
    """``resnet50_taylor`` at full width (ResNet-50, 224x224, 1000
    classes): Taylor on the six prunable convs of stage 4, fraction 0.25,
    one fine-tune epoch a target, synthetic ImageNet injected (train 256,
    the preset's 1000 scoring examples, test 512); widths, finite losses,
    each attached BatchNorm's params and running statistics sliced with
    its conv; the stem's 3x3 / 2 SAME max-pool (pads 0 / 1 at 112) on the
    card against the CPU's."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.graph import group_for
    from torchpruner_tpu_torch.core.plan import keep_indices
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.experiments import prune_retrain as PR
    from torchpruner_tpu_torch.experiments.presets import get_preset

    preset = get_preset("resnet50_taylor")
    cfg = dataclasses.replace(preset, target_filter=("stage4_",),
                              log_path="logs/chip_smoke_resnet.csv")
    reduced = {"target_filter": ("stage4_",), "train_examples": 256,
               "test_examples": 512}
    t0 = time.perf_counter()
    datasets = tuple(load_dataset(cfg.dataset, split, n=n, seed=cfg.seed)
                     for split, n in (("train", 256),
                                      ("val", cfg.score_examples),
                                      ("test", 512)))
    data_s = time.perf_counter() - t0
    sliced = []
    orig_prune = PR.prune

    def prune(model, params, layer, drop, *, state=None, opt_state=None):
        res = orig_prune(model, params, layer, drop, state=state,
                         opt_state=opt_state)
        keep = torch.as_tensor(keep_indices(L.n_units(model.layer(layer)),
                                            drop), device=dev)
        for bn in group_for(model, layer).attached_bn:
            path = L.parse_path(bn.layer)
            for tree, new, names in ((params, res.params, ("scale", "bias")),
                                     (state, res.state, ("mean", "var"))):
                for name in names:
                    old_t, new_t = tree, new
                    for k in path + (name,):
                        old_t, new_t = old_t[k], new_t[k]
                    if not torch.equal(new_t, old_t.index_select(0, keep)):
                        fail(f"resnet {layer}: {bn.layer}/{name} not "
                             f"sliced with its conv")
            sliced.append(bn.layer)
        return res

    reset_launches()
    PR.prune = prune
    try:
        t1 = time.perf_counter()
        hist = PR.run_prune_retrain(cfg, datasets=datasets, verbose=False,
                                    device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        PR.prune = orig_prune
    launches = all_launches()
    model = PR.MODEL_REGISTRY[cfg.model][0]()
    targets = [t for t in model.widths() if t.startswith("stage4_")
               and "conv3" not in t and "proj" not in t]
    if sorted(r.layer for r in hist) != sorted(targets):
        fail(f"resnet: records {[r.layer for r in hist]}, targets "
             f"{targets}")
    for r in hist:
        n = model.widths()[r.layer]
        if not (r.n_dropped == int(n * cfg.fraction)
                and r.widths[r.layer] == n - r.n_dropped
                and all(math.isfinite(v) for v in (r.pre_loss,
                                                   r.post_loss))):
            fail(f"resnet {r.layer}: dropped {r.n_dropped} of {n}, width "
                 f"{r.widths[r.layer]}, losses {r.pre_loss} / "
                 f"{r.post_loss}")
    if len(sliced) != len(hist):
        fail(f"resnet: BatchNorm slices checked {sliced}")
    # the stem pool's asymmetric SAME pad, card against CPU
    spec = model.layer("stem_pool")
    z = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 112, 112, 64)).astype(np.float32))
    card, _ = L.apply_layer(spec, {}, {}, z.to(dev))
    want, _ = L.apply_layer(spec, {}, {}, z)
    if not (tuple(card.shape[1:3]) == (56, 56)
            and torch.equal(card.cpu(), want)):
        fail("resnet stem pool: card differs from the CPU")
    out = {"model": cfg.model, "reduced": reduced, "records": len(hist),
           "wall_s": wall, "data_s": data_s, "launches": launches,
           "bn_sliced": sliced,
           "widths": {r.layer: r.widths[r.layer] for r in hist},
           "post_losses": [r.post_loss for r in hist],
           "round_s": [r.prune_time for r in hist]}
    log(f"resnet: {json.dumps(out)}")
    return out


# -- phases 18-20 -----------------------------------------------------------

#: phase 18: the shared-prefix traffic (two 256-token system prompts,
#: suffixes of 8 / 24 / 64, 32 greedy tokens, an arrival every 2 steps)
#: and the serve-v2 engine it runs on, with sharing on and off
P18_TRAFFIC = dict(vocab=128256, n_prefixes=2, prefix_len=256,
                   suffix_lens=[8, 24, 64], max_new=[32], seed=0)
P18_ENGINE = dict(n_slots=4, max_len=512, page_len=16, prefill_chunk=64,
                  prefill_token_cap=128)
#: the serve-v2 flags of phases 19-20; a bf16 KV cache keeps the
#: activations bf16, so every projection takes the dequant kernel (an f32
#: cache turns them f32 after the first attention, as in the JAX package)
#: phase 19's arrival spacing in engine ticks (loop iterations, about
#: half a millisecond each while idle): wide enough that the later
#: requests arrive after checkpoint B has staged, so both checkpoints
#: serve and are verified
SWAP_STAGGER_TICKS = 3000
CLI_V2 = ["--page-len", "16", "--prefix-pages", "32", "--prefill-chunk",
          "64", "--max-len", "512", "--kv-dtype", "bfloat16"]


def reset_serve_launches() -> None:
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    FM.dequant_matmul.launches = 0
    DA.decode_attention.launches = 0


def prefix_phase(dev) -> dict:
    """Phase 18: shared-prefix traffic through chunked prefill and prefix
    pages on full-width, full-depth Llama-3-8B int4, then the same
    traffic with sharing off."""
    import torch

    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
    )
    from torchpruner_tpu_torch.models import llama3_8b
    from torchpruner_tpu_torch.serve import (
        OpenLoopTraffic,
        ServeEngine,
        shared_prefix_requests,
        staggered_arrivals,
    )
    from torchpruner_tpu_torch.serve.engine import kernel_launches
    from torchpruner_tpu_torch.serve.frontend import verify_against_solo

    model = llama3_8b(depth=DEPTH)
    params, _ = quantized_random_params(model, bits=4, seed=0, device=dev)
    runs = {}
    for label, pages in (("on", 64), ("off", 0)):
        reqs = shared_prefix_requests(12, **P18_TRAFFIC)
        engine = ServeEngine(model, params, cache_dtype=torch.bfloat16,
                             device=dev, prefix_pages=pages, **P18_ENGINE)
        traffic = OpenLoopTraffic(reqs, staggered_arrivals(12, 2),
                                  by_step=True)
        torch.cuda.synchronize()
        reset_serve_launches()
        t0 = time.perf_counter()
        summary = engine.run(traffic)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[label] = {"engine": engine, "reqs": reqs, "summary": summary,
                       "wall_s": wall, "launches": kernel_launches()}
    on, off = runs["on"], runs["off"]
    # one 64-row chunk at full depth (position 256, after a 16-page hit),
    # host clock around synchronized calls, and its launches
    P = on["engine"].programs
    toks = torch.zeros((1, 64), dtype=torch.long, device=dev)
    P.chunk_prefill(P.params, P.cache, toks, 0, 256)
    torch.cuda.synchronize()
    reset_serve_launches()
    t0 = time.perf_counter()
    for _ in range(3):
        P.chunk_prefill(P.params, P.cache, toks, 0, 256)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) / 3 * 1e3
    chunk_launches = {k: v // 3 for k, v in kernel_launches().items()}
    mism = verify_against_solo(on["engine"])
    s = on["summary"]
    out = {label: {k: r["summary"].get(k) for k in (
        "requests_completed", "decode_steps", "gen_tokens", "ttft_p50_ms",
        "ttft_p99_ms", "token_p50_ms", "token_p99_ms", "prefilled_tokens",
        "max_prefill_tokens_step", "prefill_token_cap", "prefix_hits",
        "prefix_misses", "prefix_hit_tokens", "prefix_hit_rate")}
        | {"wall_s": r["wall_s"], "launches": r["launches"]}
        for label, r in runs.items()}
    out["chunk64_ms"] = chunk_ms
    out["chunk64_launches"] = chunk_launches
    out["verify_mismatches"] = mism
    out["tokens_equal_on_off"] = [list(a.tokens) for a in on["reqs"]] \
        == [list(b.tokens) for b in off["reqs"]]
    log(f"prefix sharing: {json.dumps(out)}")
    for label, r in runs.items():
        if r["summary"]["requests_completed"] != 12 or not all(
                q.state == "done" and len(q.tokens) == 32
                for q in r["reqs"]):
            fail(f"phase 18 sharing {label}: not every request done")
        if r["summary"]["max_prefill_tokens_step"] \
                > r["summary"]["prefill_token_cap"]:
            fail(f"phase 18 sharing {label}: a step prefilled "
                 f"{r['summary']['max_prefill_tokens_step']} tokens over "
                 f"the cap {r['summary']['prefill_token_cap']}")
        for name, n in r["launches"].items():
            if n <= 0:
                fail(f"phase 18 sharing {label} never launched {name}")
        if r["launches"]["decode_attention"] \
                != DEPTH * r["summary"]["decode_steps"]:
            fail(f"phase 18 sharing {label}: "
                 f"{r['launches']['decode_attention']} decode attention "
                 f"launches for {r['summary']['decode_steps']} steps")
    if mism:
        fail(f"phase 18: {mism} requests diverged from solo decode")
    if not out["tokens_equal_on_off"]:
        fail("phase 18: tokens with sharing on differ from sharing off")
    if not (s["prefix_hits"] > 0 and s["prefix_hit_tokens"] >= 256):
        fail(f"phase 18: prefix hits {s['prefix_hits']}, hit tokens "
             f"{s['prefix_hit_tokens']}")
    bad = [r.id for r in on["reqs"] if r.prefix_hit_tokens
           + r.prefilled_tokens != r.prompt_ids.size]
    if bad:
        fail(f"phase 18: hit + prefilled != prompt length for {bad}")
    del runs, on, off, params
    torch.cuda.empty_cache()
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def checkpoint_phase(dev, tmp: str) -> dict:
    """Phase 19: checkpoint A (phase 4's model: int8, full width, 4
    blocks) and checkpoint B (each block's FFN pruned by a quarter by
    WeightNorm, re-quantized to int8) written under ``tmp``; then the CLI
    serves A and hot-swaps to B mid-run, every request verified against
    the checkpoint that served it."""
    import torch

    from torchpruner_tpu_torch.attributions.simple import (
        WeightNormAttributionMetric,
    )
    from torchpruner_tpu_torch.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from torchpruner_tpu_torch.core.pruner import prune, score_drop_indices
    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
    )
    from torchpruner_tpu_torch.models import llama3_8b
    from torchpruner_tpu_torch.ops.quant import (
        QTensor,
        dequantize_params,
        quantize_params,
    )

    a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    model = llama3_8b(depth=4)
    params, _ = quantized_random_params(model, bits=8, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(a, model, params, step=0)
    save_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    model2, params2, _, _, meta = restore_checkpoint(a, device=dev)
    torch.cuda.synchronize()
    restore_a = time.perf_counter() - t0

    def leaves(t, p=""):
        if isinstance(t, QTensor):
            return {f"{p}/q": t.q, f"{p}/scale": t.scale}
        if isinstance(t, dict):
            return {k: v for n, s in t.items()
                    for k, v in leaves(s, f"{p}/{n}").items()}
        return {p: t}

    want, got = leaves(params), leaves(params2)
    if model2 != model or sorted(want) != sorted(got) or not all(
            torch.equal(got[k], want[k]) for k in want):
        fail("phase 19: checkpoint A restored another tree")
    del params2, got
    # B: WeightNorm scores of each block's FFN on the dequantized
    # weights, the lowest quarter pruned, int8 again
    dense = dequantize_params(params)
    del params, want
    pruned = model
    for i in range(1, 5):
        target = f"block{i}_ffn/gate"
        scores = WeightNormAttributionMetric(pruned, dense, None,
                                             None).run(target)
        drop = score_drop_indices(scores, policy="fraction", fraction=0.25)
        res = prune(pruned, dense, target, drop)
        pruned, dense = res.model, res.params
    qb = quantize_params(pruned, dense, bits=8)
    del dense, res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(b, pruned, qb, step=1,
                    prune_history=[{"layer": f"block{i}_ffn/gate",
                                    "fraction": 0.25} for i in range(1, 5)])
    save_b = time.perf_counter() - t0
    widths = {k: v for k, v in pruned.widths().items()
              if k.endswith("_ffn/gate")}
    del qb
    torch.cuda.empty_cache()
    if set(widths.values()) != {14336 - 3584}:
        fail(f"phase 19: pruned FFN widths {widths}")
    cmd = [sys.executable, "-m", "torchpruner_tpu_torch", "serve",
           "llama3_ffn_taylor", "--checkpoint", a, "--swap-checkpoint", b,
           "--swap-after", "8", "--synthetic", "8", "--rate", "0",
           "--stagger-steps", str(SWAP_STAGGER_TICKS),
           "--shared-prefixes", "2", "--prefix-len", "64", "--prompt-lens",
           "8,24", "--verify"] + CLI_V2
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"phase 19 CLI exited {res.returncode}:\n{res.stdout}\n"
             f"{res.stderr[-4000:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    out = {"bytes_a": _dir_bytes(a), "bytes_b": _dir_bytes(b),
           "save_a_s": save_a, "restore_a_s": restore_a, "save_b_s": save_b,
           "digest_a": meta["digest"], "ffn_widths_b": widths,
           "cli_s": cli_s, "summary": summary}
    log(f"checkpoint + swap: {json.dumps(out)}")
    if summary.get("device") != "cuda" \
            or summary.get("requests_completed") != 8 \
            or summary.get("swaps") != 1 \
            or summary.get("verify_mismatches") != 0 \
            or summary.get("served_by", {}).get(a, 0) < 1 \
            or summary.get("served_by", {}).get(b, 0) < 1:
        fail(f"phase 19 CLI summary: {summary}")
    for name, n in summary["kernel_launches"].items():
        if n <= 0:
            fail(f"phase 19: the CLI never launched {name}")
    return out


def _http(port: int, method: str, path: str, body=None, timeout=300,
          parse=json.loads):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, parse(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, parse(e.read())


def http_phase(tmp: str) -> dict:
    """Phase 20: ``serve --checkpoint B --http 0`` in a subprocess: four
    concurrent generations, ``/healthz`` ready, ``POST /swap`` to A (202,
    ``staging_swap``, then ready again), one generation after the swap,
    ``GET /metrics`` 200 with the session's counters and ``POST
    /profile`` 409 (no ``--obs-dir``, no profiler), then SIGTERM: exit
    code 0 and the drained summary."""
    import re
    import signal
    import threading

    from torchpruner_tpu_torch.serve import shared_prefix_requests

    a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    cmd = [sys.executable, "-m", "torchpruner_tpu_torch", "serve",
           "llama3_ffn_taylor", "--checkpoint", b, "--http", "0"] + CLI_V2
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: list = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stderr.readline, "")),
        daemon=True)
    reader.start()
    t_start = time.perf_counter()
    try:
        port = None
        while port is None and time.perf_counter() - t_start < 300:
            found = [re.search(r"serving on http://127\.0\.0\.1:(\d+)", l)
                     for l in list(lines)]
            port = next((int(m.group(1)) for m in found if m), None)
            if proc.poll() is not None:
                fail(f"phase 20 server exited {proc.returncode}:\n"
                     f"{''.join(lines)[-4000:]}")
            time.sleep(0.2)
        if port is None:
            fail("phase 20: the server never said where it listens")
        ready_s = time.perf_counter() - t_start
        if _http(port, "GET", "/healthz")[0] != 200:
            fail("phase 20: /healthz not ready after start")
        reqs = shared_prefix_requests(5, vocab=128256, n_prefixes=1,
                                      prefix_len=64, suffix_lens=[8, 16],
                                      max_new=[16], seed=5)
        answers: dict = {}

        def post(r):
            answers[r.id] = _http(port, "POST", "/v1/generate", {
                "prompt_ids": r.prompt_ids.tolist(), "max_new": r.max_new,
                "seed": r.sampling.seed})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(r,))
                   for r in reqs[:4]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        gen_s = time.perf_counter() - t0
        for r in reqs[:4]:
            code, body = answers.get(r.id, (None, {}))
            if code != 200 or len(body.get("tokens", [])) != 16 \
                    or not all(0 <= t < 128256 for t in body["tokens"]):
                fail(f"phase 20: /v1/generate answered {code} {body}")
        code, health = _http(port, "GET", "/healthz")
        if code != 200 or health.get("state") != "ready":
            fail(f"phase 20: /healthz {code} {health}")
        code, body = _http(port, "POST", "/swap", {"checkpoint": a})
        if code != 202:
            fail(f"phase 20: POST /swap answered {code} {body}")
        t0 = time.perf_counter()
        states = []
        while time.perf_counter() - t0 < 300:
            code, health = _http(port, "GET", "/healthz")
            states.append(health.get("state"))
            if code == 200 and _http(port, "GET", "/stats")[1]["swaps"]:
                break
            time.sleep(0.1)
        swap_s = time.perf_counter() - t0
        if "staging_swap" not in states or states[-1] != "ready":
            fail(f"phase 20: /healthz went through {sorted(set(states))}")
        code, body = _http(port, "POST", "/v1/generate", {
            "prompt_ids": reqs[4].prompt_ids.tolist(), "max_new": 16})
        if code != 200 or len(body.get("tokens", [])) != 16:
            fail(f"phase 20: /v1/generate after the swap: {code} {body}")
        stats = _http(port, "GET", "/stats")[1]
        # the server's obs session (no --obs-dir: in memory, so no
        # profiler): Prometheus text of its counters; no window to arm
        code, prom = _http(port, "GET", "/metrics", parse=bytes.decode)
        if code != 200 or "serve_requests_total 5" not in prom.splitlines():
            fail(f"phase 20: GET /metrics answered {code}:\n{prom[:800]}")
        code, body = _http(port, "POST", "/profile")
        if code != 409 or body.get("armed"):
            fail(f"phase 20: POST /profile answered {code} {body}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    summary = json.loads(next(l for l in reversed(lines)
                              if l.startswith("{")))
    out = {"ready_s": ready_s, "generate_4_s": gen_s, "swap_s": swap_s,
           "healthz_states": sorted(set(states)), "stats": stats,
           "exit_code": rc, "summary": summary}
    log(f"http: {json.dumps(out)}")
    if rc != 0:
        fail(f"phase 20: the server exited {rc} on SIGTERM")
    if summary.get("requests_completed") != 5 or summary.get("swaps") != 1 \
            or summary.get("requests_drained") != 0 \
            or summary.get("device") != "cuda":
        fail(f"phase 20: drained summary {summary}")
    for name, n in summary["kernel_launches"].items():
        if n <= 0:
            fail(f"phase 20: the server never launched {name}")
    return out


# -- phases 21-23 (the MoE slice, in a child process) ------------------------

#: phase 21: Mixtral-8x7B's decode rows compared card vs CPU, and its
#: serving traffic (phase 3's: prompt lengths at the prefill buckets, 32
#: greedy tokens each)
MIXTRAL_DEPTH = 32
P21_TRAFFIC = dict(vocab=32000, prompt_lens=[16, 40, 100], max_new=[32],
                   seed=0)
#: phase 21's gate bound: 4 bf16 ulps at 1.0 (the router logits round to
#: bf16 on both sides, in other orders); a token's expert set may differ
#: only where its k-th and (k+1)-th CPU logits lie within 2 bf16 ulps
GATE_TOL = 2 ** -6
#: phase 22: expert pruning at full width, depth cut 32 -> 2 for memory
#: (3.17 B parameters, 12.7 GB in f32); S 512, synthetic LM tokens
P22 = dict(depth=2, seq_len=512, train=8, val=8, test=8, batch=4)
#: phase 22: one full-width MoE layer and its (B, S) batch, where the
#: sparse dispatch at capacity E / top_k is held against dense on the
#: card in f32, relative to max|dense|: the same math, but dense sums
#: each output over all E * F = 114,688 gated terms (zeros included)
#: where sparse sums F = 14,336 terms twice and adds the two (1.08e-5
#: measured on an H100)
P22_DISPATCH = dict(E=8, d=4096, F=14336, B=2, S=512)
SPARSE_TOL = 1e-4


def _moe_inputs(model, params, dev, rows: int = 4):
    """The input of every MoE layer in one ``rows``-row decode step after
    an 8-token prefill (bf16 cache), recorded from the model walk."""
    import torch

    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.generate import _decode_seq, init_cache

    rec = []
    orig = L.apply_layer

    def spy(spec, p, s, x, **kw):
        if isinstance(spec, L.MoE):
            rec.append((spec, p["router"], x))
        return orig(spec, p, s, x, **kw)

    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(0, 32000, (rows, 9), generator=gen).to(dev)
    cache = init_cache(model, rows, 16, torch.bfloat16, device=dev)
    with torch.no_grad():
        _decode_seq(model.layers, params, cache, toks[:, :8], 0)
        L.apply_layer = spy
        try:
            _decode_seq(model.layers, params, cache, toks[:, 8:], 8)
        finally:
            L.apply_layer = orig
    return rec


def moe_gate_check(model, params, dev) -> dict:
    """The routing gates of one decode step on the card against the
    plain ops on the CPU, on the same rows (each MoE layer's recorded
    input) and the same bf16 router."""
    import torch

    from torchpruner_tpu_torch.core import layers as L

    worst, near, logit_err, layers = 0.0, 0, 0.0, 0
    for i, (spec, router, x) in enumerate(_moe_inputs(model, params, dev)):
        with torch.no_grad():
            raw_c, g_c = L.moe_routing(spec, {"router": router}, x, True)
            raw_h, g_h = L.moe_routing(spec, {"router": router.cpu()},
                                       x.cpu(), True)
        raw_c, g_c = raw_c.cpu().float(), g_c.cpu().float()
        raw_h, g_h = raw_h.float(), g_h.float()
        logit_err = max(logit_err, float((raw_c - raw_h).abs().max()))
        same = ((g_c > 0) == (g_h > 0)).all(dim=-1)
        srt = torch.sort(raw_h, dim=-1, descending=True).values
        kth = srt[..., spec.top_k - 1]
        gap = kth - srt[..., spec.top_k]
        tie = gap <= 2 * 2 ** -7 * kth.abs()
        if bool((~same & ~tie).any()):
            fail(f"phase 21 gates: {int((~same & ~tie).sum())} rows of "
                 f"MoE layer {i + 1} chose other experts on the card away "
                 f"from a near-tie")
        near += int((~same).sum())
        if bool(same.any()):
            worst = max(worst, float((g_c - g_h).abs()[same].max()))
        layers += 1
    out = {"layers": layers, "max_abs_gate_err": worst, "tolerance": GATE_TOL,
           "near_tie_rows_differing": near, "max_abs_logit_err": logit_err}
    if layers != MIXTRAL_DEPTH or worst > GATE_TOL:
        fail(f"phase 21 gates: {out}")
    return out


def expert_widening_ms(params, dev) -> float:
    """CUDA-event ms of widening one block's three int4 expert planes to
    bf16 (what the dense dispatch does at every MoE layer of a step)."""
    import torch

    from torchpruner_tpu_torch.ops.quant import wval

    w = params["block1_moe"]["experts"]
    return event_ms(lambda i: [wval(w[k], torch.bfloat16)
                               for k in ("wg", "wu", "wo")], 5)


def mixtral_serve_phase(dev) -> dict:
    """Phase 21: Mixtral-8x7B (``llama_moe()``: published width and
    depth, dense dispatch) at int4 through ``ServeEngine``, every request
    replayed alone; then one decode step traced and the gates of a step
    checked against the CPU's."""
    import torch

    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
        weight_bytes,
    )
    from torchpruner_tpu_torch.experiments.step_trace import trace_step
    from torchpruner_tpu_torch.models import llama_moe
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.serve.engine import ServeEngine
    from torchpruner_tpu_torch.serve.frontend import verify_against_solo
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        synthetic_requests,
    )

    model = llama_moe()
    t0 = time.perf_counter()
    params, _ = quantized_random_params(model, bits=4, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = ServeEngine(model, params, n_slots=4, max_len=512,
                         cache_dtype=torch.bfloat16, device=dev)
    reqs = synthetic_requests(8, **P21_TRAFFIC)
    reset_serve_launches()
    t0 = time.perf_counter()
    summary = engine.run(open_loop(reqs))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"dequant_matmul": FM.dequant_matmul.launches,
                "decode_attention": DA.decode_attention.launches}
    t0 = time.perf_counter()
    mism = verify_against_solo(engine)
    verify_s = time.perf_counter() - t0
    bad = [r.id for r in engine.results()
           if not all(0 <= t < 32000 for t in r.tokens)
           or len(r.tokens) != r.max_new]
    del engine
    gates = moe_gate_check(model, params, dev)
    trace = trace_step(model, params, slots=4, max_len=512, steps=2, reps=3)
    widen = expert_widening_ms(params, dev) * MIXTRAL_DEPTH
    out = {"model": "llama_moe() (Mixtral-8x7B)", "bits": 4,
           "depth": MIXTRAL_DEPTH, "weight_gb": weight_bytes(params) / 1e9,
           "params_build_s": build_s, "serve_s": serve_s,
           "verify_s": verify_s,
           "requests_completed": summary["requests_completed"],
           "decode_steps": summary["decode_steps"],
           "ttft_p50_ms": summary["ttft_p50_ms"],
           "token_p50_ms": summary["token_p50_ms"],
           "token_p99_ms": summary["token_p99_ms"],
           "verify_mismatches": mism, "launches": launches,
           "decode_step": {k: trace[k] for k in (
               "wall_ms", "profiler_kernel_ms", "device_idle_share",
               "profiler_kernels_per_step", "by_group", "top_kernels")},
           "expert_widening_ms_per_step": widen,
           "expert_widening_share_of_step": widen / trace["wall_ms"],
           "gates": gates,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"mixtral serve: {json.dumps(out)}")
    if summary["requests_completed"] != 8:
        fail(f"phase 21 completed {summary['requests_completed']}/8")
    if mism:
        fail(f"phase 21: {mism} requests diverged from solo decode")
    if bad:
        fail(f"phase 21: bad token lists for requests {bad}")
    if launches["dequant_matmul"] <= 0:
        fail("phase 21 never launched the dequant kernel")
    if launches["decode_attention"] != MIXTRAL_DEPTH * summary[
            "decode_steps"]:
        fail(f"phase 21: {launches['decode_attention']} decode attention "
             f"launches for {summary['decode_steps']} steps of "
             f"{MIXTRAL_DEPTH} layers")
    del params
    torch.cuda.empty_cache()
    return out


def _lm_split(n: int, seed: int):
    import numpy as np

    from torchpruner_tpu_torch.data import Dataset

    x = np.random.default_rng(seed).integers(
        0, 32000, size=(n, P22["seq_len"])).astype(np.int32)
    return Dataset(x, x, f"synthetic_lm_32000x{P22['seq_len']}")


def moe_dispatch_check(dev) -> dict:
    """One full-width MoE layer (E 8, d 4096, F 14336) on a batch of
    (2, 512) f32 rows: sparse dispatch at capacity factor E / top_k
    against dense on the card, and the capacity-1.25 dispatch plan (which
    pairs are kept, where) on the card against the CPU's.  The rows lean
    towards expert 0 (a unit step along its router column), so its
    buffer overflows and pairs are dropped."""
    import torch

    from torchpruner_tpu_torch.core import layers as L

    E, d, F, B, S = (P22_DISPATCH[k] for k in "EdFBS")
    dense = L.MoE("experts", E, F)
    gen = torch.Generator(device=dev).manual_seed(3)
    params, _ = L.init_layer(dense, gen, (S, d), device=dev)
    lean = params["router"][:, 0] / params["router"][:, 0].norm()
    x = torch.randn((B, S, d), generator=gen, device=dev) + lean
    nodrop = dataclasses.replace(dense, dispatch="sparse",
                                 capacity_factor=E / dense.top_k)
    with torch.no_grad():
        y_d, _ = L.apply_layer(dense, params, {}, x)
        y_s, _ = L.apply_layer(nodrop, params, {}, x)
        err = float((y_s - y_d).abs().max()) / float(y_d.abs().max())
        del y_d, y_s
        cf = dataclasses.replace(nodrop, capacity_factor=1.25)
        _, r_card = L.moe_routing(cf, params, x.reshape(-1, d))
        _, r_cpu = L.moe_routing(cf, {"router": params["router"].cpu()},
                                 x.reshape(-1, d).cpu())
        plans = {}
        for name, routing in (("card", r_card), ("cpu", r_cpu.to(dev))):
            p = L.moe_dispatch(cf, routing)
            plans[name] = {k: p[k].cpu() for k in
                           ("top_e", "e_s", "t_s", "slot", "keep")}
        cpu_plan = L.moe_dispatch(cf, r_cpu)
    same_sel = torch.equal(plans["card"]["top_e"], cpu_plan["top_e"])
    same_plan = all(torch.equal(plans["cpu"][k], cpu_plan[k].cpu())
                    for k in plans["cpu"])
    out = {"sparse_vs_dense_rel_err": err, "tolerance": SPARSE_TOL,
           "capacity": cpu_plan["C"],
           "pairs_dropped": int((~cpu_plan["keep"]).sum()),
           "card_selection_equals_cpu": same_sel,
           "plan_on_card_equals_cpu": same_plan}
    if same_sel:
        out["card_plan_equals_cpu"] = all(
            torch.equal(plans["card"][k], cpu_plan[k]) for k in
            plans["card"])
    log(f"moe dispatch: {json.dumps(out)}")
    if err > SPARSE_TOL or not same_plan or not out.get(
            "card_plan_equals_cpu", True) or out["pairs_dropped"] <= 0:
        fail(f"phase 22 dispatch: {out}")
    return out


def moe_prune_phase(dev) -> dict:
    """Phase 22: ``run_prune_retrain`` on Mixtral at full width (2
    blocks): f32 Taylor on both blocks' experts, fraction 0.25 (8 -> 6),
    one bf16 SGD fine-tune epoch a target with ``moe_aux_weight`` 0.01.
    Returns the phase's record and the final ``(model, params)``."""
    import torch

    from torchpruner_tpu_torch.core.segment import SegmentedModel
    from torchpruner_tpu_torch.experiments import prune_retrain as PR
    from torchpruner_tpu_torch.models import llama_moe
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.config import ExperimentConfig

    model = llama_moe(depth=P22["depth"], seq_len=P22["seq_len"])
    # Adam would hold params, grads, both moments, their successors and
    # the update at once: ~8 x 11.3 GB after the first prune; SGD: ~4 x
    cfg = ExperimentConfig(
        name="mixtral_expert_taylor", model="llama_moe", dataset="lm_mfu",
        loss="lm_cross_entropy", method="taylor", policy="fraction",
        fraction=0.25, target_filter=("_moe/",), finetune_epochs=1,
        score_examples=P22["val"], batch_size=P22["batch"],
        eval_batch_size=P22["batch"], optimizer="sgd", lr=1e-4,
        compute_dtype="bfloat16", score_dtype="float32",
        moe_aux_weight=0.01, log_path="logs/chip_smoke_moe.csv")
    datasets = tuple(_lm_split(P22[s], seed) for seed, s in
                     enumerate(("train", "val", "test")))
    last, aux = {}, []
    orig_eval, orig_prune = Trainer.evaluate, PR.prune
    orig_apply = SegmentedModel.apply

    def evaluate(self, data):  # keeps the trainer the loop ends with
        last.update(model=self.model, params=self.params)
        return orig_eval(self, data)

    def prune(*a, **kw):  # the old tree must not outlive the prune
        last.clear()
        return orig_prune(*a, **kw)

    def apply(self, *a, **kw):  # the aux losses of every training step
        out = orig_apply(self, *a, **kw)
        if kw.get("collect_aux"):
            aux.append({k: float(v.detach()) for k, v in out[-1].items()})
        return out

    reset_launches()
    Trainer.evaluate, PR.prune, SegmentedModel.apply = evaluate, prune, apply
    try:
        t0 = time.perf_counter()
        hist = PR.run_prune_retrain(cfg, model=model, datasets=datasets,
                                    verbose=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.evaluate, PR.prune = orig_eval, orig_prune
        SegmentedModel.apply = orig_apply
    launches = all_launches()
    out = {"model": "llama_moe(depth=2) (Mixtral-8x7B width)",
           "reduced": {"depth": "32 -> 2"}, "wall_s": wall,
           "records": [{"layer": r.layer, "n_dropped": r.n_dropped,
                        "experts": r.widths[r.layer],
                        "pre_loss": r.pre_loss, "post_loss": r.post_loss,
                        "n_params": r.n_params, "round_s": r.prune_time}
                       for r in hist],
           "aux_losses": aux, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"moe prune: {json.dumps(out)}")
    if [r.layer for r in hist] != ["block2_moe/experts",
                                   "block1_moe/experts"]:
        fail(f"phase 22 records {[r.layer for r in hist]}")
    for r in hist:
        if r.widths[r.layer] != 6 or not all(
                math.isfinite(v) for v in (r.pre_loss, r.post_loss)):
            fail(f"phase 22 {r.layer}: {r.widths[r.layer]} experts, losses "
                 f"{r.pre_loss} / {r.post_loss}")
    # two blocks, one train batch of 4 a step, 2 steps a target
    if len(aux) != 2 * P22["train"] // P22["batch"] or any(
            len(a) != 2 or min(a.values()) < 0.99 for a in aux):
        fail(f"phase 22 aux losses {aux}")
    for n in FLASH_KERNELS:
        if launches[n] <= 0:
            fail(f"phase 22 never launched {n}")
    return out, last["model"], last["params"]


def moe_cli_phase(dev, model, params, tmp: str) -> dict:
    """Phase 23: phase 22's pruned model cast to bf16 and quantized to
    int4, saved with ``save_checkpoint``, then served through the CLI
    with ``--checkpoint`` and ``--verify``."""
    import torch

    from torchpruner_tpu_torch.checkpoint import save_checkpoint
    from torchpruner_tpu_torch.ops.quant import quantize_params
    from torchpruner_tpu_torch.utils.tree import cast_floats

    q = quantize_params(model, cast_floats(params, torch.bfloat16), bits=4)
    del params
    wo = q["block1_moe"]["experts"]["wo"]
    path = os.path.join(tmp, "mixtral_pruned")
    t0 = time.perf_counter()
    save_checkpoint(path, model, q, step=1, prune_history=[
        {"layer": f"block{i}_moe/experts", "fraction": 0.25}
        for i in (2, 1)])
    save_s = time.perf_counter() - t0
    del q
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torchpruner_tpu_torch", "serve",
           "llama3_ffn_taylor", "--checkpoint", path, "--synthetic", "8",
           "--shared-prefixes", "2", "--prefix-len", "64", "--prompt-lens",
           "8,24", "--verify"] + CLI_V2
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"phase 23 CLI exited {res.returncode}:\n{res.stdout}\n"
             f"{res.stderr[-4000:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    out = {"bytes": _dir_bytes(path), "save_s": save_s, "cli_s": cli_s,
           "experts": model.layer("block1_moe/experts").n_experts,
           "wo_pack_axis": wo.pack_axis, "summary": summary}
    log(f"moe cli: {json.dumps(out)}")
    if summary.get("device") != "cuda" \
            or summary.get("requests_completed") != 8 \
            or summary.get("verify_mismatches") != 0:
        fail(f"phase 23 CLI summary: {summary}")
    for name, n in summary["kernel_launches"].items():
        if n <= 0:
            fail(f"phase 23: the CLI never launched {name}")
    return out


def moe_slice(dev) -> dict:
    """Phases 21-23 (run in a child process: a fresh profiler session
    for phase 21's trace, and the card's memory to itself)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    log("phase 21: serve Mixtral-8x7B int4, full width and depth")
    s21 = mixtral_serve_phase(dev)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 22: expert pruning, Mixtral full width, 2 blocks")
    s22, model, params = moe_prune_phase(dev)
    s22["dispatch"] = moe_dispatch_check(dev)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        log("phase 23: the pruned model int4, serve --checkpoint --verify")
        s23 = moe_cli_phase(dev, model, params, tmp)
    del model, params
    torch.cuda.empty_cache()
    log(f"phase 23: {time.perf_counter() - t0:.1f} s")
    return {"serve": s21, "prune": s22, "cli": s23}


def run_moe_child() -> dict:
    """Phases 21-23 in a child process; its result is its last stdout
    line."""
    import torch

    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--moe-slice"], cwd=HERE, capture_output=True,
                         text=True, timeout=900)
    for line in res.stdout.strip().splitlines()[:-1]:
        log(f"  {line}")
    if res.returncode != 0:
        fail(f"phases 21-23 exited {res.returncode}:\n{res.stdout[-4000:]}"
             f"\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])

# -- phases 24-26 -----------------------------------------------------------

#: phase 24: mfu_llama's training set-up (phase 9's), 3 steps each way
P24 = dict(batch=8, steps=3, accum=4, lr=1e-4)
#: phase 24's bound between two ways of computing the same 3 bf16 steps:
#: losses to 2**-7 relative, params to 2**-7 x the largest move a param
#: made from its start (one bf16 ulp at the scale of the update)
P24_TOL = 2 ** -7
#: phase 25: phase 11's first steps at accum_steps 2
P25 = dict(steps=5, accum=2)
#: phase 26: cached against uncached sweep curves and AUCs, relative
P26_TOL = 1e-5


def _profiled_step_idle(fn) -> dict:
    """Wall, profiler kernel time and the device's idle share of one call
    of ``fn`` (a training step); the idle share is not measured when the
    profiler sees no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchpruner_tpu_torch.experiments.step_trace import _device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_ms = sum(_device_us(e) for e in prof.key_averages()
                    if _device_us(e) > 0 and e.device_type is not None
                    and "CUDA" in str(e.device_type)) / 1e3
    return {"profiled_wall_ms": wall, "kernel_ms": kernel_ms,
            "device_idle_share": (max(0.0, 1.0 - kernel_ms / wall)
                                  if kernel_ms > 0 else None)}


def remat_phase(dev) -> dict:
    """mfu_llama at full width, 3 bf16 Adam steps each way: remat off,
    remat on, remat on with 4 microbatches, then ``multi_step`` (K 3)
    against the sequential steps of the first way.  Run in a child
    process: a fresh profiler session for the idle shares."""
    import torch

    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.models import mfu_llama
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss
    from torchpruner_tpu_torch.utils.tree import tree_leaves

    model = mfu_llama()
    n_attn = sum(isinstance(l, L.Residual) and any(
        isinstance(c, L.MultiHeadAttention) for c in l.body)
        for l in model.layers)
    B, K = P24["batch"], P24["steps"]
    batches = load_dataset("lm_mfu", "train", n=B * K, seed=0).batches(B)
    params, state = init_model(model, 0, device=dev)

    def trainer(remat, accum):
        return Trainer.create(model, optim.adam(P24["lr"]),
                              lm_cross_entropy_loss, seed=0, params=params,
                              state=state, compute_dtype=torch.bfloat16,
                              device=dev, remat=remat, accum_steps=accum)

    ways = {}
    for name, remat, accum in (("plain", False, 1), ("remat", True, 1),
                               ("remat_accum", True, P24["accum"])):
        t = trainer(remat, accum)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        losses, walls = [], []
        for i, (x, y) in enumerate(batches):
            if i == K - 1:  # the last step under the profiler
                prof = _profiled_step_idle(
                    lambda: losses.append(float(t.step(x, y))))
                continue
            t0 = time.perf_counter()
            losses.append(float(t.step(x, y)))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ways[name] = {
            "remat": remat, "accum_steps": accum, "losses": losses,
            "first_step_ms": walls[0], "step_ms": walls[-1], **prof,
            # the steps' working set: the peak above what was allocated
            # before them (this way's params and optimizer state, and the
            # earlier ways' trainers kept for the comparisons)
            "step_peak_mem_gb": (torch.cuda.max_memory_allocated()
                                 - held) / 1e9,
            "held_mem_gb": held / 1e9,
            "launches": flash_launches(), "trainer": t}
    # multi_step from the same start, against the plain way's 3 steps
    t = trainer(False, 1)
    xs = torch.stack([torch.from_numpy(x) for x, _ in batches])
    ys = torch.stack([torch.from_numpy(y) for _, y in batches])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi = t.multi_step(xs, ys).tolist()
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    seq = ways["plain"]["trainer"]
    multi_equal = multi == ways["plain"]["losses"] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(t.params),
                                           tree_leaves(seq.params)))

    moved = max(float((p1 - p0).abs().max()) for p1, p0 in zip(
        tree_leaves(ways["plain"]["trainer"].params), tree_leaves(params)))

    def apart(a, b) -> dict:
        """Loss and param distances of two ways' 3 steps, with the
        bounds: losses to 2**-7 relative, params to 2**-7 x the largest
        move the plain way made from the start."""
        la, lb = ways[a]["losses"], ways[b]["losses"]
        d = [(p1 - p2).abs() for p1, p2 in zip(
            tree_leaves(ways[a]["trainer"].params),
            tree_leaves(ways[b]["trainer"].params))]
        return {"loss_max_rel_diff": max(abs(u - v) / abs(v)
                                         for u, v in zip(la, lb)),
                "params_max_abs_diff": max(float(t.max()) for t in d),
                "params_l2_diff": math.sqrt(sum(float(t.square().sum())
                                                for t in d)),
                "loss_tol": P24_TOL, "params_tol": P24_TOL * moved}

    remat = apart("remat", "plain")
    # accumulation against the full batch: the 3 steps' losses to 2**-7,
    # and one gradient from the start, summed over the 4 microbatches,
    # against the full batch's, each leaf to 2**-7 of its largest entry.
    # Param distances after 3 steps are recorded, not bounded: each
    # microbatch's bf16 gradient rounds on its own, and Adam turns any
    # difference in a near-zero gradient into a step of up to lr (0.88 x
    # the largest move on a CPU rehearsal of this phase).
    accum = apart("remat_accum", "remat")
    g_full = trainer(True, 1).loss_and_grads(*batches[0])[1]
    g_acc = trainer(True, P24["accum"]).loss_and_grads(*batches[0])[1]
    accum["grad_max_rel_diff"] = max(
        float((a - b).abs().max() / b.abs().max())
        for a, b in zip(tree_leaves(g_acc), tree_leaves(g_full)))
    accum["grad_tol"] = P24_TOL
    del accum["params_tol"], g_full, g_acc
    for w in ways.values():
        del w["trainer"]
    out = {"card": smi_line(), "model": "mfu_llama", "batch": B,
           "seq": 1024, "attention_blocks": n_attn, "ways": ways,
           "checks": {"remat_vs_plain": remat,
                      "accum_vs_full_batch": accum},
           "multi_step": {"losses": multi, "bit_equal": multi_equal,
                          "wall_s": multi_s}}
    log(f"remat: {json.dumps(out)}")
    bad = [f"{n} losses {w['losses']}" for n, w in ways.items()
           if not all(math.isfinite(v) for v in w["losses"])]
    if not (remat["loss_max_rel_diff"] <= P24_TOL
            and remat["params_max_abs_diff"] <= remat["params_tol"]):
        bad.append(f"remat against plain {remat}")
    if not (accum["loss_max_rel_diff"] <= P24_TOL
            and accum["grad_max_rel_diff"] <= P24_TOL):
        bad.append(f"accumulation against the full batch {accum}")
    if not multi_equal:
        bad.append(f"multi_step losses {multi} are not the sequential "
                   f"steps' {ways['plain']['losses']} bit for bit")
    want = {"plain": n_attn * K, "remat": 2 * n_attn * K,
            "remat_accum": 2 * n_attn * K * P24["accum"]}
    for name, n in want.items():
        got = ways[name]["launches"]
        if got["flash_fwd"] != n or got["flash_dq"] != n // (
                1 if name == "plain" else 2):
            bad.append(f"{name}: flash launches {got}, expected {n} "
                       f"forward ({n_attn} attention blocks x {K} steps"
                       f"{' x 2 (recomputed)' if name != 'plain' else ''}"
                       f"{' x 4 microbatches' if name == 'remat_accum' else ''}"
                       f")")
    if not (ways["remat"]["step_peak_mem_gb"]
            < ways["plain"]["step_peak_mem_gb"]):
        bad.append("the steps' peak memory with remat is not below the "
                   "peak without")
    if bad:
        fail("remat phase: " + "; ".join(bad))
    return out


def run_remat_child() -> dict:
    """Phase 24 in a child process; its result is its last stdout line."""
    import torch

    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--remat-phase"], cwd=HERE, capture_output=True,
                         text=True, timeout=600)
    for line in res.stdout.strip().splitlines()[:-1]:
        log(f"  {line}")
    if res.returncode != 0:
        fail(f"phase 24 exited {res.returncode}:\n{res.stdout[-4000:]}"
             f"\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def accum_masked_phase(dev, p11: dict) -> dict:
    """Phase 11's masked recipe for 5 steps at accum_steps 2 against the
    same 5 steps at accum_steps 1, from phase 11's masked start, both at
    dropout 0 (BERT-base's dropout would draw other masks for two
    microbatches than for their batch): twice phase 11's launches a
    step, masked entries exactly 0, losses within phase 11's bound."""
    import torch

    from torchpruner_tpu_torch.core import masking
    from torchpruner_tpu_torch.models.bert import bert
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss
    from torchpruner_tpu_torch.utils.tree import tree_map

    model = bert(dropout=0.0)  # bert_base's widths and depth
    drops, n = p11["drops"], P25["steps"]
    start = tree_map(lambda t: t.to(dev), p11["start"])
    masks, _ = masking.drop_masks(model, start, drops, state=p11["state"])

    def run(accum):
        trainer = Trainer.create(
            model, optim.chain(optim.adam(1e-4),
                               masking.masked_update(masks)),
            cross_entropy_loss, seed=0, params=start, state=p11["state"],
            compute_dtype=torch.bfloat16, device=dev,
            param_transform=masking.blocksparse_transform(model, drops),
            accum_steps=accum)
        reset_launches()
        with _timed_steps() as steps:
            for x, y in p11["batches"][:n]:
                trainer.step(x, y)
        return trainer, steps, bs_launches()

    full, f_steps, f_launch = run(1)
    trainer, steps, launches = run(P25["accum"])
    got = [l for l, _ in steps]
    ref = [l for l, _ in f_steps]
    tol = 2 ** -5 * max(abs(l) for l in ref)
    out = {"card": smi_line(), "model": "bert_base, dropout 0",
           "batch": 32,
           "accum_steps": P25["accum"],
           **_step_stats(steps, "accumulated masked retrain"),
           "full_batch": _step_stats(f_steps, "masked retrain, dropout 0"),
           "launches": launches, "launches_full_batch": f_launch,
           "losses": got, "full_batch_losses": ref,
           "phase11_losses": p11["losses"][:n], "loss_tol": tol,
           "loss_max_abs_diff": max(abs(a - b) for a, b in zip(got, ref))}
    log(f"accumulated masked retrain: {json.dumps(out)}")
    want = {k: 2 * 24 * n for k in BS_KERNELS}
    if launches != want or f_launch != {k: 24 * n for k in BS_KERNELS}:
        fail(f"accumulated masked retrain: launches {launches} (full batch "
             f"{f_launch}), expected {want} (2 microbatches x 24 a step)")
    if not out["loss_max_abs_diff"] <= tol:
        fail(f"accumulated masked retrain: losses {got} differ from the "
             f"full batch's {ref} by more than {tol}")
    for target, drop in drops.items():
        mlp = trainer.params[target.split("/")[0]]
        idx = torch.as_tensor(drop, device=dev)
        if not (bool((mlp["fc1"]["w"][:, idx] == 0).all())
                and bool((mlp["fc1"]["b"][idx] == 0).all())
                and bool((mlp["fc2"]["w"][idx] == 0).all())):
            fail(f"accumulated masked retrain: a masked entry of {target} "
                 f"moved off 0")
    del trainer, full, start, masks
    torch.cuda.empty_cache()
    return out


def cached_sweep_phase(dev, p16: dict) -> dict:
    """Phase 16's three-layer panel on its trained VGG16-bn with the
    capture engine on, then off; phase 14's ``fc1`` Shapley rows (one
    batch, initial weights) with and without the cache.  cuDNN runs
    deterministic algorithms, chosen without benchmarking, for the whole
    phase, so each convolution takes the same algorithm in both runs."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.attributions.base import ActivationCache
    from torchpruner_tpu_torch.attributions.shapley import (
        ShapleyAttributionMetric,
    )
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.experiments import robustness as R
    from torchpruner_tpu_torch.experiments.presets import (
        MODEL_REGISTRY,
        get_preset,
    )
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    made = []

    class Recorded(ActivationCache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    orig_cache = R.ActivationCache
    R.ActivationCache = Recorded
    try:
        walls, res = {}, {}
        for capture in (True, False):
            methods = R.method_panel(
                p16["model"], p16["params"], p16["batches"], p16["loss_fn"],
                state=p16["state"], compute_dtype=p16["sdtype"],
                seed=p16["seed"], **p16["method_kwargs"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[capture] = R.layerwise_robustness(
                p16["model"], p16["params"], p16["state"], p16["batches"],
                methods, p16["loss_fn"], layers=VGG_LAYERS,
                compute_dtype=p16["sdtype"], capture=capture,
                verbose=False)
            torch.cuda.synchronize()
            walls[capture] = time.perf_counter() - t0
        # phase 14's fc1 rows (site act1), one batch, with and without
        cfg = get_preset("mnist_mlp_shapley")
        model = MODEL_REGISTRY[cfg.model][0]()
        params, _ = init_model(model, seed=cfg.seed, device=dev)
        batch = [load_dataset(cfg.dataset, "val", n=cfg.score_examples,
                              seed=cfg.seed).batches(cfg.eval_batch_size)[0]]
        cache = Recorded(model, params, batch, sites=("act1",))
        rows, row_s = {}, {}
        for cached in (True, False):
            m = ShapleyAttributionMetric(model, params, batch,
                                         cross_entropy_loss, seed=cfg.seed,
                                         reduction="none",
                                         **cfg.method_kwargs)
            m.capture_cache = cache if cached else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows[cached] = m.run("fc1", find_best_evaluation_layer=True)
            row_s[cached] = time.perf_counter() - t0
        with torch.no_grad():
            x, y = (torch.as_tensor(a, device=dev) for a in batch[0])
            base = float(cross_entropy_loss(model.apply(params, x)[0],
                                            y).mean())
    finally:
        R.ActivationCache = orig_cache
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    sweep_cache, row_cache = made[0], made[-1]
    curve_err = 0.0
    for layer in VGG_LAYERS:
        for m, runs in res[False][layer].items():
            for a, b in zip(res[True][layer][m], runs):
                for k in ("loss", "acc"):
                    den = np.maximum(np.abs(b[k]), 1e-30)
                    curve_err = max(curve_err, float(
                        (np.abs(np.asarray(a[k]) - b[k]) / den).max()))
                curve_err = max(curve_err, abs(a["auc"] - b["auc"])
                                / max(abs(b["auc"]), 1e-30))
    row_err = float(np.abs(rows[True] - rows[False]).max())
    out = {"card": smi_line(),
           "sweep_s": {"capture": walls[True], "uncached": walls[False]},
           "sweep_cache": sweep_cache.stats(),
           "curves_max_rel_diff": curve_err, "curves_tol": P26_TOL,
           "mlp_fc1_rows": {"rows": list(rows[True].shape),
                            "max_abs_diff": row_err, "atol": 1e-5 * base,
                            "cached_s": row_s[True],
                            "uncached_s": row_s[False],
                            "cache": row_cache.stats()},
           "cudnn": {"deterministic": True, "benchmark": False}}
    log(f"cached sweep: {json.dumps(out)}")
    if not curve_err <= P26_TOL:
        fail(f"cached sweep: curves or AUCs differ from the uncached "
             f"sweep's by {curve_err} relative > {P26_TOL}")
    if not (sweep_cache.hits > 0 and sweep_cache.prefix_flops_saved > 0):
        fail(f"cached sweep: the cache served nothing: "
             f"{sweep_cache.stats()}")
    if not (row_err <= 1e-5 * base and row_cache.hits > 0
            and row_cache.prefix_flops_saved > 0):
        fail(f"cached sweep: fc1 Shapley rows {out['mlp_fc1_rows']}")
    return out


# -- phases 27-28 (the telemetry plane) -------------------------------------

#: phase 27: a capture window every 4 decode steps, 3 steps each; 3
#: windows in all: 2 on the cadence and 1 armed on demand after the first
OBS_PROFILE_EVERY, OBS_PROFILE_STEPS, OBS_WINDOWS = 4, 3, 3
#: phase 27 serves the first 4 of phase 3's 8 requests (the script's
#: time limit); their decode outlasts the three windows
OBS_REQUESTS = 4
#: the request-trace stages every served request must pass, in order
OBS_STAGES = ("admission", "prefill", "first_token", "decode", "complete")
#: phase 28's fine-tune: phase 8's target, and a 2-step capture window
#: every 150 of its 313 steps
OBS_RETRAIN_TARGET = "block12_mlp/"
OBS_RETRAIN_EVERY = 150


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _prom_values(path: str) -> dict:
    """``name -> value`` of a Prometheus textfile's samples."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def _span_tree(events: list) -> list:
    """``(name, parent name, target)`` of every span, in order."""
    names, out = {}, []
    for e in events:
        if e.get("event") == "span_begin":
            names[e["span"]] = e["name"]
            out.append((e["name"], names.get(e.get("parent")),
                        e.get("target")))
    return out


class _ArmAfterFirstWindow:
    """Phase 27's traffic: phase 3's open loop, plus one on-demand capture
    window armed (the call ``POST /profile`` makes) at the first loop
    boundary after the first cadence window closed."""

    def __init__(self, inner, profiler):
        self.inner, self.profiler, self.armed = inner, profiler, False

    @property
    def exhausted(self):
        return self.inner.exhausted

    def drain(self):
        return self.inner.drain()

    def pump(self, engine):
        from torchpruner_tpu_torch import obs

        n = self.inner.pump(engine)
        if not self.armed and self.profiler.windows:
            self.armed = obs.request_profile_window()
        return n


def _window_launches(phase: int, w: dict, t: dict) -> None:
    """A window's launches, exactly: the port's wrappers counted
    ``w["launches"]`` inside it (by group of ``ops.launches``); its
    in-memory kernel events, its exported trace's table ``t`` and its
    missing count must all agree."""
    from torchpruner_tpu_torch.ops.launches import GROUPS

    table = {g: sum(t["launches"].get(b, 0) for b in bodies)
             for g, (_, bodies) in GROUPS.items()}
    table = {g: n for g, n in table.items() if n}
    if w.get("missing_kernel_events") != 0 \
            or w["kernel_events"] != w.get("launches") \
            or table != w.get("launches"):
        fail(f"phase {phase}: window {w['index']}: the wrappers launched "
             f"{w.get('launches')}, the window holds "
             f"{w['kernel_events']} kernel events ({table} in its "
             f"trace), missing {w.get('missing_kernel_events')}")


def _window_rows(w: dict, phase: int = 27) -> dict:
    """One capture window's kernel table, by base kernel name."""
    from torchpruner_tpu_torch.obs.profile.kernels import (
        kernel_table,
        merge_ops,
        summarize_window,
    )

    s = summarize_window(w["dir"])
    if s is None:
        fail(f"phase {phase}: window {w['index']} holds no parseable "
             f"trace")
    merged = merge_ops([s])
    rows = kernel_table(merged, steps=max(1, w["steps"]), top=400)
    return {"rows": {r["kernel"]: r for r in rows},
            "launches": {k: v["count"] for k, v in merged.items()},
            "op_ms": s["total_ms"]}


def obs_serve_phase(dev, s3: dict, smi: str) -> dict:
    """Phase 27: phase 3's model and traffic through ``ServeEngine``
    inside ``obs.configure(dir, profile_every=4, profile_steps=3)``,
    with one window armed on demand; the same serve with no session and
    with a session that opens no window."""
    import tempfile

    import torch

    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
    )
    from torchpruner_tpu_torch.experiments.step_trace import trace_step
    from torchpruner_tpu_torch.models import llama3_8b
    from torchpruner_tpu_torch.obs import reqtrace
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.serve.engine import ServeEngine
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        synthetic_requests,
    )

    model = llama3_8b(depth=DEPTH)
    params, _ = quantized_random_params(model, bits=4, seed=0, device=dev)

    def serve(wrap=None):
        engine = ServeEngine(model, params, n_slots=4, max_len=512,
                             cache_dtype=torch.bfloat16, device=dev)
        reqs = synthetic_requests(8, vocab=128256, prompt_lens=[16, 40, 100],
                                  max_new=[16, 24, 32], seed=0)
        reqs = reqs[:OBS_REQUESTS]
        for r in reqs:  # traced, as a fleet router mints them
            r.trace_id = reqtrace.mint_trace_id(f"r{r.id}")
        traffic = open_loop(reqs)
        if wrap is not None:
            traffic = wrap(traffic)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = engine.run(traffic)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = sorted(engine.results(), key=lambda r: r.id)
        return summary, wall, [list(r.tokens) for r in done], reqs

    obs.shutdown()
    _, wall_off, tok_off, _ = serve()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs27_") as tmp:
        obs.configure(os.path.join(tmp, "plain"))
        summary_plain, wall_plain, tok_plain, _ = serve()
        obs.shutdown()
        d = os.path.join(tmp, "windows")
        reqtrace.reset(sample_every=1)  # every request's stages
        session = obs.configure(d, profile_every=OBS_PROFILE_EVERY,
                                profile_steps=OBS_PROFILE_STEPS)
        prof = session.profiler
        prof.max_windows = OBS_WINDOWS
        summary, wall_on, tok_on, reqs = serve(
            lambda t: _ArmAfterFirstWindow(t, prof))
        obs.shutdown()
        reqtrace.reset()
        # the reference: trace_step's own profiler session of one decode
        # step of the same model, in this process; the kernels' wrappers
        # count its launches (2 warm-up, 3 timed and 3 profiled steps)
        reset_serve_launches()
        ts = trace_step(model, params, slots=4, max_len=512, steps=3,
                        reps=3)
        torch.cuda.synchronize()
        wrapper = {"decode_split": DA.decode_attention.launches / 8,
                   "dq_mma": FM.dequant_matmul.launches / 8}
        events = _read_jsonl(os.path.join(d, "events.jsonl"))
        prom = _prom_values(os.path.join(d, "metrics.prom"))
        with open(os.path.join(d, "profile.json")) as f:
            profile = json.load(f)
        with open(os.path.join(d, "trace.json")) as f:
            trace_cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
        windows = [dict(w) for w in prof.windows]
        tables = [_window_rows(w) for w in windows]
    del params
    torch.cuda.empty_cache()

    for name, toks in (("no session", tok_off), ("no windows", tok_plain),
                       ("windows", tok_on)):
        # every request's tokens are its solo decode's (the serving
        # contract), so the first requests alone give phase 3's tokens
        if toks != s3["tokens"][:OBS_REQUESTS]:
            fail(f"phase 27: the tokens served with {name} differ from "
                 f"phase 3's")
    # windows: 3 in this one process, 2 cadence + 1 on demand, each with
    # device kernel events
    if len(windows) != OBS_WINDOWS or prof.failed \
            or sorted(w["on_demand"] for w in windows) != [False, False,
                                                            True]:
        fail(f"phase 27: windows {[(w['index'], w['on_demand']) for w in windows]}"
             f" (failed {prof.failed})")
    if any(w["device_events"] <= 0 for w in windows) \
            or prom.get("profile_empty_windows_total") != 0 \
            or prom.get("profile_missing_kernel_events_total") != 0:
        fail(f"phase 27: device events per window "
             f"{[w['device_events'] for w in windows]}, empty windows "
             f"{prom.get('profile_empty_windows_total')}, missing kernel "
             f"events {prom.get('profile_missing_kernel_events_total')}")
    # prefills that ran inside each window (their dequant launches count)
    bounds, prefills = {}, {}
    for e in events:
        if e.get("event") in ("profile_window_begin", "profile_window_end"):
            bounds.setdefault(e["window"], []).append(e["ts"])
    for e in events:
        if e.get("event") == "span_begin" and e["name"] == "serve_prefill":
            for i, (t0, t1) in bounds.items():
                if t0 <= e["ts"] <= t1:
                    prefills[i] = prefills.get(i, 0) + 1
    ref = {"decode_split": ts["by_group"]["decode_attention"],
           "dq_mma": ts["by_group"]["dequant_matmul"]}
    if wrapper["decode_split"] != DEPTH \
            or wrapper["dq_mma"] != int(wrapper["dq_mma"]):
        fail(f"phase 27: trace_step's step launched {wrapper} (wrapper "
             f"counts a step)")
    # trace_step's own profiler session saw every launch of its steps
    for k in ("decode_split", "dq_mma"):
        if ref[k]["kernels_per_step"] != wrapper[k]:
            fail(f"phase 27: trace_step's profiler saw "
                 f"{ref[k]['kernels_per_step']} {k} kernels a step, the "
                 f"wrappers launched {wrapper[k]}")
    per_window = []
    for w, t in zip(windows, tables):
        rows, steps = t["rows"], w["steps"]
        n_pre = prefills.get(w["index"], 0)
        rec = {"index": w["index"], "on_demand": w["on_demand"],
               "steps": steps, "prefills": n_pre,
               "device_events": w["device_events"],
               # where a window's cost goes: its start, stop and export
               # on the engine thread, and its steps' own walls
               "capture_s": w.get("capture_s"),
               "step_ms": [round(x * 1e3, 3) for x in w["step_times"]],
               "op_ms_per_step": t["op_ms"] / max(1, steps),
               "coverage": t["op_ms"] / (w["step_seconds"] * 1e3)
               if w["step_seconds"] else None}
        rec["idle_share"] = (1.0 - rec["coverage"]
                             if rec["coverage"] is not None else None)
        for k in ("decode_split", "dq_mma"):
            if k not in rows:
                fail(f"phase 27: window {w['index']} names no {k} "
                     f"(kernels {sorted(rows)[:12]})")
            rec[k] = {"ms_per_step": rows[k]["ms_per_step"],
                      "launches": t["launches"][k],
                      "trace_step_ms": ref[k]["ms_per_step"],
                      "ratio": rows[k]["ms_per_step"]
                      / ref[k]["ms_per_step"]}
        # decode attention runs once a layer a decode step; a prefill runs
        # every projection once, as a decode step does (the wrappers'
        # count of trace_step's step is the reference)
        for k, want in (("decode_split", DEPTH * steps),
                        ("dq_mma", wrapper["dq_mma"] * (steps + n_pre))):
            rec[k]["expected"] = want
            if rec[k]["launches"] != want:
                fail(f"phase 27: window {w['index']}: {k} "
                     f"{rec[k]['launches']} launches in the table, the "
                     f"wrappers {want:g} for {steps} steps and {n_pre} "
                     f"prefills")
        # the program's own account: the wrappers' launches inside the
        # window against the window's kernel events, and the trace's
        _window_launches(27, w, t)
        per_window.append(rec)
    clean = [r for r in per_window if r["prefills"] == 0]
    if not clean:
        fail("phase 27: every window held a prefill; no decode-only "
             "window to compare with trace_step")
    for r in clean:
        for k in ("decode_split", "dq_mma"):
            if not 0.75 <= r[k]["ratio"] <= 1.33:
                fail(f"phase 27: window {r['index']}: {k} "
                     f"{r[k]['ms_per_step']:.4f} ms a step against "
                     f"trace_step's {r[k]['trace_step_ms']:.4f}")
    # counters against the engine's own summary
    want = {"serve_requests_total": len(reqs),
            "serve_completed_total": summary["requests_completed"],
            "serve_prefill_tokens_total": summary["prefilled_tokens"],
            "serve_decode_steps_total": summary["decode_steps"]}
    got = {k: prom.get(k) for k in want}
    if got != {k: float(v) for k, v in want.items()}:
        fail(f"phase 27: metrics.prom {got} against summary {want}")
    # spans and request traces
    prefill_reqs = {e.get("request") for e in events
                    if e.get("event") == "span_begin"
                    and e["name"] in ("serve_prefill", "serve_prefill_chunk")}
    if prefill_reqs != {r.id for r in reqs}:
        fail(f"phase 27: prefill spans for requests {sorted(prefill_reqs)}")
    stages = {}
    for e in events:
        if e.get("event") == "req_stage":
            stages.setdefault(e["trace"], []).append(e["stage"])
    for r in reqs:
        seq = [s for s in stages.get(r.trace_id, []) if s in OBS_STAGES]
        if tuple(seq) != OBS_STAGES:
            fail(f"phase 27: request {r.id} stages "
                 f"{stages.get(r.trace_id)}")
    if not {"obs", "device_op"} <= trace_cats:
        fail(f"phase 27: trace.json event categories {sorted(trace_cats)}")
    names = {k["kernel"] for k in profile["kernels"]}
    out = {
        "card": smi, "windows": per_window,
        "profile_coverage": profile["coverage"],
        "profile_idle_share": (1.0 - profile["coverage"]
                               if profile["coverage"] is not None
                               else None),
        "trace_step": {"wall_ms": ts["wall_ms"],
                       "kernel_ms": ts["profiler_kernel_ms"],
                       "idle_share": ts["device_idle_share"],
                       "decode_split": ref["decode_split"],
                       "dq_mma": ref["dq_mma"],
                       "wrapper_launches_a_step": wrapper},
        "kernels_named": sorted(names)[:40],
        "top_kernels": [(k["kernel"], k["ms_per_step"],
                         k["launches_per_step"])
                        for k in profile["kernels"][:10]],
        "wall_s": {"no_session": wall_off, "session_no_windows": wall_plain,
                   "session_with_windows": wall_on},
        "decode_steps": summary["decode_steps"],
        "token_p50_ms": {"session_no_windows":
                         summary_plain.get("token_p50_ms"),
                         "session_with_windows":
                         summary.get("token_p50_ms")},
        "counters": got,
    }
    log(f"obs serve: {json.dumps(out)}")
    log(f"obs serve ({smi}): serve wall {wall_off:.3f} s with no session, "
        f"{wall_plain:.3f} s with a session and no window, {wall_on:.3f} s "
        f"with 3 windows; coverage {profile['coverage']} (idle "
        f"{out['profile_idle_share']}), trace_step idle "
        f"{ts['device_idle_share']:.3f}")
    return out


def _recorded_prunes():
    """Record ``(target, dropped indices)`` of every prune the port's
    prune loop makes while the context is open."""
    import contextlib

    from torchpruner_tpu_torch.experiments import prune_retrain as PPR

    drops = []
    orig = PPR.prune

    def prune(model, params, layer, drop, **kw):
        drops.append((str(layer), sorted(int(d) for d in drop)))
        return orig(model, params, layer, drop, **kw)

    @contextlib.contextmanager
    def ctx():
        PPR.prune = prune
        try:
            yield drops
        finally:
            PPR.prune = orig

    return ctx()


def obs_prune_phase(dev, pr: dict, pr_drops: list, rt: dict,
                    smi: str) -> dict:
    """Phase 28: phase 7's preset on its first 2 targets with
    ``--obs-dir``; one Sensitivity scoring pass inside an on-demand
    capture window; phase 8's bf16 fine-tune with ``obs_grad_norm`` and
    ``--profile-every``."""
    import dataclasses
    import tempfile

    import torch

    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments import prune_retrain as PPR
    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.ops import flash_attention as FA

    os.makedirs("logs", exist_ok=True)
    base = get_preset("bert_glue_sensitivity")
    first = pr["layers"][:2]
    cfg = dataclasses.replace(base, target_filter=tuple(first),
                              log_path="logs/chip_smoke_obs_prune.csv")
    path = os.path.join("logs", "chip_smoke_obs_prune.json")
    cfg.to_json(path)
    retrain_cfg = dataclasses.replace(
        base, finetune_epochs=1, target_filter=(OBS_RETRAIN_TARGET,),
        obs_grad_norm=True, log_path="logs/chip_smoke_obs_retrain.csv")
    retrain_path = os.path.join("logs", "chip_smoke_obs_retrain.json")
    retrain_cfg.to_json(retrain_path)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs28_") as tmp:
        d1 = os.path.join(tmp, "prune")
        n_before = len(_csv_rows(cfg.log_path))
        t0 = time.perf_counter()
        with _recorded_prunes() as drops:
            _cli(["--config", path, "--obs-dir", d1])
        prune_wall = time.perf_counter() - t0
        rows = _csv_rows(cfg.log_path)[n_before:]
        events = _read_jsonl(os.path.join(d1, "events.jsonl"))
        ledger = _read_jsonl(os.path.join(d1, "ledger.jsonl"))
        report = _cli(["obs", "report", d1])
        # a scoring pass of the first target inside an on-demand window
        model, (_train, val, _test) = PPR.resolve_model_and_data(cfg)
        params, state = init_model(model, cfg.seed, device=dev)
        metric = PPR.build_metric(
            cfg.method, model, params, val.batches(cfg.eval_batch_size),
            PPR.LOSS_REGISTRY[cfg.loss], state=state,
            reduction=cfg.reduction, seed=cfg.seed,
            compute_dtype=PPR.compute_dtype(cfg.score_dtype))
        d2 = os.path.join(tmp, "score")
        session = obs.configure(d2)
        if not obs.request_profile_window():
            fail("phase 28: the scoring window was not armed")
        fwd0 = FA.flash_fwd.launches
        obs.profile_tick()  # a loop boundary: the armed window opens
        t0 = time.perf_counter()
        metric.run(first[0])
        score_s = time.perf_counter() - t0
        obs.shutdown()  # closes the window on this thread
        score_fwd = FA.flash_fwd.launches - fwd0
        score_windows = [dict(w) for w in session.profiler.windows]
        score_tables = [_window_rows(w, 28) for w in score_windows]
        score_prom = _prom_values(os.path.join(d2, "metrics.prom"))
        with open(os.path.join(d2, "profile.json")) as f:
            score_profile = json.load(f)
        del model, params, state, metric
        torch.cuda.empty_cache()
        # phase 8's fine-tune with the gradient norm and capture windows
        d3 = os.path.join(tmp, "retrain")
        t0 = time.perf_counter()
        with _timed_steps() as steps:
            _cli(["--config", retrain_path, "--obs-dir", d3,
                  "--profile-every", str(OBS_RETRAIN_EVERY),
                  "--profile-steps", "2"])
        retrain_wall = time.perf_counter() - t0
        prom = _prom_values(os.path.join(d3, "metrics.prom"))
        retrain_profile = {"kernels": [], "coverage": None}
        if os.path.exists(os.path.join(d3, "profile.json")):
            with open(os.path.join(d3, "profile.json")) as f:
                retrain_profile = json.load(f)
        retrain_windows = []
        pdir = os.path.join(d3, "profile")
        for w in sorted(os.listdir(pdir) if os.path.isdir(pdir) else []):
            with open(os.path.join(pdir, w, "window.json")) as f:
                retrain_windows.append(dict(json.load(f),
                                            dir=os.path.join(pdir, w)))
        retrain_tables = [_window_rows(w, 28) for w in retrain_windows]

    # results unchanged: phase 7's first 2 drops and widths
    if drops != pr_drops[:2]:
        fail(f"phase 28: dropped units differ from phase 7's first 2 "
             f"({[(t, len(i)) for t, i in drops]} against "
             f"{[(t, len(i)) for t, i in pr_drops[:2]]})")
    if [r["widths"] for r in rows] != pr["widths"][:2] \
            or [r["layer"] for r in rows] != first:
        fail(f"phase 28: records {[(r['layer'], r['widths']) for r in rows]}")
    # the span tree: run -> prune_retrain -> setup / attribution / eval /
    # prune / retrain, per target
    tree = _span_tree(events)
    if tree[:3] != [("run", None, None), ("prune_retrain", "run", None),
                    ("setup", "prune_retrain", None)]:
        fail(f"phase 28: span tree starts {tree[:3]}")
    for target in first:
        for name in ("attribution", "eval", "prune", "retrain"):
            if (name, "prune_retrain", target) not in tree:
                fail(f"phase 28: no {name} span of {target} under "
                     f"prune_retrain")
    rounds = [r for r in ledger if r.get("event") == "round"]
    finite = all(math.isfinite(v) for r in rounds
                 for v in r["score_dist"].values()
                 if isinstance(v, float))
    if [r["target"] for r in rounds] != first or not finite:
        fail(f"phase 28: ledger rounds {[r.get('target') for r in rounds]}"
             f" (finite score distributions: {finite})")
    if not all(t in report for t in first):
        fail("phase 28: obs report does not render both rounds")
    score_names = {k["kernel"] for k in score_profile["kernels"]}
    if len(score_windows) != 1 or score_windows[0]["device_events"] <= 0 \
            or "fwd_tf32x3" not in score_names:
        fail(f"phase 28: scoring window {score_windows}, kernels "
             f"{sorted(score_names)[:20]}")
    # every flash forward of the scoring pass is in its window, exactly
    score_fwd_seen = score_tables[0]["launches"].get("fwd_tf32x3", 0)
    if score_fwd_seen != score_fwd \
            or score_windows[0].get("launches", {}).get("flash_fwd") \
            != score_fwd \
            or score_prom.get("profile_missing_kernel_events_total") != 0:
        fail(f"phase 28: the scoring window holds {score_fwd_seen} "
             f"fwd_tf32x3 launches, the wrapper launched {score_fwd} "
             f"(the window's own count "
             f"{score_windows[0].get('launches', {}).get('flash_fwd')}, "
             f"missing "
             f"{score_prom.get('profile_missing_kernel_events_total')})")
    _window_launches(28, score_windows[0], score_tables[0])
    for w, t in zip(retrain_windows, retrain_tables):
        _window_launches(28, w, t)
    retrain_names = {k["kernel"] for k in retrain_profile["kernels"]}
    want = {"fwd_wgmma", "dq_wgmma", "dkv_wgmma"}
    if not want <= retrain_names or not retrain_windows \
            or any(w["device_events"] <= 0 for w in retrain_windows) \
            or prom.get("profile_empty_windows_total") != 0 \
            or prom.get("profile_missing_kernel_events_total") != 0:
        fail(f"phase 28: retrain windows {len(retrain_windows)}, kernels "
             f"{sorted(retrain_names)[:20]}, empty "
             f"{prom.get('profile_empty_windows_total')}, missing "
             f"{prom.get('profile_missing_kernel_events_total')}")
    gnorm = prom.get("grad_norm")
    if gnorm is None or not (math.isfinite(gnorm) and gnorm > 0):
        fail(f"phase 28: grad_norm gauge {gnorm}")
    stats = _step_stats(steps, "obs retrain")
    out = {
        "card": smi, "prune_wall_s": prune_wall,
        "records": [(r["layer"], r["widths"]) for r in rows],
        "n_dropped": [len(i) for _, i in drops],
        "rounds": len(rounds), "span_names": sorted({t[0] for t in tree}),
        "scoring_window": {
            "seconds": score_s, "device_events":
                score_windows[0]["device_events"],
            "kernels": [(k["kernel"], k["ms_per_step"],
                         k["launches_per_step"])
                        for k in score_profile["kernels"][:8]],
            # the flash bodies' rows: ms and launches in the window
            "flash": {k["kernel"]: (k["ms_per_step"],
                                    k["launches_per_step"])
                      for k in score_profile["kernels"]
                      if k["category"] == "attention"}},
        "retrain": {
            "wall_s": retrain_wall, "windows": len(retrain_windows),
            "device_events": [w["device_events"] for w in retrain_windows],
            "coverage": retrain_profile["coverage"],
            "idle_share": (1.0 - retrain_profile["coverage"]
                           if retrain_profile["coverage"] is not None
                           else None),
            "kernels": [(k["kernel"], k["ms_per_step"],
                         k["launches_per_step"])
                        for k in retrain_profile["kernels"][:10]],
            "flash": {k["kernel"]: (k["ms_per_step"],
                                    k["launches_per_step"])
                      for k in retrain_profile["kernels"]
                      if k["category"] == "attention"},
            "grad_norm": gnorm, **stats,
            "phase8_step_ms_median": rt["step_ms_median"],
            "phase8_last_loss": rt["last_loss"]},
    }
    log(f"obs prune: {json.dumps(out)}")
    return out


def per_step(cases, key, weight):
    return sum(c[key] * weight(c) for c in cases)


def prefill_sums(dq) -> dict:
    """The dequant kernel's time, bound and library time per full-depth
    Llama-3-8B prefill at each bucket of phase 3 and per 64-row chunk of
    phase 18, int4 and int8 (sum over that forward's calls; the lm_head
    runs on every row), and per decode step at 4 slots."""
    w = lambda c: DQ_SHAPES[(c["D"], c["F"])]  # noqa: E731
    out = {}
    for bits in (4, 8):
        for key in ("ms", "bound_ms", "library_ms", "plain_ms"):
            out[f"prefill_int{bits}_{key}_by_bucket"] = {
                str(M): per_step([c for c in dq if c["bits"] == bits
                                  and c["M"] == M], key, w)
                for M in PREFILL_BUCKETS}
            # one 64-row chunk of phase 18's chunked prefill
            out[f"chunk64_int{bits}_{key}"] = per_step(
                [c for c in dq if c["bits"] == bits and c["M"] == 64], key,
                w)
            out[f"decode_step_int{bits}_{key}"] = per_step(
                [c for c in dq if c["bits"] == bits and c["M"] == 4], key, w)
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    # tear CUPTI down at every profiler session's stop: kept set up, the
    # later sessions of a long process lose their first kernels
    # (ROADMAP C3)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    try:
        import torch

        from torchpruner_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 2
    from torchpruner_tpu_torch.utils.device import strict_fp32_matmul

    t_start = time.perf_counter()
    os.chdir(HERE)  # the runs' logs land inside the checkout
    dev = torch.device("cuda")
    strict_fp32_matmul()  # float32 products in full precision (no TF32)
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    if sys.argv[1:] == ["--moe-slice"]:  # phases 21-23, as a child
        _build.build()
        out = moe_slice(dev)
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--remat-phase"]:  # phase 24, as a child
        _build.build()
        out = remat_phase(dev)
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--obs-slice"]:  # phases 3, 7, 8, 27 and 28 alone
        _build.build()
        s4 = serve_phase(dev, bits=4, depth=DEPTH)
        pr, pr_drops = preset_phase(dev)
        rt = retrain_phase(dev)
        out = {"serve": obs_serve_phase(dev, s4, smi),
               "prune": obs_prune_phase(dev, pr, pr_drops, rt, smi)}
        log(f"total {time.perf_counter() - t_start:.1f} s ({smi})")
        print(json.dumps(out), flush=True)
        return 0

    t0 = time.perf_counter()
    info = _build.build()
    each = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in info.items())
    log(f"phase 1: built {sorted(info)} in {time.perf_counter() - t0:.2f} s "
        f"({each})")
    for name, v in info.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 2: kernels vs plain versions")
    dq = dequant_cases(dev)
    da = decode_cases(dev)

    log("phase 3: serve Llama-3-8B int4, full width and depth")
    s4 = serve_phase(dev, bits=4, depth=DEPTH)
    log("phase 4: serve Llama-3-8B int8, full width, 4 blocks")
    s8 = serve_phase(dev, bits=8, depth=4)
    log("phase 5: CLI serve --smoke --verify")
    cli_phase()
    log("phase 6: flash attention kernels vs plain versions")
    fl = [flash_case(dev, *c) for c in FLASH_CASES]
    log("phase 7: --preset bert_glue_sensitivity, BERT-base full width")
    pr, pr_drops = preset_phase(dev)
    log("phase 8: retrain block12_mlp one epoch, bf16, through --config")
    rt = retrain_phase(dev)
    log("phase 9: mfu_llama causal training, 3 steps, bf16")
    ca = causal_phase(dev)
    log("phase 10: block-sparse matmul kernels vs plain versions")
    bs = [blocksparse_case(dev, *c, dtn) for c in BS_CASES
          for dtn in ("float32", "bfloat16")]
    log("phase 11: masked block-sparse retraining, BERT-base full width")
    mr, p11 = masked_retrain_phase(dev)
    log("phase 12: --config with simulate=true, BERT-base full width")
    sim = simulate_phase(dev, pr)
    log("phase 13: mfu_llama GatedDense through the block-sparse kernels")
    gd = gated_phase(dev)
    log("phase 14: --preset mnist_mlp_shapley, 784-2024-2024-10")
    mlp = mlp_shapley_phase(dev)
    log("phase 15: vit_head_mlp_shapley recipe, ViT-B/16 full width and "
        "depth")
    vit = vit_shapley_phase(dev)
    log("phase 16: vgg16_digits32_layerwise, VGG16-bn full width: train, "
        "then the 8-method panel on conv1, conv13, fc1")
    t0 = time.perf_counter()
    _, p16 = vgg_sweep_phase(dev)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    log("phase 17: resnet50_taylor, ResNet-50 full width, stage 4")
    t0 = time.perf_counter()
    resnet_phase(dev)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")
    log("phase 18: shared-prefix traffic, chunked prefill and prefix pages, "
        "Llama-3-8B int4 full width and depth, sharing on and off")
    t0 = time.perf_counter()
    px = prefix_phase(dev)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        log("phase 19: checkpoints A and B (FFN pruned a quarter), serve "
            "--checkpoint A --swap-checkpoint B --verify")
        t0 = time.perf_counter()
        ck = checkpoint_phase(dev, tmp)
        log(f"phase 19: {time.perf_counter() - t0:.1f} s")
        log("phase 20: serve --checkpoint B --http: generate, healthz, "
            "swap to A, SIGTERM drain")
        t0 = time.perf_counter()
        hp = http_phase(tmp)
        log(f"phase 20: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phases 21-23: the MoE slice (Mixtral-8x7B), in a child process")
    moe = run_moe_child()
    log(f"phases 21-23: {time.perf_counter() - t0:.1f} s")
    log("phase 24: remat, gradient accumulation and multi_step, mfu_llama "
        "full width, bf16, in a child process")
    t0 = time.perf_counter()
    rm = run_remat_child()
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    log("phase 25: accumulated masked retraining (accum_steps 2), BERT-base "
        "full width")
    t0 = time.perf_counter()
    am = accum_masked_phase(dev, p11)
    log(f"phase 25: {time.perf_counter() - t0:.1f} s")
    log("phase 26: the cached sweep: phase 16's panel with capture on and "
        "off, phase 14's fc1 Shapley rows with and without the cache")
    t0 = time.perf_counter()
    cs = cached_sweep_phase(dev, p16)
    del p11, p16
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")
    log("phase 27: observability on serving: Llama-3-8B int4 full width "
        "and depth, 3 capture windows in one process")
    t0 = time.perf_counter()
    o27 = obs_serve_phase(dev, s4, smi)
    log(f"phase 27: {time.perf_counter() - t0:.1f} s ({smi})")
    log("phase 28: observability on the prune loop: BERT-base, 2 targets "
        "with --obs-dir, a scoring window, the bf16 fine-tune with "
        "obs_grad_norm and --profile-every")
    t0 = time.perf_counter()
    o28 = obs_prune_phase(dev, pr, pr_drops, rt, smi)
    log(f"phase 28: {time.perf_counter() - t0:.1f} s ({smi})")

    # per-kernel line: the work of one full-depth 8B int4 decode step at
    # 4 slots (sum over that step's calls), every case beside it
    step_dq = [c for c in dq if c["bits"] == 4 and c["M"] == 4]
    step_da = [c for c in da if c["cache_dtype"] == "bfloat16"
               and c["T"] == DECODE_CASES[0][1]]
    dq_w = lambda c: DQ_SHAPES[(c["D"], c["F"])]  # noqa: E731
    da_w = lambda c: DEPTH  # noqa: E731
    kernels = []
    for name, src, replaces, cases, step, w, tol in (
            ("dequant_matmul", "torchpruner_tpu_torch/csrc/dequant_matmul.cu",
             "torchpruner_tpu/ops/fused_matmul.py:150", dq, step_dq, dq_w,
             "per case 1e-5 x max|plain| (f32 sums in another order)"),
            ("decode_attention",
             "torchpruner_tpu_torch/csrc/decode_attention.cu",
             "torchpruner_tpu/ops/decode_attention.py:170", da, step_da,
             da_w, "per case 1e-5 (f32 cache) or 2**-7 (bf16 cache, one "
                   "bf16 ulp) x max|plain|")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": s4["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": tol,
            "ms": per_step(step, "ms", w),
            "plain_ms": per_step(step, "plain_ms", w),
            "bound_ms": per_step(step, "bound_ms", w),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in step) else "operations",
            "library_ms": per_step(step, "library_ms", w),
            "per": "one full-depth Llama-3-8B int4 decode step at 4 slots "
                   "(sum over its calls)",
            "launches_int8_phase": s8["launches"][name],
            # serve v2: phase 18 with sharing on (the path) and off, the
            # CLI's checkpoint + swap run (19) and the HTTP server (20)
            "launches_prefix_phase": px["on"]["launches"][name],
            "launches_prefix_phase_sharing_off": px["off"]["launches"][name],
            "launches_checkpoint_swap_cli": ck["summary"]["kernel_launches"][
                name],
            "launches_http_server": hp["summary"]["kernel_launches"][name],
            # the MoE slice: Mixtral-8x7B int4 serving (21), the pruned
            # 2-block Mixtral's checkpoint through the CLI (23)
            "launches_mixtral_serve": moe["serve"]["launches"][name],
            "launches_moe_checkpoint_cli": moe["cli"]["summary"][
                "kernel_launches"][name],
            **(prefill_sums(dq) if name == "dequant_matmul" else
               {"plan": step[0]["plan"]}),
            "cases": cases,
        })
    score = next(c for c in fl if c["label"] == "scoring")
    vit_case = next(c for c in fl if c["label"] == "vit_scoring")
    outputs = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
               "flash_dkv": ("dk", "dv")}
    for name, src_line in zip(FLASH_KERNELS, (104, 223, 279)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "torchpruner_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"torchpruner_tpu/ops/flash_attention.py:{src_line}",
            "launches": pr["launches"][name],
            "max_abs_err": max(c["errors"][e]["max_abs_err"] for c in fl
                               for e in outputs[name]),
            "tolerance": "f32: 1e-5 (out, lse) / 1e-4 (grads) x max|plain|;"
                         " bf16: 2**-7 x max|plain| (plain in f32 on the "
                         "same inputs)",
            "ms": score["ms"][name],
            "plain_ms": score["plain_fwd_ms"] if name == "flash_fwd"
            else score["plain_bwd_ms"],
            "bound_ms": score["bound"][name][0],
            "bound_by": score["bound"][name][1],
            "library_ms": score["library_fwd_ms"] if name == "flash_fwd"
            else score["library_bwd_ms"],
            "per": "one call at the scoring shape (f32, B 128, S 128, H 12, "
                   "Dh 64); backward rows: plain_ms and library_ms are the "
                   "whole backward (dq, dk, dv)",
            # the bodies the profiler saw at the scoring and retrain shapes
            "body": {"float32": score["body"][name],
                     "bfloat16": next(c["body"][name] for c in fl
                                      if c["label"] == "retrain")},
            # bound_ms is at 3xTF32's f32 rate; the FMA units' beside it
            "bound_fma_ms": score["bound_fma"][name][0],
            "launches_retrain": rt["launches"][name],
            "launches_causal": ca["launches"][name],
            # phase 22: Mixtral expert pruning (f32 Taylor, bf16 SGD)
            "launches_moe_prune": moe["prune"]["launches"][name],
            # phase 24: 3 mfu_llama steps each way (remat recomputes the
            # forward in the backward; accumulation adds 4 microbatches)
            **{f"launches_{w}": rm["ways"][w]["launches"][name]
               for w in ("plain", "remat", "remat_accum")},
            # a ViT-B/16 scoring batch (B 64, S 197, H 12, Dh 64, f32, not
            # causal); launches: phase 15's run
            "vit_scoring": {
                "ms": vit_case["ms"][name],
                "bound_ms": vit_case["bound"][name][0],
                "bound_by": vit_case["bound"][name][1],
                "bound_fma_ms": vit_case["bound_fma"][name][0],
                "plain_ms": vit_case["plain_fwd_ms"] if name == "flash_fwd"
                else vit_case["plain_bwd_ms"],
                "library_ms": vit_case["library_fwd_ms"]
                if name == "flash_fwd" else vit_case["library_bwd_ms"],
                "launches": vit["launches"][name]},
            # the bf16 training shapes (the wgmma forward and dK/dV)
            "bf16": {c["label"]: {
                "ms": c["ms"][name], "bound_ms": c["bound"][name][0],
                "library_ms": c["library_fwd_ms"] if name == "flash_fwd"
                else c["library_bwd_ms"]}
                for c in fl if c["dtype"] == "bfloat16"},
            **({"cases": fl, "vit_shapley": vit, "mlp_shapley": mlp}
               if name == "flash_fwd" else {}),
        })
    path = next(c for c in bs if c["label"] == "fc1"
                and c["dtype"] == "bfloat16")
    fc2 = next(c for c in bs if c["label"] == "fc2"
               and c["dtype"] == "bfloat16")
    f32_cases = {c["label"]: c for c in bs if c["dtype"] == "float32"
                 and c["label"] in ("fc1", "fc2")}
    b32 = next(c for c in bs if c["label"] == "block32"
               and c["dtype"] == "bfloat16")
    for name in BS_KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "torchpruner_tpu_torch/csrc/blocksparse_matmul.cu",
            "replaces": "torchpruner_tpu/ops/blocksparse.py:140",
            "launches": mr["launches"][name],
            "max_abs_err": max(c["errors"][name]["max_abs_err"] for c in bs),
            "tolerance": "f32: 1e-5 x max|plain|; bf16: 2**-7 x max|plain| "
                         "(plain in f32 on the same inputs)",
            "ms": path["ms"][name],
            "plain_ms": path["plain_ms"][name],
            "bound_ms": path["bound"][name][0],
            "bound_by": path["bound"][name][1],
            "library_ms": path["library_ms"][name],
            "all_kept_ms": path["all_kept_ms"][name],
            "plan": path["plan"][name],
            # fc2 (D 3072, F 768, 12 of 24 input blocks kept), bf16
            "fc2": {k: fc2[k][name] for k in ("ms", "library_ms", "plan")}
            | {"bound_ms": fc2["bound"][name][0],
               "bound_by": fc2["bound"][name][1]},
            "per": "one call at BERT-base fc1 in training (bf16, R 4096, "
                   "D 768, F 3072, 12 of 24 output blocks kept); "
                   "library_ms: torch.matmul on the dense masked weight",
            "launches_gated": gd["launches"][name],
            # phase 25: 5 masked steps at accum_steps 2
            "launches_accum_masked": am["launches"][name],
            "body": path["plan"][name]["body"],
            # the f32 body (the documented masked-retraining recipe's
            # dtype) at fc1 and fc2; bound_ms at 3xTF32's rate, the FMA
            # units' beside it
            "f32": {label: {
                "ms": c["ms"][name], "bound_ms": c["bound"][name][0],
                "bound_by": c["bound"][name][1],
                "bound_fma_ms": c["bound_fma"][name][0],
                "library_ms": c["library_ms"][name],
                "plain_ms": c["plain_ms"][name], "plan": c["plan"][name]}
                for label, c in f32_cases.items()},
            # bf16 at block 32 (the wmma body, off every main path)
            "block32_bf16": {k: b32[k][name] for k in ("ms", "library_ms",
                                                        "plan")}
            | {"bound_ms": b32["bound"][name][0],
               "bound_by": b32["bound"][name][1]},
            **({"cases": bs, "masked_retrain": mr, "simulate": sim,
                "gated": gd} if name == "blocksparse_fwd" else {}),
        })
    kernels[0]["serve_v2"] = {"prefix_sharing": px, "checkpoint_swap": ck,
                              "http": hp}
    kernels[0]["moe"] = moe
    kernels[0]["training_v2"] = {"remat": rm, "accum_masked": am,
                                 "cached_sweep": cs}
    # phases 27-28: what the program's own capture windows name
    kernels[0]["obs"] = {"serve": o27, "prune": o28}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
