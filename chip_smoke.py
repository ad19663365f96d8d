"""On-card smoke test of the PyTorch/CUDA port (``torchpruner_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. Environment: the card's name and power limit (``nvidia-smi``); build
   both CUDA kernels from ``torchpruner_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the build time.
2. Kernel vs plain: the dequant matmul (int4 and int8, M in {1, 4, 64}
   and the prefill buckets {16, 48, 104} of phase 3's prompts, at the
   Llama-3-8B projection shapes) and decode attention (B=4, T=512,
   H=32, Dh=128, f32 and bf16 cache, ragged positions incl. 0 and T-1,
   stale rows poisoned) against their plain PyTorch versions; CUDA-event
   times of kernel, plain version, one PyTorch library call, and the
   least time the card could take (bound).
3. Serve Llama-3-8B at full width and depth with int4 weights through
   ``ServeEngine`` (4 slots, max_len 512, bf16 activations and KV) on 8
   greedy requests, replay each alone through ``generate``; launch
   counts of both kernels are read around the serve run.
4. The same at int8 with 4 blocks (the int8 mode of the dequant kernel).
5. The CLI: ``python -m torchpruner_tpu_torch serve llama3_ffn_taylor
   --smoke --synthetic 8 --verify``.

The last three stdout lines: the ``nvidia-smi`` name/power line, one JSON
``{"kernels": [...]}`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s,
#: bf16 tensor-core FLOP/s, float32 non-tensor FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

#: Llama-3-8B dequant matmul sites: (D, F) -> calls per decode step
#: (32 blocks x wq / wk+wv / wg+wu / down, plus the lm_head)
DQ_SHAPES = {(4096, 4096): 32, (4096, 1024): 64, (4096, 14336): 64,
             (14336, 4096): 32, (4096, 128256): 1}
DEPTH = 32
#: rows of a dequant call: decode at 1 and 4 slots, a 64-row case,
#: and the prefill buckets of phase 3's prompts (16, 40, 100 tokens)
DQ_ROWS = (1, 4, 16, 48, 64, 104)
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
            for M in DQ_ROWS:
                x = torch.randn((M, D), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                got = FM.dequant_matmul(x, q, scale, bits=bits)
                want = FM.dequant_matmul_plain(x, q, scale, bits=bits)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = 1e-5 * float(want.abs().max()) + 1e-6
                if not (err <= tol and bool(torch.isfinite(got).all())):
                    fail(f"dequant bits={bits} M={M} D={D} F={F}: max "
                         f"abs err {err} > tol {tol}")
                ms = event_ms(lambda i: FM.dequant_matmul(
                    x, qs[i % n], scale, bits=bits), 20)
                plain = event_ms(lambda i: FM.dequant_matmul_plain(
                    x, qs[i % n], scale, bits=bits), 2)
                lib = event_ms(lambda i: torch.matmul(
                    x, libs[i % n_lib]), 20)
                nbytes = x.numel() * 2 + q.numel() + F * 4 + M * F * 4
                b, by = bound_ms(nbytes, 2.0 * M * D * F, BF16_FLOPS)
                cases.append({"bits": bits, "M": M, "D": D, "F": F,
                              "max_abs_err": err, "tol": tol, "ms": ms,
                              "plain_ms": plain, "library_ms": lib,
                              "bound_ms": b, "bound_by": by})
                log(f"  dequant int{bits} M={M:<3d} D={D:<6d} F={F:<7d} "
                    f"kernel {ms:.4f} ms  plain {plain:.3f} ms  "
                    f"library {lib:.4f} ms  bound {b:.4f} ms ({by})  "
                    f"err {err:.3g} (tol {tol:.3g})")
            del qs, libs, w_lib, qt
        del w
    torch.cuda.empty_cache()
    return cases


def decode_cases(dev):
    import torch
    import torch.nn.functional as Fn

    from torchpruner_tpu_torch.ops import decode_attention as DA

    B, T, H, Dh = 4, 512, 32, 128
    pos = torch.tensor([0, 100, 300, T - 1], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, 1, H, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((B, T, H, Dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, T, H, Dh), generator=gen, device=dev).to(dtype)
        got = DA.decode_attention(q, k, v, pos)
        want = DA.decode_attention_plain(q, k, v, pos)
        torch.cuda.synchronize()
        rel = 1e-5 if dtype == torch.float32 else 2 ** -7
        tol = rel * float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            fail(f"decode attention {dtype}: max abs err {err} > tol {tol}")
        kp, vp = k.clone(), v.clone()
        for b, p in enumerate(pos.tolist()):
            kp[b, p + 1:] = 1e4
            vp[b, p + 1:] = -1e4
        if not torch.equal(DA.decode_attention(q, kp, vp, pos), got):
            fail(f"decode attention {dtype}: stale rows changed a result")
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
        live = sum(p + 1 for p in pos.tolist())
        nbytes = (q.numel() * q.element_size()
                  + 2 * live * H * Dh * k.element_size()
                  + pos.numel() * 4 + got.numel() * got.element_size())
        b, by = bound_ms(nbytes, 4.0 * live * H * Dh, FP32_FLOPS)
        cases.append({"cache_dtype": str(dtype).replace("torch.", ""),
                      "B": B, "T": T, "H": H, "Dh": Dh,
                      "pos": pos.tolist(), "max_abs_err": err, "tol": tol,
                      "ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": b, "bound_by": by})
        log(f"  decode cache={dtype} kernel {ms:.4f} ms  plain "
            f"{plain:.3f} ms  library {lib:.4f} ms  bound {b:.4f} ms "
            f"({by})  err {err:.3g} (tol {tol:.3g})")
        del kvs, k, v, kp, vp
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


def per_step(cases, key, weight):
    return sum(c[key] * weight(c) for c in cases)


def prefill_sums(dq) -> dict:
    """The dequant kernel's time, bound and library time per full-depth
    int4 prefill at each bucket of phase 3 (sum over that forward's
    calls; the lm_head runs on every bucket row)."""
    out = {}
    for key in ("ms", "bound_ms", "library_ms", "plain_ms"):
        out[f"prefill_{key}_by_bucket"] = {
            str(M): per_step([c for c in dq if c["bits"] == 4
                              and c["M"] == M], key,
                             lambda c: DQ_SHAPES[(c["D"], c["F"])])
            for M in PREFILL_BUCKETS}
    return out


def main() -> int:
    sys.path.insert(0, HERE)
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
    dev = torch.device("cuda")
    strict_fp32_matmul()  # float32 products in full precision (no TF32)
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

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

    # per-kernel line: the work of one full-depth 8B int4 decode step at
    # 4 slots (sum over that step's calls), every case beside it
    step_dq = [c for c in dq if c["bits"] == 4 and c["M"] == 4]
    step_da = [c for c in da if c["cache_dtype"] == "bfloat16"]
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
            **(prefill_sums(dq) if name == "dequant_matmul" else {}),
            "cases": cases,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
