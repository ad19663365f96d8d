"""A/B of two dequant-matmul kernels on the card, in turns A, B, B, A.

Builds a second dequant kernel from ``--old`` (a copy of an earlier
``csrc/dequant_matmul.cu`` with its C entry ``tp_dequant_matmul(x, q,
scale, y, part, M, D, F, bits, ks, stream)``: the one-pass FMA kernel
whose K splits come from :func:`old_k_splits`) beside the package's own
kernel, and compares the two in one process on one card:

- every phase 2 case of ``chip_smoke.py`` (the Llama-3-8B projection
  shapes, int4 and int8, ``DQ_ROWS`` rows): CUDA-event ms of each kernel
  in turns old, new, new, old on the same inputs (the same weight copies
  cycled past the 50 MB L2), and whether the two agree with the plain
  version;
- the per-prefill sums at each bucket of phase 3 and the decode-step sum
  at 4 slots (sum over one full-depth forward's calls);
- phase 3 of ``chip_smoke.py`` (full-depth Llama-3-8B int4 served on 8
  requests and replayed alone) with ``fused_matmul.dequant_matmul`` bound
  to each kernel in turns old, new, new, old: ``ttft_p50_ms``,
  ``token_p50_ms``, ``verify_mismatches``.

Writes the whole result to ``--out`` (JSON) and prints a summary.

Run from the root of a checkout on the card, with the earlier revision's
``csrc/`` extracted into the git-ignored ``_archive/`` (``python -m
torchpruner_tpu_torch.experiments._ab REV``):
``python -m torchpruner_tpu_torch.experiments.dequant_ab --old
_archive/REV/dequant_matmul.cu [--out chiprun_out/dequant_ab.json]
[--no-serve]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

from torchpruner_tpu_torch.experiments._ab import ORDER, build_library

#: the earlier kernel's grid target: 528 blocks of 128 columns
_OLD_TARGET_BLOCKS = 528


def old_k_splits(rows: int, F: int) -> int:
    """K splits of the earlier kernel (a function of the weight's shape)."""
    tiles = -(-F // 128)
    want = -(-_OLD_TARGET_BLOCKS // tiles)
    return max(1, min(want, rows // 128))


def build_old(src: str):
    """Compile ``src``; the loaded entry and the build seconds."""
    lib, seconds = build_library(src, "dequant_matmul_old")
    fn = lib.tp_dequant_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, seconds


def old_wrapper(fn):
    """``dequant_matmul`` with the earlier kernel behind it."""
    import torch

    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    def dequant_matmul(x, q, scale=None, *, bits=8):
        FM._check(x, q, scale, bits)
        xb = x.to(torch.bfloat16).contiguous()
        if xb.data_ptr() % 4:
            xb = xb.clone()
        qc = q.contiguous()
        M, D = xb.shape
        F = qc.shape[1]
        y = torch.empty((M, F), dtype=torch.float32, device=x.device)
        if M == 0:
            return y
        ks = old_k_splits(qc.shape[0], F)
        part = (torch.empty((ks, M, F), dtype=torch.float32,
                            device=x.device) if ks > 1 else y)
        sc = None
        if scale is not None:
            sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
        err = fn(xb.data_ptr(), qc.data_ptr(),
                 sc.data_ptr() if sc is not None else None, y.data_ptr(),
                 part.data_ptr(), M, D, F, bits, ks,
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "old dequant_matmul")
        dequant_matmul.launches += 1
        return y

    dequant_matmul.launches = 0
    return dequant_matmul


def kernel_cases(dev, kernels) -> list:
    """Phase 2's dequant cases, each kernel of ``kernels`` (name ->
    function) timed in turns old, new, new, old."""
    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.ops.quant import quantize_tensor

    cases = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for (D, F) in CS.DQ_SHAPES:
        w = torch.randn((D, F), generator=gen, device=dev,
                        dtype=torch.bfloat16) * 0.02
        for bits in (4, 8):
            qt = quantize_tensor(w, in_axes=(0,), bits=bits)
            q, scale = qt.q, qt.out_scale()
            n = CS.copies_for(q.numel())
            qs = [q] + [q.clone() for _ in range(n - 1)]
            for M in CS.DQ_ROWS:
                x = torch.randn((M, D), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                want = FM.dequant_matmul_plain(x, q, scale, bits=bits)
                tol = 1e-5 * float(want.abs().max()) + 1e-6
                errs = {k: float((fn(x, q, scale, bits=bits) - want).abs()
                                 .max()) for k, fn in kernels.items()}
                times = {k: [] for k in kernels}
                for k in ORDER:
                    fn = kernels[k]
                    times[k].append(CS.event_ms(
                        lambda i: fn(x, qs[i % n], scale, bits=bits), 20))
                nbytes = x.numel() * 2 + q.numel() + F * 4 + M * F * 4
                b, by = CS.bound_ms(nbytes, 2.0 * M * D * F, CS.BF16_FLOPS)
                case = {"bits": bits, "M": M, "D": D, "F": F, "tol": tol,
                        "max_abs_err": errs, "ms": times, "bound_ms": b,
                        "bound_by": by}
                cases.append(case)
                print(f"  int{bits} M={M:<3d} D={D:<6d} F={F:<7d} "
                      f"old {times['old'][0]:.4f}/{times['old'][1]:.4f} "
                      f"new {times['new'][0]:.4f}/{times['new'][1]:.4f} ms "
                      f"bound {b:.4f}  err old {errs['old']:.3g} new "
                      f"{errs['new']:.3g} (tol {tol:.3g})", flush=True)
            del qs, qt
        del w
    torch.cuda.empty_cache()
    return cases


def sums(cases) -> dict:
    """Per-prefill sums at each bucket and the decode-step sum (4 slots),
    int4 and int8, for each run of each kernel."""
    import chip_smoke as CS

    def total(bits, M, k, run):
        return sum(c["ms"][k][run] * CS.DQ_SHAPES[(c["D"], c["F"])]
                   for c in cases if c["bits"] == bits and c["M"] == M)

    out = {}
    for bits in (4, 8):
        for M, label in [(m, f"prefill_{m}") for m in CS.PREFILL_BUCKETS] \
                + [(4, "decode_step")]:
            out[f"int{bits}_{label}"] = {
                k: [total(bits, M, k, r) for r in (0, 1)]
                for k in ("old", "new")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="an earlier kernel source beside its own revision's "
                         "headers (_archive/REV/NAME.cu, from python -m "
                         "torchpruner_tpu_torch.experiments._ab REV)")
    ap.add_argument("--out", default="chiprun_out/dequant_ab.json")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the phase 3 serve turns")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.ops import fused_matmul as FM
    from torchpruner_tpu_torch.utils.device import strict_fp32_matmul

    if not torch.cuda.is_available():
        print("dequant_ab: needs a CUDA device", file=sys.stderr)
        return 2
    strict_fp32_matmul()
    dev = torch.device("cuda")
    smi = CS.smi_line()
    info = _build.build(["dequant_matmul"])
    old_fn, old_s = build_old(args.old)
    new = FM.dequant_matmul
    old = old_wrapper(old_fn)
    print(f"card: {smi}; built new {info['dequant_matmul']['seconds']:.2f} s,"
          f" old {old_s:.2f} s", flush=True)
    result = {"card": smi, "cases": kernel_cases(dev, {"old": old,
                                                       "new": new})}
    result["sums"] = sums(result["cases"])
    for k, v in result["sums"].items():
        print(f"  {k}: old {v['old'][0]:.3f}/{v['old'][1]:.3f} ms, new "
              f"{v['new'][0]:.3f}/{v['new'][1]:.3f} ms", flush=True)
    if not args.no_serve:
        serve = []
        for k in ORDER:
            FM.dequant_matmul = old if k == "old" else new
            try:
                out = CS.serve_phase(dev, bits=4, depth=CS.DEPTH)
            finally:
                FM.dequant_matmul = new
            serve.append({"kernel": k, **{
                key: out[key] for key in ("ttft_p50_ms", "token_p50_ms",
                                          "sustained_gen_tok_s",
                                          "verify_mismatches", "launches")}})
        result["serve"] = serve
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"card": smi, "sums": result["sums"],
                      "serve": result.get("serve")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
