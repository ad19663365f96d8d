"""A/B of two block-sparse matmul kernel sources on the card, in turns
old, new, new, old.

Builds ``--old`` (an earlier ``csrc/blocksparse_matmul.cu`` with the same
C entries ``tp_bs_fwd`` / ``tp_bs_dx`` / ``tp_bs_dw``, beside its own
revision's headers; or an edited copy of this one, which is how another
plan choice is measured) beside the package's own library.  It binds the
wrappers of ``ops/blocksparse.py`` to each library in turn and compares,
in one process on one card:

- every phase 10 case of ``chip_smoke.py`` (``BS_CASES``) and phase 13's
  two mfu_llama GatedDense shapes (``MFU_CASES``), f32 and bf16 (or the
  ``--cases`` / ``--dtypes`` named): each library's plan where it has a
  ``tp_bs_plan`` entry, its max abs error against autograd of the plain
  version in
  f32, and CUDA-event ms of the forward, dx and dW launches, twice: warm
  (back to back on the same inputs, as phase 10 times them) and cold
  (a 64 MB buffer written before every launch evicts the 50 MB L2; the
  ms of write + launch less the write's alone), and the host's µs to
  enqueue one call (the wrapper, the plan, the tensor maps, the launch:
  what a host-bound step pays per call);
- phase 11's masked step (BERT-base, B 32, S 128, bf16, Adam +
  ``masked_update``, half of every ``fc1``'s 128-blocks dropped, the
  block-sparse transform): the median step ms (each step ended by a
  synchronize) and, under ``torch.profiler``, the kernel ms per step,
  the three block-sparse kernels' ms and the device's idle share.

Writes the whole result to ``--out`` (JSON) and prints a summary: for
each case and kernel the median of each library's turns and its ratio
to the old library's.

Run from the root of a checkout on the card, with the earlier revision's
``csrc/`` extracted into the git-ignored ``_archive/`` (``python -m
torchpruner_tpu_torch.experiments._ab REV``):
``python -m torchpruner_tpu_torch.experiments.blocksparse_ab --old
_archive/REV/blocksparse_matmul.cu [--cases fc1,mfu_gate] [--dtypes
bfloat16] [--out logs/blocksparse_ab.json] [--steps 8] [--no-steps]``
(~2 min).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from torchpruner_tpu_torch.experiments._ab import (
    ORDER,
    bound_library,
    build_library,
)

LIB = "blocksparse_matmul"
MODES = ("blocksparse_fwd", "blocksparse_dx", "blocksparse_dw")
#: bytes written before a cold launch: more than the H100's 50 MB L2
FLUSH_BYTES = 64 << 20
#: phase 13's GatedDense sites at B 8 x S 1024 (mfu_llama): the gate and
#: up projections keep half their out-blocks, the down projection half
#: its in-blocks (label, R, D, F, block, half_in, half_out)
MFU_CASES = (
    ("mfu_gate", 8192, 1024, 4096, 128, False, True),
    ("mfu_down", 8192, 4096, 1024, 128, True, False),
)


def library_plan(lib, mode: str, *shape) -> dict:
    """The plan of ``lib``'s own ``tp_bs_plan`` entry (``None`` for a
    library that has none)."""
    from torchpruner_tpu_torch.ops import blocksparse as BS

    if not hasattr(lib, "tp_bs_plan"):
        return None
    with bound_library(LIB, lib):
        return BS.plan_on_card(mode, *shape).__dict__


def enqueue_us(fn, calls: int = 200) -> float:
    """Host µs per call of ``fn`` while the card is kept busy, so that
    no call waits for the device (the launch queue holds them all)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def kernel_cases(dev, libs, cases, dtypes) -> list:
    """Phase 10's (and 13's) cases: each library's errors against the
    plain version and its warm and cold CUDA-event ms per kernel, in
    turns."""
    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import blocksparse as BS

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush_ms = CS.event_ms(lambda i: flush.zero_(), 20)
    out = []
    for label, R, D, F, block, half_in, half_out in cases:
        for dtn in dtypes:
            dtype = getattr(torch, dtn)
            gen = torch.Generator(device=dev).manual_seed(R + D + F + block)
            ik = tuple(i for i in range(D // block)
                       if not (half_in and i % 2))
            ok = tuple(j for j in range(F // block)
                       if not (half_out and j % 2 == 0))
            in_m = BS._unit_mask(D, ik, block, dev)
            out_m = BS._unit_mask(F, ok, block, dev)
            x = torch.randn((R, D), generator=gen, device=dev).to(dtype)
            w = (torch.randn((D, F), generator=gen, device=dev) * 0.02
                 * in_m[:, None] * out_m[None, :]).to(dtype)
            g = torch.randn((R, F), generator=gen, device=dev).to(dtype)
            xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
            yr = BS.blocksparse_matmul_plain(xr, wr, in_keep=ik,
                                             out_keep=ok, block=block)
            want = dict(zip(MODES, (yr.detach(), *torch.autograd.grad(
                yr, (xr, wr), g.float()))))
            del xr, wr, yr
            launch = {
                "blocksparse_fwd": lambda i: BS.blocksparse_fwd(
                    x, w, ik, ok, block),
                "blocksparse_dx": lambda i: BS.blocksparse_dx(
                    g, w, ik, ok, block),
                "blocksparse_dw": lambda i: BS.blocksparse_dw(
                    x, g, ik, ok, block)}
            errs = {}
            for name, lib in libs.items():
                with bound_library(LIB, lib):
                    got = {m: launch[m](0) for m in MODES}
                torch.cuda.synchronize()
                errs[name] = {m: float((got[m].float() - want[m]).abs()
                                       .max()) for m in MODES}
            del got
            warm = {m: {n: [] for n in libs} for m in MODES}
            cold = {m: {n: [] for n in libs} for m in MODES}
            host = {m: {n: [] for n in libs} for m in MODES}
            for name in ORDER:
                with bound_library(LIB, libs[name]):
                    for m in MODES:
                        warm[m][name].append(CS.event_ms(launch[m], 20))
                        host[m][name].append(enqueue_us(launch[m]))
                        fn = launch[m]
                        cold[m][name].append(CS.event_ms(
                            lambda i, fn=fn: (flush.zero_(), fn(i)), 20)
                            - flush_ms)
            med = {kind: {m: {n: statistics.median(v[m][n]) for n in libs}
                          for m in MODES}
                   for kind, v in (("warm", warm), ("cold", cold),
                                   ("host_us", host))}
            ratio = {kind: {m: {n: med[kind][m][n] / med[kind][m]["old"]
                                for n in libs if n != "old"}
                            for m in MODES} for kind in ("warm", "cold")}
            tol = (1e-5 if dtn == "float32" else 2 ** -7)
            case = {"label": label, "R": R, "D": D, "F": F, "block": block,
                    "dtype": dtn, "in_kept": len(ik), "out_kept": len(ok),
                    "plan": {n: {m: library_plan(
                        lib, m[12:], R, D, F, block, len(ik), len(ok),
                        dtype) for m in MODES} for n, lib in libs.items()},
                    "tol": {m: tol * float(want[m].abs().max())
                            for m in MODES},
                    "max_abs_err": errs, "warm_ms": warm, "cold_ms": cold,
                    "host_us": host,
                    "median_ms": med, "over_old": ratio}
            out.append(case)
            print(f"  {label:<9s} {dtn:<8s} " + "  ".join(
                f"{m[12:]} " + " ".join(
                    f"{n} {med['warm'][m][n]:.4f}/{med['cold'][m][n]:.4f}/"
                    f"{med['host_us'][m][n]:.1f}" for n in libs)
                for m in MODES) + "  (warm ms/cold ms/host us)", flush=True)
            print("    plan (tile_n x split): " + "  ".join(
                f"{n} " + " ".join(
                    f"{p['tile_n']}x{p['split']}" if p else "-"
                    for p in case["plan"][n].values()) for n in libs),
                flush=True)
            del x, w, g, want
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


def masked_steps(dev, libs, steps: int) -> list:
    """Phase 11's block-sparse step with each library in turns: the
    median step ms, then a profile (kernel ms per step, the block-sparse
    kernels' ms, idle share)."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.core import masking, segment
    from torchpruner_tpu_torch.core.pruner import score_drop_indices
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.experiments.prune_trace import _profile
    from torchpruner_tpu_torch.models import bert_base
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    model = bert_base()
    params, state = segment.init_model(model, 0, device=dev)
    rng = np.random.default_rng(0)
    drops = {f"block{i}_mlp/fc1": score_drop_indices(
        rng.normal(size=3072), policy="fraction", fraction=0.5,
        granularity=128) for i in range(1, 13)}
    masks, _ = masking.drop_masks(model, params, drops, state=state)
    tx = optim.chain(optim.adam(1e-4), masking.masked_update(masks))
    trainer = Trainer.create(
        model, tx, cross_entropy_loss, seed=0,
        params=masking.apply_masks(params, masks), state=state,
        compute_dtype=torch.bfloat16, device=dev,
        param_transform=masking.blocksparse_transform(model, drops))
    batches = load_dataset("glue_sst2", "train", n=32 * (steps + 1),
                           seed=0).batches(32)
    out = []
    for name in ORDER:
        with bound_library(LIB, libs[name]):
            trainer.step(*batches[0])
            walls = []
            for x, y in batches[1:steps + 1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step(x, y)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            x, y = batches[0]
            prof = _profile(lambda: trainer.step(x, y), 2)
        out.append({"kernel": name,
                    "step_ms_median": statistics.median(walls),
                    "profile_wall_ms": prof["wall_ms"],
                    "kernel_ms": prof["kernel_ms"],
                    "device_idle_share": prof["device_idle_share"],
                    "blocksparse_ms": {
                        m: prof["by_group"].get(m, {}).get("ms", 0.0)
                        for m in MODES}})
        t = out[-1]
        print(f"    {name}: step {t['step_ms_median']:.2f} ms, kernels "
              f"{t['kernel_ms']:.2f} ms, idle {t['device_idle_share']:.3f}, "
              "block-sparse " + " / ".join(
                  f"{v:.3f}" for v in t["blocksparse_ms"].values())
              + " ms", flush=True)
    del trainer, params
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="an earlier (or edited) kernel source beside its "
                         "own revision's headers (_archive/REV/NAME.cu, "
                         "from python -m "
                         "torchpruner_tpu_torch.experiments._ab REV)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated labels of BS_CASES and MFU_CASES "
                         "(default: all)")
    ap.add_argument("--out", default="logs/blocksparse_ab.json")
    ap.add_argument("--steps", type=int, default=8,
                    help="timed masked steps per turn")
    ap.add_argument("--no-steps", action="store_true",
                    help="skip the phase 11 step turns")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.utils.device import strict_fp32_matmul

    if not torch.cuda.is_available():
        print("blocksparse_ab: needs a CUDA device", file=sys.stderr)
        return 2
    strict_fp32_matmul()
    dev = torch.device("cuda")
    smi = CS.smi_line()
    every = CS.BS_CASES + MFU_CASES
    cases = every if args.cases is None else tuple(
        c for c in every if c[0] in args.cases.split(","))
    info = _build.build([LIB])[LIB]
    old_lib, old_s = build_library(args.old, f"{LIB}_old")
    libs = {"old": old_lib, "new": _build.library(LIB)}
    print(f"card: {smi}; built new {info['seconds']:.2f} s, old "
          f"{old_s:.2f} s", flush=True)
    result = {"card": smi, "old": args.old,
              "cases": kernel_cases(dev, libs, cases,
                                    args.dtypes.split(","))}
    if not args.no_steps:
        print("  phase 11 masked steps:", flush=True)
        result["masked_steps"] = masked_steps(dev, libs, args.steps)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"card": smi, "over_old": {
        f"{c['label']} {c['dtype']}": c["over_old"]
        for c in result["cases"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
