"""A/B of two flash-attention kernel sources on the card, in turns old,
new, new, old.

Builds ``--old`` (an earlier ``csrc/flash_attention.cu`` with the same C
entries ``tp_flash_fwd`` / ``tp_flash_dq`` / ``tp_flash_dkv``) into a
second library beside the package's own, binds the wrappers of
``ops/flash_attention.py`` to each library in turn, and compares, in one
process on one card:

- every phase 6 case of ``chip_smoke.py`` (``FLASH_CASES``): CUDA-event
  ms of the forward, dQ and dK/dV launches of each library on the same
  inputs, and each library's max abs error against autograd of the plain
  version in f32;
- phase 9: mfu_llama causal training steps (B 8, S 1024, bf16, Adam):
  the median step ms (each step ended by a synchronize) and, under
  ``torch.profiler``, the kernel ms per step, the flash kernels' ms and
  the device's idle share;
- phase 8: the BERT-base bf16 retrain step (B 32) of the
  ``bert_glue_sensitivity`` preset, measured the same way;
- phase 7's scoring: ``prune_trace.py``'s f32 scoring batch of that
  preset (B 128, Sensitivity on ``SCORING_TARGET``) measured the same
  way, and the Sensitivity scores of ``SCORING_TARGET`` over the
  preset's score examples through each library and through the plain
  attention route
  (``impl="xla"``): the largest score difference relative to the plain
  route's largest score, whether the fraction policy's drop set equals
  the plain route's, and for each unit that differs its distance from
  the plain route's cut, relative to the same scale.

Writes the whole result to ``--out`` (JSON) and prints a summary: for
each case and kernel the median of the new library's turns over the
median of the old's.

Run from the root of a checkout on the card, with the earlier revision's
``csrc/`` extracted into the git-ignored ``_archive/`` (``python -m
torchpruner_tpu_torch.experiments._ab REV``):
``python -m torchpruner_tpu_torch.experiments.flash_ab --old
_archive/REV/flash_attention.cu [--out logs/flash_ab.json] [--steps 6]
[--no-steps]``.
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

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
#: the ``fc1`` whose scores the scoring leg compares
SCORING_TARGET = "block6_mlp/fc1"


def kernel_cases(dev, libs) -> list:
    """Phase 6's cases: each library's errors against the plain version
    and its CUDA-event ms per kernel, in turns."""
    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import flash_attention as FA

    cases = []
    for label, B, S, H, Dh, dtn, causal, *rest in CS.FLASH_CASES:
        layout = rest[0] if rest else "bshd"
        dtype = getattr(torch, dtn)
        gen = torch.Generator(device=dev).manual_seed(S + Dh)
        q, k, v, g = (torch.randn((B, S, H, Dh), generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        q, k, v = CS.flash_layout(q, k, v, layout)
        ref = [t.float().requires_grad_() for t in (q, k, v)]
        r_out, r_lse = FA.flash_attention_plain(*ref, causal=causal,
                                                with_lse=True)
        want = {"out": r_out.detach(), "lse": r_lse.detach(),
                **dict(zip(("dq", "dk", "dv"), torch.autograd.grad(
                    r_out, ref, g.float())))}
        del ref, r_out, r_lse
        errs, times, inputs = {}, {k_: {n: [] for n in libs}
                                   for k_ in KERNELS}, {}
        for name, lib in libs.items():
            with bound_library("flash_attention", lib):
                o, lse = FA.flash_fwd(q, k, v, causal=causal, with_lse=True)
                dq, delta = FA.flash_dq(q, k, v, o, g, lse, causal=causal)
                dk, dv = FA.flash_dkv(q, k, v, g, lse, delta, causal=causal)
            torch.cuda.synchronize()
            got = {"out": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
            errs[name] = {key: float((got[key].float() - want[key]).abs()
                                     .max()) for key in got}
            inputs[name] = (o, lse, delta)
        o, lse, delta = inputs["new"]
        launch = {
            "flash_fwd": lambda i: FA.flash_fwd(q, k, v, causal=causal,
                                                with_lse=True),
            "flash_dq": lambda i: FA.flash_dq(q, k, v, o, g, lse,
                                              causal=causal),
            "flash_dkv": lambda i: FA.flash_dkv(q, k, v, g, lse, delta,
                                                causal=causal)}
        for name in ORDER:
            with bound_library("flash_attention", libs[name]):
                for kern in KERNELS:
                    times[kern][name].append(CS.event_ms(launch[kern], 20))
        ratio = {kern: statistics.median(times[kern]["new"])
                 / statistics.median(times[kern]["old"]) for kern in KERNELS}
        case = {"label": label, "B": B, "S": S, "H": H, "Dh": Dh,
                "dtype": dtn, "causal": causal, "layout": layout,
                "route": None if dtn == "float32"
                else FA.copy_route(q, k, v, g),
                "max_abs_err": errs, "ms": times, "new_over_old": ratio}
        cases.append(case)
        print(f"  {label:<20s} " + "  ".join(
            f"{kern[6:]} old {statistics.median(times[kern]['old']):.4f} "
            f"new {statistics.median(times[kern]['new']):.4f} "
            f"({ratio[kern]:.3f}x)" for kern in KERNELS), flush=True)
        del q, k, v, g, want, inputs, o, lse, delta
        torch.cuda.empty_cache()
    return cases


def step_turns(trainer, batches, libs, steps: int) -> list:
    """Steps of ``trainer`` with each library in turns: the median step
    ms, then a profile (kernel ms per step, flash groups, idle share)."""
    import torch

    from torchpruner_tpu_torch.experiments.prune_trace import _profile

    out = []
    for name in ORDER:
        with bound_library("flash_attention", libs[name]):
            walls = []
            for x, y in batches[:steps]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step(x, y)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            x, y = batches[0]
            prof = _profile(lambda: trainer.step(x, y), 2)
        out.append({"kernel": name,
                    "step_ms_median": statistics.median(walls[1:] or walls),
                    "profile_wall_ms": prof["wall_ms"],
                    "kernel_ms": prof["kernel_ms"],
                    "device_idle_share": prof["device_idle_share"],
                    "flash_ms": {g: prof["by_group"].get(g, {}).get("ms", 0.0)
                                 for g in KERNELS}})
        t = out[-1]
        print(f"    {name}: step {t['step_ms_median']:.2f} ms, kernels "
              f"{t['kernel_ms']:.2f} ms, idle {t['device_idle_share']:.3f}, "
              "flash " + " / ".join(f"{v:.3f}" for v in t["flash_ms"].values())
              + " ms", flush=True)
    return out


def causal_steps(dev, libs, steps: int) -> list:
    """Phase 9's set-up: mfu_llama, B 8, S 1024, bf16, Adam."""
    import torch

    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.models import mfu_llama
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.losses import lm_cross_entropy_loss

    batches = load_dataset("lm_mfu", "train", n=8 * steps,
                           seed=0).batches(8)
    trainer = Trainer.create(mfu_llama(), optim.adam(1e-4),
                             lm_cross_entropy_loss, seed=0,
                             compute_dtype=torch.bfloat16, device=dev)
    trainer.step(*batches[0])
    out = step_turns(trainer, batches, libs, steps)
    del trainer
    torch.cuda.empty_cache()
    return out


def retrain_steps(dev, libs, steps: int) -> list:
    """Phase 8's step: BERT-base, the preset's optimizer, bf16, B 32."""
    import torch

    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        make_optimizer,
        resolve_model_and_data,
    )
    from torchpruner_tpu_torch.train.loop import Trainer

    cfg = get_preset("bert_glue_sensitivity")
    model, (train, _, _) = resolve_model_and_data(cfg)
    trainer = Trainer.create(model, make_optimizer(cfg),
                             LOSS_REGISTRY[cfg.loss], seed=cfg.seed,
                             compute_dtype=torch.bfloat16, device=dev)
    batches = train.batches(cfg.batch_size)
    trainer.step(*batches[0])
    out = step_turns(trainer, batches, libs, steps)
    del trainer
    torch.cuda.empty_cache()
    return out


def plain_attention(model):
    """``model`` with every attention layer on the plain einsum core
    (``impl="xla"``), which launches no flash kernel."""
    import dataclasses

    from torchpruner_tpu_torch.core import layers as L

    def fix(spec):
        if isinstance(spec, L.MultiHeadAttention):
            return dataclasses.replace(spec, impl="xla")
        if isinstance(spec, L.Residual):
            return dataclasses.replace(
                spec, body=tuple(map(fix, spec.body)),
                shortcut=tuple(map(fix, spec.shortcut)))
        return spec

    return dataclasses.replace(model, layers=tuple(map(fix, model.layers)))


def scoring_leg(dev, libs, steps: int) -> dict:
    """Phase 7's scoring (the preset's model, f32): the scoring batch in
    turns, then ``SCORING_TARGET``'s Sensitivity scores and drop set
    through each library against the plain attention route."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.attributions.activation import grad_rows_fn
    from torchpruner_tpu_torch.core.pruner import score_drop_indices
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        build_metric,
        resolve_model_and_data,
    )
    from torchpruner_tpu_torch.experiments.prune_trace import _profile
    from torchpruner_tpu_torch.train.loop import to_device

    cfg = get_preset("bert_glue_sensitivity")
    model, (_, val, _) = resolve_model_and_data(cfg)
    loss_fn = LOSS_REGISTRY[cfg.loss]
    params, _ = init_model(model, cfg.seed, device=dev)
    val_b = val.batches(cfg.eval_batch_size)
    rows = grad_rows_fn(model, SCORING_TARGET, loss_fn, cfg.method)
    xs, ys = (to_device(a, dev) for a in val_b[0])
    batch = []
    for name in ORDER:
        with bound_library("flash_attention", libs[name]):
            prof = _profile(lambda: rows(params, {}, xs, ys), steps)
        batch.append({"kernel": name, "wall_ms": prof["wall_ms"],
                      "kernel_ms": prof["kernel_ms"],
                      "device_idle_share": prof["device_idle_share"],
                      "flash_ms": {g: prof["by_group"].get(g, {}).get(
                          "ms", 0.0) for g in KERNELS}})
        t = batch[-1]
        print(f"    {name}: scoring batch {t['wall_ms']:.2f} ms, kernels "
              f"{t['kernel_ms']:.2f} ms, idle {t['device_idle_share']:.3f}, "
              "flash " + " / ".join(f"{v:.3f}" for v in t["flash_ms"].values())
              + " ms", flush=True)

    def scores(m, lib=None) -> np.ndarray:
        metric = build_metric(cfg.method, m, params, val_b, loss_fn)
        run = lambda: metric.run(  # noqa: E731
            SCORING_TARGET,
            find_best_evaluation_layer=cfg.find_best_evaluation_layer)
        if lib is None:
            return np.asarray(run(), np.float64)
        with bound_library("flash_attention", lib):
            return np.asarray(run(), np.float64)

    plain = scores(plain_attention(model))
    scale = float(np.abs(plain).max())
    drop = set(score_drop_indices(plain, policy=cfg.policy,
                                  fraction=cfg.fraction).tolist())
    ranked = np.sort(plain)
    cut = 0.5 * (ranked[len(drop) - 1] + ranked[len(drop)])
    out = {"target": SCORING_TARGET, "batch": batch,
           "plain_drop": len(drop), "score_scale": scale}
    for name in ("new", "old"):
        got = scores(model, libs[name])
        d = set(score_drop_indices(got, policy=cfg.policy,
                                   fraction=cfg.fraction).tolist())
        differ = sorted(d ^ drop)
        out[name] = {
            "max_rel_score_diff": float(np.abs(got - plain).max()) / scale,
            "drop_set_equal": not differ,
            "differing_units": {int(u): float(abs(plain[u] - cut)) / scale
                                for u in differ}}
        print(f"    {name}: {SCORING_TARGET} Sensitivity vs plain route: "
              f"max rel diff {out[name]['max_rel_score_diff']:.3g}, drop set "
              f"{'equal' if not differ else 'differs'}"
              + "".join(f", unit {u} {r:.3g} from the cut"
                        for u, r in out[name]["differing_units"].items()),
              flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="an earlier kernel source beside its own revision's "
                         "headers (_archive/REV/NAME.cu, from python -m "
                         "torchpruner_tpu_torch.experiments._ab REV)")
    ap.add_argument("--out", default="logs/flash_ab.json")
    ap.add_argument("--steps", type=int, default=6,
                    help="timed training steps per turn")
    ap.add_argument("--no-steps", action="store_true",
                    help="skip the phase 8 and 9 step turns and the "
                         "scoring leg")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.utils.device import strict_fp32_matmul

    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA device", file=sys.stderr)
        return 2
    strict_fp32_matmul()
    dev = torch.device("cuda")
    smi = CS.smi_line()
    info = _build.build(["flash_attention"])["flash_attention"]
    old_lib, old_s = build_library(args.old, "flash_attention_old")
    libs = {"old": old_lib, "new": _build.library("flash_attention")}
    print(f"card: {smi}; built new {info['seconds']:.2f} s, old "
          f"{old_s:.2f} s", flush=True)
    result = {"card": smi, "cases": kernel_cases(dev, libs)}
    if not args.no_steps:
        print("  phase 9 mfu_llama steps:", flush=True)
        result["causal_steps"] = causal_steps(dev, libs, args.steps)
        print("  phase 8 retrain steps:", flush=True)
        result["retrain_steps"] = retrain_steps(dev, libs, args.steps)
        print("  phase 7 scoring:", flush=True)
        result["scoring"] = scoring_leg(dev, libs, args.steps)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"card": smi, "new_over_old": {
        c["label"]: c["new_over_old"] for c in result["cases"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
