"""Prune-round anatomy: where one round of the ``bert_glue_sensitivity``
preset, and one retrain step, spend their time on the GPU.

Builds the preset's model and data at full width (BERT-base, the
``glue_sst2`` synthetic fallback, seeded init) and measures:

- ``round``: one prune round on ``--target`` as ``run_prune_retrain``
  runs it, after a first round on ``block12_mlp/fc1`` that pays the
  kernel build and first-call costs (``first_round``), stage by stage,
  each ended by a synchronize: scoring
  (Sensitivity over the preset's ``score_examples``), the evaluation
  over the test split, the prune (plan and slicing) and ``model_cost``;
- ``scoring_batch`` / ``retrain_step``: ``torch.profiler`` over
  ``--steps`` scoring batches (a forward with a perturb tap and its
  backward, f32, at the preset's ``eval_batch_size``) and over
  ``--steps`` bf16 retrain steps (``batch_size``): host wall per batch
  or step, the summed device time of its kernels by group (the flash
  kernels, matrix products, everything else), the kernel count, and the
  device's idle share ``1 - kernel time / wall``.

Prints one JSON line.  Runs on ``cuda``; there is no CPU mode.

Run: ``python -m torchpruner_tpu_torch.experiments.prune_trace
[--target block6_mlp/fc1] [--steps 3]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from torchpruner_tpu_torch.experiments.step_trace import _device_us

#: kernel-name fragments by group: the port's flash kernels
#: (csrc/flash_attention.cu) and the library's matrix products
GROUPS = {"flash_fwd": ("fwd_kernel", "fwd_tc"),
          "flash_dq": ("dq_kernel", "dq_tc"),
          "flash_dkv": ("dkv_kernel", "dkv_tc"),
          "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet")}


def _group(name: str) -> str:
    for group, frags in GROUPS.items():
        if any(f in name for f in frags):
            return group
    return "other"


def _profile(fn, steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    rows = [e for e in prof.key_averages() if _device_us(e) > 0
            and e.device_type is not None and "CUDA" in str(e.device_type)]
    kernel_ms = sum(_device_us(e) for e in rows) / 1e3 / steps
    groups: dict = {}
    for e in rows:
        g = groups.setdefault(_group(e.key), {"kernels": 0.0, "ms": 0.0})
        g["kernels"] += e.count / steps
        g["ms"] += _device_us(e) / 1e3 / steps
    wall = sorted(walls)[len(walls) // 2]
    return {"wall_ms": wall, "kernel_ms": kernel_ms,
            "device_idle_share": max(0.0, 1.0 - kernel_ms / wall),
            "kernels": sum(e.count for e in rows) / steps,
            "by_group": groups}


def run(target: str = "block6_mlp/fc1", steps: int = 3) -> dict:
    import torch

    from torchpruner_tpu_torch.attributions.activation import grad_rows_fn
    from torchpruner_tpu_torch.core.pruner import prune, score_drop_indices
    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        build_metric,
        make_optimizer,
        resolve_model_and_data,
    )
    from torchpruner_tpu_torch.train.loop import Trainer, to_device
    from torchpruner_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32_matmul,
    )
    from torchpruner_tpu_torch.utils.flops import model_cost

    dev = resolve_device(None)
    strict_fp32_matmul()
    cfg = get_preset("bert_glue_sensitivity")
    model, (train, val, test) = resolve_model_and_data(cfg)
    loss_fn = LOSS_REGISTRY[cfg.loss]
    trainer = Trainer.create(model, make_optimizer(cfg), loss_fn,
                             seed=cfg.seed, compute_dtype=torch.bfloat16,
                             device=dev)
    val_b = val.batches(cfg.eval_batch_size)
    test_b = test.batches(cfg.eval_batch_size)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def one_round(t: str) -> dict:
        metric = build_metric(cfg.method, model, trainer.params, val_b,
                              loss_fn)
        scores, t_score = timed(lambda: metric.run(
            t, find_best_evaluation_layer=cfg.find_best_evaluation_layer))
        _, t_eval = timed(lambda: trainer.evaluate(test_b))
        drop = score_drop_indices(scores, policy=cfg.policy,
                                  fraction=cfg.fraction)
        res, t_prune = timed(lambda: prune(model, trainer.params, t, drop,
                                           opt_state=trainer.opt_state))
        _, t_cost = timed(lambda: model_cost(res.model, res.params))
        return {"target": t, "scoring_s": t_score, "eval_s": t_eval,
                "prune_s": t_prune, "model_cost_s": t_cost,
                "score_examples": len(val), "eval_examples": len(test)}

    # the first round pays the kernel build and first-call costs; the
    # measured round is the second, on the full-width model again
    first = one_round("block12_mlp/fc1")
    rnd = one_round(target)

    rows = grad_rows_fn(model, target, loss_fn, cfg.method)
    xs, ys = (to_device(a, dev) for a in val_b[0])
    scoring = _profile(lambda: rows(trainer.params, {}, xs, ys), steps)
    xt, yt = train.batches(cfg.batch_size)[0]
    retrain = _profile(lambda: trainer.step(xt, yt), steps)
    return {"preset": cfg.name, "model": cfg.model, "round": rnd,
            "first_round": first,
            "scoring_batch": {"batch": cfg.eval_batch_size, **scoring},
            "retrain_step": {"batch": cfg.batch_size, "dtype": "bfloat16",
                             **retrain},
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch.experiments.prune_trace",
        description="time one prune round and one retrain step of the "
                    "bert_glue_sensitivity preset at full width on the GPU")
    p.add_argument("--target", default="block6_mlp/fc1")
    p.add_argument("--steps", type=int, default=3)
    a = p.parse_args(argv)
    print(json.dumps(run(a.target, a.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
