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

With ``--masked`` it measures the masked retrain step instead: half the
128-blocks of every ``block{i}_mlp/fc1`` dropped by seeded random block
scores, the params masked, ``masked_update`` chained after Adam, bf16 at
B 32, with the block-sparse kernels
(``param_transform=blocksparse_transform``) and masked dense (no
transform): the median wall of ``--masked`` steps, each ended by a
synchronize, in turns (masked dense, block-sparse, block-sparse, masked
dense) so that drift shows, and the same profile over ``--steps`` steps
of each, the three block-sparse kernels in groups of their own.

Prints one JSON line.  Runs on ``cuda``; there is no CPU mode.

Run: ``python -m torchpruner_tpu_torch.experiments.prune_trace
[--target block6_mlp/fc1] [--steps 3] [--masked 30]``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time

from torchpruner_tpu_torch.experiments.step_trace import _device_us

#: kernel-name fragments by group: the port's flash kernels
#: (csrc/flash_attention.cu; ``fwd_kernel`` / ``dkv_kernel``: the f32 FMA
#: bodies before ``*_tf32x3``, and ``fwd_tc`` / ``dq_tc`` / ``dkv_tc``:
#: the earlier bf16 wmma bodies, which ``flash_ab.py`` builds from older
#: sources) and the library's matrix products
GROUPS = {"flash_fwd": ("fwd_kernel", "fwd_tf32x3", "fwd_wgmma", "fwd_tc"),
          "flash_dq": ("dq_kernel", "dq_wgmma", "dq_tc"),
          "flash_dkv": ("dkv_kernel", "dkv_tf32x3", "dkv_wgmma", "dkv_tc"),
          "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet")}
#: csrc/blocksparse_matmul.cu: ``bs_kernel<T, MODE, ...>`` and
#: ``bs_wgmma<MODE, ...>``, MODE 0 forward, 1 dx, 2 dW
_BS_MODE = re.compile(r"bs_(?:kernel<[^,]*, *|wgmma<)(?:\([^)]*\))?(\d)")
_BS_NAMES = ("blocksparse_fwd", "blocksparse_dx", "blocksparse_dw")


def _group(name: str) -> str:
    m = _BS_MODE.search(name)
    if m:
        return _BS_NAMES[int(m.group(1))]
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


def run_masked(n_steps: int = 30, steps: int = 3) -> dict:
    import numpy as np
    import torch

    from torchpruner_tpu_torch.core import masking, segment
    from torchpruner_tpu_torch.core.pruner import score_drop_indices
    from torchpruner_tpu_torch.data import load_dataset
    from torchpruner_tpu_torch.models import bert_base
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32_matmul,
    )
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    dev = resolve_device(None)
    strict_fp32_matmul()
    model = bert_base()
    params, state = segment.init_model(model, 0, device=dev)
    rng = np.random.default_rng(0)
    drops = {f"block{i}_mlp/fc1": score_drop_indices(
        rng.normal(size=3072), policy="fraction", fraction=0.5,
        granularity=128) for i in range(1, 13)}
    masks, _ = masking.drop_masks(model, params, drops, state=state)
    start = masking.apply_masks(params, masks)
    tx = optim.chain(optim.adam(1e-4), masking.masked_update(masks))
    batches = load_dataset("glue_sst2", "train", n=32 * n_steps,
                           seed=0).batches(32)[:n_steps]
    trainers = {name: Trainer.create(
        model, tx, cross_entropy_loss, seed=0, params=start, state=state,
        compute_dtype=torch.bfloat16, device=dev, param_transform=tf)
        for name, tf in (
            ("masked_dense", None),
            ("blocksparse", masking.blocksparse_transform(model, drops)))}

    def median_step_ms(t: Trainer) -> float:
        walls = []
        for x, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.step(x, y)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls[1:] or walls)

    for t in trainers.values():  # kernel build and first-call costs
        t.step(*batches[0])
    turns = [{"path": name, "step_ms_median": median_step_ms(trainers[name])}
             for name in ("masked_dense", "blocksparse", "blocksparse",
                          "masked_dense")]
    x0, y0 = batches[0]
    prof = {name: _profile(lambda t=t: t.step(x0, y0), steps)
            for name, t in trainers.items()}
    return {"model": "bert_base", "batch": 32, "seq": 128,
            "dtype": "bfloat16", "steps": turns, "profile": prof,
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch.experiments.prune_trace",
        description="time one prune round and one retrain step of the "
                    "bert_glue_sensitivity preset at full width on the GPU")
    p.add_argument("--target", default="block6_mlp/fc1")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--masked", type=int, default=0, metavar="N",
                   help="time N masked retrain steps, block-sparse against "
                        "masked dense, instead of the prune round")
    a = p.parse_args(argv)
    out = run_masked(a.masked, a.steps) if a.masked \
        else run(a.target, a.steps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
