"""ZeRO weight-update sharding, off and on — counterpart of
``torchpruner_tpu/experiments/zero_bench.py``, cut to what one host
can show: per rank, the optimizer bytes the memory plan predicts
(``parallel.memory.training_memory``) against the bytes the sharded
trainer holds, the parameter bytes likewise, the two runs' losses over
the same steps (ZeRO reorders no sum that decides a loss beyond
rounding), the step wall and the card's peak memory.

Run one process per rank under ``torchrun``::

    torchrun --standalone --nproc_per_node 2 -m \\
        torchpruner_tpu_torch.experiments.zero_bench [--model bert_base]
        [--steps 5] [--batch 32] [--cpu] [--out PATH]

The mesh is ``{"data": N}`` for N ranks (``--model-axis 2`` makes it
``{"data": N / 2, "model": 2}``).  Rank 0 prints one JSON line (and
writes ``--out``).  It fails when a rank's held bytes differ from the
plan or ZeRO does not cut the optimizer bytes to the data axis's share.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: slack of the opt-bytes invariant: replicated step counters and
#: per-leaf ceil-division padding
OPT_BYTES_SLACK = 1 << 16


def _batch(model, batch: int, step: int):
    """A seeded batch of a classifier: the model's example input, labels
    below its class count."""
    import numpy as np

    x = model.example_input(batch, seed=step, device="cpu")
    y = np.random.default_rng(step).integers(
        0, model.out_shape()[-1], size=(batch,)).astype(np.int64)
    return x, y


def _measure(model, mesh, zero: bool, args, dev) -> dict:
    import torch

    from torchpruner_tpu_torch.parallel import ShardedTrainer
    from torchpruner_tpu_torch.parallel.memory import held_bytes
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = ShardedTrainer.create(
        model, optim.adam(1e-4), cross_entropy_loss, mesh, seed=0,
        zero=zero, partition=args.partition,
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=dev)
    plan = t.memory_plan(batch_per_chip=args.batch)
    losses, times = [], []
    for i in range(args.steps):
        x, y = _batch(model, args.batch, i)
        t0 = time.perf_counter()
        losses.append(float(t.step(x, y)))  # the read waits for the step
        times.append(time.perf_counter() - t0)
    return {
        "zero": zero, "losses": losses,
        "held_params_bytes": held_bytes(t.params),
        "held_opt_bytes": held_bytes(t.opt_state),
        "planned_params_bytes": plan.params_bytes,
        "planned_opt_bytes": plan.opt_bytes,
        "step_s": sorted(times[1:])[len(times[1:]) // 2] if times[1:]
        else times[0],
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}


def run(args) -> dict:
    import torch
    import torch.distributed as dist

    from torchpruner_tpu_torch.experiments.presets import MODEL_REGISTRY
    from torchpruner_tpu_torch.parallel import make_mesh
    from torchpruner_tpu_torch.parallel.mesh import (
        initialize_distributed,
        rank_device,
        world_size,
    )

    dev = rank_device("cpu" if args.cpu else None)
    initialize_distributed(dev)
    n = world_size()
    axes = ({"data": n // args.model_axis, "model": args.model_axis}
            if args.model_axis > 1 else {"data": n})
    if axes.get("data", 1) < 2:
        raise SystemExit(f"zero_bench needs a data axis of 2 or more "
                         f"ranks (have {n}); run it under torchrun")
    mesh = make_mesh(axes, device=dev)
    model = MODEL_REGISTRY[args.model][0]()
    off = _measure(model, mesh, False, args, dev)
    on = _measure(model, mesh, True, args, dev)
    for r in (off, on):
        if (r["held_params_bytes"], r["held_opt_bytes"]) != (
                r["planned_params_bytes"], r["planned_opt_bytes"]):
            raise AssertionError(f"held bytes differ from the plan: {r}")
    share = off["planned_opt_bytes"] / axes["data"] + OPT_BYTES_SLACK
    if on["planned_opt_bytes"] > share:
        raise AssertionError(f"ZeRO opt bytes {on['planned_opt_bytes']} "
                             f"over the data axis's share {share}")
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(on["losses"], off["losses"]))
    out = {"model": args.model, "mesh": axes, "partition": args.partition,
           "batch": args.batch, "steps": args.steps,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "backend": dist.get_backend(), "off": off, "on": on,
           "loss_max_rel_diff": rel,
           "opt_bytes_ratio": on["held_opt_bytes"] / off["held_opt_bytes"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bert_base",
                    help="a classifier of the model registry")
    ap.add_argument("--partition", default="fsdp", choices=("fsdp", "tp"))
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (f32 masters)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = run(args)
    from torchpruner_tpu_torch.parallel.mesh import is_writer

    if is_writer():
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
