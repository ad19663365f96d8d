"""Decode-step anatomy: where one slot-array decode step's time goes.

Counterpart of ``torchpruner_tpu/experiments/step_trace.py`` for the
serving path: builds Llama-3-8B at int4 (or int8) weights, fills a
``(slots, max_len)`` bf16 KV cache, and times one decode step of the slot
array (the model walk ``generate._decode_seq`` at ``slots`` rows, each at
its own position) two ways:

- ``wall_ms``: host wall time of the step with a synchronize after it
  (median of five);
- ``profiler``: ``torch.profiler`` over ``--steps`` steps: the summed
  self device time of every kernel per step, the kernel count, the split
  between the port's CUDA kernels and the plain PyTorch ops, and the
  kernels ranked by device time.

The device's idle share of the step is ``1 - kernel time / wall``.  Prints
one JSON line.  Runs on ``cuda``; there is no CPU mode.

Run: ``python -m torchpruner_tpu_torch.experiments.step_trace
[--bits 4] [--depth 32] [--slots 4] [--max-len 512] [--steps 3]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


#: kernel-name fragments of the port's hand-written kernels (csrc/*.cu;
#: ``decode_attn``: the one-CTA-per-row decode body of an older source)
PORT_KERNELS = {"dequant_matmul": ("dq_mma",),
                "decode_attention": ("decode_split", "decode_attn")}


def _group(name: str) -> str:
    for group, frags in PORT_KERNELS.items():
        if any(f in name for f in frags):
            return group
    return "plain_torch"


def run(bits: int = 4, depth: int = 32, slots: int = 4, max_len: int = 512,
        steps: int = 3, reps: int = 5, top: int = 15) -> dict:
    import numpy as np
    import torch

    from torchpruner_tpu_torch.experiments.llama8b_decode import (
        quantized_random_params,
    )
    from torchpruner_tpu_torch.generate import _decode_seq, init_cache
    from torchpruner_tpu_torch.models import llama3_8b
    from torchpruner_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32_matmul,
    )

    dev = resolve_device(None)
    strict_fp32_matmul()
    model = llama3_8b(depth=depth)
    params, _ = quantized_random_params(model, bits=bits, seed=0, device=dev)
    cache = init_cache(model, slots, max_len, torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for entry in cache.values():
        for buf in entry.values():
            buf.normal_(generator=gen)
    tok = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
    # mid-run positions of a 4-slot serve of 16-100-token prompts
    pos = torch.as_tensor(np.minimum(np.arange(slots) * 20 + 60,
                                     max_len - 1).astype(np.int32),
                          device=dev)

    def step():
        _decode_seq(model.layers, params, cache, tok, pos)

    walls = []
    with torch.no_grad():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if _device_us(e) > 0
            and e.device_type is not None
            and "CUDA" in str(e.device_type)]
    kernel_ms = sum(_device_us(e) for e in rows) / 1e3 / steps
    rows.sort(key=_device_us, reverse=True)
    groups = {}
    for e in rows:
        g = groups.setdefault(_group(e.key), {"kernels_per_step": 0.0,
                                              "ms_per_step": 0.0})
        g["kernels_per_step"] += e.count / steps
        g["ms_per_step"] += _device_us(e) / 1e3 / steps
    out = {
        "bits": bits, "depth": depth, "slots": slots, "max_len": max_len,
        "pos": pos.tolist(),
        "wall_ms": wall,
        "profiler_kernel_ms": kernel_ms,
        "device_idle_share": (max(0.0, 1.0 - kernel_ms / wall)
                              if kernel_ms > 0 else None),
        "profiler_kernels_per_step": sum(e.count for e in rows) / steps,
        "by_group": groups,
        "top_kernels": [
            {"name": e.key[:120], "calls_per_step": e.count / steps,
             "ms_per_step": _device_us(e) / 1e3 / steps}
            for e in rows[:top]],
        "card": torch.cuda.get_device_name(0),
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch.experiments.step_trace",
        description="time and profile one slot-array decode step of "
                    "Llama-3-8B at quantized weights on the GPU")
    p.add_argument("--bits", type=int, choices=(4, 8), default=4)
    p.add_argument("--depth", type=int, default=32)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=15)
    a = p.parse_args(argv)
    print(json.dumps(run(a.bits, a.depth, a.slots, a.max_len, a.steps,
                         top=a.top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
