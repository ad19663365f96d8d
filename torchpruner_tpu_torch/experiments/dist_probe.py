"""Which collectives a card's process groups take: every collective the
distribution layer (``parallel/``) issues, on CUDA tensors, in three
worlds on the card — NCCL with one rank, gloo with two ranks sharing
the card, NCCL with two ranks sharing it.  Each rank prints ``ok`` or
the error per collective, and whether ``init_device_mesh`` builds.

Run on a machine with a GPU::

    python -m torchpruner_tpu_torch.experiments.dist_probe

It is how ``parallel/mesh.py backend_for`` was chosen: NCCL refuses two
ranks on one device, gloo takes CUDA tensors for every collective used.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile


def _worker(rank: int, world: int, backend: str, store: str,
            out: str) -> None:
    import torch
    import torch.distributed as dist

    res = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda", 0)

        def probe(name, fn):
            try:
                fn()
                torch.cuda.synchronize()
                res[name] = "ok"
            except Exception as e:  # noqa: BLE001 - the probe's result
                res[name] = f"{type(e).__name__}: {str(e)[:200]}"

        n = world
        probe("all_reduce_f32", lambda: dist.all_reduce(
            torch.ones(8, device=dev)))
        probe("all_reduce_bf16", lambda: dist.all_reduce(
            torch.ones(8, dtype=torch.bfloat16, device=dev)))
        probe("all_reduce_int64", lambda: dist.all_reduce(
            torch.ones(8, dtype=torch.int64, device=dev)))
        probe("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(8 * n, device=dev), torch.ones(8, device=dev)))
        probe("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * n, device=dev)))
        probe("broadcast", lambda: dist.broadcast(
            torch.ones(4, device=dev), 0))
        probe("barrier", dist.barrier)
        try:
            from torch.distributed.device_mesh import init_device_mesh

            res["device_mesh"] = str(init_device_mesh(
                "cuda", (n,), mesh_dim_names=("data",)))
        except Exception as e:  # noqa: BLE001 - the probe's result
            res["device_mesh"] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - the probe's result
        res["init"] = f"{type(e).__name__}: {str(e)[:300]}"
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


def main() -> int:
    import multiprocessing as mp

    import torch

    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    ctx = mp.get_context("spawn")
    for backend, world in (("nccl", 1), ("gloo", 2), ("nccl", 2)):
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "out")
            procs = [ctx.Process(target=_worker, args=(
                r, world, backend, os.path.join(d, "store"), out))
                for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(150)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            for r, p in enumerate(procs):
                try:
                    with open(f"{out}.{r}") as f:
                        line = f.read()
                except OSError:
                    line = f"no output; exit code {p.exitcode}"
                print(backend, world, r, line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
