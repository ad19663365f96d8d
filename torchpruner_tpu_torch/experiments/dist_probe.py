"""Which collectives a card's process groups take: every collective the
distribution layer (``parallel/``) issues, on CUDA tensors, in three
worlds on the card — NCCL with one rank, gloo with two ranks sharing
the card, NCCL with two ranks sharing it.  Each rank prints ``ok`` or
the error per collective, and whether ``init_device_mesh`` builds.

Run on a machine with a GPU::

    python -m torchpruner_tpu_torch.experiments.dist_probe

It is how ``parallel/mesh.py backend_for`` was chosen: NCCL refuses two
ranks on one device, gloo takes CUDA tensors for every collective used.
It also probes the exchanges of sequence and pipeline parallelism:
``all_to_all_single`` with even and with uneven splits, ``all_to_all``
and a ``batch_isend_irecv`` cyclic shift (``parallel/collectives.py
all_to_all`` / ``ppermute``).
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

    def save():
        # after every probe: a probe that aborts the process (gloo's
        # point-to-point on CUDA tensors can) leaves the results before it
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)

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
            save()

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
        # the sequence- and pipeline-parallel exchanges (parallel/ring.py,
        # ulysses.py, pp_spmd.py): all-to-all in both forms, and a cyclic
        # shift rank i -> i+1 posted in both directions at once
        probe("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty(4 * n, device=dev),
            torch.arange(4 * n, dtype=torch.float32, device=dev)))
        probe("all_to_all", lambda: dist.all_to_all(
            [torch.empty(4, device=dev) for _ in range(n)],
            [torch.full((4,), float(r), device=dev) for r in range(n)]))

        def shift():
            got = torch.empty(8, device=dev)
            ops = [dist.P2POp(dist.isend, torch.full((8,), float(rank),
                                                     device=dev),
                              (rank + 1) % n),
                   dist.P2POp(dist.irecv, got, (rank - 1) % n)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            if int(got[0].item()) != (rank - 1) % n:
                raise RuntimeError(f"received {got[0].item()}")

        def uneven():
            # collectives.shift: the whole buffer to rank + 1, nothing to
            # the others, so the splits differ from rank to rank
            send, recv = [0] * n, [0] * n
            send[(rank + 1) % n] = recv[(rank - 1) % n] = 8
            got = torch.empty(8, device=dev)
            dist.all_to_all_single(
                got, torch.full((8,), float(rank), device=dev),
                output_split_sizes=recv, input_split_sizes=send)
            if int(got[0].item()) != (rank - 1) % n:
                raise RuntimeError(f"received {got[0].item()}")

        if n > 1:
            probe("all_to_all_single_uneven", uneven)
        try:
            from torch.distributed.device_mesh import init_device_mesh

            res["device_mesh"] = str(init_device_mesh(
                "cuda", (n,), mesh_dim_names=("data",)))
        except Exception as e:  # noqa: BLE001 - the probe's result
            res["device_mesh"] = f"{type(e).__name__}: {str(e)[:200]}"
        save()
        if n > 1:  # last: under gloo it can abort the process
            probe("batch_isend_irecv", shift)
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - the probe's result
        res["init"] = f"{type(e).__name__}: {str(e)[:300]}"
    save()


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
                    line = "no output"
                print(backend, world, r, line, f"exit code {p.exitcode}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
