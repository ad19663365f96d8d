"""``python -m torchpruner_tpu_torch serve`` — counterpart of
``torchpruner_tpu/serve/frontend.py`` in its ``--synthetic`` mode.

Serves N open-loop synthetic requests through :class:`ServeEngine` and
prints a JSON summary line.  ``--verify`` re-decodes every request alone
through ``generate()`` at the engine's cache length and asks for equal
tokens — the continuous-batching correctness contract.  Runs on ``cuda``
unless ``--cpu`` is given; without a GPU and without ``--cpu`` it fails.

Example::

    python -m torchpruner_tpu_torch serve llama3_ffn_taylor --smoke \\
        --synthetic 8 --verify

The HTTP and stdin front ends, hot-swap, SLO monitoring and the telemetry
plane of the JAX frontend are later slices.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def serve_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch serve",
        description="continuous-batching inference engine (PyTorch/CUDA "
                    "port): synthetic open-loop traffic, optional solo "
                    "replay verification")
    p.add_argument("preset", help="preset name (its model is served) or a "
                                  "MODEL_REGISTRY model name")
    p.add_argument("--smoke", action="store_true",
                   help="the preset's miniature model variant")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode slot-array width")
    p.add_argument("--max-len", type=int, default=256,
                   help="KV positions per slot (prompt + max_new cap)")
    p.add_argument("--kv-dtype", choices=("float32", "bfloat16"),
                   default="float32", help="KV-cache dtype")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", type=int, metavar="N", default=8,
                   help="serve N open-loop synthetic requests")
    p.add_argument("--prompt-lens", default="4,8,6",
                   help="comma list of prompt lengths (cycled)")
    p.add_argument("--max-new", default="8,5,12",
                   help="comma list of generation budgets (cycled)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy)")
    p.add_argument("--verify", action="store_true",
                   help="assert every request's tokens equal its solo "
                        "generate() decode")
    args = p.parse_args(argv)

    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments.presets import (
        MODEL_REGISTRY,
        preset_model,
    )
    from torchpruner_tpu_torch.serve.engine import ServeEngine
    from torchpruner_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32_matmul,
    )

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        strict_fp32_matmul()
    try:
        model_name = preset_model(args.preset, smoke=args.smoke)
    except KeyError as e:
        p.error(str(e))
    model = MODEL_REGISTRY[model_name][0]()
    params, _state = init_model(model, seed=args.seed, device=device)
    engine = ServeEngine(
        model, params, n_slots=args.slots, max_len=args.max_len,
        cache_dtype=args.kv_dtype, device=device)
    return run_synthetic(engine, args)


def run_synthetic(engine, args) -> int:
    from torchpruner_tpu_torch.serve.engine import vocab_of
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        synthetic_requests,
    )

    reqs = synthetic_requests(
        args.synthetic, vocab=vocab_of(engine.model),
        prompt_lens=[int(x) for x in args.prompt_lens.split(",") if x],
        max_new=[int(x) for x in args.max_new.split(",") if x],
        seed=args.seed, temperature=args.temperature)
    traffic = open_loop(reqs, seed=args.seed)  # deterministic staggering
    print(f"serve: engine loop starting ({len(reqs)} synthetic requests, "
          f"{engine.n_slots} slots, {engine.device})", file=sys.stderr,
          flush=True)
    summary = engine.run(traffic)
    if args.verify:
        summary["verify_mismatches"] = verify_against_solo(engine)
        if summary["verify_mismatches"]:
            print(json.dumps(summary))
            print(f"VERIFY FAILED: {summary['verify_mismatches']} requests "
                  "diverged from solo decode", file=sys.stderr)
            return 1
    print(json.dumps(summary))
    return 0


def verify_against_solo(engine) -> int:
    """Replay every completed request alone through ``generate`` at the
    engine's cache length and count those whose tokens differ."""
    from torchpruner_tpu_torch.generate import generate

    mismatches = 0
    for r in engine.results():
        s = r.sampling
        P = engine.programs
        want = generate(
            P.model, P.params, r.prompt_ids[None], r.max_new,
            temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
            rng=torch.Generator().manual_seed(int(s.seed)),
            cache_dtype=P.cache_dtype, max_len=P.max_len,
            device=engine.device)
        got = np.asarray(r.tokens, np.int64)
        if not np.array_equal(got, want.cpu().numpy()[0][:len(got)]):
            mismatches += 1
    return mismatches


if __name__ == "__main__":
    sys.exit(serve_main())
