"""``python -m torchpruner_tpu_torch`` — the port's CLI.

    --preset NAME [--smoke] [--cpu]     run a named preset: the
                                        prune(-retrain) loop, training, the
                                        robustness sweep or training then
                                        the sweep, as its ``experiment``
                                        says
    --config PATH [--cpu]               run an ExperimentConfig JSON
    --list                              list the presets
    --dump-config PATH                  write the resolved config, exit
    serve <preset> [--smoke] [--cpu] --synthetic N [--verify] ...
        the continuous-batching engine on synthetic traffic
        (torchpruner_tpu_torch/serve/frontend.py)

Each experiment prints one JSON summary line, as the JAX package's CLI
does (the sweeps: their AUC summary).  Everything runs on the CUDA
device unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from torchpruner_tpu_torch.serve.frontend import serve_main

        return serve_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch",
        description="structured pruning experiments on PyTorch/CUDA "
                    "(subcommand: serve — the continuous-batching engine)")
    p.add_argument("target", nargs="?", default=None,
                   help="preset name or config JSON path (shorthand for "
                        "--preset / --config)")
    p.add_argument("--preset", help="named preset (see --list)")
    p.add_argument("--config", help="path to an ExperimentConfig JSON")
    p.add_argument("--smoke", action="store_true",
                   help="miniature model/data variants")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--list", action="store_true",
                   help="list presets and exit")
    p.add_argument("--dump-config", metavar="PATH",
                   help="write the resolved config JSON to PATH and exit")
    args = p.parse_args(argv)
    if args.target:
        if args.preset or args.config:
            p.error("give the experiment either positionally or via "
                    "--preset/--config, not both")
        if args.target.endswith(".json"):
            args.config = args.target
        else:
            args.preset = args.target

    from torchpruner_tpu_torch.experiments.presets import PRESETS, get_preset
    from torchpruner_tpu_torch.utils.config import ExperimentConfig

    if args.list:
        for name, fn in PRESETS.items():
            print(f"{name:26s} {fn.__doc__.splitlines()[0]}")
        return 0
    if args.config:
        cfg = ExperimentConfig.from_json(args.config)
    elif args.preset:
        cfg = get_preset(args.preset, smoke=args.smoke)
    else:
        p.error("one of --preset / --config / --list is required")
    if args.dump_config:
        cfg.to_json(args.dump_config)
        print(f"wrote {args.dump_config}")
        return 0

    print(json.dumps(run_experiment(cfg, "cpu" if args.cpu else None)))
    return 0


def run_experiment(cfg, device=None) -> dict:
    """Run ``cfg`` by its ``experiment`` and return the summary the CLI
    prints."""
    if cfg.experiment == "robustness":
        from torchpruner_tpu_torch.experiments.robustness import (
            run_robustness_config,
        )

        return run_robustness_config(cfg, device=device)
    if cfg.experiment == "train_robustness":
        from torchpruner_tpu_torch.experiments.robustness import (
            run_train_robustness,
        )

        return run_train_robustness(cfg, device=device)
    if cfg.experiment == "train":
        from torchpruner_tpu_torch.experiments.train_model import run_train

        _, history = run_train(cfg, device=device)
        last = history[-1] if history else None
        return {"experiment": cfg.name, "epochs": len(history),
                "final_test_acc": last["test_acc"] if last else None,
                "final_test_loss": last["test_loss"] if last else None}
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        run_prune_retrain,
    )

    history = run_prune_retrain(cfg, device=device)
    last = history[-1] if history else None
    return {"experiment": cfg.name, "steps": len(history),
            "final_acc": last.post_acc if last else None,
            "final_params": last.n_params if last else None}


if __name__ == "__main__":
    sys.exit(main())
