"""``python -m torchpruner_tpu_torch`` — the port's CLI.

    --preset NAME [--smoke] [--cpu]     run a named preset: the
                                        prune(-retrain) loop, training, the
                                        robustness sweep or training then
                                        the sweep, as its ``experiment``
                                        says
    --config PATH [--cpu]               run an ExperimentConfig JSON
    --list                              list the presets
    --dump-config PATH                  write the resolved config, exit
    --obs-dir DIR [--profile-every N [--profile-steps K]] | --no-obs
                                        telemetry (below)
    serve <preset> [--smoke] [--cpu] --synthetic N [--verify] ...
        the continuous-batching engine on synthetic traffic
        (torchpruner_tpu_torch/serve/frontend.py)
    obs report DIR | diff A B [--gate G] | watch DIR | incident DIR
        | profile DIR
        render, compare and gate a run directory (obs/report.py); reads
        the JAX package's run directories too

Each experiment prints one JSON summary line, as the JAX package's CLI
does (the sweeps: their AUC summary).  Everything runs on the CUDA
device unless ``--cpu`` is given.  The run is wrapped in an obs session
(``--no-obs``: none) whose summary table goes to stderr, also when the
run crashes; ``--obs-dir`` writes the event stream, metrics, ledger,
report and trace, and ``--profile-every N`` opens a ``torch.profiler``
capture window every N training steps (``obs profile DIR``).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "obs":
        # run-directory tooling: report / diff [--gate] / watch /
        # incident / profile (obs/report.py)
        from torchpruner_tpu_torch.obs.report import obs_main

        return obs_main(argv[1:])
    if argv and argv[0] == "serve":
        from torchpruner_tpu_torch.serve.frontend import serve_main

        return serve_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch",
        description="structured pruning experiments on PyTorch/CUDA "
                    "(subcommands: serve — the continuous-batching engine; "
                    "obs report/diff/watch/incident/profile — run-ledger "
                    "tooling)")
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
    p.add_argument("--obs-dir", metavar="DIR",
                   help="write runtime telemetry into DIR: events.jsonl "
                        "(span/phase stream), metrics.prom (Prometheus "
                        "textfile), ledger.jsonl + report.json (per-round "
                        "prune provenance; see `obs report`) and trace.json "
                        "(open in ui.perfetto.dev); the end-of-run summary "
                        "prints to stderr either way")
    p.add_argument("--no-obs", action="store_true",
                   help="disable runtime telemetry entirely (no spans, no "
                        "step metrics, no summary)")
    p.add_argument("--profile-every", metavar="N", type=int, default=None,
                   help="with --obs-dir: continuous kernel profiling — a "
                        "torch.profiler capture window every N recorded "
                        "steps, under <obs-dir>/profile/; `obs profile "
                        "<obs-dir>` renders the ranked kernel table")
    p.add_argument("--profile-steps", metavar="K", type=int, default=None,
                   help="steps per capture window (default 3)")
    args = p.parse_args(argv)
    if args.obs_dir and args.no_obs:
        p.error("--obs-dir and --no-obs are mutually exclusive")
    if args.profile_every is not None and not args.obs_dir:
        p.error("--profile-every needs --obs-dir (the capture windows "
                "live under it)")
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

    obs = None
    if not args.no_obs:
        from torchpruner_tpu_torch import obs

        obs.configure(args.obs_dir, profile_every=args.profile_every,
                      profile_steps=args.profile_steps)
        obs.annotate_run(experiment=cfg.name, kind=cfg.experiment,
                         model=cfg.model, method=cfg.method)
    try:
        if obs is not None:
            with obs.span("run", experiment=cfg.name,
                          experiment_kind=cfg.experiment):
                summary = run_experiment(cfg, "cpu" if args.cpu else None)
        else:
            summary = run_experiment(cfg, "cpu" if args.cpu else None)
    finally:
        # a crashed run is exactly when the telemetry matters: flush the
        # summary and the exporters on every exit path
        if obs is not None:
            obs.shutdown(print_to=sys.stderr)
            if args.obs_dir:
                print(f"telemetry written to {args.obs_dir}",
                      file=sys.stderr)
    print(json.dumps(summary))
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
