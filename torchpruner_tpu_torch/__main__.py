"""``python -m torchpruner_tpu_torch`` — the port's CLI.

    --preset NAME [--smoke] [--cpu]     run a named preset: the
                                        prune(-retrain) loop, training, the
                                        robustness sweep or training then
                                        the sweep, as its ``experiment``
                                        says
    --config PATH [--cpu]               run an ExperimentConfig JSON
    --list                              list the presets
    --dump-config PATH                  write the resolved config, exit
    --resume DIR [--checkpoint-every N] [--chaos JSON_OR_PATH]
                                        resilient run directory: a fresh
                                        DIR starts a preemption-safe run,
                                        an existing one resumes it
                                        (below)
    --obs-dir DIR [--profile-every N [--profile-steps K]] | --no-obs
                                        telemetry (below)
    --zero                              ZeRO weight-update sharding over
                                        the config mesh's data axis
    --lint [PRESET_OR_JSON] [--lint-plan PATH] [--smoke]
                                        the static analyzer (plan and
                                        sharding lint over meta trees, the
                                        host lint): print the findings,
                                        exit 1 on an error finding
    serve <preset> [--smoke] [--cpu] --synthetic N [--verify] ...
        the continuous-batching engine on synthetic traffic
        (torchpruner_tpu_torch/serve/frontend.py)
    fleet <preset> [--smoke] [--cpu] --synthetic N | --scenario JSON
        | --http PORT ...
        the multi-replica serving plane: N serve replicas behind a
        health-checked router over a durable request journal, with the
        kill -9 failover and autoscale drills
        (torchpruner_tpu_torch/fleet/frontend.py)
    search <campaign> [--cpu] [--jobs N] [--campaign-dir DIR] ...
        the Pareto sparsity-search campaign driver: pre-priced
        concurrent prune-retrain trials, dominance early-stop, a
        resumable frontier.json (torchpruner_tpu_torch/search/driver.py)
    lint-host [paths ...] [--waivers FILE] [--json OUT]
        the host-side concurrency / durability lint alone, no preset
        (torchpruner_tpu_torch/analysis/host_lint.py)
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

``--resume DIR`` sets ``cfg.run_dir``: the run commits digest-verified
checkpoints and a manifest into DIR (``resilience/runner.py``), and run
again with the same DIR it resumes where the last commit left it —
training at the exact epoch, step and data cursor, the prune loop
mid-retrain of the interrupted target, the sweep at the first unfinished
layer.  A run directory the JAX package wrote is refused.
``--checkpoint-every N`` also commits every N optimizer steps (the prune
loop: after every retrain epoch); the default 0 commits at round and
epoch boundaries.  ``--chaos`` (or the ``TORCHPRUNER_CHAOS`` env var)
installs deterministic fault injection (``resilience/chaos.py``).  A
preempted run (SIGTERM) commits, prints how to resume and exits 0.

A config with a ``mesh`` runs with one process per device under
``torchrun --standalone --nproc_per_node N -m torchpruner_tpu_torch
--config PATH`` (``parallel/``): the mesh's size must equal N.  Rank 0
alone writes the outputs, prints the summary line and keeps the obs
session; ``--zero`` sets ``cfg.zero``.

``--lint`` needs no device: a plan (``--lint-plan``, the JSON of
``core.plan.plan_to_dict``, either package's) is checked against the
config's model instead of the graph-derived groups.  The JAX package's
``--plan`` (its placement planner) reads XLA programs and is not
ported: given it, the CLI says so and exits 2.
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
    if argv and argv[0] == "fleet":
        # the multi-replica serving plane: router + request journal +
        # N serve replicas + failover drills (fleet/frontend.py)
        from torchpruner_tpu_torch.fleet.frontend import fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "lint-host":
        # the host-side concurrency / durability scan needs no preset
        # and no model: CI runs it over the whole package
        from torchpruner_tpu_torch.analysis.host_lint import host_lint_main

        return host_lint_main(argv[1:])
    if argv and argv[0] == "search":
        # the Pareto sparsity-search campaign driver (search/driver.py)
        from torchpruner_tpu_torch.search.driver import search_main

        return search_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch",
        description="structured pruning experiments on PyTorch/CUDA "
                    "(subcommands: serve — the continuous-batching engine; "
                    "fleet — the multi-replica serving plane and its "
                    "failover drills; search — the Pareto sparsity-search "
                    "campaign driver; lint-host — the host-side "
                    "concurrency/durability lint; obs report/diff/watch/"
                    "incident/profile — run-ledger tooling)")
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
    p.add_argument("--resume", metavar="DIR",
                   help="resilient run directory (resilience.RunManifest + "
                        "digest-verified checkpoints): a fresh DIR starts a "
                        "preemption-safe run recording into it; an existing "
                        "one resumes mid-round (train: exact epoch/step/"
                        "data-cursor; prune_retrain: mid-retrain of the "
                        "interrupted target; robustness: first unfinished "
                        "layer)")
    p.add_argument("--checkpoint-every", metavar="N", type=int, default=None,
                   help="with --resume: checkpoint every N optimizer steps "
                        "(prune_retrain: additionally after every retrain "
                        "epoch); default 0 = round/epoch boundaries only")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO weight-update sharding over the config "
                        "mesh's data axis (cfg.zero): optimizer state "
                        "sharded, gradients reduce-scattered, params "
                        "all-gathered after the update — needs a mesh "
                        "with a 'data' axis")
    p.add_argument("--lint", metavar="PRESET_OR_JSON", nargs="?",
                   const="", default=None,
                   help="run the static analyzer (plan and sharding lint "
                        "over meta trees, host lint) over a preset name or "
                        "config JSON path — or over --preset/--config when "
                        "given bare — print the findings, and exit 1 on an "
                        "error-severity finding")
    p.add_argument("--lint-plan", metavar="PATH",
                   help="with --lint: validate this JSON-serialized "
                        "PrunePlan (core.plan.plan_to_dict) against the "
                        "config's model instead of the graph-derived groups")
    p.add_argument("--plan", choices=("auto", "report"), default=None,
                   help="the JAX package's placement planner: not ported "
                        "(it reads XLA programs); refused with exit 2")
    p.add_argument("--chaos", metavar="JSON_OR_PATH",
                   help="deterministic fault injection (resilience.chaos), "
                        "e.g. '{\"nan_at_step\": 5, \"kill_at_step\": 12}' "
                        "— for recovery-path testing; also via "
                        "TORCHPRUNER_CHAOS env")
    args = p.parse_args(argv)
    if args.plan is not None:
        p.error("--plan is not ported: the placement planner prices "
                "candidates from compiled XLA programs, which the port "
                "does not build (ROADMAP §C)")
    if args.lint_plan and args.lint is None:
        p.error("--lint-plan only makes sense together with --lint")
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
    if args.lint:  # --lint <preset-name-or-config-path> names its target
        if args.lint.endswith(".json"):
            cfg = ExperimentConfig.from_json(args.lint)
        else:
            cfg = get_preset(args.lint, smoke=args.smoke)
    elif args.config:
        cfg = ExperimentConfig.from_json(args.config)
    elif args.preset:
        cfg = get_preset(args.preset, smoke=args.smoke)
    else:
        p.error("one of --preset / --config / --list / --lint PRESET is "
                "required")
    if args.zero:
        if "data" not in (cfg.mesh or {}):
            p.error("--zero needs a config mesh with a 'data' axis "
                    "(e.g. \"mesh\": {\"data\": 4, \"model\": 2})")
        cfg.zero = True
    if args.lint is not None:
        return _lint(cfg, args.lint_plan)
    if args.resume:
        cfg.run_dir = args.resume
    if args.checkpoint_every is not None:
        cfg.checkpoint_every_steps = args.checkpoint_every
    if args.chaos:
        import dataclasses

        from torchpruner_tpu_torch.resilience.chaos import ChaosConfig

        # validate up front; stash as plain knobs so --dump-config
        # round-trips and the experiments install it themselves
        cfg.chaos = dataclasses.asdict(ChaosConfig.from_any(args.chaos))
    else:
        import os

        if os.environ.get("TORCHPRUNER_CHAOS"):
            from torchpruner_tpu_torch.resilience import chaos

            chaos.configure(None)  # reads the env var
    if args.dump_config:
        cfg.to_json(args.dump_config)
        print(f"wrote {args.dump_config}")
        return 0

    import torch.distributed as dist

    from torchpruner_tpu_torch.parallel.mesh import (
        initialize_distributed,
        is_writer,
    )

    # under torchrun: join the process group (a no-op otherwise); a group
    # the caller made stays the caller's
    joined = not dist.is_initialized() and initialize_distributed(
        "cpu" if args.cpu else None)
    obs = None
    if not args.no_obs and is_writer():
        from torchpruner_tpu_torch import obs

        obs.configure(args.obs_dir, profile_every=args.profile_every,
                      profile_steps=args.profile_steps)
        obs.annotate_run(experiment=cfg.name, kind=cfg.experiment,
                         model=cfg.model, method=cfg.method,
                         resumed=bool(args.resume))
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
    if is_writer():
        print(json.dumps(summary))
    if joined:
        dist.destroy_process_group()
    return 0


def _lint(cfg, plan_path=None) -> int:
    """``--lint``: the analyzer's report over ``cfg`` (and the plan in
    ``plan_path``); 0 when it holds no error finding, else 1."""
    from torchpruner_tpu_torch.analysis import lint_config

    plans = None
    if plan_path:
        from torchpruner_tpu_torch.core.plan import plan_from_dict

        with open(plan_path) as f:
            plans = [plan_from_dict(json.load(f))]
    report = lint_config(cfg, plans=plans)
    print(report.format())
    return 0 if report.ok else 1


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
