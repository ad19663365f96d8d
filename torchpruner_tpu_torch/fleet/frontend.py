"""``python -m torchpruner_tpu_torch fleet``: the multi-replica serving
plane.
(Counterpart of ``torchpruner_tpu/fleet/frontend.py``: replicas run the
port's ``serve`` CLI, on the CUDA device unless ``--cpu`` is given, which
every replica is passed too; on CUDA the router process builds the kernels once
before the first replica starts, and ``--verify`` replays through the
port's solo ``generate()`` on the router process's device.  ``--kv-dtype`` is
the port's: it goes to every replica and to the replays.)

Spawns N single-replica serve processes (``serve --http``, each with its
own obs dir, bounded queue, and drain snapshot dir), fronts them with
the health-checked :class:`~torchpruner_tpu_torch.fleet.router.FleetRouter`
over a durable :class:`~torchpruner_tpu_torch.fleet.plane.RequestPlane`
journal, and runs one of two modes:

- ``--synthetic N`` — the FAILOVER DRILL: N seeded synthetic requests
  on an open-loop Poisson schedule (``--rate`` req/s), optional fleet
  chaos (``--chaos '{"kill_replica_at_step": 8}'`` SIGKILLs a replica
  once the router has dispatched 8 requests; ``hang_replica_at_step``
  SIGSTOPs it; ``slow_replica_ms`` degrades one replica's per-step
  latency via the core chaos env), optional ``--swap-checkpoint`` (a
  rolling fleet upgrade mid-drill), then: SIGTERM-drains the
  survivors, merges every replica's obs shard into ONE fleet-wide
  report, ``--verify`` re-decodes every completed request from the
  JOURNAL through solo ``generate()`` (bit-identity: the redrive
  correctness contract), prints a JSON summary, and exits non-zero on
  ANY accepted-request loss or verify mismatch.
- ``--http PORT`` — the serving-plane endpoint: ``POST /v1/generate``
  accepts into the journal (durable before the 200 path starts) and
  blocks for the routed result; over-capacity answers 429/503 +
  Retry-After by the router's (degradation-tightened) admission
  policy; ``GET /healthz`` / ``GET /stats`` expose the fleet view.

Every replica is started with the SAME seed/checkpoint and geometry, so
a redriven request re-decodes bit-identically on any survivor — greedy
requests always, sampled requests because their rng is seed-pinned (see
the README caveat: that guarantee is a property of identical replicas,
not of redrive itself).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from torchpruner_tpu_torch.fleet.plane import COMPLETED, RequestPlane
from torchpruner_tpu_torch.fleet.replica import ReplicaProcess, free_port
from torchpruner_tpu_torch.serve.request import request_from_dict
from torchpruner_tpu_torch.fleet.report import (
    merge_replica_shards,
    merge_timeseries,
)
from torchpruner_tpu_torch.fleet.router import FleetRouter, RouterPolicy

JOURNAL_FILENAME = "fleet_journal.json"


@dataclass
class FleetChaos:
    """Router-side fleet fault injection (the chaos harness's fleet
    extension): ``*_at_step`` counts ROUTER DISPATCHES (deterministic
    under a fixed arrival schedule), ``replica_index`` picks the
    victim.  ``slow_replica_ms`` is forwarded to the victim's env as
    core chaos ``slow_steps_ms`` (a per-decode-step stall)."""

    kill_replica_at_step: int = -1
    hang_replica_at_step: int = -1
    slow_replica_ms: float = 0.0
    replica_index: int = 0

    @classmethod
    def from_any(cls, spec) -> "FleetChaos":
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            spec = json.loads(spec)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown fleet chaos keys: "
                             f"{sorted(unknown)} (known: {sorted(known)})")
        return cls(**spec)


def replica_argv(preset: str, port: int, args,
                 obs_dir: str, run_dir: str) -> List[str]:
    """The serve subcommand line one replica runs."""
    argv = [sys.executable, "-m", "torchpruner_tpu_torch", "serve", preset,
            "--http", str(port), "--slots", str(args.slots),
            "--max-len", str(args.max_len), "--seed", str(args.seed),
            "--queue-bound", str(args.replica_queue_bound),
            "--obs-dir", obs_dir, "--run-dir", run_dir,
            "--trace-sample-every", str(args.trace_sample_every),
            "--timeout", str(args.deadline_s)]
    if args.page_len > 0:
        argv += ["--page-len", str(args.page_len)]
    if args.prefix_pages > 0:
        # Serve v2 on every replica: same pool/chunk geometry fleet-
        # wide, so any replica serves any session (affinity is a
        # throughput hint, failover stays free)
        argv += ["--prefix-pages", str(args.prefix_pages),
                 "--prefill-chunk", str(args.prefill_chunk),
                 "--prefill-cap", str(args.prefill_cap)]
    if args.smoke:
        argv.append("--smoke")
    if args.cpu:
        argv.append("--cpu")
    if args.kv_dtype != "float32":
        argv += ["--kv-dtype", args.kv_dtype]
    if args.checkpoint:
        argv += ["--checkpoint", args.checkpoint]
    if args.slo_ttft_p99_ms is not None:
        argv += ["--slo-ttft-p99-ms", str(args.slo_ttft_p99_ms)]
    if args.slo_token_p99_ms is not None:
        argv += ["--slo-token-p99-ms", str(args.slo_token_p99_ms)]
    if args.slo_queue_p99_ms is not None:
        argv += ["--slo-queue-p99-ms", str(args.slo_queue_p99_ms)]
    if getattr(args, "tenants_json", None):
        # the scenario's QoS table rides to every replica: the tenant
        # policies are committed WITH the traffic (one contract)
        argv += ["--tenants", args.tenants_json]
    return argv


def spawn_fleet(preset: str, args, fleet_dir: str,
                chaos: FleetChaos) -> List[ReplicaProcess]:
    """Spawn + wait-listening on every replica.  All replicas share the
    seed/checkpoint and geometry — the redrive bit-identity contract."""
    from torchpruner_tpu_torch import obs

    procs: List[ReplicaProcess] = []
    for i in range(args.replicas):
        port = free_port()
        obs_dir = os.path.join(fleet_dir, "obs", f"replica{i}")
        run_dir = os.path.join(fleet_dir, f"replica{i}_run")
        env = dict(os.environ)
        env.pop("TORCHPRUNER_CHAOS", None)  # fleet chaos is router-side
        if chaos.slow_replica_ms > 0 and i == chaos.replica_index:
            env["TORCHPRUNER_CHAOS"] = json.dumps(
                {"slow_steps_ms": chaos.slow_replica_ms})
            # the planted fault is provenance: ledgered at injection
            # time, so the incident correlator can NAME it — the CI
            # planted-cause drill asserts the top-ranked suspect is
            # this record, by replica and event class (obs.incident)
            obs.record_serve(kind="chaos_injection",
                             chaos="slow_replica",
                             replica=f"replica{i}",
                             slow_steps_ms=chaos.slow_replica_ms)
        rep = ReplicaProcess(
            name=f"replica{i}", port=port,
            argv=replica_argv(preset, port, args, obs_dir, run_dir),
            env=env,
            log_path=os.path.join(fleet_dir, f"replica{i}.log"))
        rep.obs_dir = obs_dir
        rep.spawn()
        procs.append(rep)
    for rep in procs:
        if not rep.wait_listening(timeout_s=args.startup_timeout_s):
            for r in procs:
                r.kill9()
            raise SystemExit(
                f"fleet: {rep.name} never started listening "
                f"(see {rep.log_path})")
    return procs


def _payload_of(req) -> dict:
    """serve.Request → the wire dict (request_from_dict schema)."""
    s = req.sampling
    out = {"prompt_ids": req.prompt_ids.tolist(),
           "max_new": int(req.max_new), "eos_id": req.eos_id,
           "temperature": s.temperature, "top_k": s.top_k,
           "top_p": s.top_p, "seed": s.seed}
    if req.session_id:
        out["session_id"] = req.session_id
    if req.tenant:
        out["tenant"] = req.tenant
    return out


class _ChaosTrigger:
    """Fires the router-side injections at their dispatch-count step."""

    def __init__(self, chaos: FleetChaos, procs: List[ReplicaProcess]):
        self.chaos, self.procs = chaos, procs
        self.killed: List[str] = []
        self.hung: List[str] = []

    def __call__(self, router: FleetRouter) -> None:
        from torchpruner_tpu_torch import obs

        c = self.chaos
        idx = c.replica_index
        if 0 <= c.kill_replica_at_step <= router.dispatched_total \
                and not self.killed and idx < len(self.procs):
            victim = self.procs[idx]
            print(f"[fleet] chaos: kill -9 {victim.name} at dispatch "
                  f"{router.dispatched_total}", file=sys.stderr,
                  flush=True)
            obs.record_serve(kind="chaos_injection",
                             chaos="kill_replica", replica=victim.name,
                             at_dispatch=router.dispatched_total)
            victim.kill9()
            self.killed.append(victim.name)
        if 0 <= c.hang_replica_at_step <= router.dispatched_total \
                and not self.hung and idx < len(self.procs):
            victim = self.procs[idx]
            print(f"[fleet] chaos: SIGSTOP {victim.name} at dispatch "
                  f"{router.dispatched_total}", file=sys.stderr,
                  flush=True)
            obs.record_serve(kind="chaos_injection",
                             chaos="hang_replica", replica=victim.name,
                             at_dispatch=router.dispatched_total)
            victim.hang()
            self.hung.append(victim.name)


def _finalize_tracing(fleet_obs_dir: str) -> dict:
    """The drill/endpoint's trace epilogue, run while the fleet session
    is still open: flush pending exemplars, assemble every process's
    stage events into cross-process request traces, compute the
    TTFT/E2E latency budget over the MERGED stage histograms, and land
    budget + assembly verdict as gauges (``ttft_stage_*_pct`` /
    ``reqtrace_*``, gated by ``obs diff``) and a ledger ``reqtrace``
    record (rendered by ``obs report``).  Returns the summary fields
    the drill prints."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.fleet import report as fleet_report
    from torchpruner_tpu_torch.obs import aggregate, reqtrace

    session = obs.get()
    if session is None:
        return {}
    reqtrace.session_flush()
    # NOTE: the merged trace.json is assembled AGAIN after
    # obs.shutdown (fleet_main) — intentionally, not redundantly: the
    # router's stream gains this function's own flushes and the
    # session-close records, so the file must re-read it; this pass
    # only needs the traces + summary while the session can still
    # take gauges/ledger records
    traces = fleet_report.assemble_fleet_traces(fleet_obs_dir)
    tsum = fleet_report.trace_summary(traces)
    try:
        merged = aggregate.merged_registry(fleet_obs_dir,
                                           local=session.metrics)
        budget = reqtrace.latency_budget(merged.snapshot())
    except Exception:
        budget = None
    reqtrace.install_budget_gauges(budget)
    obs.gauge_set("reqtrace_traces_assembled", tsum["assembled"],
                  help="cross-process request traces assembled from "
                       "the fleet's event streams")
    obs.gauge_set("reqtrace_traces_cross_process", tsum["cross_process"],
                  help="completed traces whose waterfall spans router "
                       "AND replica pids (contiguity verdict)")
    obs.gauge_set("reqtrace_traces_torn", tsum["torn"],
                  help="traces with stage events but no terminal "
                       "summary from any process")
    exemplars = fleet_report.slowest_exemplars(traces)
    obs.record_reqtrace(budget=budget, assembly=tsum,
                        exemplars=exemplars)
    out = {
        "traces_assembled": tsum["assembled"],
        "traces_cross_process": tsum["cross_process"],
        "traces_redriven_cross_process": tsum["redriven_cross_process"],
        "traces_torn": tsum["torn"],
    }
    ttft = (budget or {}).get("ttft") or {}
    if ttft.get("recon_pct") is not None:
        out["ttft_recon_pct"] = round(ttft["recon_pct"], 2)
    stages = sorted((r for r in ttft.get("stages") or []
                     if r.get("pct") is not None),
                    key=lambda r: -r["pct"])
    if stages:
        out["ttft_budget_top2"] = [[r["stage"], round(r["pct"], 1)]
                                   for r in stages[:2]]
    return out


def run_drill(preset: str, args, fleet_dir: str,
              chaos: FleetChaos) -> int:
    """The synthetic failover drill (see module docstring)."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.serve.engine import vocab_of
    from torchpruner_tpu_torch.serve.frontend import _resolve_model
    from torchpruner_tpu_torch.serve.traffic import (
        poisson_arrivals,
        shared_prefix_requests,
        synthetic_requests,
    )

    # the router process's own copy of the weights — vocab for the synthetic
    # prompts now, solo-decode replays for --verify later
    model, params, _meta = _resolve_model(
        preset, smoke=args.smoke, seed=args.seed,
        checkpoint=args.checkpoint, device=args.device)
    n = args.synthetic
    prompt_lens = [int(x) for x in args.prompt_lens.split(",") if x]
    max_new = [int(x) for x in args.max_new.split(",") if x]
    if args.shared_prefixes > 0:
        reqs = shared_prefix_requests(
            n, vocab=vocab_of(model), n_prefixes=args.shared_prefixes,
            prefix_len=args.prefix_len, suffix_lens=prompt_lens,
            max_new=max_new, seed=args.seed, sessions=args.sessions,
            temperature=args.temperature)
    else:
        reqs = synthetic_requests(
            n, vocab=vocab_of(model), prompt_lens=prompt_lens,
            max_new=max_new, seed=args.seed,
            temperature=args.temperature)
    payloads = [_payload_of(r) for r in reqs]
    arrivals = poisson_arrivals(n, args.rate, seed=args.seed)

    t_spawn = time.monotonic()
    procs = spawn_fleet(preset, args, fleet_dir, chaos)
    startup_s = time.monotonic() - t_spawn
    plane = RequestPlane(os.path.join(fleet_dir, JOURNAL_FILENAME))
    router = FleetRouter(plane, procs, policy=_policy_of(args))
    trigger = _ChaosTrigger(chaos, procs)
    swap_thread = None
    t0 = time.monotonic()
    try:
        router.check_health(force=True)
        i = 0
        shed = 0
        while True:
            now = time.monotonic() - t0
            while i < n and arrivals[i] <= now:
                if router.submit(payloads[i],
                                 deadline_s=args.deadline_s) is None:
                    shed += 1
                i += 1
            router.tick()
            trigger(router)
            if swap_thread is None and args.swap_checkpoint \
                    and router.dispatched_total >= args.swap_after:
                swap_thread = threading.Thread(
                    target=router.rolling_swap,
                    args=(args.swap_checkpoint,), daemon=True)
                swap_thread.start()
            if i >= n and plane.all_terminal() \
                    and plane.pending_depth == 0:
                break
            if now > args.drill_timeout_s:
                print(f"[fleet] drill timed out: {plane.counts()}",
                      file=sys.stderr, flush=True)
                break
            time.sleep(0.01)
        if swap_thread is not None:
            swap_thread.join(timeout=args.drill_timeout_s)
    finally:
        router.close()
        exit_codes = {p.name: p.drain(timeout_s=args.startup_timeout_s)
                      for p in procs}
    wall = time.monotonic() - t0

    # fleet-wide report: every survivor's obs shard merged into the
    # fleet session's registry (BEFORE obs.shutdown exports it)
    shards = merge_replica_shards(
        os.path.join(fleet_dir, "obs"), [p.obs_dir for p in procs])
    # fleet-wide time-series: every process's windows re-homed onto the
    # router clock (metrics_ts_fleet.jsonl; re-merged after obs.shutdown
    # in fleet_main so the router's final window lands too)
    try:
        ts_merge = merge_timeseries(
            os.path.join(fleet_dir, "obs"), [p.obs_dir for p in procs])
    except Exception:
        ts_merge = {"streams": 0, "windows": 0}
    # tracing BEFORE burn collection: the ledgered reqtrace record
    # (slowest-K exemplars) must exist when a re-recorded burn alert
    # triggers the incident correlator, so the incident carries them
    trace_fields = _finalize_tracing(os.path.join(fleet_dir, "obs"))
    # replica-ledgered burn-rate alerts re-homed into the FLEET ledger
    # (each re-record fires the obs.record_serve incident hook — this
    # is where fleet incidents assemble), and the drill's pass/fail
    # signal: the planted slow_replica_ms drill must fire one
    burn_alerts = _collect_burn_alerts(procs)

    records = plane.records()
    completed = [r for r in records if r.state == COMPLETED]
    lost = [r for r in records if r.state != COMPLETED]
    redrives = sum(r.redrives for r in records)
    mismatches = 0
    if args.verify:
        mismatches = _verify_from_journal(
            model, params, completed, max_len=args.max_len,
            cache_dtype=args.kv_dtype, device=args.device)
    summary = {
        "mode": "drill",
        "replicas": args.replicas,
        "requests": n,
        "accepted": len(records),
        "completed": len(completed),
        "lost": len(lost),
        "shed": shed,
        "redrives": redrives,
        "failovers": router.failovers_total,
        "duplicates": plane.duplicate_results_total,
        "killed": trigger.killed,
        "hung": trigger.hung,
        "replica_exit_codes": exit_codes,
        "shards_merged": sum(bool(v) for v in shards.values()),
        "ts_streams": ts_merge["streams"],
        "ts_windows": ts_merge["windows"],
        "slo_burn_alerts": len(burn_alerts),
        **_incident_counts(),
        "affinity_preferred": router.affinity_preferred_total,
        "affinity_hits": router.affinity_hits_total,
        "affinity_hit_rate": round(
            router.affinity_hits_total
            / max(1, router.affinity_preferred_total), 4),
        "wall_s": round(wall, 3),
        # the port's: seconds until every seed replica listened
        "startup_s": round(startup_s, 3),
        **trace_fields,
    }
    if args.swap_checkpoint:
        summary["rolling_swap"] = args.swap_checkpoint
    if args.verify:
        summary["verify_mismatches"] = mismatches
    obs.record_serve(kind="fleet_drill", **{
        k: v for k, v in summary.items()
        if isinstance(v, (int, float, str))})
    print(json.dumps(summary))
    if lost:
        print(f"DRILL FAILED: {len(lost)} accepted request(s) lost: "
              + ", ".join(f"{r.rid}[{r.state}:{r.error}]"
                          for r in lost[:8]),
              file=sys.stderr, flush=True)
        return 1
    if mismatches:
        print(f"VERIFY FAILED: {mismatches} redriven/completed "
              "request(s) diverged from solo decode",
              file=sys.stderr, flush=True)
        return 1
    if burn_alerts:
        print("SLO BURN: " + ", ".join(
            f"{a.get('replica')}:{a.get('metric')} "
            f"(fast {a.get('burn_fast')}x, slow {a.get('burn_slow')}x)"
            for a in burn_alerts[:8]),
            file=sys.stderr, flush=True)
        return 1
    return 0


class _ReplicaLauncher:
    """The autoscaling supervisor's process-control half: ``launch()``
    spawns one more replica (same preset/seed/geometry as the seed
    fleet — the bit-identity contract survives scaling) and blocks
    until it listens; ``retire(name)`` SIGTERM-drains it.  The shared
    ``procs`` list keeps every process ever launched so the drill's
    epilogue can drain/merge them all."""

    def __init__(self, preset: str, args, fleet_dir: str,
                 procs: List[ReplicaProcess]):
        self.preset, self.args, self.fleet_dir = preset, args, fleet_dir
        self.procs = procs
        self._next = args.replicas
        self._lock = threading.Lock()
        #: seconds each launch took until its replica listened
        self.launch_s: List[float] = []

    def launch(self) -> ReplicaProcess:
        with self._lock:
            i = self._next
            self._next += 1
        args = self.args
        t0 = time.monotonic()
        port = free_port()
        obs_dir = os.path.join(self.fleet_dir, "obs", f"replica{i}")
        run_dir = os.path.join(self.fleet_dir, f"replica{i}_run")
        env = dict(os.environ)
        env.pop("TORCHPRUNER_CHAOS", None)
        rep = ReplicaProcess(
            name=f"replica{i}", port=port,
            argv=replica_argv(self.preset, port, args, obs_dir, run_dir),
            env=env,
            log_path=os.path.join(self.fleet_dir, f"replica{i}.log"))
        rep.obs_dir = obs_dir
        rep.spawn()
        with self._lock:
            self.procs.append(rep)
        if not rep.wait_listening(timeout_s=args.startup_timeout_s):
            rep.kill9()
            raise RuntimeError(f"{rep.name} never started listening "
                               f"(see {rep.log_path})")
        with self._lock:
            self.launch_s.append(time.monotonic() - t0)
        return rep

    def retire(self, name: str) -> None:
        with self._lock:
            procs = list(self.procs)
        for p in procs:
            if p.name == name:
                p.drain(timeout_s=self.args.startup_timeout_s)
                return


def run_scenario(preset: str, args, fleet_dir: str,
                 chaos: FleetChaos) -> int:
    """The scenario replay / autoscale chaos drill: replay a committed
    workload scenario (digest-asserted) against the fleet with the
    SLO-driven supervisor closing the scale loop, then assert the
    robustness contract — zero accepted-request loss across scale-up
    AND drain-based scale-down, every scale decision ledgered, batch
    tier shed then resumed, interactive TTFT p99 within budget."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.fleet.supervisor import (
        RUNGS,
        ScalePolicy,
        Supervisor,
        predict_replica_capacity,
    )
    from torchpruner_tpu_torch.fleet.workload import (
        WorkloadReplayer,
        build_schedule,
        load_scenario,
        verify_schedule,
    )
    from torchpruner_tpu_torch.serve.engine import vocab_of
    from torchpruner_tpu_torch.serve.frontend import _resolve_model
    from torchpruner_tpu_torch.serve.qos import TenantPolicy

    spec = load_scenario(args.scenario)
    schedule = build_schedule(spec)
    digest = verify_schedule(spec, schedule)
    obs.gauge_set("workload_planned_requests", len(schedule),
                  help="scenario schedule size (committed, "
                       "digest-pinned)")
    model, _params, _meta = _resolve_model(
        preset, smoke=args.smoke, seed=args.seed,
        checkpoint=args.checkpoint, device=args.device)
    if int(spec["vocab"]) > vocab_of(model):
        raise SystemExit(
            f"scenario vocab {spec['vocab']} exceeds the served "
            f"model's vocab {vocab_of(model)} — the committed prompt "
            f"ids would be out of range")
    tenants = spec.get("tenants") or {}
    args.tenants_json = json.dumps(tenants) if tenants else None
    # rung 1's shed set: the scenario's preemptible batch tier
    batch_tier = tuple(sorted(
        name for name, cfg in tenants.items()
        if TenantPolicy.from_dict(name, cfg).priority > 0))

    t_spawn = time.monotonic()
    procs = spawn_fleet(preset, args, fleet_dir, chaos)
    startup_s = time.monotonic() - t_spawn
    plane = RequestPlane(os.path.join(fleet_dir, JOURNAL_FILENAME))
    router = FleetRouter(plane, procs, policy=_policy_of(args))
    trigger = _ChaosTrigger(chaos, procs)

    sup = None
    if args.autoscale:
        policy = ScalePolicy(
            min_replicas=args.replicas,
            max_replicas=args.max_replicas,
            queue_age_up_s=args.scale_up_age_s,
            queue_age_down_s=args.scale_down_age_s,
            cooldown_s=args.scale_cooldown_s,
            drain_timeout_s=args.startup_timeout_s,
            shed_tenants=batch_tier,
            pruned_checkpoint=args.degrade_checkpoint,
            restore_checkpoint=args.checkpoint)
        # capacity prediction BEFORE any launch: what the ledger says
        # one more replica should buy (None: the port has no cost
        # model; supervisor.predict_replica_capacity)
        capacity = predict_replica_capacity(
            model, n_slots=args.slots, max_len=args.max_len)
        launcher = _ReplicaLauncher(preset, args, fleet_dir, procs)
        sup = Supervisor(router, policy, launcher=launcher,
                         capacity=capacity)

    replayer = WorkloadReplayer.from_spec(router, spec,
                                          deadline_s=args.deadline_s)
    t0 = time.monotonic()

    def on_tick():
        router.tick()
        trigger(router)
        if sup is not None:
            sup.tick()

    try:
        router.check_health(force=True)
        rsum = replayer.run(timeout_s=args.drill_timeout_s,
                            on_tick=on_tick)
        # settle: keep ticking until the supervisor has recovered every
        # degradation rung and drained the surge capacity back down —
        # the drill's "reversible" half (scale_down + recover must both
        # land, or we time out and the asserts below fail loudly)
        if sup is not None:
            deadline = time.monotonic() + args.settle_timeout_s
            while time.monotonic() < deadline:
                on_tick()
                s = sup.summary()
                with router._lock:
                    n_views = len(router.views)
                if s["scale_downs"] >= 1 and s["rung"] == RUNGS[0] \
                        and n_views <= args.replicas \
                        and not sup._busy():
                    break
                time.sleep(0.02)
            sup.join(timeout_s=args.settle_timeout_s)
        tenant_table = router.tenant_summary()
    finally:
        router.close()
        exit_codes = {p.name: p.drain(timeout_s=args.startup_timeout_s)
                      for p in procs}
    wall = time.monotonic() - t0

    shards = merge_replica_shards(
        os.path.join(fleet_dir, "obs"), [p.obs_dir for p in procs])
    try:
        ts_merge = merge_timeseries(
            os.path.join(fleet_dir, "obs"), [p.obs_dir for p in procs])
    except Exception:
        ts_merge = {"streams": 0, "windows": 0}
    trace_fields = _finalize_tracing(os.path.join(fleet_dir, "obs"))
    # same epilogue as the drill: replica burns re-homed into the fleet
    # ledger (incident correlation included) — informational here, the
    # scenario's verdict stays with the robustness asserts below
    burn_alerts = _collect_burn_alerts(procs)

    records = plane.records()
    completed = [r for r in records if r.state == COMPLETED]
    lost = [r for r in records if r.state != COMPLETED]
    ssum = sup.summary() if sup is not None else {}
    summary = {
        "mode": "scenario",
        "scenario": rsum.scenario,
        "digest": rsum.digest,
        "replicas_min": args.replicas,
        "replicas_max": args.max_replicas,
        **{k: v for k, v in rsum.to_json().items()
           if k not in ("scenario", "digest")},
        "accepted": len(records),
        "completed": len(completed),
        "lost": len(lost),
        "redrives": sum(r.redrives for r in records),
        "replica_exit_codes": exit_codes,
        "shards_merged": sum(bool(v) for v in shards.values()),
        "ts_streams": ts_merge["streams"],
        "ts_windows": ts_merge["windows"],
        "slo_burn_alerts": len(burn_alerts),
        **_incident_counts(),
        "tenants": tenant_table,
        "wall_s": round(wall, 3),
        # the port's: seconds until every seed replica listened, and
        # each scale-up's launch until its replica listened
        "startup_s": round(startup_s, 3),
        "launch_s": [round(s, 3) for s in launcher.launch_s]
        if args.autoscale else [],
        **trace_fields,
    }
    if sup is not None:
        summary["autoscale"] = ssum
    obs.record_serve(kind="scenario_drill", **{
        k: v for k, v in summary.items()
        if isinstance(v, (int, float, str))})
    print(json.dumps(summary))

    failures: List[str] = []
    if lost:
        failures.append(
            f"{len(lost)} accepted request(s) lost: "
            + ", ".join(f"{r.rid}[{r.state}:{r.error}]"
                        for r in lost[:8]))
    # batch-tier abandonment under a degrade rung is the ladder WORKING
    # (that tier is being shed on purpose); any other tenant abandoned
    # means admission control turned away traffic it must not
    hard_abandoned = {t or "(none)": n
                      for t, n in rsum.abandoned_by_tenant.items()
                      if t not in batch_tier}
    if hard_abandoned:
        failures.append(f"non-batch request(s) abandoned after "
                        f"exhausting their hedged-retry budget: "
                        f"{hard_abandoned}")
    if sup is not None:
        if ssum["scale_ups"] < 1:
            failures.append("no scale_up decision fired")
        if ssum["scale_downs"] < 1:
            failures.append("no scale_down landed (surge capacity "
                            "never drained back out)")
        if batch_tier and ssum["degrades"] < 1:
            failures.append("batch tier was never shed (no degrade "
                            "rung climbed)")
        if ssum["degrades"] and ssum["recovers"] < ssum["degrades"]:
            failures.append("degradation rung(s) never recovered "
                            f"(rung {ssum['rung']})")
        if ssum["errors"]:
            failures.append(f"supervisor errors: {ssum['errors'][:4]}")
    if args.assert_ttft_p99_ms > 0:
        interactive = [
            name for name, cfg in tenants.items()
            if TenantPolicy.from_dict(name, cfg).priority == 0]
        for name in interactive:
            row = tenant_table.get(name) or {}
            p99 = row.get("ttft_p99_s")
            if p99 is not None \
                    and p99 * 1e3 > args.assert_ttft_p99_ms:
                failures.append(
                    f"tenant {name!r} TTFT p99 {p99 * 1e3:.0f} ms "
                    f"exceeds the {args.assert_ttft_p99_ms:.0f} ms "
                    f"budget")
    if failures:
        for f in failures:
            print(f"SCENARIO DRILL FAILED: {f}", file=sys.stderr,
                  flush=True)
        return 1
    return 0


def _incident_counts() -> dict:
    """The fleet session's incident/anomaly tallies for the summary
    line (zeros without a session — e.g. unit tests calling the run_*
    helpers directly)."""
    from torchpruner_tpu_torch import obs

    s = obs.get()
    out = {"incidents": 0, "anomalies": 0}
    if s is not None and s.incidents is not None:
        out["incidents"] = len(s.incidents.incidents)
    if s is not None and s.anomaly is not None:
        out["anomalies"] = s.anomaly.counts()["opened"]
    return out


def _collect_burn_alerts(procs) -> List[dict]:
    """Every replica's ledgered ``slo_burn`` records (serve/slo.py's
    multi-window burn-rate alerts), re-recorded into the FLEET session's
    ledger stamped with the replica name — so the merged fleet report
    carries the incident — and returned for the drill's verdict."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.obs.ledger import LEDGER_FILENAME, load_ledger

    alerts: List[dict] = []
    for p in procs:
        path = os.path.join(p.obs_dir, LEDGER_FILENAME)
        if not os.path.exists(path):
            continue
        try:
            records = load_ledger(path)
        except Exception:
            continue
        for rec in records:
            if rec.get("event") == "serve" \
                    and rec.get("kind") == "slo_burn":
                fields = {k: v for k, v in rec.items()
                          if k not in ("event", "kind")}
                obs.record_serve(kind="slo_burn", replica=p.name,
                                 **fields)
                alerts.append({"replica": p.name, **fields})
    return alerts


def _verify_from_journal(model, params, completed, max_len: int,
                         cache_dtype="float32", device=None) -> int:
    """Re-decode every completed record's journal payload through solo
    ``generate()`` at the replicas' cache geometry and count token
    mismatches — works on greedy AND seed-pinned sampled requests
    because every replica serves identical weights/geometry (the
    redrive caveat: with non-identical replicas only greedy requests
    are re-verifiable).  A replica's request draws from a CPU
    ``torch.Generator`` seeded with the request's seed; so does the
    replay."""
    import numpy as np
    import torch

    from torchpruner_tpu_torch.generate import generate

    mismatches = 0
    for rec in completed:
        p = rec.payload
        prompt = np.asarray(p["prompt_ids"], np.int64)
        want = generate(
            model, params, prompt[None], int(p["max_new"]),
            temperature=float(p.get("temperature") or 0.0),
            top_k=p.get("top_k"), top_p=p.get("top_p"),
            rng=torch.Generator().manual_seed(int(p.get("seed") or 0)),
            max_len=max_len, cache_dtype=cache_dtype,
            device=device).cpu().numpy()
        got = np.asarray(rec.tokens or [], np.int64)
        if not np.array_equal(got, want[0][:got.size]) \
                or got.size != int(p["max_new"]):
            # eos early-stop: accept a shorter stream only when the
            # solo replay stops at the same token
            solo = want[0]
            if not (got.size and p.get("eos_id") is not None
                    and got[-1] == p["eos_id"]
                    and np.array_equal(got, solo[:got.size])):
                mismatches += 1
    return mismatches


def run_http(preset: str, args, fleet_dir: str,
             chaos: FleetChaos) -> int:
    """The fleet HTTP endpoint: accept → journal → route → answer."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from torchpruner_tpu_torch.resilience.guards import PreemptionHandler

    procs = spawn_fleet(preset, args, fleet_dir, chaos)
    journal = os.path.join(fleet_dir, JOURNAL_FILENAME)
    if os.path.exists(journal):
        # a restarted endpoint REDRIVES its previous incarnation's
        # journal instead of clobbering it — the router-death half of
        # the completed-or-redrivable contract
        # retain_terminal bounds the journal: the long-running endpoint
        # keeps only the newest terminal records (flush cost must not
        # grow with lifetime traffic)
        plane = RequestPlane.load(journal, retain_terminal=512)
        redriven = plane.pending_depth
        if redriven:
            print(f"[fleet] journal reloaded: {redriven} non-terminal "
                  f"record(s) redriven", file=sys.stderr, flush=True)
    else:
        plane = RequestPlane(journal, retain_terminal=512)
    router = FleetRouter(plane, procs, policy=_policy_of(args))
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            router.tick()
            time.sleep(0.02)

    from torchpruner_tpu_torch.serve.frontend import http_json

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, payload: dict,
                  headers: Optional[dict] = None):
            http_json(self, code, payload, headers)

        def do_GET(self):
            if self.path == "/healthz":
                verdict = router.admission()
                self._json(
                    200 if verdict["accepting"] else verdict["code"],
                    {"ok": verdict["accepting"],
                     "reason": verdict["reason"],
                     "degraded": router.degraded()})
            elif self.path == "/stats":
                self._json(200, router.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                # validate the wire schema BEFORE the journal accepts
                # it: a malformed request must be an immediate 400, not
                # a journaled record that burns the whole retry budget
                # on replica 400s and lands in the LOSS counter
                probe = request_from_dict(payload)
                probe.sampling.validate(0)
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            rec = router.submit(payload, deadline_s=args.deadline_s)
            if rec is None:
                verdict = router.admission()
                self._json(verdict["code"] or 503,
                           {"error": verdict["reason"] or "shed"},
                           headers={"Retry-After":
                                    verdict["retry_after_s"] or 1})
                return
            rec.wait(timeout=args.deadline_s + 5)
            if rec.state == COMPLETED:
                self._json(200, {"id": rec.rid, "state": "done",
                                 "tokens": rec.tokens,
                                 "served_by": rec.completed_by,
                                 "attempts": rec.attempts,
                                 "redrives": rec.redrives})
            else:
                self._json(504, {"id": rec.rid, "state": rec.state,
                                 "error": rec.error})

    server = ThreadingHTTPServer(("127.0.0.1", args.http), Handler)
    pump_t = threading.Thread(target=pump, daemon=True)
    pump_t.start()
    srv_t = threading.Thread(target=server.serve_forever, daemon=True)
    srv_t.start()
    print(f"fleet: routing {args.replicas} replicas on "
          f"http://127.0.0.1:{args.http} (POST /v1/generate, "
          f"GET /healthz /stats)", file=sys.stderr, flush=True)
    rc = 0
    try:
        with PreemptionHandler() as pre:
            while not pre.requested:
                time.sleep(0.2)
            print("[fleet] SIGTERM: draining", file=sys.stderr,
                  flush=True)
            deadline = time.monotonic() + args.deadline_s
            while not plane.all_terminal() \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
    finally:
        stop.set()
        server.shutdown()
        router.close()
        for p in procs:
            p.drain(timeout_s=args.startup_timeout_s)
        merge_replica_shards(os.path.join(fleet_dir, "obs"),
                             [p.obs_dir for p in procs])
        try:
            merge_timeseries(os.path.join(fleet_dir, "obs"),
                             [p.obs_dir for p in procs])
        except Exception:
            pass
        trace_fields = _finalize_tracing(os.path.join(fleet_dir, "obs"))
        burn_alerts = _collect_burn_alerts(procs)
        print(json.dumps({"mode": "http", **router.snapshot(),
                          "slo_burn_alerts": len(burn_alerts),
                          **_incident_counts(), **trace_fields}),
              file=sys.stderr, flush=True)
    return rc


def _policy_of(args) -> RouterPolicy:
    return RouterPolicy(
        queue_bound=args.queue_bound,
        max_attempts=args.max_attempts,
        attempt_timeout_s=args.attempt_timeout_s,
        default_deadline_s=args.deadline_s,
        seed=args.seed,
        health_every_s=args.health_every_s,
        max_inflight_per_replica=args.inflight_per_replica)


def fleet_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch fleet",
        description="fault-tolerant multi-replica serving plane: "
                    "health-checked router over N serve replicas, "
                    "durable request journal, redrive on replica "
                    "death, degraded-mode admission, failover drills")
    p.add_argument("preset", help="preset/model name every replica "
                                  "serves (same seed ⇒ identical "
                                  "weights ⇒ redrive bit-identity)")
    p.add_argument("--checkpoint", metavar="DIR",
                   help="serve this checkpoint on every replica")
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max-len", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run the router process and every replica on the CPU "
                        "(default: the CUDA device)")
    p.add_argument("--kv-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="every replica's KV-cache dtype (serve "
                        "--kv-dtype), and the --verify replays'; serve an "
                        "int4/int8 checkpoint with bfloat16")
    p.add_argument("--fleet-dir", default="logs/fleet",
                   help="journal + per-replica obs/run/log dirs + the "
                        "merged fleet obs dir live here")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--synthetic", type=int, metavar="N",
                      help="failover drill: N open-loop Poisson "
                           "requests, JSON summary, exit 1 on any "
                           "accepted-request loss")
    mode.add_argument("--http", type=int, metavar="PORT",
                      help="serve the fleet HTTP endpoint")
    mode.add_argument("--scenario", metavar="JSON",
                      help="scenario replay drill: replay a committed "
                           "workload scenario (results/scenarios/) "
                           "against the fleet — digest-asserted "
                           "deterministic traffic, per-tenant QoS from "
                           "the spec, JSON summary, exit 1 on any "
                           "accepted-request loss (add --autoscale for "
                           "the supervisor chaos drill)")
    p.add_argument("--autoscale", action="store_true",
                   help="scenario: run the SLO-driven autoscaling "
                        "supervisor (scale on queue age / breach "
                        "fraction between --replicas and "
                        "--max-replicas, degradation ladder at max, "
                        "every decision ledgered before its effect)")
    p.add_argument("--max-replicas", type=int, default=4,
                   help="autoscale: replica ceiling (past it the "
                        "supervisor climbs the degradation ladder "
                        "instead)")
    p.add_argument("--scale-up-age-s", type=float, default=1.0,
                   help="autoscale: scale up when the oldest pending "
                        "request is older than this")
    p.add_argument("--scale-down-age-s", type=float, default=0.1,
                   help="autoscale: eligible to scale down only below "
                        "this queue age (plus an empty plane)")
    p.add_argument("--scale-cooldown-s", type=float, default=2.0,
                   help="autoscale: quiet period after every action")
    p.add_argument("--degrade-checkpoint", metavar="DIR",
                   help="autoscale: degradation-ladder rung 3 — "
                        "rolling-swap replicas to this PRUNED "
                        "checkpoint when shedding + tightening were "
                        "not enough (omit to skip the rung)")
    p.add_argument("--assert-ttft-p99-ms", type=float, default=0.0,
                   help="scenario: fail the drill when any INTERACTIVE "
                        "tenant's TTFT p99 exceeds this budget "
                        "(0 = no assertion)")
    p.add_argument("--settle-timeout-s", type=float, default=240.0,
                   help="autoscale: post-replay budget for recovery + "
                        "drain-based scale-down to land")
    p.add_argument("--rate", type=float, default=4.0,
                   help="drill: Poisson arrival rate (requests/s)")
    p.add_argument("--prompt-lens", default="4,8,6")
    p.add_argument("--max-new", default="8,5,12")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--shared-prefixes", type=int, default=0, metavar="K",
                   help="drill: draw prompts from a pool of K shared "
                        "system prompts + random suffixes (--prompt-"
                        "lens become SUFFIX lengths) — the prefix-"
                        "affinity workload; 0 = fully random prompts")
    p.add_argument("--prefix-len", type=int, default=32,
                   help="drill: shared system-prompt length in tokens")
    p.add_argument("--sessions", type=int, default=0,
                   help="drill: tag requests with round-robin session "
                        "ids — the router's session-affinity signal")
    p.add_argument("--page-len", type=int, default=0,
                   help="per-replica KV page size (serve --page-len; "
                        "0 = lane-aligned default — note the default "
                        "can be a whole slot at small max-len, which "
                        "makes 16-token prefixes unshareable)")
    p.add_argument("--prefix-pages", type=int, default=0,
                   help="per-replica shared-prefix KV pool pages "
                        "(serve --prefix-pages on every replica; 0 = "
                        "sharing off)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="per-replica chunked-prefill width (serve "
                        "--prefill-chunk; 0 = auto with prefix pages)")
    p.add_argument("--prefill-cap", type=int, default=0,
                   help="per-replica per-step prefill-token budget "
                        "(serve --prefill-cap; 0 = uncapped)")
    p.add_argument("--verify", action="store_true",
                   help="drill: re-decode every completed request from "
                        "the journal through solo generate() and "
                        "assert token bit-identity (the redrive "
                        "correctness contract)")
    p.add_argument("--chaos", metavar="JSON",
                   help="fleet fault injection, e.g. "
                        "'{\"kill_replica_at_step\": 8}' (SIGKILL), "
                        "hang_replica_at_step (SIGSTOP), "
                        "slow_replica_ms (per-step stall), "
                        "replica_index")
    p.add_argument("--swap-checkpoint", metavar="DIR",
                   help="drill: rolling hot-swap every replica to this "
                        "checkpoint once --swap-after dispatches "
                        "happened (the fleet upgrade loop)")
    p.add_argument("--swap-after", type=int, default=4)
    p.add_argument("--queue-bound", type=int, default=64,
                   help="router pending-queue bound (shed past it; "
                        "tightened while degraded)")
    p.add_argument("--replica-queue-bound", type=int, default=8,
                   help="per-replica scheduler queue bound (the serve "
                        "--queue-bound each replica runs with)")
    p.add_argument("--deadline-s", type=float, default=300.0,
                   help="per-request deadline budget")
    p.add_argument("--max-attempts", type=int, default=10)
    p.add_argument("--attempt-timeout-s", type=float, default=90.0)
    p.add_argument("--health-every-s", type=float, default=0.25)
    p.add_argument("--inflight-per-replica", type=int, default=4)
    p.add_argument("--drill-timeout-s", type=float, default=900.0)
    p.add_argument("--startup-timeout-s", type=float, default=300.0)
    p.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                   help="forwarded to every replica (their /healthz "
                        "flips to slo_breach on episodes — the "
                        "router's degraded-admission signal)")
    p.add_argument("--slo-token-p99-ms", type=float, default=None)
    p.add_argument("--slo-queue-p99-ms", type=float, default=None,
                   help="replica queue-age-at-admission p99 SLO (ms); "
                        "joins the burn-rate evaluation like the "
                        "ttft/token thresholds")
    p.add_argument("--trace-sample-every", type=int, default=None,
                   metavar="N",
                   help="request-trace exemplar policy on the router "
                        "AND every replica (obs.reqtrace): full stage "
                        "detail for 1-in-N requests plus the slowest-K "
                        "per window; default 1 (eager full tracing) "
                        "for --synthetic drills, 16 for --http")
    p.add_argument("--no-obs", action="store_true")
    args = p.parse_args(argv)
    if args.trace_sample_every is None:
        # the failover drill's acceptance contract needs EVERY
        # request's cross-process waterfall; the long-running endpoint
        # AND the scenario drill sample (a flash crowd must not write
        # a stage line per shed)
        args.trace_sample_every = 1 if args.synthetic is not None else 16

    chaos = FleetChaos.from_any(args.chaos)
    fleet_dir = os.path.abspath(args.fleet_dir)
    os.makedirs(fleet_dir, exist_ok=True)

    # the router process itself computes (model init for synthetic vocab,
    # --verify replays): on the replicas' device
    from torchpruner_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32_matmul,
    )

    args.device = resolve_device("cpu" if args.cpu else None)
    if args.device.type == "cuda":
        strict_fp32_matmul()
        # every replica would otherwise compile the kernels it misses on
        # its own; built once here, a failed build fails the fleet
        # instead of timing out a replica's start-up
        from torchpruner_tpu_torch.ops import _build

        _build.build()

    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.obs import reqtrace

    reqtrace.configure(sample_every=args.trace_sample_every)
    session = None
    if not args.no_obs:
        session = obs.configure(os.path.join(fleet_dir, "obs"))
        obs.annotate_run(experiment=f"fleet:{args.preset}", kind="fleet",
                         model=args.preset, replicas=args.replicas)
    try:
        if args.http is not None:
            return run_http(args.preset, args, fleet_dir, chaos)
        if args.scenario is not None:
            return run_scenario(args.preset, args, fleet_dir, chaos)
        return run_drill(args.preset, args, fleet_dir, chaos)
    finally:
        if session is not None:
            obs.shutdown(print_to=sys.stderr)
            # the session's own export wrote the ROUTER-only trace;
            # overwrite it with the ONE merged fleet trace: every
            # process's span flame on its own pid + the per-request
            # cross-process waterfalls (clock-offset aligned)
            try:
                from torchpruner_tpu_torch.fleet.report import (
                    write_fleet_trace,
                )

                write_fleet_trace(os.path.join(fleet_dir, "obs"))
            except Exception as e:  # the trace must never fail the run
                print(f"[fleet] merged trace export failed: {e}",
                      file=sys.stderr)
            # re-merge the fleet time-series: the router's own final
            # window only lands at session close, so the in-drill merge
            # missed it
            try:
                merge_timeseries(os.path.join(fleet_dir, "obs"))
            except Exception:
                pass
            print(f"fleet telemetry written to "
                  f"{os.path.join(fleet_dir, 'obs')} (merged "
                  f"trace.json: open in ui.perfetto.dev)",
                  file=sys.stderr)


if __name__ == "__main__":
    sys.exit(fleet_main())
