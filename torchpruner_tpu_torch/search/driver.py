"""The campaign driver: concurrent prune-retrain trials, static
pre-pricing, dominance early-stop, and the resumable frontier artifact.
(The port of ``torchpruner_tpu/search/driver.py``.)

``python -m torchpruner_tpu_torch search <campaign>`` runs a whole
attribution→prune→retrain *campaign*: the trial grid is priced
statically before any trial runs (search/pricing.py), the survivors run
concurrently as worker *processes* (each trial a full resilient
prune-retrain run on ``resilience/``: RunManifest + digest-verified
checkpoints + its own obs ledger), the driver polls the
live ledgers and cancels trials whose partial accuracy-at-FLOPs curve is
Pareto-dominated by the completed frontier past a confidence margin
(SIGTERM → the trial snapshots at its next checkpoint boundary — the
preemption path reused as cooperative cancellation), and the outcome
lands as ``frontier.json`` (search/frontier.py) with one provenance
record per point.

Durability model (everything kill -9-safe):

- ``campaign.json`` — the campaign manifest, atomically replaced on
  every state change.  Trial statuses move
  ``pending → running → done | early_stopped | failed`` (plus
  ``excluded`` from pricing and the transient
  ``early_stop_requested``); pricing decisions and early-stop decisions
  are recorded BEFORE they take effect, so a killed driver resumes with
  the same exclusions and the same stops — the decisions, not the
  timing, are the durable truth.
- each trial dir is a resilient run dir: a worker killed mid-round
  resumes cursor-exact; a driver killed mid-campaign re-queues its
  running trials, which resume the same way.
- ``frontier.json`` is rewritten (atomically) after every trial
  completion — the campaign's partial result is always on disk — and
  its ``frontier_digest`` covers only deterministic content, so an
  interrupted-then-resumed campaign reproduces the identical artifact
  (CI-asserted by the chaos drill).

Worker processes claim trials with ``flock`` locks (auto-released on
any death), so a resumed driver can never double-run a trial an
orphaned worker still holds.

Devices: the driver holds no CUDA context — it prices with the chip-less
cost constants and builds the port's kernels (``ops/_build.build``)
before it spawns CUDA workers, so no two workers compile at once.  Each
worker runs on the CUDA device (``--cpu`` campaigns: the CPU); with
``trial_devices`` k each worker slot sees its own k cards through
``CUDA_VISIBLE_DEVICES``, and a trial whose config has a mesh of n
devices runs its worker under ``torchrun --standalone --nproc_per_node
n`` (the port's mesh contract), rank 0 writing ``result.json``.
Workers run in process groups of their own: a SIGTERM (early stop) goes
to the leader, which forwards it; a SIGKILL goes to the whole group.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from torchpruner_tpu_torch.search import frontier as frontier_mod
from torchpruner_tpu_torch.search.grid import CampaignSpec, campaign_names
from torchpruner_tpu_torch.search.pricing import (
    format_exclusions,
    price_campaign,
)

MANIFEST_NAME = "campaign.json"
GRID_NAME = "grid.json"
FRONTIER_NAME = "frontier.json"
RESULT_NAME = "result.json"

#: worker exit codes the driver interprets
EXIT_PREEMPTED = 3
EXIT_LOCKED = 4

#: how long a SIGTERMed worker gets to reach its next checkpoint
#: boundary before escalation to SIGKILL (it resumes nothing — the
#: early-stop decision is already durable)
STOP_GRACE_S = 120.0

#: respawn backoff after a worker found its trial flock still held (an
#: orphan from a killed driver) — without it the driver would launch a
#: full interpreter against the lock every poll
LOCK_RETRY_S = 5.0


@dataclass
class SearchChaos:
    """Driver-side fault injection for the CI chaos drill: SIGKILL the
    driver AND its workers at a deterministic campaign position —
    'mid-trial' (after the K-th completion, while others run) and
    'mid-early-stop' (right after an early-stop decision is recorded
    but before the worker dies)."""

    kill_after_trials: int = -1
    kill_on_early_stop: bool = False

    @classmethod
    def from_any(cls, spec) -> "SearchChaos":
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            spec = json.loads(spec)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown search chaos keys: "
                             f"{sorted(unknown)} (known: {sorted(known)})")
        return cls(**spec)


@dataclass
class CampaignManifest:
    """Durable campaign position — the work-queue's source of truth."""

    version: int = 1
    kind: str = "search"
    name: str = "campaign"
    campaign_id: str = ""
    spec_digest: str = ""
    #: trial_id -> {"overrides", "status", "pricing", "attempts",
    #:              "result", "early_stop"}
    trials: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    status: str = "running"
    resumes: int = 0

    @staticmethod
    def path_in(campaign_dir: str) -> str:
        return os.path.join(os.path.abspath(campaign_dir), MANIFEST_NAME)

    @classmethod
    def load(cls, campaign_dir: str) -> "CampaignManifest":
        from torchpruner_tpu_torch.resilience.manifest import read_json

        raw = read_json(cls.path_in(campaign_dir))
        known = {f.name for f in dataclasses.fields(cls)}
        m = cls(**{k: v for k, v in raw.items() if k in known})
        if m.kind != "search":
            raise ValueError(
                f"{campaign_dir!r} holds a {m.kind!r} manifest — not a "
                f"search campaign dir")
        return m

    def save(self, campaign_dir: str) -> None:
        from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

        atomic_write_json(self.path_in(campaign_dir),
                          dataclasses.asdict(self))


def trial_dir(campaign_dir: str, tid: str) -> str:
    return os.path.join(os.path.abspath(campaign_dir), "trials", tid)


def trial_obs_dir(campaign_dir: str, tid: str) -> str:
    return os.path.join(trial_dir(campaign_dir, tid), "obs")


def _flock(path: str):
    """Exclusive non-blocking lock (None when already held elsewhere) —
    released by the OS on ANY process death, which is exactly the
    orphan-safety a kill -9 drill needs."""
    import fcntl

    os.makedirs(os.path.dirname(path), exist_ok=True)
    f = open(path, "w")
    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        f.close()
        return None
    f.write(str(os.getpid()))
    f.flush()
    return f


# ---------------------------------------------------------------------------
# worker (one trial, one process)
# ---------------------------------------------------------------------------


def run_trial_worker(campaign_dir: str, tid: str, device=None) -> int:
    """Run ONE trial to completion (or a preemption boundary) in this
    process on ``device`` (``None`` = ``cuda``): the full resilient
    prune-retrain loop with its own obs session, every ledger record
    stamped with ``trial_id`` / ``campaign_id``, and a ``result.json``
    (atomic) carrying the frontier point's provenance — final
    accuracy/FLOPs/params, the committed checkpoint's content digest,
    and the ledger run id.  Under ``torchrun`` every rank runs the loop
    and rank 0 alone takes the trial's lock and writes."""
    import torch.distributed as dist

    from torchpruner_tpu_torch.parallel.mesh import (
        initialize_distributed,
        is_writer,
    )
    from torchpruner_tpu_torch.resilience.manifest import read_json

    campaign_dir = os.path.abspath(campaign_dir)
    spec = CampaignSpec.from_any(
        read_json(os.path.join(campaign_dir, GRID_NAME)))
    manifest = CampaignManifest.load(campaign_dir)
    if tid not in manifest.trials:
        print(f"[search] unknown trial {tid!r}", file=sys.stderr)
        return 2
    tdir = trial_dir(campaign_dir, tid)
    joined = not dist.is_initialized() and initialize_distributed(device)
    lock = _flock(os.path.join(tdir, "lock")) if is_writer() else True
    if joined:  # every rank learns whether rank 0 holds the trial
        held = [lock is not None]
        dist.broadcast_object_list(held, src=0)
        lock = lock if held[0] else None
    if lock is None:
        print(f"[search] trial {tid} is locked by a live worker",
              file=sys.stderr)
        if joined:
            dist.destroy_process_group()
        return EXIT_LOCKED
    try:
        return _run_trial(spec, manifest, campaign_dir, tid, tdir, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _run_trial(spec, manifest, campaign_dir: str, tid: str, tdir: str,
               device) -> int:
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        run_prune_retrain,
    )
    from torchpruner_tpu_torch.parallel.mesh import is_writer
    from torchpruner_tpu_torch.resilience.manifest import (
        RunManifest,
        atomic_write_json,
        read_json,
    )
    from torchpruner_tpu_torch.search.grid import TrialSpec
    from torchpruner_tpu_torch.utils.device import resolve_device

    st = manifest.trials[tid]
    trial = TrialSpec(trial_id=tid, overrides=st.get("overrides") or {})
    cfg = spec.trial_config(trial, tdir)
    ledger_run_id = f"{spec.campaign_id}:{tid}"

    t0 = time.perf_counter()
    writer = is_writer()
    session = obs.configure(trial_obs_dir(campaign_dir, tid)) \
        if writer else None
    obs.annotate_run(experiment=cfg.name, kind="prune_retrain",
                     model=cfg.model, method=cfg.method,
                     trial_id=tid, campaign_id=spec.campaign_id,
                     run_id=ledger_run_id)
    obs.set_trial(tid, campaign_id=spec.campaign_id)
    # the pre-pricing already predicted this trial's step/HBM numbers —
    # land them as the standard gauges without recompiling the twin
    pricing = st.get("pricing") or {}
    for key, gauge in (("predicted_step_ms", "predicted_step_ms"),
                       ("predicted_comm_ms", "predicted_comm_ms"),
                       ("predicted_hbm_bytes_per_chip",
                        "predicted_hbm_bytes_per_chip")):
        if pricing.get(key) is not None:
            obs.gauge_set(gauge, pricing[key],
                          help="search pre-pricing prediction")
    try:
        with obs.span("trial", trial=tid, campaign=spec.campaign_id):
            history = run_prune_retrain(cfg, verbose=False, device=device)
    finally:
        derived = session.derived() if session else {}
    if not writer:
        # rank 0 commits the run's last manifest after the loop returns
        # on every rank: it alone reads the outcome and writes the result
        return 0
    m = RunManifest.load(tdir) if RunManifest.exists_in(tdir) else None
    if m is None or m.status != "done":
        obs.shutdown(print_to=sys.stderr)
        return EXIT_PREEMPTED if m is not None \
            and m.status == "preempted" else 1

    last = history[-1] if history else None
    rounds = (session.ledger.records("round")
              if session and session.ledger else [])
    flops = next((r.get("flops") for r in reversed(rounds)
                  if r.get("flops") is not None), None)
    # the per-round (flops, acc) curve — what the driver's rung-matched
    # dominance check judges running trials against
    curve = [[float(r["flops"]), float((r.get("post") or {})["acc"])]
             for r in rounds
             if r.get("flops") is not None
             and (r.get("post") or {}).get("acc") is not None]
    digest = None
    if m.checkpoint:
        try:
            spec_json = read_json(
                os.path.join(tdir, m.checkpoint, "spec.json"))
            digest = spec_json.get("digest")
        except Exception:  # noqa: BLE001 — provenance is best-effort
            digest = None
    result = {
        "trial_id": tid,
        "campaign_id": spec.campaign_id,
        "ledger_run_id": ledger_run_id,
        "final_acc": float(last.post_acc) if last else None,
        "final_loss": float(last.post_loss) if last else None,
        "params": int(last.n_params) if last else None,
        "flops": flops,
        "widths": dict(last.widths) if last else None,
        "curve": curve,
        "rounds": len(history),
        "checkpoint": m.checkpoint,
        "checkpoint_digest": digest,
        "obs_dir": trial_obs_dir(campaign_dir, tid),
        # where the trial ran (not a frontier point key)
        "device": str(resolve_device(device)),
        # volatile measurements (kept out of the frontier digest)
        "step_time_mean_s": derived.get("step_time_mean_s"),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    atomic_write_json(os.path.join(tdir, RESULT_NAME), result)
    obs.shutdown(print_to=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _partial_points(obs_dir: str,
                    cache: Optional[Dict[str, Tuple[int, list]]] = None
                    ) -> List[Tuple[float, float]]:
    """A running trial's committed (flops, accuracy) round points, read
    from its LIVE ledger (torn tails skipped — the file is mid-write by
    another process, which is the point).  ``cache`` (keyed by path,
    holding ``(size, points)``) skips the re-parse while the file has
    not grown — the driver polls ~2×/s and a long trial's ledger holds
    thousands of non-round records."""
    from torchpruner_tpu_torch.obs.ledger import LEDGER_FILENAME, load_ledger

    path = os.path.join(obs_dir, LEDGER_FILENAME)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = -1
    if cache is not None and path in cache and cache[path][0] == size:
        return cache[path][1]
    pts = []
    for r in load_ledger(path):
        if r.get("event") != "round":
            continue
        a = (r.get("post") or {}).get("acc")
        f = r.get("flops")
        if a is not None and f is not None:
            pts.append((float(f), float(a)))
    if cache is not None:
        cache[path] = (size, pts)
    return pts


def _dense_flops(spec: CampaignSpec) -> Optional[float]:
    """Forward FLOPs of the unpruned base model — the denominator of
    the frontier's FLOPs buckets.  Deterministic shape math (the same
    ``model_cost`` the round records use)."""
    try:
        from torchpruner_tpu_torch.core.segment import init_model
        from torchpruner_tpu_torch.experiments.prune_retrain import (
            MODEL_REGISTRY,
        )
        from torchpruner_tpu_torch.utils.flops import model_cost

        model = MODEL_REGISTRY[spec.base_config().model][0]()
        params, state = init_model(model, seed=0, device="cpu")
        _, flops = model_cost(model, params, state)
        return float(flops) if flops else None
    except Exception:  # noqa: BLE001
        return None


def _worker_env(spec: CampaignSpec, slot: int, cpu: bool) -> Dict[str, str]:
    """Per-worker environment: device isolation.  CUDA campaigns with
    ``trial_devices`` k give each worker slot a disjoint k-card slice
    through ``CUDA_VISIBLE_DEVICES``; everything else inherits.  No
    device probe here: the driver must never initialize CUDA (a context
    would hold memory on the very cards the workers need)."""
    env = dict(os.environ)
    k = spec.trial_devices
    if k and not cpu:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(slot * k + j) for j in range(k))
    return env


def _mesh_size(cfg) -> int:
    n = 1
    for v in (cfg.mesh or {}).values():
        n *= int(v)
    return n


def _worker_cmd(spec: CampaignSpec, campaign_dir: str, tid: str,
                overrides: Dict[str, Any], cpu: bool) -> List[str]:
    """The worker's command: ``python -m torchpruner_tpu_torch search
    --run-trial TID``, under ``torchrun --standalone --nproc_per_node n``
    when the trial's config has a mesh of n devices."""
    from torchpruner_tpu_torch.search.grid import TrialSpec

    cmd = ["-m", "torchpruner_tpu_torch", "search",
           "--campaign-dir", campaign_dir, "--run-trial", tid]
    if cpu:
        cmd.append("--cpu")
    cfg = spec.trial_config(TrialSpec(tid, overrides),
                            trial_dir(campaign_dir, tid))
    n = _mesh_size(cfg)
    if n > 1:
        return [sys.executable, "-m", "torch.distributed.run",
                "--standalone", f"--nproc_per_node={n}", *cmd]
    return [sys.executable, *cmd]


def run_campaign(spec: CampaignSpec, campaign_dir: str, *,
                 jobs: Optional[int] = None, cpu: bool = False,
                 poll_s: float = 0.5, chaos: Optional[SearchChaos] = None,
                 frontier_out: Optional[str] = None,
                 verbose: bool = True) -> Dict[str, Any]:
    """The campaign loop: price → schedule → poll/early-stop → frontier.
    Returns the final frontier dict.  Safe to kill -9 at any instant and
    re-invoke with the same ``campaign_dir``."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.resilience.manifest import (
        RunManifest,
        atomic_write_json,
        read_json,
    )

    campaign_dir = os.path.abspath(campaign_dir)
    os.makedirs(campaign_dir, exist_ok=True)
    chaos = chaos or SearchChaos()
    jobs = jobs or spec.jobs
    lock = _flock(os.path.join(campaign_dir, "driver.lock"))
    if lock is None:
        raise RuntimeError(
            f"another campaign driver is live on {campaign_dir!r} "
            f"(driver.lock held)")

    trials = spec.enumerate_trials()
    resuming = os.path.exists(CampaignManifest.path_in(campaign_dir))
    if resuming:
        manifest = CampaignManifest.load(campaign_dir)
        if manifest.spec_digest != spec.digest():
            raise ValueError(
                f"campaign dir {campaign_dir!r} was created from a "
                f"different grid (digest {manifest.spec_digest[:12]} != "
                f"{spec.digest()[:12]}) — resuming would change the "
                f"trial set; use a fresh directory")
        manifest.resumes += 1
        obs.inc("search_campaign_resumes_total",
                help="campaign drivers resumed from campaign.json")
    else:
        manifest = CampaignManifest(
            name=spec.name, campaign_id=spec.campaign_id,
            spec_digest=spec.digest(),
            trials={t.trial_id: {"overrides": dict(t.overrides),
                                 "status": "pending", "attempts": 0}
                    for t in trials})
        atomic_write_json(os.path.join(campaign_dir, GRID_NAME),
                          spec.to_dict())
    manifest.status = "running"

    def log(msg: str) -> None:
        if verbose:
            print(f"[search:{spec.name}] {msg}", flush=True)

    # -- resume reconciliation: decisions are durable, timing is not ----
    for tid, st in manifest.trials.items():
        if st["status"] == "early_stop_requested":
            # the stop decision was recorded before the kill — finalize
            # it; whatever the orphan worker managed to commit is moot
            _finalize_early_stop(manifest, tid, log)
        elif st["status"] == "running":
            # a driver death mid-flight: the worker may have finished,
            # died, or still be running (its flock shows).  A finished
            # trial's result is adopted; anything else re-queues and
            # resumes cursor-exact on the trial's own RunManifest.
            res_path = os.path.join(trial_dir(campaign_dir, tid),
                                    RESULT_NAME)
            tdir = trial_dir(campaign_dir, tid)
            done = (os.path.exists(res_path)
                    and RunManifest.exists_in(tdir)
                    and RunManifest.load(tdir).status == "done")
            if done:
                st["status"] = "done"
                st["result"] = read_json(res_path)
                log(f"{tid}: adopted a completed result from the "
                    f"previous driver")
            else:
                st["status"] = "pending"
    manifest.save(campaign_dir)

    # -- pre-pricing (once; exclusions are durable across resumes) ------
    unpriced = [t for t in trials
                if "pricing" not in manifest.trials[t.trial_id]]
    if unpriced:
        with obs.span("search_pricing", campaign=spec.campaign_id):
            pricing = price_campaign(spec, unpriced, campaign_dir)
        for tid, p in pricing.items():
            st = manifest.trials[tid]
            st["pricing"] = p
            if p["excluded_by"]:
                st["status"] = "excluded"
                obs.record_trial(trial_id=tid, status="excluded",
                                 excluded_by=p["excluded_by"],
                                 reasons=p["reasons"])
        manifest.save(campaign_dir)
        excl = format_exclusions(pricing)
        if excl:
            log("pre-pricing exclusions:\n" + excl)
    n_excluded = sum(1 for st in manifest.trials.values()
                     if st["status"] == "excluded")
    obs.gauge_set("search_candidates_total", len(manifest.trials),
                  help="search: enumerated trial candidates")
    obs.gauge_set("search_excluded_total", n_excluded,
                  help="search: candidates excluded by pre-pricing")

    # -- deterministic queue: cheapest predicted trials first, so the
    # frontier anchors exist before expensive trials need judging ------
    def cost_key(tid: str):
        p = manifest.trials[tid].get("pricing") or {}
        return (p.get("predicted_trial_s") or float("inf"), tid)

    queue = sorted(
        (tid for tid, st in manifest.trials.items()
         if st["status"] == "pending"), key=cost_key)
    log(f"{len(manifest.trials)} candidate(s): {len(queue)} queued, "
        f"{n_excluded} excluded, "
        f"{sum(1 for s in manifest.trials.values() if s['status'] == 'done')} "
        f"already done (resume #{manifest.resumes})")

    procs: Dict[str, subprocess.Popen] = {}
    stop_deadline: Dict[str, float] = {}
    slot_of: Dict[str, int] = {}
    #: trial_id -> monotonic time before which it must not respawn
    #: (flock backoff: an orphan worker from a killed driver may hold a
    #: trial for minutes — respawning every poll would busy-loop full
    #: interpreter launches against the lock)
    defer: Dict[str, float] = {}
    #: ledger-poll cache: path -> (file size, parsed round points)
    ledger_cache: Dict[str, Tuple[int, list]] = {}
    completions = 0

    def chaos_kill() -> None:
        """The drill's kill -9: workers first (no orphans to fight the
        resumed driver), then the driver itself — no cleanup, no
        goodbye, exactly what a preempted VM gets."""
        for p in procs.values():
            _signal_group(p, signal.SIGKILL)
        os.kill(os.getpid(), signal.SIGKILL)

    def spawn(tid: str) -> None:
        st = manifest.trials[tid]
        st["status"] = "running"
        st["attempts"] = st.get("attempts", 0) + 1
        manifest.save(campaign_dir)
        slot = next(i for i in range(jobs) if i not in slot_of.values())
        slot_of[tid] = slot
        cmd = _worker_cmd(spec, campaign_dir, tid,
                          st.get("overrides") or {}, cpu)
        # worker output appends to a per-trial log across attempts — a
        # failed trial's traceback must survive for diagnosis (the same
        # loud-by-contract rule the pricing exclusions follow)
        tdir = trial_dir(campaign_dir, tid)
        os.makedirs(tdir, exist_ok=True)
        logf = open(os.path.join(tdir, "worker.log"), "a")
        procs[tid] = subprocess.Popen(
            cmd, env=_worker_env(spec, slot, cpu),
            stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)
        logf.close()  # the child holds its own descriptor
        log(f"{tid}: started (attempt {st['attempts']}, slot {slot}, "
            f"pid {procs[tid].pid})")

    def completed_curves() -> List[List[Tuple[float, float]]]:
        """Completed trials' per-round (flops, acc) curves — the rungs
        the dominance check matches running trials against."""
        curves = []
        for st in manifest.trials.values():
            r = st.get("result") or {}
            if st["status"] == "done" and r.get("curve"):
                curves.append([(float(f), float(a))
                               for f, a in r["curve"]])
        return curves

    def results() -> Dict[str, Dict[str, Any]]:
        return {tid: st["result"] for tid, st in manifest.trials.items()
                if st["status"] == "done" and st.get("result")}

    if queue and not cpu:
        # built once here, before any worker starts: two workers never
        # compile into the build directory at once, and a failed build
        # fails the campaign (nvcc makes no CUDA context)
        from torchpruner_tpu_torch.ops import _build

        _build.build()

    dense = _dense_flops(spec)
    margin = float(spec.early_stop.get("margin", 0.1))
    min_rounds = int(spec.early_stop.get("min_rounds", 1))
    out_path = frontier_out or os.path.join(campaign_dir, FRONTIER_NAME)

    def write_partial_frontier() -> Dict[str, Any]:
        f = frontier_mod.build_frontier(
            spec=spec, manifest=manifest, results=results(),
            dense_flops=dense, margin=spec.frontier_margin)
        frontier_mod.write_frontier(f, out_path)
        return f

    with obs.span("search_schedule", campaign=spec.campaign_id):
        while queue or procs:
            while queue and len(procs) < jobs:
                now = time.monotonic()
                ready = [t for t in queue if now >= defer.get(t, 0.0)]
                if not ready:
                    break  # every queued trial is backing off a lock
                queue.remove(ready[0])
                spawn(ready[0])

            time.sleep(poll_s)

            # -- reap finished workers --------------------------------
            for tid in [t for t, p in procs.items()
                        if p.poll() is not None]:
                rc = procs.pop(tid).returncode
                slot_of.pop(tid, None)
                stop_deadline.pop(tid, None)
                st = manifest.trials[tid]
                tdir = trial_dir(campaign_dir, tid)
                rm_status = (RunManifest.load(tdir).status
                             if RunManifest.exists_in(tdir) else "")
                res_path = os.path.join(tdir, RESULT_NAME)
                if st["status"] == "early_stop_requested":
                    # the recorded decision WINS even when the worker
                    # raced to completion before the SIGTERM landed —
                    # the resume path finalizes the same way, so an
                    # interrupted and an uninterrupted campaign can
                    # never disagree about this trial's fate
                    _finalize_early_stop(manifest, tid, log)
                    manifest.save(campaign_dir)
                elif rc == 0 and rm_status == "done" \
                        and os.path.exists(res_path):
                    st["status"] = "done"
                    st["result"] = read_json(res_path)
                    completions += 1
                    obs.inc("search_trials_completed_total",
                            help="search: trials run to completion")
                    r = st["result"]
                    obs.record_trial(
                        trial_id=tid, status="done",
                        accuracy=r.get("final_acc"), flops=r.get("flops"),
                        params=r.get("params"),
                        checkpoint_digest=r.get("checkpoint_digest"))
                    log(f"{tid}: done (acc "
                        f"{r.get('final_acc')}, params {r.get('params')})")
                    manifest.save(campaign_dir)
                    write_partial_frontier()
                    if chaos.kill_after_trials >= 0 \
                            and completions >= chaos.kill_after_trials:
                        chaos_kill()
                elif rm_status == "preempted" or rc == EXIT_LOCKED:
                    # an external preemption (or a still-locked trial):
                    # back to the queue, it resumes cursor-exact — and
                    # it is not a crash, so it must not burn an attempt
                    st["attempts"] = max(0, st.get("attempts", 1) - 1)
                    st["status"] = "pending"
                    queue.append(tid)
                    queue.sort(key=cost_key)
                    if rc == EXIT_LOCKED:
                        defer[tid] = time.monotonic() + LOCK_RETRY_S
                    manifest.save(campaign_dir)
                    log(f"{tid}: preempted/locked (rc {rc}) — requeued")
                else:
                    if st.get("attempts", 0) >= spec.max_attempts:
                        st["status"] = "failed"
                        st["exit_code"] = rc
                        obs.inc("search_trials_failed_total",
                                help="search: trials failed past the "
                                     "attempt budget")
                        obs.record_trial(trial_id=tid, status="failed",
                                         exit_code=rc)
                        log(f"{tid}: FAILED (rc {rc}, "
                            f"{st['attempts']} attempts) — see "
                            f"{os.path.join(tdir, 'worker.log')}")
                    else:
                        st["status"] = "pending"
                        queue.append(tid)
                        queue.sort(key=cost_key)
                        log(f"{tid}: crashed (rc {rc}) — requeued "
                            f"(attempt {st['attempts']}/"
                            f"{spec.max_attempts})")
                    manifest.save(campaign_dir)

            # -- dominance early-stop over the LIVE ledgers -----------
            front = completed_curves()
            for tid, proc in procs.items():
                st = manifest.trials[tid]
                if st["status"] == "early_stop_requested":
                    if time.monotonic() > stop_deadline.get(
                            tid, float("inf")):
                        # boundary never came; the decision holds
                        _signal_group(proc, signal.SIGKILL)
                    continue
                partial = _partial_points(
                    trial_obs_dir(campaign_dir, tid), ledger_cache)
                if frontier_mod.curve_dominated(
                        partial, front, margin=margin,
                        min_points=min_rounds):
                    # decision BEFORE signal: the stop must survive a
                    # driver kill between these two lines
                    st["status"] = "early_stop_requested"
                    st["early_stop"] = {
                        "at_points": len(partial),
                        "margin": margin,
                        "reason": "partial accuracy-at-FLOPs curve "
                                  "Pareto-dominated by the completed "
                                  "frontier past the confidence margin",
                    }
                    manifest.save(campaign_dir)
                    log(f"{tid}: dominated after {len(partial)} "
                        f"round(s) — cancelling at the next checkpoint "
                        f"boundary")
                    if chaos.kill_on_early_stop:
                        chaos_kill()
                    proc.send_signal(signal.SIGTERM)
                    stop_deadline[tid] = time.monotonic() + STOP_GRACE_S

    # -- final frontier --------------------------------------------------
    fr = write_partial_frontier()
    frontier_mod.record_obs(fr)
    # the counters must reflect the WHOLE campaign even when part of it
    # ran under a pre-kill driver process (counters are per-process):
    # top each up to the frontier's authoritative count
    for counter, n, hlp in (
        ("search_trials_early_stopped_total",
         fr["counts"]["early_stopped"],
         "search: trials early-stopped as Pareto-dominated"),
        ("search_trials_completed_total", fr["counts"]["completed"],
         "search: trials run to completion"),
        ("search_trials_failed_total", fr["counts"]["failed"],
         "search: trials failed past the attempt budget"),
    ):
        already = obs.counter_value(counter)
        if n > already:
            obs.inc(counter, n - already, help=hlp)
    manifest.status = "done"
    manifest.save(campaign_dir)
    log(f"frontier written to {out_path} "
        f"(digest {fr['frontier_digest'][:12]})")
    # the contract that the workers own the cards, said by the one
    # process that knows: torch made no CUDA context here
    log("driver CUDA context: "
        + ("yes" if _cuda_initialized() else "none"))
    return fr


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    """``sig`` to a worker's whole process group (a torchrun leader and
    its ranks); a group already gone is fine."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def _finalize_early_stop(manifest: CampaignManifest, tid: str, log) -> None:
    from torchpruner_tpu_torch import obs

    st = manifest.trials[tid]
    st["status"] = "early_stopped"
    obs.inc("search_trials_early_stopped_total",
            help="search: trials early-stopped as Pareto-dominated")
    obs.record_trial(trial_id=tid, status="early_stopped",
                     **(st.get("early_stop") or {}))
    log(f"{tid}: early-stopped (dominated)")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def search_main(argv=None) -> int:
    """``python -m torchpruner_tpu_torch search <campaign> [...]``."""
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch search",
        description="Pareto sparsity-search campaign driver: concurrent "
                    "prune-retrain trials with static pre-pricing, "
                    "dominance early-stop, and a resumable frontier "
                    "artifact",
    )
    p.add_argument("campaign", nargs="?", default=None,
                   help=f"campaign preset ({', '.join(campaign_names())}) "
                        f"or a campaign-spec JSON path")
    p.add_argument("--campaign-dir", metavar="DIR",
                   help="campaign working dir (campaign.json, trials/, "
                        "frontier.json); an existing dir RESUMES the "
                        "campaign.  Default logs/search_<name>")
    p.add_argument("--jobs", type=int, default=None,
                   help="concurrent trial worker processes "
                        "(default: the spec's)")
    p.add_argument("--cpu", action="store_true",
                   help="run the trials on the CPU (default: the CUDA "
                        "device; the driver itself never uses it)")
    p.add_argument("--smoke", action="store_true",
                   help="smoke-size the base config (campaign presets "
                        "choose their own default)")
    p.add_argument("--poll-s", type=float, default=0.5,
                   help="driver poll cadence for reaping workers and "
                        "scanning live ledgers for dominance")
    p.add_argument("--trial-devices", type=int, default=None,
                   help="CUDA devices per worker (overrides the spec): "
                        "each worker slot sees its own cards through "
                        "CUDA_VISIBLE_DEVICES")
    p.add_argument("--frontier-out", metavar="PATH",
                   help="frontier artifact path "
                        "(default <campaign-dir>/frontier.json)")
    p.add_argument("--chaos", metavar="JSON",
                   help="driver-side fault injection for the drill, "
                        "e.g. '{\"kill_after_trials\": 2}' or "
                        "'{\"kill_on_early_stop\": true}'")
    p.add_argument("--report", action="store_true",
                   help="re-render an existing frontier.json and exit")
    p.add_argument("--run-trial", metavar="TRIAL_ID",
                   help="(internal) worker mode: run one trial of "
                        "--campaign-dir in this process")
    args = p.parse_args(argv)

    if args.run_trial:
        if not args.campaign_dir:
            p.error("--run-trial needs --campaign-dir")
        return run_trial_worker(args.campaign_dir, args.run_trial,
                                device="cpu" if args.cpu else None)

    if args.report:
        # re-rendering needs only the artifact path — never the spec
        path = args.frontier_out or (
            os.path.join(args.campaign_dir, FRONTIER_NAME)
            if args.campaign_dir else None)
        if path is None and args.campaign:
            spec = CampaignSpec.from_any(args.campaign)
            path = os.path.join("logs", f"search_{spec.name}",
                                FRONTIER_NAME)
        if path is None:
            p.error("--report needs --campaign-dir, --frontier-out, or "
                    "a campaign name to locate frontier.json")
        with open(path) as f:
            print(frontier_mod.format_frontier(json.load(f)))
        return 0

    if not args.campaign:
        p.error("give a campaign preset name or spec JSON path "
                f"(presets: {', '.join(campaign_names())})")
    # the DRIVER holds no device: pricing and enumeration are static
    # (the chip-less cost constants), and a driver with a CUDA context
    # would hold memory on the cards its workers need
    spec = CampaignSpec.from_any(args.campaign)
    if args.smoke:
        spec = dataclasses.replace(spec, smoke=True)
    if args.trial_devices is not None:
        # an execution knob, not search identity (excluded from the
        # spec digest like jobs) — a resume may re-slice freely
        spec = dataclasses.replace(spec, trial_devices=args.trial_devices)
    campaign_dir = args.campaign_dir or os.path.join(
        "logs", f"search_{spec.name}")

    from torchpruner_tpu_torch import obs

    obs.configure(os.path.join(campaign_dir, "obs"))
    obs.annotate_run(experiment=spec.name, kind="search",
                     campaign_id=spec.campaign_id, base=spec.base)
    try:
        with obs.span("search", campaign=spec.campaign_id):
            fr = run_campaign(
                spec, campaign_dir, jobs=args.jobs, cpu=args.cpu,
                poll_s=args.poll_s,
                chaos=SearchChaos.from_any(args.chaos),
                frontier_out=args.frontier_out)
    finally:
        obs.shutdown(print_to=sys.stderr)
    print(frontier_mod.format_frontier(fr))
    if not fr["points"]:
        print("no trial completed — see the per-candidate exclusion "
              "reasons and trial statuses in campaign.json",
              file=sys.stderr)
        return 1
    return 0
