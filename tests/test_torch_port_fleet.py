"""The port's serving fleet (``torchpruner_tpu_torch/fleet/``) on the CPU,
held against the JAX package's ``torchpruner_tpu/fleet/``.

- the request plane: the JAX ``tests/test_fleet.py`` plane cases, and a
  journal written by either package's ``RequestPlane`` loaded by the
  other with equal records;
- scenarios: both committed scenarios (and the unit spec of
  ``tests/test_qos.py``) give the same schedule and digest in both
  packages, and ``validate_scenario`` rejects the same junk;
- the router: the router cases of ``tests/test_fleet.py`` on scripted
  fake replicas through both packages' routers, with equal record
  states, results, ``completed_by`` where the case fixes it, and
  counters;
- the supervisor: the signal sequences of ``tests/test_qos.py`` give the
  same actions in both packages;
- reports: shard merge, time-series merge and fleet incident assembly
  give equal output from both packages on the same directories;
- live engines: the port's router over two in-process port engines on
  the JAX ``llama_tiny`` weights (bit-identical to the port's solo
  ``generate()``, greedy tokens equal to the JAX solo ``generate()``
  under the margin rule), with a counted failover;
- the CLI drill: ``fleet llama_tiny --smoke --cpu`` with a ``kill -9``,
  its summary, journal (loaded by the JAX plane too), merged report and
  ``obs incident`` on its obs directory.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torchpruner_tpu.fleet as J
import torchpruner_tpu_torch.fleet as P
from torchpruner_tpu.fleet import report as j_report
from torchpruner_tpu.fleet import supervisor as j_sup
from torchpruner_tpu.fleet import workload as j_work
from torchpruner_tpu_torch.fleet import report as p_report
from torchpruner_tpu_torch.fleet import supervisor as p_sup
from torchpruner_tpu_torch.fleet import workload as p_work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(glob.glob(os.path.join(HERE, "results", "scenarios",
                                          "*.json")))
PAYLOAD = {"prompt_ids": [1, 2, 3], "max_new": 4, "eos_id": None,
           "temperature": 0.0, "top_k": None, "top_p": None, "seed": 7}
PKGS = {"jax": J, "port": P}


def test_exports_match_jax():
    assert P.__all__ == J.__all__
    assert (P.ACCEPTED, P.DISPATCHED, P.COMPLETED, P.FAILED) \
        == (J.ACCEPTED, J.DISPATCHED, J.COMPLETED, J.FAILED)
    assert p_sup.RUNGS == j_sup.RUNGS
    assert dataclasses.asdict(P.RouterPolicy()) \
        == dataclasses.asdict(J.RouterPolicy())
    assert dataclasses.asdict(P.ScalePolicy()) \
        == dataclasses.asdict(J.ScalePolicy())


# -- request plane (test_fleet.py:36-140) ------------------------------------


def test_plane_accept_is_durable_before_ack(tmp_path):
    journal = str(tmp_path / "journal.json")
    plane = P.RequestPlane(journal)
    rec = plane.accept(PAYLOAD, deadline_s=60.0)
    raw = json.load(open(journal))
    assert [r["rid"] for r in raw["records"]] == [rec.rid]
    assert raw["records"][0]["state"] == P.ACCEPTED
    assert raw["records"][0]["payload"]["prompt_ids"] == [1, 2, 3]
    assert rec.remaining_s() > 50


def test_plane_lifecycle_and_idempotent_completion(tmp_path):
    plane = P.RequestPlane(str(tmp_path / "j.json"))
    rec = plane.accept(PAYLOAD, deadline_s=60.0)
    got = plane.checkout()
    assert got is rec and rec.state == P.DISPATCHED
    assert plane.checkout() is None
    plane.assign(rec.rid, "replica0")
    assert rec.replica == "replica0" and rec.attempts == 1
    assert plane.assigned_to("replica0") == [rec.rid]
    assert plane.release(rec.rid, redrive=True)
    assert rec.state == P.ACCEPTED and rec.redrives == 1
    assert plane.pending_depth == 1
    plane.checkout()
    assert plane.complete(rec.rid, [9, 8, 7, 6], "replica1")
    assert rec.state == P.COMPLETED and rec.completed_by == "replica1"
    assert rec._event.is_set()
    assert not plane.complete(rec.rid, [0, 0, 0, 0], "replica0")
    assert rec.tokens == [9, 8, 7, 6]
    assert plane.duplicate_results_total == 1
    assert not plane.release(rec.rid)
    assert not plane.fail(rec.rid, "late")
    assert plane.all_terminal()


def _three_record_journal(pkg, journal):
    """accepted a -> dispatched on replica0, b completed, c accepted."""
    plane = pkg.RequestPlane(journal)
    a = plane.accept(PAYLOAD, deadline_s=60.0)
    b = plane.accept({**PAYLOAD, "prompt_ids": [4, 5]}, deadline_s=60.0)
    c = plane.accept({**PAYLOAD, "session_id": "s1"}, deadline_s=60.0)
    plane.checkout()
    plane.assign(a.rid, "replica0")
    plane.checkout()
    plane.complete(b.rid, [1], "replica1")
    plane.note_shed()
    return a.rid, b.rid, c.rid


def test_plane_load_redrives_non_terminal(tmp_path):
    journal = str(tmp_path / "j.json")
    a, b, c = _three_record_journal(P, journal)
    revived = P.RequestPlane.load(journal)
    assert revived.get(b).state == P.COMPLETED
    assert revived.get(b)._event.is_set()
    assert revived.get(a).state == P.ACCEPTED
    assert revived.get(a).redrives == 1
    assert revived.get(c).redrives == 0
    assert revived.pending_depth == 2
    fresh = revived.accept(PAYLOAD, deadline_s=1.0)
    assert fresh.rid not in {a, b, c}


def test_plane_compaction_bounds_journal(tmp_path):
    journal = str(tmp_path / "j.json")
    plane = P.RequestPlane(journal, retain_terminal=2)
    recs = [plane.accept(PAYLOAD, deadline_s=60.0) for _ in range(5)]
    keep = plane.accept(PAYLOAD, deadline_s=60.0)
    for r in recs:
        plane.checkout()
        plane.complete(r.rid, [1], "replica0")
    assert plane.compacted_total == 3
    raw = json.load(open(journal))
    states = [r["state"] for r in raw["records"]]
    assert states.count("completed") == 2
    assert plane.get(keep.rid) is not None
    assert recs[0]._event.is_set()


@pytest.mark.parametrize("end", ["complete", "fail"])
def test_plane_terminal_record_leaves_the_queue(tmp_path, end):
    """A failover re-queues a dispatched record (``release``) while the
    worker that held it retries it on a survivor and completes it.  The
    port's plane drops the now-terminal record from the queue, so it is
    neither dispatched nor counted again; the JAX package's plane hands
    the completed record out once more, marked dispatched, and a second
    completion then counts it twice (``fleet_completed_total`` 9 of 8 in
    a CLI drill)."""
    out = {}
    for name, pkg in PKGS.items():
        plane = pkg.RequestPlane(str(tmp_path / f"{name}.json"))
        rec = plane.accept(PAYLOAD, deadline_s=60.0)
        plane.checkout()
        plane.assign(rec.rid, "replica0")
        assert plane.release(rec.rid, redrive=True)  # the failover
        plane.assign(rec.rid, "replica1")  # the worker's retry
        if end == "complete":
            assert plane.complete(rec.rid, [5], "replica1")
        else:
            assert plane.fail(rec.rid, "deadline")
        again = plane.checkout()
        out[name] = (again is not None, rec.state, plane.pending_depth)
        if again is not None:  # the second worker's result
            plane.complete(rec.rid, [5], "replica1")
    state = "completed" if end == "complete" else "failed"
    assert out["port"] == (False, state, 0)
    assert out["jax"] == (True, "dispatched", 0)


def test_plane_oldest_pending_age(tmp_path):
    plane = P.RequestPlane(str(tmp_path / "journal.json"))
    assert plane.oldest_pending_age_s() == 0.0
    rec = plane.accept({"prompt_ids": [1, 2], "max_new": 2},
                       deadline_s=60.0)
    assert 0.0 <= plane.oldest_pending_age_s() < 5.0
    got = plane.checkout()
    assert got is not None and got.rid == rec.rid
    assert plane.oldest_pending_age_s() == 0.0


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_journal_crosses_packages(tmp_path, writer, reader):
    """A journal one package wrote loads in the other: equal records
    (every journaled field), the same pending queue and shed count, the
    same redrive bookkeeping as a reload in the writing package."""
    journal = str(tmp_path / "j.json")
    _three_record_journal(PKGS[writer], journal)
    raw = json.load(open(journal))
    assert raw["version"] == 1 and raw["shed_total"] == 1
    got = PKGS[reader].RequestPlane.load(journal)
    want = PKGS[writer].RequestPlane.load(journal)
    assert [r.to_json() for r in got.records()] \
        == [r.to_json() for r in want.records()]
    assert got.counts() == want.counts()
    assert got.pending_depth == want.pending_depth == 2
    assert [r.rid for r in got.records()] == [d["rid"]
                                               for d in raw["records"]]


# -- scenarios (test_qos.py:344-441) -----------------------------------------


def _spec(**over):
    spec = {
        "version": 1, "name": "unit", "seed": 7, "vocab": 64,
        "tenants": {
            "chat": {"priority": "interactive"},
            "bulk": {"priority": "batch", "rate": 4.0, "burst": 8,
                     "page_quota": 8},
        },
        "classes": {
            "short": {"tenant": "chat", "prompt_lens": [4, 6, 12],
                      "max_new": [4, 8], "sessions": 3},
            "long": {"tenant": "bulk", "prompt_lens": [24],
                     "max_new": [16]},
        },
        "phases": [
            {"name": "warm", "duration_s": 2.0, "rate": 3.0,
             "mix": {"short": 0.7, "long": 0.3}},
            {"name": "crowd", "duration_s": 1.0, "rate": [6.0, 30.0],
             "mix": {"short": 1.0}},
        ],
        "retry": {"max_attempts": 3, "base_delay_s": 0.01,
                  "max_delay_s": 0.1, "hedge_after_s": 0.5},
    }
    spec.update(over)
    return spec


def _sched_rows(schedule):
    return [(s.t, s.cls, s.tenant, s.payload) for s in schedule]


@pytest.mark.parametrize("path", SCENARIOS,
                         ids=[os.path.basename(p) for p in SCENARIOS])
def test_committed_scenario_schedule_matches_jax(path):
    assert len(SCENARIOS) == 2
    spec = p_work.load_scenario(path)
    assert spec == j_work.load_scenario(path)
    got, want = p_work.build_schedule(spec), j_work.build_schedule(spec)
    assert _sched_rows(got) == _sched_rows(want)
    digest = p_work.verify_schedule(spec, got)
    assert digest == spec["digest"] == j_work.schedule_digest(want)


@pytest.mark.parametrize("seed", [7, 8, 1337])
def test_unit_schedule_matches_jax(seed):
    spec = _spec(seed=seed)
    got, want = p_work.build_schedule(spec), j_work.build_schedule(spec)
    assert _sched_rows(got) == _sched_rows(want)
    assert p_work.schedule_digest(got) == j_work.schedule_digest(want)
    ts = [r.t for r in got]
    assert ts == sorted(ts) and 0.0 < ts[-1] < 3.0
    seeds = [r.payload["seed"] for r in got]
    assert len(set(seeds)) == len(seeds)
    spec["digest"] = "0" * 64
    for mod in (p_work, j_work):
        with pytest.raises(ValueError, match="digest"):
            mod.verify_schedule(spec, got)


def _junk(case):
    if case == "extra_key":
        return _spec(extra=1)
    if case == "class_key":
        return _spec(classes={"short": {"prompt_lens": [4], "max_new": [4],
                                        "burst": 2}})
    spec = _spec()
    if case == "ghost_tenant":
        spec["classes"]["short"]["tenant"] = "ghost"
    elif case == "ghost_class":
        spec["phases"][0]["mix"] = {"ghost": 1.0}
    elif case == "version":
        spec["version"] = 2
    elif case == "empty_lens":
        spec["classes"]["long"]["prompt_lens"] = []
    elif case == "zero_duration":
        spec["phases"][1]["duration_s"] = 0
    elif case == "retry_key":
        spec["retry"]["jitter"] = 1
    elif case == "missing_phases":
        del spec["phases"]
    elif case == "bad_tenant_policy":
        spec["tenants"]["bulk"]["priority"] = "urgent"
    return spec


@pytest.mark.parametrize("case", [
    "extra_key", "class_key", "ghost_tenant", "ghost_class", "version",
    "empty_lens", "zero_duration", "retry_key", "missing_phases",
    "bad_tenant_policy"])
def test_validate_scenario_rejects_the_same_junk(case):
    errors = []
    for mod in (p_work, j_work):
        with pytest.raises(ValueError) as e:
            mod.validate_scenario(_junk(case))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- router on fake replicas (test_fleet.py:150-358) --------------------------


class FakeReplica:
    """Scripted stand-in for ReplicaClient (``tests/test_fleet.py``):
    greedy 'tokens' derived from the payload, can die after K requests,
    report a health state, or shed with 503; raises the errors of the
    package whose router drives it."""

    def __init__(self, pkg, name, *, die_after=None, state="ready",
                 busy=False, latency_s=0.0):
        self.pkg = pkg
        self.name = name
        self.die_after = die_after
        self.state = state
        self.busy = busy
        self.latency_s = latency_s
        self.served = 0
        self.dead = False
        self.swapped = 0

    def healthz(self, timeout=None):
        if self.dead:
            return {"live": False, "ready": False, "state": "dead"}
        return {"live": True, "ready": self.state == "ready",
                "state": self.state}

    def stats(self, timeout=None):
        return {"kv_page_occupancy": 0.1 * self.served,
                "slot_utilization": 0.0, "queue_depth": 0,
                "swaps": self.swapped, "state": self.state}

    def generate(self, payload, timeout=None):
        if self.dead:
            raise self.pkg.ReplicaDown(f"{self.name}: connection refused")
        if self.busy:
            raise self.pkg.ReplicaBusy(f"{self.name}: 503",
                                       retry_after_s=0.01)
        if self.latency_s:
            time.sleep(self.latency_s)
        if self.die_after is not None and self.served >= self.die_after:
            self.dead = True
            raise self.pkg.ReplicaDown(
                f"{self.name}: connection reset mid-request")
        self.served += 1
        return {"state": "done",
                "tokens": [x + 1 for x in payload["prompt_ids"]]}

    def swap(self, checkpoint, timeout=None):
        self.swapped += 1
        return {"staging": True}


def _fast_policy(pkg, **kw):
    base = dict(queue_bound=32, max_attempts=6, attempt_timeout_s=5.0,
                default_deadline_s=30.0, base_backoff_s=0.001,
                max_backoff_s=0.01, health_every_s=0.01,
                max_inflight_per_replica=4)
    base.update(kw)
    return pkg.RouterPolicy(**base)


def _drain(router, timeout_s=30.0):
    router.run_until_drained(poll_s=0.002, timeout_s=timeout_s)
    router.close()


def _records(recs):
    return [(r.state, r.tokens, bool(r.error)) for r in recs]


def case_least_loaded(pkg, tmp):
    plane = pkg.RequestPlane(os.path.join(tmp, "j.json"))
    reps = [FakeReplica(pkg, "replica0"), FakeReplica(pkg, "replica1")]
    router = pkg.FleetRouter(plane, reps, policy=_fast_policy(pkg))
    recs = [router.submit({**PAYLOAD, "prompt_ids": [i, i + 1]})
            for i in range(8)]
    _drain(router)
    assert reps[0].served > 0 and reps[1].served > 0
    assert all(r.tokens == [i + 1, i + 2] for i, r in enumerate(recs))
    return {"records": _records(recs), "failovers": router.failovers_total,
            "served": sum(r.served for r in reps),
            "counts": plane.counts()}


def case_failover(pkg, tmp):
    plane = pkg.RequestPlane(os.path.join(tmp, "j.json"))
    reps = [FakeReplica(pkg, "replica0", die_after=2),
            FakeReplica(pkg, "replica1")]
    router = pkg.FleetRouter(plane, reps, policy=_fast_policy(pkg))
    recs = [router.submit({**PAYLOAD, "prompt_ids": [i]})
            for i in range(10)]
    _drain(router)
    assert sum(r.redrives for r in recs) >= 1 \
        or sum(r.attempts for r in recs) > len(recs)
    # a redrive raced by its own worker's retry may be served twice (the
    # JAX plane can even complete it twice), so replica1 serves >= 8
    assert reps[1].served >= 8
    return {"records": _records(recs), "failovers": router.failovers_total,
            "served_by_dead": reps[0].served, "counts": plane.counts(),
            # after the death every record lands on the survivor
            "completed_by_dead": sum(r.completed_by == "replica0"
                                     for r in recs)}


def case_all_dead(pkg, tmp):
    plane = pkg.RequestPlane(os.path.join(tmp, "j.json"))
    router = pkg.FleetRouter(
        plane, [FakeReplica(pkg, "replica0", state="draining")],
        policy=_fast_policy(pkg, max_attempts=3, default_deadline_s=0.5))
    rec = router.submit(PAYLOAD)
    assert rec is not None
    _drain(router)
    return {"records": _records([rec]), "counts": plane.counts()}


def case_admission(pkg, tmp):
    plane = pkg.RequestPlane(os.path.join(tmp, "j.json"))
    reps = [FakeReplica(pkg, "replica0"), FakeReplica(pkg, "replica1")]
    router = pkg.FleetRouter(plane, reps, policy=_fast_policy(
        pkg, queue_bound=4, degraded_queue_factor=0.5))
    router.check_health(force=True)
    accepted = [router.submit(PAYLOAD) is not None for _ in range(4)]
    verdicts = [router.admission()]
    shed = router.submit(PAYLOAD) is None
    counters = (router.shed_total, plane.counts()["shed"])
    _drain(router)
    for r in reps:
        r.state = "slo_breach"
    router2 = pkg.FleetRouter(pkg.RequestPlane(), reps, policy=_fast_policy(
        pkg, queue_bound=4, degraded_queue_factor=0.5))
    router2.check_health(force=True)
    tight = (router2.degraded(), router2.effective_queue_bound())
    accepted2 = [router2.submit(PAYLOAD) is not None for _ in range(3)]
    verdicts.append(router2.admission())
    router2.close()
    assert verdicts[0]["reason"] == "backpressure" and shed
    assert tight == (True, 2) and accepted2 == [True, True, False]
    return {"accepted": accepted, "verdicts": verdicts, "shed": shed,
            "counters": counters, "tight": tight, "accepted2": accepted2,
            "records": _records(plane.records())}


def case_prefers_ready(pkg, tmp):
    breached = FakeReplica(pkg, "replica0", state="slo_breach")
    ready = FakeReplica(pkg, "replica1")
    router = pkg.FleetRouter(pkg.RequestPlane(), [breached, ready],
                             policy=_fast_policy(pkg))
    recs = [router.submit({**PAYLOAD, "prompt_ids": [i]})
            for i in range(6)]
    _drain(router)
    breached2 = FakeReplica(pkg, "replica0", state="slo_breach")
    router2 = pkg.FleetRouter(pkg.RequestPlane(), [breached2],
                              policy=_fast_policy(pkg))
    rec = router2.submit(PAYLOAD)
    _drain(router2)
    assert breached.served == 0 and ready.served == 6
    return {"records": _records(recs + [rec]),
            "completed_by": [r.completed_by for r in recs + [rec]],
            "served": [breached.served, ready.served, breached2.served]}


def case_rolling_swap(pkg, tmp):
    reps = [FakeReplica(pkg, f"replica{i}") for i in range(3)]
    router = pkg.FleetRouter(pkg.RequestPlane(), reps,
                             policy=_fast_policy(pkg))
    router.check_health(force=True)
    n = router.rolling_swap("/fake/ckpt", wait_s=5.0)
    router.close()
    return {"swapped": n, "each": [r.swapped for r in reps]}


def case_affinity(pkg, tmp):
    """Session keys route a repeat request to the replica that served
    the session (dispatched one at a time, so the landing is fixed)."""
    reps = [FakeReplica(pkg, "replica0"), FakeReplica(pkg, "replica1")]
    router = pkg.FleetRouter(pkg.RequestPlane(), reps,
                             policy=_fast_policy(pkg))
    recs = []
    for i in range(6):
        recs.append(router.submit({**PAYLOAD, "prompt_ids": [i, i],
                                   "session_id": f"s{i % 2}"}))
        router.run_until_drained(poll_s=0.002, timeout_s=30.0)
    router.close()
    by = [r.completed_by for r in recs]
    assert by[2:] == by[:2] * 2
    return {"records": _records(recs), "completed_by": by,
            "affinity": router.snapshot()["affinity"]}


ROUTER_CASES = {f.__name__[5:]: f for f in (
    case_least_loaded, case_failover, case_all_dead, case_admission,
    case_prefers_ready, case_rolling_swap, case_affinity)}


@pytest.mark.parametrize("case", list(ROUTER_CASES))
def test_router_case_matches_jax(case, tmp_path):
    fn = ROUTER_CASES[case]
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = fn(pkg, str(d))
    assert out["port"] == out["jax"]
    if case == "failover":
        assert out["port"]["failovers"] == 1
        assert all(s == "completed" for s, _, _ in out["port"]["records"])
    if case == "all_dead":
        assert out["port"]["records"][0][0] == "failed"
        assert out["port"]["records"][0][2]


def test_router_policy_loop_knobs():
    assert P.RouterPolicy().swap_poll_s == 0.25
    assert P.RouterPolicy().drain_poll_s == 0.02
    router = P.FleetRouter(P.RequestPlane(), [FakeReplica(P, "replica0")],
                           policy=_fast_policy(P, swap_poll_s=0.001,
                                               drain_poll_s=0.001))
    rec = router.submit(PAYLOAD)
    router.run_until_drained(timeout_s=30.0)
    router.close()
    assert rec.state == P.COMPLETED


def test_health_scrape_records_rtt_and_replica_gauges():
    from torchpruner_tpu_torch import obs

    obs.shutdown()
    obs.configure()
    try:
        reps = [FakeReplica(P, "replica0"), FakeReplica(P, "replica1")]
        reps[0].served = 3
        router = P.FleetRouter(P.RequestPlane(), reps,
                               policy=_fast_policy(P))
        router.check_health(force=True)
        snap = obs.get().metrics.snapshot()
        assert snap["fleet_scrape_seconds_count"] == 2
        assert snap["fleet_replica_replica0_occupancy"] \
            == pytest.approx(0.3)
        assert snap["fleet_replica_replica0_queue_depth"] == 0
        assert snap["fleet_replica_replica0_state_code"] == 0
        assert snap["fleet_replica_replica0_scrape_rtt_s"] >= 0.0
        reps[1].dead = True
        router.check_health(force=True)
        snap = obs.get().metrics.snapshot()
        assert snap["fleet_replica_replica1_state_code"] == -1
        assert snap["fleet_scrape_seconds_count"] == 4
        router.close()
    finally:
        obs.shutdown()


def test_fleet_chaos_and_replica_argv():
    from torchpruner_tpu.fleet.frontend import FleetChaos as JChaos
    from torchpruner_tpu_torch.fleet.frontend import (
        FleetChaos,
        replica_argv,
    )

    spec = '{"kill_replica_at_step": 3, "replica_index": 1}'
    assert dataclasses.asdict(FleetChaos.from_any(spec)) \
        == dataclasses.asdict(JChaos.from_any(spec))
    assert FleetChaos.from_any(None).kill_replica_at_step == -1
    with pytest.raises(ValueError, match="unknown fleet chaos"):
        FleetChaos.from_any('{"kill_at_step": 3}')
    args = dataclasses.make_dataclass("A", [])()
    for k, v in dict(slots=2, max_len=512, seed=0, replica_queue_bound=8,
                     trace_sample_every=1, deadline_s=300.0, page_len=16,
                     prefix_pages=32, prefill_chunk=64, prefill_cap=128,
                     smoke=False, cpu=True, kv_dtype="bfloat16",
                     checkpoint="/ck/a", slo_ttft_p99_ms=None,
                     slo_token_p99_ms=None, slo_queue_p99_ms=None,
                     tenants_json=None).items():
        setattr(args, k, v)
    argv = replica_argv("llama3_ffn_taylor", 8811, args, "/o", "/r")
    assert argv[:5] == [sys.executable, "-m", "torchpruner_tpu_torch",
                        "serve", "llama3_ffn_taylor"]
    assert "--cpu" in argv and argv[argv.index("--kv-dtype") + 1] \
        == "bfloat16"
    assert argv[argv.index("--checkpoint") + 1] == "/ck/a"
    args.cpu, args.kv_dtype = False, "float32"
    argv = replica_argv("llama3_ffn_taylor", 8811, args, "/o", "/r")
    assert "--cpu" not in argv and "--kv-dtype" not in argv


# -- supervisor decision core (test_qos.py:241-340) ---------------------------


def _sig(age=0.0, pending=0, replicas=1, breach=0.0, retiring=0,
         rung="none"):
    return {"queue_age_s": age, "pending": pending, "replicas": replicas,
            "live": replicas, "breach_frac": breach, "retiring": retiring,
            "rung": rung}


def _actions(mod, steps, **kw):
    """Feed ``(now, signal, rung_or_None)`` samples through a fresh
    supervisor's ``evaluate``; a returned action stamps the cooldown as
    ``tick`` would, and a given rung is set before the sample."""
    knobs = dict(min_replicas=1, max_replicas=2, queue_age_up_s=1.0,
                 queue_age_down_s=0.1, up_ticks=3, down_ticks=4,
                 cooldown_s=10.0, degrade_ticks=4)
    knobs.update(kw)
    t = {"now": 0.0}
    sup = mod.Supervisor(router=None, policy=mod.ScalePolicy(**knobs),
                         now=lambda: t["now"])
    out = []
    for now, sig, rung, stamp in steps:
        t["now"] = now
        if rung is not None:
            sup.rung = rung
        act = sup.evaluate(sig, now=now)
        out.append(act)
        if act is not None and stamp:
            sup._last_action_t = now
            sup._up = sup._down = sup._at_max = 0
    return out


SUPERVISOR_SEQUENCES = {
    "flapping": [(float(i), _sig(age=5.0) if i % 2
                  else _sig(age=0.0, pending=3), None, True)
                 for i in range(40)],
    "scale_up_then_cooldown": [(float(i), _sig(age=5.0), None, True)
                               for i in range(3)]
    + [(now, _sig(age=5.0, replicas=2), None, True)
       for now in (3.0, 5.0, 8.0, 11.0, 13.0, 14.0, 15.0)],
    "breach_fraction": [(float(i), _sig(breach=0.6), None, True)
                        for i in range(3)],
    "degrade_at_max": [(float(i), _sig(age=5.0, replicas=2), None, True)
                       for i in range(4)],
    "retiring_not_at_max": [(float(i), _sig(age=5.0, replicas=2,
                                             retiring=1), None, True)
                            for i in range(3)],
    "recover_then_scale_down": [(float(i), _sig(replicas=2), 1, False)
                                for i in range(4)]
    + [(4.0, _sig(replicas=2), 0, False), (5.0, _sig(), None, False)],
    "pending_blocks_quiet": [(float(i), _sig(pending=1, replicas=2), None,
                              True) for i in range(20)],
    "ladder": [(float(i), _sig(age=5.0, replicas=2), None, True)
               for i in range(0, 60, 3)],
}


@pytest.mark.parametrize("name", list(SUPERVISOR_SEQUENCES))
def test_supervisor_sequence_matches_jax(name):
    steps = SUPERVISOR_SEQUENCES[name]
    got = _actions(p_sup, steps)
    assert got == _actions(j_sup, steps)
    want = {
        "flapping": [None] * 40,
        "breach_fraction": [None, None, "scale_up"],
        "degrade_at_max": [None, None, None, "degrade"],
        "retiring_not_at_max": [None, None, "scale_up"],
        "recover_then_scale_down": [None, None, None, "recover",
                                    "scale_down", None],
        "pending_blocks_quiet": [None] * 20,
    }.get(name)
    if want is not None:
        assert got == want
    if name == "scale_up_then_cooldown":
        assert got[:3] == [None, None, "scale_up"]
        assert got[3:7] == [None] * 4


class _LadderRouter:
    """The router surface the supervisor's rungs act on."""

    def __init__(self):
        self._lock = threading.RLock()
        self.shed_tenants = set()
        self.force_degraded = False
        self.swaps = []

    def rolling_swap(self, ckpt):
        self.swaps.append(ckpt)


@pytest.mark.parametrize("pruned", [None, "/ck/b"])
def test_supervisor_ladder_climbs_and_recovers_like_jax(pruned):
    """_climb / _descend through every rung: the same rungs, router
    state and ledgered events in both packages; the port's scale-up
    records carry ``capacity`` None (no cost model)."""
    out = {}
    for name, mod in (("jax", j_sup), ("port", p_sup)):
        router = _LadderRouter()
        sup = mod.Supervisor(router, mod.ScalePolicy(
            shed_tenants=("bulk",), pruned_checkpoint=pruned,
            restore_checkpoint="/ck/a"), now=lambda: 0.0)
        trail = []
        for _ in range(3):
            sup._climb(_sig(age=5.0))
            sup.join()
            trail.append((sup.rung, sorted(router.shed_tenants),
                          router.force_degraded, list(router.swaps)))
        while sup.rung:
            sup._descend(_sig())
            sup.join()
            trail.append((sup.rung, sorted(router.shed_tenants),
                          router.force_degraded, list(router.swaps)))
        s = sup.summary()
        out[name] = (trail, [(e["action"], e.get("rung"))
                             for e in s["events"]], s["rung"])
    assert out["port"] == out["jax"]
    assert p_sup.predict_replica_capacity(None, n_slots=2,
                                          max_len=512) is None


# -- reports (fleet/report.py) ------------------------------------------------


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _hand_built_fleet_dir(root):
    """A fleet obs dir as a drill leaves it: the router's stream, ledger
    and windows; replica0 kill -9'd (no shard, a torn stream), replica1
    drained (shard, stream, windows), replica10 to pin the numeric
    order."""
    obs_dir = os.path.join(root, "obs")
    reps = [os.path.join(obs_dir, f"replica{i}") for i in (0, 1, 10)]
    for d in reps:
        os.makedirs(d)
    t0 = 1_800_000_000.0
    _write_jsonl(os.path.join(obs_dir, "events.jsonl"), [
        {"event": "obs_init", "ts": t0},
        {"event": "clock_offset", "ts": t0 + 1, "replica": "replica0",
         "offset_s": 0.25, "rtt_s": 0.002},
        {"event": "clock_offset", "ts": t0 + 1, "replica": "replica1",
         "offset_s": -0.5, "rtt_s": 0.001},
        {"event": "clock_offset", "ts": t0 + 3, "replica": "replica1",
         "offset_s": -0.4, "rtt_s": 0.001},
    ])
    for i, d in enumerate(reps):
        _write_jsonl(os.path.join(d, "events.jsonl"), [
            {"event": "obs_init", "ts": t0 + i}])
    with open(os.path.join(reps[0], "events.jsonl"), "a") as f:
        f.write('{"event": "reqtrace_stage", "ts": 18')  # torn by SIGKILL
    for i, d in enumerate(reps[1:]):
        with open(os.path.join(d, "metrics.shard0.json"), "w") as f:
            json.dump({"process_index": 0,
                       "counters": {"serve_completed_total":
                                    {"value": 5 + i, "help": "x"}},
                       "gauges": {"kv_page_occupancy":
                                  {"value": 0.1 * (i + 1), "help": "y"}},
                       "histograms": {}}, f)

    def windows(n, base, gauges, pid):
        rows = [{"kind": "ts_meta", "v": 1, "pid": pid, "t0": base,
                 "interval_s": 1.0}]
        for k in range(n):
            rows.append({"kind": "ts_window", "seq": k + 1,
                         "ts": base + k + 1.0, "dur_s": 1.0,
                         "counters": {"fleet_dispatch_total":
                                      float(k % 3)},
                         "gauges": {g: float(v + (5.0 if k == n - 3
                                                  else 0.0))
                                    for g, v in gauges.items()},
                         "hist": {}})
        return rows

    _write_jsonl(os.path.join(obs_dir, "metrics_ts.jsonl"), windows(
        30, t0, {"fleet_replica_replica1_occupancy": 0.2,
                 "fleet_replica_replica1_queue_depth": 1.0,
                 "tenant_chat_ttft_p99_s": 0.05,
                 "fleet_queue_age_seconds": 0.1}, 1))
    _write_jsonl(os.path.join(reps[0], "metrics_ts.jsonl"),
                 windows(8, t0 + 0.25, {"kv_page_occupancy": 0.3}, 2))
    _write_jsonl(os.path.join(reps[1], "metrics_ts.jsonl"),
                 windows(30, t0 - 0.4, {"kv_page_occupancy": 0.4}, 3))
    _write_jsonl(os.path.join(obs_dir, "ledger.jsonl"), [
        {"event": "run", "ts": t0},
        {"event": "serve", "kind": "chaos_injection", "ts": t0 + 8.0,
         "chaos": "slow_replica", "replica": "replica1",
         "slow_steps_ms": 250.0},
        {"event": "serve", "kind": "scale_decision", "ts": t0 + 12.0,
         "action": "scale_up", "trigger": {"queue_age_s": 2.0},
         "correlation_id": None, "capacity": None},
        {"event": "serve", "kind": "swap", "ts": t0 + 14.0,
         "replica": "replica1"},
        {"event": "serve", "kind": "slo_burn", "ts": t0 + 40.0,
         "burn_ts": t0 + 20.0, "replica": "replica1",
         "metric": "token_p99", "burn_fast": 40.0, "burn_slow": 12.0},
        {"event": "reqtrace", "ts": t0 + 30.0, "exemplars": [
            {"trace": "tr-1", "e2e_ms": 9.0, "ttft_ms": 2.0,
             "attempts": 2, "redrive": True, "stages": []}]},
    ])
    return obs_dir, reps


def _read(path):
    with open(path) as f:
        return f.read()


def test_reports_match_jax_on_a_hand_built_fleet_dir(tmp_path):
    import shutil

    src, _ = _hand_built_fleet_dir(str(tmp_path / "src"))
    out = {}
    for name, mod in (("jax", j_report), ("port", p_report)):
        obs_dir = str(tmp_path / name / "obs")
        shutil.copytree(src, obs_dir)
        reps = mod.replica_obs_dirs_of(obs_dir)
        shards = mod.merge_replica_shards(obs_dir, reps)
        ts = mod.merge_timeseries(obs_dir)
        inc = mod.assemble_fleet_incidents(obs_dir)
        out[name] = {
            "reps": [os.path.relpath(r, obs_dir) for r in reps],
            "shards": {os.path.relpath(k, obs_dir): v
                       for k, v in shards.items()},
            "shard_files": {os.path.basename(p): json.loads(_read(p))
                            for p in sorted(glob.glob(os.path.join(
                                obs_dir, "metrics.shard*.json")))},
            "ts": ts,
            "ts_file": _read(os.path.join(obs_dir,
                                          "metrics_ts_fleet.jsonl")),
            "offsets": mod.clock_offsets_of(
                [json.loads(line) for line in _read(os.path.join(
                    obs_dir, "events.jsonl")).splitlines()]),
            "incidents": inc["incidents"], "anomalies": inc["anomalies"],
            "burns": inc["burns"],
        }
    assert out["port"] == out["jax"]
    got = out["port"]
    assert got["reps"] == ["replica0", "replica1", "replica10"]
    assert got["shards"] == {"replica0": False, "replica1": True,
                             "replica10": True}
    assert sorted(got["shard_files"]) == ["metrics.shard2.json",
                                          "metrics.shard3.json"]
    assert got["offsets"] == {"replica0": 0.25, "replica1": -0.4}
    assert got["ts"]["streams"] == 3 and got["ts"]["windows"] == 68
    assert len(got["burns"]) == 1 and len(got["incidents"]) >= 1
    # the planted cause ranks first, on the replica it was planted in
    assert got["incidents"][0]["top_suspect"]["class"] == "chaos_injection"
    assert got["incidents"][0]["top_suspect"]["replica"] == "replica1"
    assert got["incidents"][0]["exemplars"][0]["trace"] == "tr-1"


def test_replica_summary_line(tmp_path):
    log = tmp_path / "replica0.log"
    log.write_text("serving on http://127.0.0.1:1\n"
                   '{"requests_completed": 3, "kernel_launches": '
                   '{"decode_attention": 4}}\n'
                   "── observability summary ──\n{torn\n")
    for mod in (p_report, j_report):
        assert mod.replica_summary_line(str(log)) == {
            "requests_completed": 3,
            "kernel_launches": {"decode_attention": 4}}
        assert mod.replica_summary_line(str(tmp_path / "none")) is None


# -- the router over live port engines (test_fleet.py:400-489) ----------------


@pytest.fixture
def live_replicas():
    """Two port ServeEngine replicas behind the port's HTTP front end,
    in-process, on the JAX ``llama_tiny`` weights."""
    from torchpruner_tpu.core.segment import init_model as j_init_model
    from torchpruner_tpu.models import llama_tiny as j_llama_tiny
    from torchpruner_tpu_torch.convert import (
        model_from_reference,
        params_from_numpy,
    )
    from torchpruner_tpu_torch.fleet.replica import ReplicaClient
    from torchpruner_tpu_torch.serve import ServeEngine
    from torchpruner_tpu_torch.serve.frontend import _http_server

    def numpy_tree(tree):
        if isinstance(tree, dict):
            return {k: numpy_tree(v) for k, v in tree.items()}
        return np.asarray(tree)

    jmodel = j_llama_tiny()
    jparams, _ = j_init_model(jmodel, seed=0)
    model = model_from_reference(jmodel)
    params = params_from_numpy(numpy_tree(jparams), device="cpu")
    engines, servers, stops, threads, clients = [], [], [], [], []
    for i in range(2):
        eng = ServeEngine(model, params, n_slots=2, max_len=64,
                          device="cpu", queue_bound=8,
                          retain_results=False)
        server = _http_server(eng, 0, request_timeout_s=120.0)
        stop = threading.Event()
        threads.append(threading.Thread(target=server.serve_forever,
                                        daemon=True))
        threads.append(threading.Thread(
            target=lambda e=eng, s=stop: e.run(stop_event=s),
            daemon=True))
        engines.append(eng)
        servers.append(server)
        stops.append(stop)
        clients.append(ReplicaClient(f"replica{i}",
                                     server.server_address[1]))
    for t in threads:
        t.start()
    try:
        yield (jmodel, jparams), (model, params), servers, stops, clients
    finally:
        for stop in stops:
            stop.set()
        for server in servers:
            server.shutdown()


def test_router_over_live_port_replicas(live_replicas, tmp_path):
    """Every request bit-identical to the port's solo ``generate()``;
    greedy tokens equal to the JAX solo ``generate()`` (a token may
    differ only where the JAX top-2 logit margin is inside the float32
    tolerance); replica0 dies and the rest completes on replica1 with
    a counted failover."""
    import jax.numpy as jnp

    from torchpruner_tpu.generate import _decode_seq as j_decode_seq
    from torchpruner_tpu.generate import generate as j_generate
    from torchpruner_tpu.generate import init_cache as j_init_cache
    from torchpruner_tpu_torch.generate import generate

    (jmodel, jparams), (model, params), servers, stops, clients = \
        live_replicas
    plane = P.RequestPlane(str(tmp_path / "j.json"))
    router = P.FleetRouter(plane, clients, policy=_fast_policy(
        P, attempt_timeout_s=120.0, default_deadline_s=240.0,
        base_backoff_s=0.01, max_backoff_s=0.1, health_every_s=0.05))
    rng = np.random.default_rng(0)
    payloads = [{"prompt_ids": rng.integers(0, 64, size=4 + (i % 3)
                                            ).tolist(),
                 "max_new": 3 + (i % 2), "seed": i,
                 "temperature": 0.0 if i < 4 else 0.8}
                for i in range(6)]
    recs = [router.submit(p) for p in payloads]
    router.run_until_drained(poll_s=0.01, timeout_s=240.0)
    assert all(r.state == P.COMPLETED for r in recs)
    assert {r.completed_by for r in recs} == {"replica0", "replica1"}

    stops[0].set()
    servers[0].shutdown()
    recs2 = [router.submit(p) for p in payloads[:3]]
    router.run_until_drained(poll_s=0.01, timeout_s=240.0)
    router.close()
    assert all(r.state == P.COMPLETED for r in recs2)
    assert all(r.completed_by == "replica1" for r in recs2)
    assert router.failovers_total >= 1

    for p, rec in zip(payloads + payloads[:3], recs + recs2):
        want = generate(model, params, np.asarray(p["prompt_ids"])[None],
                        p["max_new"], temperature=p["temperature"],
                        rng=torch.Generator().manual_seed(p["seed"]),
                        max_len=64, device="cpu")[0].numpy()
        np.testing.assert_array_equal(np.asarray(rec.tokens), want)
    for p, rec in zip(payloads[:4], recs[:4]):  # greedy against JAX
        prompt = np.asarray(p["prompt_ids"], np.int32)
        want = np.asarray(j_generate(jmodel, jparams,
                                     jnp.asarray(prompt[None]),
                                     p["max_new"]))[0]
        diff = np.nonzero(np.asarray(rec.tokens) != want)[0]
        if diff.size == 0:
            continue
        i = int(diff[0])
        full = np.concatenate([prompt, want]).astype(np.int32)[None]
        jx, _ = j_decode_seq(jmodel.layers, jparams,
                             j_init_cache(jmodel, 1, full.shape[1]),
                             jnp.asarray(full), 0)
        row = np.asarray(jx)[0, prompt.size - 1 + i]
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= 2e-4 * np.abs(row).max(), \
            f"{rec.rid} step {i}: tokens differ at a clear margin"


# -- the CLI drill (test_fleet.py:494-552) ------------------------------------


#: the drill at its default arrival rate (4/s: on the CPU a replica
#: finishes a request between arrivals, so the killed one may hold none),
#: and under a burst that keeps both replicas busy at the kill, so one of
#: its in-flight requests is redriven
CLI_DRILLS = {"default_rate": [], "burst": ["--rate", "50", "--max-new",
                                            "16,24"]}


@pytest.mark.parametrize("drill", list(CLI_DRILLS))
def test_fleet_cli_kill9_drill(tmp_path, drill):
    """Two subprocess replicas, kill -9 one at dispatch 3: zero loss,
    ``--verify`` bit identity, one merged report of the survivor, every
    trace cross-process, a journaled redrive under the burst; the
    journal loads in the JAX package; ``obs incident`` reads the fleet
    directory."""
    fleet_dir = str(tmp_path / "fleet")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torchpruner_tpu_torch", "fleet",
         "llama_tiny", "--smoke", "--cpu", "--replicas", "2",
         "--synthetic", "8", "--verify", "--fleet-dir", fleet_dir,
         "--chaos", '{"kill_replica_at_step": 3}'] + CLI_DRILLS[drill],
        capture_output=True, text=True, timeout=300, cwd=HERE, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    s = json.loads([line for line in r.stdout.splitlines()
                    if line.startswith("{")][-1])
    assert s["killed"] == ["replica0"]
    assert s["accepted"] == 8 and s["completed"] == 8
    assert s["lost"] == 0 and s["verify_mismatches"] == 0
    assert s["failovers"] == 1 and s["shards_merged"] == 1
    assert s["replica_exit_codes"] == {"replica0": -9, "replica1": 0}
    assert s["traces_assembled"] == 8 and s["traces_cross_process"] == 8
    assert abs(s["ttft_recon_pct"]) <= 10
    journal = os.path.join(fleet_dir, "fleet_journal.json")
    j = json.load(open(journal))
    assert len(j["records"]) == 8
    assert all(rec["state"] == "completed" for rec in j["records"])
    if drill == "burst":
        assert s["redrives"] >= 1 and s["traces_redriven_cross_process"] >= 1
        assert any(rec["redrives"] > 0 for rec in j["records"])
    assert [x.to_json() for x in J.RequestPlane.load(journal).records()] \
        == [x.to_json() for x in P.RequestPlane.load(journal).records()]

    from torchpruner_tpu_torch.obs.report import format_report, load_run

    obs_dir = os.path.join(fleet_dir, "obs")
    rep = load_run(obs_dir)
    m = rep["metrics"]
    assert m.get("fleet_failover_total", 0) == 1
    assert m.get("fleet_redrive_total", 0) == s["redrives"]
    assert m.get("fleet_completed_total") == 8
    assert m.get("serve_ttft_seconds_count", 0) > 0
    assert m.get("fleet_dispatch_wait_seconds_count", 0) >= 8
    trace = json.load(open(os.path.join(obs_dir, "trace.json")))
    pids = {e["pid"] for e in trace["traceEvents"]
            if e.get("cat") == "reqtrace" and e.get("ph") in ("X", "i")}
    assert 0 in pids and len(pids) >= 2
    md = format_report(rep)
    assert "latency budget:" in md and "exemplar waterfalls" in md
    assert os.path.exists(os.path.join(obs_dir, "metrics_ts_fleet.jsonl"))
    survivor = p_report.replica_summary_line(
        os.path.join(fleet_dir, "replica1.log"))
    assert survivor["device"] == "cpu" and survivor["requests_drained"] == 0
    inc = subprocess.run(
        [sys.executable, "-m", "torchpruner_tpu_torch", "obs", "incident",
         obs_dir], capture_output=True, text=True, timeout=120, cwd=HERE)
    assert inc.returncode == 0, inc.stderr[-2000:]
    assert "obs incident" in inc.stdout
