"""The autoscaled scenario drill over simulated replicas: which fleet
settings can pass the JAX package's verdict at a given replica launch
time.

The fleet's router (``fleet/router.py``), request plane, supervisor and
workload replayer run as they do in ``fleet --scenario --autoscale``, in
real time, but each replica is a stand-in with ``--slots`` decode slots
that holds a request for ``(1.5 + max_new) x --step-ms`` and the launcher
takes ``--launch-s`` to bring one up.  Calibrate the two times from a
card run of the real drill (its ``launch_s`` and the replicas' token
p50); then the verdict here tells whether ``--slots`` /
``--scale-up-age-s`` / ``--scale-cooldown-s`` / ``--max-replicas`` /
``--queue-bound`` can reach the degradation ladder before the traffic
ends.  Host only; no model, no card::

    python -m torchpruner_tpu_torch.experiments.fleet_sim --slots 1 \\
        --scale-up-age-s 0.2 --scale-cooldown-s 0.5 --max-replicas 3 \\
        --step-ms 25 --launch-s 19

One JSON line: the supervisor's summary, the replay's sheds and
abandonments, and ``verdict_ok`` (the checks of ``fleet/frontend.py
run_scenario``).  A run takes the scenario's length plus the settle.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

from torchpruner_tpu_torch.fleet import FleetRouter, RequestPlane, RouterPolicy
from torchpruner_tpu_torch.fleet.supervisor import (
    RUNGS,
    ScalePolicy,
    Supervisor,
)
from torchpruner_tpu_torch.fleet.workload import (
    WorkloadReplayer,
    load_scenario,
)
from torchpruner_tpu_torch.serve.qos import TenantPolicy

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SimReplica:
    """A replica's HTTP surface (``fleet/replica.py ReplicaClient``) over
    ``slots`` concurrent decode slots; a swap stages for ``swap_s``."""

    def __init__(self, name: str, slots: int, step_s: float,
                 swap_s: float = 3.0):
        self.name, self.slots, self.step_s = name, slots, step_s
        self.swap_s = swap_s
        self._slots = threading.Semaphore(slots)
        self._lock = threading.Lock()
        self.active = self.waiting = self.swaps = 0
        self.staging = False

    def healthz(self, timeout=None) -> dict:
        state = "staging_swap" if self.staging else "ready"
        return {"live": True, "ready": not self.staging, "state": state}

    def stats(self, timeout=None) -> dict:
        with self._lock:
            return {"slot_utilization": self.active / self.slots,
                    "kv_page_occupancy": 0.5 * self.active / self.slots,
                    "queue_depth": self.waiting, "swaps": self.swaps}

    def generate(self, payload: dict, timeout=None) -> dict:
        with self._lock:
            self.waiting += 1
        with self._slots:
            with self._lock:
                self.waiting -= 1
                self.active += 1
            time.sleep((1.5 + int(payload["max_new"])) * self.step_s)
            with self._lock:
                self.active -= 1
        return {"state": "done", "tokens": [0] * int(payload["max_new"]),
                "ttft_s": 1.5 * self.step_s}

    def swap(self, checkpoint: str, timeout=None) -> dict:
        def stage():
            self.staging = True
            time.sleep(self.swap_s)
            with self._lock:
                self.swaps += 1
            self.staging = False

        threading.Thread(target=stage, daemon=True).start()
        return {"staging": True}


class SimLauncher:
    """The supervisor's launcher: a replica listens ``launch_s`` after
    the launch."""

    def __init__(self, slots: int, step_s: float, launch_s: float):
        self.slots, self.step_s, self.launch_s = slots, step_s, launch_s
        self._next = 1

    def launch(self) -> SimReplica:
        time.sleep(self.launch_s)
        name, self._next = f"replica{self._next}", self._next + 1
        return SimReplica(name, self.slots, self.step_s)

    def retire(self, name: str) -> None:
        pass


def simulate(scenario: str, *, slots: int, up_age_s: float,
             cooldown_s: float, max_replicas: int, step_s: float,
             launch_s: float, queue_bound: int = 64,
             settle_s: float = 240.0) -> dict:
    """One autoscaled replay from a single replica (``run_scenario``'s
    loop and settle) and its verdict."""
    spec = load_scenario(scenario)
    tenants = spec.get("tenants") or {}
    batch = tuple(sorted(n for n, c in tenants.items()
                         if TenantPolicy.from_dict(n, c).priority > 0))
    # the fleet CLI's defaults (fleet/frontend.py _policy_of)
    router = FleetRouter(RequestPlane(),
                         [SimReplica("replica0", slots, step_s)],
                         policy=RouterPolicy(health_every_s=0.25,
                                             queue_bound=queue_bound))
    sup = Supervisor(router, ScalePolicy(
        min_replicas=1, max_replicas=max_replicas,
        queue_age_up_s=up_age_s, queue_age_down_s=0.1,
        cooldown_s=cooldown_s, drain_timeout_s=300.0, shed_tenants=batch,
        pruned_checkpoint="pruned", restore_checkpoint="base"),
        launcher=SimLauncher(slots, step_s, launch_s))
    replayer = WorkloadReplayer.from_spec(router, spec, deadline_s=300.0)

    def on_tick():
        router.tick()
        sup.tick()

    t0 = time.monotonic()
    router.check_health(force=True)
    rsum = replayer.run(timeout_s=900.0, on_tick=on_tick)
    deadline = time.monotonic() + settle_s
    while time.monotonic() < deadline:
        on_tick()
        s = sup.summary()
        with router._lock:
            n_views = len(router.views)
        if s["scale_downs"] >= 1 and s["rung"] == RUNGS[0] \
                and n_views <= 1 and not sup._busy():
            break
        time.sleep(0.02)
    sup.join(timeout_s=settle_s)
    router.close()
    s = sup.summary()
    hard = {t: n for t, n in rsum.abandoned_by_tenant.items()
            if t not in batch}
    ok = (not hard and s["scale_ups"] >= 1 and s["scale_downs"] >= 1
          and (not batch or s["degrades"] >= 1)
          and s["recovers"] >= s["degrades"] and not s["errors"])
    return {"verdict_ok": ok, "wall_s": round(time.monotonic() - t0, 3),
            "shed": rsum.shed, "retries": rsum.retries,
            "abandoned_by_tenant": rsum.abandoned_by_tenant,
            **{k: v for k, v in s.items() if k != "events"},
            "events": [[round(e["t_s"], 3), e["action"], e.get("rung"),
                        e["trigger"]["queue_age_s"],
                        e["trigger"]["replicas"]] for e in s["events"]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m torchpruner_tpu_torch.experiments.fleet_sim",
        description=__doc__.splitlines()[0])
    p.add_argument("--scenario", default=os.path.join(
        HERE, "results", "scenarios", "flash_crowd_ci.json"))
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--scale-up-age-s", type=float, default=1.0)
    p.add_argument("--scale-cooldown-s", type=float, default=2.0)
    p.add_argument("--max-replicas", type=int, default=3)
    p.add_argument("--queue-bound", type=int, default=64,
                   help="the router's pending bound (sheds past it)")
    p.add_argument("--step-ms", type=float, default=30.0,
                   help="a decode step (a request holds its slot for "
                        "1.5 + max_new steps)")
    p.add_argument("--launch-s", type=float, default=19.0,
                   help="a scale-up's launch until the replica listens")
    p.add_argument("--settle-s", type=float, default=240.0)
    args = p.parse_args(argv)
    out = simulate(args.scenario, slots=args.slots,
                   up_age_s=args.scale_up_age_s,
                   cooldown_s=args.scale_cooldown_s,
                   max_replicas=args.max_replicas,
                   step_s=args.step_ms / 1e3, launch_s=args.launch_s,
                   queue_bound=args.queue_bound, settle_s=args.settle_s)
    print(json.dumps({"settings": vars(args), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
