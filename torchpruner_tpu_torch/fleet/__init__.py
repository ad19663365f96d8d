"""``torchpruner_tpu_torch.fleet`` — the fault-tolerant multi-replica
serving plane, counterpart of ``torchpruner_tpu/fleet/`` (the same
exports; host code over the port's serve replicas).

One engine serves one chip group; a fleet serves traffic.  This package
splits the TRANSPORT-AGNOSTIC request plane out of the engine-side
scheduler and composes the existing subsystems into a plane where a
``kill -9``'d replica is a non-event:

- :class:`~torchpruner_tpu_torch.fleet.plane.RequestPlane` — durable request
  records in an atomic journal: every ACCEPTED request is either
  completed or redrivable, by construction.
- :class:`~torchpruner_tpu_torch.fleet.replica.ReplicaClient` /
  :class:`~torchpruner_tpu_torch.fleet.replica.ReplicaProcess` — the HTTP
  view of one serve replica (generate / healthz readiness states /
  stats gauges / swap) + subprocess lifecycle (spawn, kill -9,
  SIGSTOP "hang", SIGTERM drain).
- :class:`~torchpruner_tpu_torch.fleet.router.FleetRouter` — health-checked
  least-loaded dispatch over the live ``kv_page_occupancy`` /
  ``slot_utilization`` gauges, per-request deadline budgets with
  bounded deterministic-jitter retries
  (``resilience.retry.with_retries``), hedged redrive of a dead
  replica's journaled queue, degraded-mode admission (bounded queue,
  SLO-tightened, 429/503 + Retry-After), rolling checkpoint hot-swap.
- :mod:`~torchpruner_tpu_torch.fleet.report` — every replica's obs shard
  merged into ONE fleet-wide report (``obs.aggregate``).
- :mod:`~torchpruner_tpu_torch.fleet.workload` — deterministic scenario
  library: committed JSON specs (diurnal ramps, flash crowds,
  heavy-tail length mixes, session reuse) compiled to a digest-pinned
  schedule and replayed open-loop with Retry-After-honoring hedged
  retries, so every serving change is judged on the same traffic.
- :class:`~torchpruner_tpu_torch.fleet.supervisor.Supervisor` — SLO-driven
  autoscaling (ledgered decisions before effects, drain-then-remove
  scale-down, graceful degradation ladder down to a pruned-checkpoint
  rolling swap).
- ``python -m torchpruner_tpu_torch fleet <preset>``
  (:mod:`~torchpruner_tpu_torch.fleet.frontend`) — the endpoint and the
  kill-9 failover / autoscale chaos drills CI runs.
"""

from torchpruner_tpu_torch.fleet.plane import (
    ACCEPTED,
    COMPLETED,
    DISPATCHED,
    FAILED,
    PlaneRecord,
    RequestPlane,
)
from torchpruner_tpu_torch.fleet.replica import (
    ReplicaBusy,
    ReplicaClient,
    ReplicaDown,
    ReplicaError,
    ReplicaProcess,
    ReplicaRejected,
    ReplicaTimeout,
    free_port,
)
from torchpruner_tpu_torch.fleet.report import merge_replica_shards
from torchpruner_tpu_torch.fleet.router import (
    FleetRouter,
    ReplicaView,
    RouterPolicy,
)
from torchpruner_tpu_torch.fleet.supervisor import (
    ScalePolicy,
    Supervisor,
    predict_replica_capacity,
)
from torchpruner_tpu_torch.fleet.workload import (
    ScheduledRequest,
    WorkloadReplayer,
    build_schedule,
    load_scenario,
    schedule_digest,
    verify_schedule,
)

__all__ = [
    "ACCEPTED", "DISPATCHED", "COMPLETED", "FAILED",
    "PlaneRecord", "RequestPlane",
    "ReplicaClient", "ReplicaProcess", "ReplicaError", "ReplicaDown",
    "ReplicaTimeout", "ReplicaBusy", "ReplicaRejected", "free_port",
    "FleetRouter", "RouterPolicy", "ReplicaView",
    "merge_replica_shards",
    "ScalePolicy", "Supervisor", "predict_replica_capacity",
    "ScheduledRequest", "WorkloadReplayer", "build_schedule",
    "load_scenario", "schedule_digest", "verify_schedule",
]
