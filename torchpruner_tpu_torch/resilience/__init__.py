"""Resilience layer of the port — counterpart of
``torchpruner_tpu/resilience/``: preemption-safe resumable pipelines,
deterministic fault injection, non-finite / OOM step guards with
rollback, and retry with backoff for transient failures.

A prune → retrain run on preemptible hardware gets SIGTERM'd, NaN'd by
an unlucky LR or out-of-memory'd by a batch that no longer fits.  Each
of those is a *resume*, not a *restart*:

- :mod:`.manifest` — :class:`RunManifest`: the atomically written JSON
  pipeline position (prune round, epoch, data cursor, LR backoff) beside
  digest-verified checkpoints; the JAX package's schema.
- :mod:`.chaos` — deterministic fault injection (NaN batch at step k,
  SIGKILL, synthetic OOM, corrupt checkpoint bytes, data-load failures,
  slow serve steps), so recovery paths are tested code.
- :mod:`.guards` — the host half of the non-finite guard
  (:class:`StepGuard` → rollback and LR backoff after M consecutive
  skips), OOM classification, SIGTERM → snapshot.
- :mod:`.retry` — exponential backoff with deterministic jitter.
- :mod:`.runner` — the resumable runners wiring all of it through
  training, the prune loop and the robustness sweep (imported lazily:
  it depends on the train loop, which itself uses the chaos hooks).

Everything emits obs counters and spans (``resilience_nan_skips_total``,
``resilience_resumes_total``, ``resilience_rollbacks_total``,
``checkpoint_write_seconds``, ``chaos:*``).
"""

from torchpruner_tpu_torch.resilience import chaos
from torchpruner_tpu_torch.resilience.guards import (
    NonFiniteStreakError,
    Preempted,
    PreemptionHandler,
    StepGuard,
    is_oom_error,
)
from torchpruner_tpu_torch.resilience.manifest import (
    RunManifest,
    atomic_write_json,
)
from torchpruner_tpu_torch.resilience.retry import (
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    retriable,
    retry_call,
    with_retries,
)

__all__ = [
    "chaos",
    "ChaosConfig",
    "NonFiniteStreakError",
    "Preempted",
    "PreemptionHandler",
    "StepGuard",
    "is_oom_error",
    "RunManifest",
    "atomic_write_json",
    "Deadline",
    "DeadlineExceeded",
    "RetryPolicy",
    "retriable",
    "retry_call",
    "with_retries",
]

ChaosConfig = chaos.ChaosConfig
