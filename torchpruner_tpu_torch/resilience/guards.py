"""Step guards: non-finite detection and skip, OOM classification,
preemption — the port of ``torchpruner_tpu/resilience/guards.py``.

The device half of the non-finite guard lives in
``train/loop.py Trainer`` (``guard=StepGuard(...)``): after the forward
and backward the host reads ``ok = isfinite(loss) &
isfinite(global_norm(grads))`` once and skips the optimizer update, the
parameter write and the BatchNorm-state write when it is false, so a
NaN step costs one wasted forward and backward, never a poisoned
parameter.  (The JAX package compiles the same gate into the step with
``jnp.where``; the eager port pays one host read a guarded step instead,
and nothing without a guard.)  This module holds the host half:

- :class:`StepGuard` counts skips, and after ``max_bad_steps``
  consecutive bad steps raises :class:`NonFiniteStreakError`, which the
  resilient runner turns into rollback to the last checkpoint with a
  backed-off LR.
- :func:`is_oom_error` classifies allocation failures (torch's
  ``OutOfMemoryError``, a ``RuntimeError`` saying "CUDA out of memory",
  the chaos module's injected one), the trigger for the runner's retry
  at doubled ``accum_steps``.
- :class:`PreemptionHandler` turns SIGTERM into a flag polled at step
  boundaries.  Single process: the multi-process agreement of the JAX
  package waits for the port's parallelism.
"""

from __future__ import annotations

import re
import signal
import threading
from dataclasses import dataclass
from typing import Optional

from torchpruner_tpu_torch import obs


class NonFiniteStreakError(RuntimeError):
    """``max_bad_steps`` consecutive steps produced a non-finite loss or
    gradients; the skip alone is no longer enough."""

    def __init__(self, streak: int, total: int):
        self.streak = streak
        self.total = total
        super().__init__(
            f"{streak} consecutive non-finite train steps "
            f"({total} skipped total) — params are being held at their "
            "last finite values but training is not progressing; roll "
            "back to the last checkpoint and back off the LR")


@dataclass
class StepGuard:
    """Host-side tracker fed one bool per guarded step."""

    max_bad_steps: int = 3
    consecutive: int = 0
    total_skips: int = 0

    def observe(self, bad: bool) -> bool:
        """Record one step's guard flag; returns ``bad``.  Raises
        :class:`NonFiniteStreakError` when the streak limit is hit."""
        if not bad:
            self.consecutive = 0
            return False
        self.consecutive += 1
        self.total_skips += 1
        obs.inc("resilience_nan_skips_total",
                help="train steps skipped by the non-finite guard")
        if self.max_bad_steps and self.consecutive >= self.max_bad_steps:
            raise NonFiniteStreakError(self.consecutive, self.total_skips)
        return True

    def reset(self) -> None:
        self.consecutive = 0


#: message patterns of an allocation failure: the CUDA caching
#: allocator's "CUDA out of memory", the CPU allocator's, XLA's
#: RESOURCE_EXHAUSTED (and the chaos injection, which says both), and
#: OOM as a word of its own
_OOM_PATTERN = re.compile(
    r"RESOURCE_EXHAUSTED|[Oo]ut of memory|failed to allocate|\bOOM\b")


def is_oom_error(e: BaseException) -> bool:
    """True when ``e`` is an allocation failure worth retrying with a
    smaller memory footprint (doubled ``accum_steps``, halved microbatch
    activations)."""
    import torch

    if isinstance(e, (MemoryError, torch.OutOfMemoryError)):
        return True
    return bool(_OOM_PATTERN.search(str(e)))


def next_accum_for_oom(accum: int, batch_size: int) -> Optional[int]:
    """The one degradation policy after an OOM: double ``accum_steps``,
    or ``None`` when nothing is left to degrade to (already at
    per-example microbatches, or the batch stops dividing).  Shared by
    the train runner and the prune loop."""
    new = max(1, accum) * 2
    if new > batch_size or batch_size % new:
        return None
    return new


class Preempted(Exception):
    """Raised by runner code (never by the handler) after a preemption
    snapshot commits — unwinds the pipeline cleanly."""


class PreemptionHandler:
    """SIGTERM → "snapshot at the next step boundary" flag.

    Use as a context manager around a loop and poll :attr:`requested`
    at step boundaries (the resilient runners snapshot and unwind; the
    serving engine drains in-flight requests and snapshots its queue).
    Installed only on the main thread; from any other thread the
    handler stays poll-only (:meth:`request`).  The previous handlers
    come back when the context exits."""

    def __init__(self):
        self._old = {}
        self._flag = threading.Event()
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        try:
            self._old[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                      self._on_signal)
            self.installed = True
        except ValueError:
            # not the main thread (tests, embedded use): stay poll-only
            self.installed = False
        return self

    def __exit__(self, *exc) -> bool:
        for s, old in self._old.items():
            try:
                signal.signal(s, old)
            except ValueError:
                pass
        self._old.clear()
        return False

    def _on_signal(self, signum, _frame) -> None:
        self._flag.set()
        obs.inc("resilience_preemptions_total",
                help="preemption signals observed (SIGTERM)")

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def request(self) -> None:
        """Programmatic preemption (tests; in-process drain)."""
        self._flag.set()
