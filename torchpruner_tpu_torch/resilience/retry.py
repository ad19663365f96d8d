"""Retry with exponential backoff and deterministic jitter — a copy of
``torchpruner_tpu/resilience/retry.py`` (host-only; the port imports
nothing of the JAX package).

For *transient* failures — flaky data loads, filesystem blips while
writing a checkpoint — where the right response is "wait a moment and
try again", not "roll back to a checkpoint".  Persistent failures (the
exception keeps coming) re-raise after the budget is spent;
non-retryable exception types pass straight through.

Jitter is deterministic (a splitmix64 hash of ``seed`` and the
attempt), the same policy the repo uses for data shuffling: two runs of
the same config sleep the same schedule, and the delays for a seed are
the JAX package's, so retry behaviour never makes a resumed run diverge
from an uninterrupted one.

:class:`Deadline` / :func:`with_retries` are the attempt machine: max
attempts, per-attempt timeout and an overall deadline budget, with
pinned exhaustion-vs-deadline error ordering.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from torchpruner_tpu_torch import obs


class DeadlineExceeded(TimeoutError):
    """The :class:`Deadline` ran out before the call succeeded.  The
    last transient failure (when one happened) is chained as
    ``__cause__`` so the operator sees WHY the budget was spent, not
    just that it was."""


@dataclass(frozen=True)
class Deadline:
    """An absolute time budget shared across retry attempts.

    A per-attempt timeout bounds one try; the deadline bounds the WHOLE
    operation (attempts + backoff sleeps) — the budget a caller with an
    SLA actually has.  Monotonic-clock based; create with
    :meth:`after`."""

    t_end: float
    budget_s: float

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        return cls(t_end=time.monotonic() + float(budget_s),
                   budget_s=float(budget_s))

    def remaining(self) -> float:
        return max(0.0, self.t_end - time.monotonic())

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.t_end

    def clamp(self, timeout_s: Optional[float]) -> float:
        """The per-attempt timeout: ``timeout_s`` bounded by what is
        left of the budget (never negative)."""
        rem = self.remaining()
        return rem if timeout_s is None else min(float(timeout_s), rem)

#: exception types considered transient by default: data-loading /
#: host-callback I/O.  Deliberately narrow — an OOM or a NaN streak must
#: NOT be retried blindly (they have their own recovery paths in
#: ``guards`` / ``runner``).
DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    OSError, IOError, ConnectionError, TimeoutError,
)


def _jitter01(seed: int, attempt: int) -> float:
    """Deterministic uniform-ish [0, 1) from (seed, attempt) — splitmix64
    finalizer, matching the repo's shuffle hashing idiom."""
    z = (seed * 0x9E3779B97F4A7C15 + attempt * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return ((z ^ (z >> 31)) & 0xFFFFFFFFFFFFFFFF) / 2.0**64


@dataclass(frozen=True)
class RetryPolicy:
    tries: int = 4                 # total attempts (1 = no retry)
    base_delay_s: float = 0.05     # delay before the 1st retry
    factor: float = 2.0            # exponential growth per retry
    max_delay_s: float = 2.0       # backoff ceiling
    jitter: float = 0.5            # +- fraction of the delay randomized
    seed: int = 0                  # jitter determinism

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        d = min(self.base_delay_s * self.factor ** (attempt - 1),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * _jitter01(self.seed, attempt)
                                      - 1.0)
        return max(0.0, d)


def with_retries(
    fn: Callable[[Optional[float]], object],
    *,
    policy: RetryPolicy = RetryPolicy(),
    deadline: Optional[Deadline] = None,
    attempt_timeout_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_TRANSIENT,
    label: str = "call",
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """The shared attempt machine under both the data-stream retries
    (:func:`retry_call`) and any dispatch with a time budget: bounded
    attempts, per-attempt timeout, deterministic-jitter exponential
    backoff, and an overall :class:`Deadline`.

    ``fn(timeout_s)`` is called with the per-attempt timeout — the
    caller's ``attempt_timeout_s`` clamped to the deadline's remaining
    budget (``None`` when neither bound is set; transports pass it to
    their socket timeout, plain calls may ignore it).

    Error ordering (test-pinned):

    - the deadline already expired before an attempt → raise
      :class:`DeadlineExceeded` (chained from the last failure, if any)
      WITHOUT burning another attempt;
    - the LAST allowed attempt fails → re-raise its exception unchanged
      (exhaustion wins over a simultaneous deadline expiry: the caller
      sees the real failure, not a wrapper);
    - a mid-budget failure whose backoff sleep would cross the deadline
      → :class:`DeadlineExceeded` chained from that failure (never
      sleep past the budget just to fail on arrival).
    """
    last: Optional[BaseException] = None
    for attempt in range(1, policy.tries + 1):
        if deadline is not None and deadline.expired:
            obs.inc("resilience_deadline_exceeded_total",
                    help="retry budgets cut short by their deadline")
            raise DeadlineExceeded(
                f"{label}: deadline ({deadline.budget_s:.3f}s) expired "
                f"after {attempt - 1} attempt(s)") from last
        timeout = (deadline.clamp(attempt_timeout_s)
                   if deadline is not None else attempt_timeout_s)
        try:
            return fn(timeout)
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            last = e
            if attempt == policy.tries:
                raise
            obs.inc("resilience_retries_total",
                    help="transient-failure retries (retry_call)")
            if label != "call":
                # per-site breakdown: checkpoint-FS retries vs data-
                # stream retries are different operational signals
                obs.inc(f"resilience_retries_{label}_total",
                        help=f"transient-failure retries ({label})")
            if on_retry is not None:
                on_retry(attempt, e)
            delay = policy.delay(attempt)
            if deadline is not None and delay >= deadline.remaining():
                obs.inc("resilience_deadline_exceeded_total",
                        help="retry budgets cut short by their deadline")
                raise DeadlineExceeded(
                    f"{label}: deadline ({deadline.budget_s:.3f}s) "
                    f"leaves no room for the {delay:.3f}s backoff after "
                    f"attempt {attempt}") from e
            sleep(delay)
    raise last  # unreachable; keeps type checkers honest


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy = RetryPolicy(),
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_TRANSIENT,
    label: str = "call",
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying transient failures with
    exponential backoff.  Each retry bumps ``resilience_retries_total``;
    exhausting the budget re-raises the LAST exception unchanged (the
    caller sees the real failure, not a wrapper).  Timeout-less facade
    over :func:`with_retries`."""
    return with_retries(
        lambda _timeout_s: fn(*args, **kwargs), policy=policy,
        retry_on=retry_on, label=label, sleep=sleep, on_retry=on_retry)


def retriable(policy: RetryPolicy = RetryPolicy(),
              retry_on: Tuple[Type[BaseException], ...] = DEFAULT_TRANSIENT,
              label: str = "call"):
    """Decorator form of :func:`retry_call`::

        @retriable(RetryPolicy(tries=3))
        def fetch_shard(i): ...
    """

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, retry_on=retry_on,
                              label=label, **kwargs)

        return wrapped

    return deco
