"""Deterministic fault injection ("chaos") for recovery-path testing —
the port of ``torchpruner_tpu/resilience/chaos.py``.

Real failures — NaN gradients, SIGKILLs, out-of-memory, flaky data
loads — are rare and nondeterministic, which makes recovery code the
least-tested code in a training stack.  This module turns each failure
mode into a deterministic, step-indexed event driven by config
(``ExperimentConfig.chaos``), the CLI (``--chaos``) or the
``TORCHPRUNER_CHAOS`` env var (JSON):

    {"nan_at_step": 5}          # poison step 5's batch with NaNs
    {"kill_at_step": 12}        # SIGKILL the process at step 12's boundary
    {"oom_at_step": 3}          # synthetic out-of-memory at step 3
    {"fail_data_at_step": 2}    # transient OSError from the batch stream
    {"corrupt_checkpoint": true} # flip bytes in the next saved checkpoint
    {"delay_callback_s": 0.05}  # stall the data fetch once
    {"slow_steps_ms": 5}        # stall EVERY serve engine step

The keys, their validation errors and their semantics are the JAX
package's.  Hooks sit at the top of ``Trainer.step``, in the resilient
runner's data fetch and commit, and in the serve engine's step; each is
a single module-global ``None`` check when chaos is not configured, so
production paths pay nothing.  Step indices are global optimizer-step
counts (``trainer.step_count``), and each injection fires at most once
per process by default (``once``).  A resumed process has a fresh fired
set, so the resilient runners call :func:`disarm_through` with the
restored step count: injections at or before the cursor stay dead even
when a commit boundary coincides with the injection step.

Every firing emits an obs ``chaos:*`` span and bumps
``chaos_injections_total``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from torchpruner_tpu_torch import obs

ENV_VAR = "TORCHPRUNER_CHAOS"


class InjectedResourceExhausted(RuntimeError):
    """Synthetic OOM — its message says what ``guards.is_oom_error``
    looks for in a real allocation failure."""

    def __init__(self, step: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: chaos-injected allocation failure at "
            f"step {step} (out of memory simulation)"
        )


class InjectedDataError(OSError):
    """Synthetic transient data-loading failure (retryable)."""


@dataclass
class ChaosConfig:
    """All knobs default to 'never fires'."""

    #: poison this global step's batch with NaNs (→ NaN loss/grads)
    nan_at_step: int = -1
    #: SIGKILL the process at this step's boundary (before it computes)
    kill_at_step: int = -1
    #: raise a synthetic RESOURCE_EXHAUSTED at this step's boundary
    oom_at_step: int = -1
    #: raise a transient OSError from the data stream at this step
    fail_data_at_step: int = -1
    #: flip bytes inside the next checkpoint written after this is set
    corrupt_checkpoint: bool = False
    #: one-shot sleep injected into the data fetch (the JAX package's
    #: key name: there it also stalls host callbacks)
    delay_callback_s: float = 0.0
    #: per-step sleep injected into a serving engine's loop (ms) — the
    #: "slow replica" fault: the process stays live and correct but its
    #: tail latency degrades.  Fires every step (not once).
    slow_steps_ms: float = 0.0
    #: each injection fires at most once per process (default) — set
    #: False only in unit tests that want repeat fires
    once: bool = True

    @classmethod
    def from_any(cls, spec) -> "ChaosConfig":
        """Build from a dict, JSON string, JSON file path, or None."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            if os.path.exists(spec):
                with open(spec) as f:
                    spec = json.load(f)
            else:
                spec = json.loads(spec)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"unknown chaos keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        return cls(**spec)

    def any_active(self) -> bool:
        return (
            self.nan_at_step >= 0 or self.kill_at_step >= 0
            or self.oom_at_step >= 0 or self.fail_data_at_step >= 0
            or self.corrupt_checkpoint or self.delay_callback_s > 0
            or self.slow_steps_ms > 0
        )


_cfg: Optional[ChaosConfig] = None
_fired: set = set()


def configure(spec=None) -> Optional[ChaosConfig]:
    """Install a process-wide chaos config (dict / JSON string / path /
    ChaosConfig / None).  Falls back to the ``TORCHPRUNER_CHAOS`` env var
    when ``spec`` is empty; installs nothing when neither names an
    active injection.  Returns the installed config (or None)."""
    global _cfg
    if not spec:
        spec = os.environ.get(ENV_VAR) or None
    cfg = ChaosConfig.from_any(spec) if spec else None
    if cfg is not None and not cfg.any_active():
        cfg = None
    _cfg = cfg
    _fired.clear()
    return _cfg


def disable() -> None:
    """Uninstall chaos unconditionally — unlike ``configure({})``, this
    does NOT fall back to the ``TORCHPRUNER_CHAOS`` env var, so cleanup
    code (bench legs, test fixtures) cannot accidentally re-arm an
    env-configured injection with a fresh fired-set."""
    global _cfg
    _cfg = None
    _fired.clear()


def active() -> bool:
    return _cfg is not None


def disarm_through(step: int) -> None:
    """Mark every step-indexed injection at or before ``step`` as fired.

    Resume safety: chaos persisted in a config file / env survives into
    the resumed process with a fresh ``_fired`` set.  When a commit
    boundary coincides with ``kill_at_step``, the restored step counter
    re-enters exactly the kill step and the run would die on every
    resume, never progressing.  The resilient runners call this with the
    restored step count so already-survived injections stay behind the
    cursor."""
    if _cfg is None:
        return
    for kind, at in (("nan", _cfg.nan_at_step), ("kill", _cfg.kill_at_step),
                     ("oom", _cfg.oom_at_step),
                     ("data", _cfg.fail_data_at_step)):
        if 0 <= at <= step:
            _fired.add(kind)


def _fires(kind: str, at: int, step: int) -> bool:
    if at < 0 or step != at:
        return False
    if _cfg.once and kind in _fired:
        return False
    _fired.add(kind)
    obs.inc("chaos_injections_total", help="chaos faults injected")
    return True


# -- hooks (call sites guard on active() for zero-cost no-ops) --------------


def maybe_kill(step: int) -> None:
    """SIGKILL this process at the configured step boundary — the
    unhandleable death a preempted machine actually gets."""
    if _cfg is None or not _fires("kill", _cfg.kill_at_step, step):
        return
    with obs.span("chaos:kill", step=step):
        pass
    # flush whatever telemetry exists; SIGKILL allows no atexit
    obs.shutdown()
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_oom(step: int) -> None:
    if _cfg is None or not _fires("oom", _cfg.oom_at_step, step):
        return
    with obs.span("chaos:oom", step=step):
        pass
    raise InjectedResourceExhausted(step)


def poison_batch(step: int, x):
    """Return ``x`` (a tensor or a numpy array) NaN-poisoned at the
    configured step — the forward then produces a NaN loss and NaN
    gradients, exercising the non-finite guard end to end (detection,
    skip, rollback).

    Integer batches (LM token ids) cannot carry a NaN: the embedding
    lookup would see a clamped id, the loss would stay finite, and the
    drill would report success while testing nothing.  That case logs a
    loud warning and leaves the batch untouched (the injection still
    counts as fired, keeping the step schedule deterministic)."""
    if _cfg is None or not _fires("nan", _cfg.nan_at_step, step):
        return x
    import torch

    floating = (x.is_floating_point() if isinstance(x, torch.Tensor)
                else np.issubdtype(np.asarray(x).dtype, np.floating))
    if not floating:
        import logging

        logging.getLogger("torchpruner_tpu_torch").warning(
            "[chaos] nan_at_step=%d: batch dtype %s cannot represent "
            "NaN — injection skipped (poison a float input, or use "
            "oom_at_step/kill_at_step for integer-input models)",
            step, x.dtype)
        return x
    with obs.span("chaos:nan_grads", step=step):
        pass
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan"))
    return np.full_like(np.asarray(x), np.nan)


def maybe_fail_data(step: int) -> None:
    """Raise a transient OSError out of the data stream — what the
    ``retry`` wrapper around batch fetching exists to absorb."""
    if _cfg is None or not _fires("data", _cfg.fail_data_at_step, step):
        return
    with obs.span("chaos:data_fail", step=step):
        pass
    raise InjectedDataError(
        f"chaos: transient data-loading failure at step {step}"
    )


def maybe_slow_step() -> None:
    """Per-step stall for a serving engine (``slow_steps_ms``) — unlike
    :func:`maybe_delay` this fires on every engine step, degrading the
    replica's per-token latency without killing it (the "slow replica"
    fault)."""
    if _cfg is None or _cfg.slow_steps_ms <= 0:
        return
    if "slow" not in _fired:
        # count the injection once; the sleeps themselves are the fault
        _fired.add("slow")
        obs.inc("chaos_injections_total", help="chaos faults injected")
    time.sleep(_cfg.slow_steps_ms / 1e3)


def maybe_delay() -> None:
    """One-shot data-fetch stall (a prefetch hiccup, a slow NFS read)."""
    if _cfg is None or _cfg.delay_callback_s <= 0:
        return
    if _cfg.once and "delay" in _fired:
        return
    _fired.add("delay")
    with obs.span("chaos:delay", seconds=_cfg.delay_callback_s):
        time.sleep(_cfg.delay_callback_s)


def corrupt_checkpoint_bytes(path: str, *, force: bool = False) -> bool:
    """Flip bytes in the largest array file under checkpoint ``path`` —
    the torn-write/bitrot case ``restore_checkpoint``'s digest must
    catch.  Fires when the installed config's ``corrupt_checkpoint`` is
    set (once); ``force=True`` corrupts unconditionally (tests/bench
    calling it directly on a checkpoint dir).  Returns True when
    something was corrupted."""
    if not force:
        if _cfg is None or not _cfg.corrupt_checkpoint:
            return False
        if _cfg.once and "corrupt" in _fired:
            return False
        _fired.add("corrupt")
        obs.inc("chaos_injections_total", help="chaos faults injected")
    arrays = os.path.join(path, "arrays")
    if os.path.isdir(arrays):
        path = arrays  # corrupt the digest-sealed payload, not spec.json
    victim, size = None, 0
    for root, _dirs, files in os.walk(path):
        for fn in files:
            fp = os.path.join(root, fn)
            try:
                s = os.path.getsize(fp)
            except OSError:
                continue
            if s > size:
                victim, size = fp, s
    if victim is None or size == 0:
        return False
    with obs.span("chaos:corrupt_checkpoint", file=os.path.basename(victim)):
        with open(victim, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(64) or b"\0"
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
    return True
