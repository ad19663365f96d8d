"""SIGTERM as a flag polled at step boundaries — the single-process
:class:`PreemptionHandler` of ``torchpruner_tpu/resilience/guards.py``.
The non-finite step guard, OOM classification and the multi-process
broadcast are ROADMAP A8."""

from __future__ import annotations

import signal
import threading


class PreemptionHandler:
    """SIGTERM → "drain at the next step boundary" flag.

    Use as a context manager around a loop and poll :attr:`requested`
    at step boundaries (the serving engine drains in-flight requests
    and snapshots its queue).  Installed only on the main thread; from
    any other thread the handler stays poll-only (:meth:`request`).  The
    previous handlers come back when the context exits."""

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

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def request(self) -> None:
        """Programmatic preemption (tests; in-process drain)."""
        self._flag.set()
