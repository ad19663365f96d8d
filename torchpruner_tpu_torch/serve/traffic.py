"""Synthetic open-loop traffic for the serving engine.

Counterpart of ``torchpruner_tpu/serve/traffic.py``, copied without the
shared-prefix workload (prefix pages are not ported yet).

Open-loop means arrivals follow their OWN schedule regardless of how
fast the engine drains them — the regime where queueing delay, TTFT
tails, and slot contention actually show up (a closed loop that waits
for each response can never overload the server).  Two schedules:

- **Poisson** (``poisson_arrivals``) — exponential inter-arrival gaps
  at a target rate, the classic serving-bench workload; wall-clock
  driven.
- **Step-staggered** (``staggered_arrivals``) — arrivals pinned to
  ENGINE STEP indices, fully deterministic regardless of host speed;
  what the tests and ``--synthetic`` use to force mid-run admissions
  and slot reuse reproducibly.

Requests are seeded synthetics: prompt ids uniform over the model's
vocab, lengths/budgets drawn from ranges, per-request sampling seeds —
the same request replayed through ``generate`` solo reproduces its
tokens (the CI parity assertion).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from torchpruner_tpu_torch.serve.request import Request, Sampling


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0) -> List[float]:
    """``n`` arrival offsets (seconds from traffic start) with
    exponential inter-arrival gaps at ``rate_per_s``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
    return np.cumsum(gaps).tolist()


def staggered_arrivals(n: int, every_steps: int = 2,
                       burst: int = 1) -> List[int]:
    """Deterministic step-indexed arrivals: ``burst`` requests every
    ``every_steps`` engine steps (request 0 at step 0)."""
    return [(i // burst) * every_steps for i in range(n)]


def synthetic_requests(n: int, *, vocab: int, prompt_lens: Sequence[int],
                       max_new: Sequence[int], seed: int = 0,
                       temperature: float = 0.0,
                       eos_id: Optional[int] = None) -> List[Request]:
    """``n`` seeded synthetic requests.  ``prompt_lens`` / ``max_new``
    are cycled per request, so a mixed-length workload (different
    prefill buckets, different finish times — the ragged mix) is one
    list literal away."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(prompt_lens[i % len(prompt_lens)])
        ids = rng.integers(0, vocab, size=plen).astype(np.int32)
        out.append(Request(
            prompt_ids=ids, max_new=int(max_new[i % len(max_new)]),
            eos_id=eos_id,
            sampling=Sampling(temperature=temperature, seed=seed + i)))
    return out


def open_loop(requests: Sequence[Request], *, rate: float = 0.0,
              stagger_steps: int = 2, seed: int = 0
              ) -> "OpenLoopTraffic":
    """THE open-loop schedule selector of the serve frontend's
    ``--synthetic`` mode (one copy of the rate>0 → Poisson, else
    step-staggered choice): ``rate > 0`` drives wall-clock Poisson arrivals at that
    rate; ``rate == 0`` pins arrivals to engine ticks every
    ``stagger_steps`` steps (fully deterministic)."""
    if rate > 0:
        return OpenLoopTraffic(
            requests, poisson_arrivals(len(requests), rate, seed=seed))
    return OpenLoopTraffic(
        requests,
        staggered_arrivals(len(requests), every_steps=stagger_steps),
        by_step=True)


class OpenLoopTraffic:
    """Feeds requests into an engine on an open-loop schedule.

    ``arrivals`` are either seconds-from-start floats (wall-clock mode)
    or engine-TICK ints (``by_step=True``, deterministic mode — ticks
    are the engine's loop-iteration clock, which advances even while
    the slot array is idle, so a sparse schedule can never stall
    waiting for a decode step that will never happen).  The engine
    calls :meth:`pump` at every loop iteration; due requests are
    submitted with their SCHEDULED arrival time so queueing delay
    counts into TTFT (wall-clock mode) even when the engine was busy."""

    def __init__(self, requests: Sequence[Request],
                 arrivals: Sequence[float], *, by_step: bool = False):
        if len(requests) != len(arrivals):
            raise ValueError("one arrival per request")
        order = np.argsort(np.asarray(arrivals, float), kind="stable")
        self._pending = [(float(arrivals[i]), requests[i]) for i in order]
        self.by_step = by_step
        self._start: Optional[float] = None
        self.submitted = 0

    @property
    def exhausted(self) -> bool:
        return not self._pending

    def pump(self, engine) -> int:
        """Submit every request whose arrival is due; returns how many."""
        if self._start is None:
            self._start = time.perf_counter()
        now_clock = time.perf_counter()
        clock = float(engine.ticks) if self.by_step \
            else now_clock - self._start
        n = 0
        while self._pending and self._pending[0][0] <= clock:
            at, req = self._pending.pop(0)
            engine.submit(req, arrival_s=(
                None if self.by_step else self._start + at))
            self.submitted += 1
            n += 1
        return n
