"""Request/response types for the continuous-batching serving engine.

Counterpart of ``torchpruner_tpu/serve/request.py``, copied without the
fields of the slices not ported yet (tracing, sessions, prefix pages,
hot-swap, drain snapshots and the wire schema).

A :class:`Request` is one generation job: prompt token ids, a budget of
new tokens, and per-request :class:`Sampling` parameters.  The engine
mutates the request in place as it moves through the lifecycle
(``QUEUED → ACTIVE → DONE``), appending generated tokens and stamping
the latency timestamps the serving summary is built from (TTFT =
first-token wall time from arrival; per-token = gap between successive
tokens of the SAME request, which under continuous batching includes
any steps the request spent sharing the slot array).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_ids = itertools.count()


@dataclass(frozen=True)
class Sampling:
    """Per-request sampling config — the same semantics as
    :func:`torchpruner_tpu_torch.generate.generate`: greedy at
    ``temperature == 0`` (exact argmax, the bit-parity contract with
    solo decode), else seeded softmax sampling optionally truncated to
    ``top_k`` / the ``top_p`` nucleus.  ``seed`` pins the request's rng
    stream so a request replayed alone reproduces its tokens."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0

    def validate(self, vocab: int) -> None:
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k is not None and not (1 <= self.top_k):
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


# lifecycle states
QUEUED = "queued"      # submitted, waiting for a slot
ACTIVE = "active"      # holds a slot (prefilled, decoding)
DONE = "done"          # emitted max_new tokens (or eos)
SHED = "shed"          # rejected (tenant throttled or over its quota)


@dataclass
class Request:
    """One generation job.  ``prompt_ids`` is a 1-D int sequence;
    ``max_new`` the generation budget; ``eos_id`` an optional early-stop
    token.  ``arrival_s`` is stamped by the scheduler at submit (or
    carried in by an open-loop traffic generator whose arrival schedule
    is the experiment)."""

    prompt_ids: np.ndarray
    max_new: int
    sampling: Sampling = field(default_factory=Sampling)
    eos_id: Optional[int] = None
    id: int = field(default_factory=lambda: next(_ids))

    #: QoS tenant (serve.qos): traffic class for token-bucket
    #: throttling, priority admission/preemption and KV-page quotas;
    #: None = the unthrottled interactive default
    tenant: Optional[str] = None

    # -- engine-owned runtime state ------------------------------------
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    arrival_s: Optional[float] = None
    #: when the scheduler granted the slot (queue-age = admitted - arrival)
    admitted_s: Optional[float] = None
    #: wall seconds the prefill program (+ cache insert) took
    prefill_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    #: wall-clock gaps between successive tokens (len == tokens - 1)
    token_gaps_s: List[float] = field(default_factory=list)
    #: times this request was preempted back to the queue by a
    #: higher-priority admission (qos) — progress restarts on re-admit
    preemptions: int = 0
    #: prompt tokens computed by the prefill
    prefilled_tokens: int = 0

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids,
                                     np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")

    @property
    def total_len(self) -> int:
        """Positions the request needs resident in its slot's cache."""
        return int(self.prompt_ids.size) + int(self.max_new)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None or self.arrival_s is None:
            return None
        return self.first_token_s - self.arrival_s
