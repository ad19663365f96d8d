"""Request/response types for the continuous-batching serving engine —
counterpart of ``torchpruner_tpu/serve/request.py``.

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
import threading
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
    ``top_k`` / the ``top_p`` nucleus.  ``seed`` pins the request's
    generator so a request replayed alone reproduces its tokens."""

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
DRAINED = "drained"    # never started; snapshotted at drain
SHED = "shed"          # rejected at admission (queue over its bound)


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

    #: fleet-minted distributed trace id (obs.reqtrace) — propagated in
    #: the dispatch payload so replica-side stage events join the
    #: router's on one cross-process waterfall; None = untraced
    trace_id: Optional[str] = None

    #: caller-asserted session key — the fleet router's strongest
    #: prefix-affinity signal (requests of one session share a growing
    #: prompt prefix, so landing them on one replica compounds its
    #: prefix-cache hits); None = route by prompt-page hash / load only
    session_id: Optional[str] = None

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
    #: prompt tokens served by mapping shared prefix pages (0 = miss
    #: or sharing off) / actually computed by prefill programs —
    #: stamped by the engine; hit + prefilled == prompt_len on the
    #: chunked path
    prefix_hit_tokens: int = 0
    prefilled_tokens: int = 0
    #: the program set (checkpoint) that decoded this request — stamped
    #: at prefill so verification replays against the RIGHT weights
    #: even when a hot-swap landed mid-run
    served_by: Optional[object] = field(default=None, repr=False)
    #: completion signal for frontends blocking on the result
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False)

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

    def finished(self) -> bool:
        return self.state in (DONE, DRAINED)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine completes (or drains) this request —
        the HTTP frontend's hand-off from handler thread to engine
        loop."""
        return self._event.wait(timeout)

    def result(self) -> dict:
        return {
            "id": self.id,
            "state": self.state,
            "tokens": list(self.tokens),
            "prompt_len": int(self.prompt_ids.size),
            "ttft_s": self.ttft_s,
            "token_gaps_s": list(self.token_gaps_s),
            "prefix_hit_tokens": int(self.prefix_hit_tokens),
        }

    def snapshot(self) -> dict:
        """JSON form for the drain snapshot — enough to resubmit the
        request verbatim after a preemption."""
        return {
            "prompt_ids": self.prompt_ids.tolist(),
            "max_new": int(self.max_new),
            "eos_id": self.eos_id,
            "session_id": self.session_id,
            "tenant": self.tenant,
            "sampling": {
                "temperature": self.sampling.temperature,
                "top_k": self.sampling.top_k,
                "top_p": self.sampling.top_p,
                "seed": self.sampling.seed,
            },
        }

    @classmethod
    def from_snapshot(cls, d: dict) -> "Request":
        return cls(prompt_ids=np.asarray(d["prompt_ids"], np.int32),
                   max_new=int(d["max_new"]), eos_id=d.get("eos_id"),
                   session_id=d.get("session_id"),
                   tenant=d.get("tenant"),
                   sampling=Sampling(**(d.get("sampling") or {})))


def request_from_dict(d: dict) -> Request:
    """The ONE wire schema → :class:`Request` parse, shared by every
    transport (single-replica HTTP/stdin front ends, the fleet router's
    dispatch, journal redrive): ``{"prompt_ids": [...], "max_new": N,
    "eos_id": ..., "temperature": .., "top_k": .., "top_p": ..,
    "seed": ..}`` — flat sampling fields, matching ``POST
    /v1/generate``."""
    return Request(
        prompt_ids=d["prompt_ids"], max_new=int(d.get("max_new", 16)),
        eos_id=d.get("eos_id"),
        # the router injects the fleet trace id at dispatch; absent on
        # direct/journal submissions (untraced)
        trace_id=d.get("trace_id"),
        session_id=d.get("session_id"),
        tenant=d.get("tenant"),
        sampling=Sampling(
            temperature=float(d.get("temperature", 0.0)),
            top_k=d.get("top_k"), top_p=d.get("top_p"),
            seed=int(d.get("seed", 0))))
