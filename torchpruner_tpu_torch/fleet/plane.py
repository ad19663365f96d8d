"""The transport-agnostic request plane: durable, redrivable records.
(A copy of ``torchpruner_tpu/fleet/plane.py``, imports renamed: the
same journal schema and state names, so either package reads the
other's journal.  One repair: a record that turns terminal leaves the
pending queue, so a failover's redrive cannot dispatch a completed
record again; see ``_unqueue_locked``.)

The single-replica engine's :class:`~torchpruner_tpu_torch.serve.scheduler.
Scheduler` tracks requests in process memory — a ``kill -9`` loses every
queued and in-flight request with it.  The request plane is the fleet's
answer: one :class:`PlaneRecord` per ACCEPTED request (wire payload,
deadline, attempt count, assignment, outcome) in an atomic JSON journal
(the ``resilience.manifest.atomic_write_json`` discipline), flushed
BEFORE the acceptance is acknowledged.  That makes the core robustness
contract structural rather than aspirational:

    every accepted request is, at every instant, either COMPLETED or
    REDRIVABLE — a replica death (its records re-enter the pending
    queue) and even a router death (:meth:`RequestPlane.load` turns the
    journal's non-terminal records back into pending work) lose nothing.

The plane is transport-agnostic on purpose: records carry the one wire
schema (``serve.request.request_from_dict``) that the HTTP front end,
the stdin front end, and the router's dispatch all share, so the same
record can be accepted over HTTP, redriven over HTTP to a different
replica, and replayed offline through ``generate()`` for ``--verify``.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.obs import reqtrace
from torchpruner_tpu_torch.resilience.manifest import (
    atomic_write_json,
    read_json,
)

JOURNAL_VERSION = 1

# record lifecycle states
ACCEPTED = "accepted"        # journaled, waiting for dispatch
DISPATCHED = "dispatched"    # a dispatch attempt is in flight
COMPLETED = "completed"      # tokens returned by some replica
FAILED = "failed"            # attempts/deadline exhausted (terminal)

_TERMINAL = (COMPLETED, FAILED)


@dataclass
class PlaneRecord:
    """One accepted request's durable state.  ``payload`` is the wire
    dict (``request_from_dict`` schema); ``deadline_epoch_s`` is
    wall-clock absolute so it survives a router restart."""

    rid: str
    payload: dict
    deadline_epoch_s: float
    accepted_epoch_s: float
    state: str = ACCEPTED
    #: distributed trace id minted at acceptance (obs.reqtrace) —
    #: journaled so a redriven/reloaded record keeps ONE waterfall
    trace_id: Optional[str] = None
    #: replica name of the CURRENT/latest dispatch attempt
    replica: Optional[str] = None
    attempts: int = 0
    #: times this record was re-queued off a failed/dead replica
    redrives: int = 0
    tokens: Optional[List[int]] = None
    completed_by: Optional[str] = None
    error: str = ""
    #: completion signal for front ends blocking on the result (never
    #: journaled)
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False, compare=False)

    def remaining_s(self, now: Optional[float] = None) -> float:
        return max(0.0, self.deadline_epoch_s
                   - (time.time() if now is None else now))

    def terminal(self) -> bool:
        return self.state in _TERMINAL

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def to_json(self) -> dict:
        return {
            "rid": self.rid,
            "payload": self.payload,
            "deadline_epoch_s": self.deadline_epoch_s,
            "accepted_epoch_s": self.accepted_epoch_s,
            "state": self.state,
            "trace_id": self.trace_id,
            "replica": self.replica,
            "attempts": self.attempts,
            "redrives": self.redrives,
            "tokens": self.tokens,
            "completed_by": self.completed_by,
            "error": self.error,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlaneRecord":
        return cls(**{k: d.get(k) for k in (
            "rid", "payload", "deadline_epoch_s", "accepted_epoch_s",
            "state", "trace_id", "replica", "attempts", "redrives",
            "tokens", "completed_by", "error")})


class RequestPlane:
    """Thread-safe record store + FIFO pending queue + atomic journal.

    Every mutation happens under one lock and (when a ``journal_path``
    is set) lands on disk via ``atomic_write_json`` before the mutating
    call returns — :meth:`accept` in particular, so an acknowledged
    acceptance is durable by construction.  Completion is IDEMPOTENT:
    a hedged duplicate dispatch that finishes second is dropped (and
    counted), never double-recorded.
    """

    def __init__(self, journal_path: Optional[str] = None,
                 retain_terminal: int = 0):
        """``retain_terminal > 0`` (the long-running HTTP endpoint)
        compacts the journal: only the newest N TERMINAL records are
        retained, so per-transition flush cost stays bounded instead of
        growing with lifetime traffic.  0 (drills/batch) keeps
        everything — the drill's verify pass replays the full set."""
        self.journal_path = journal_path
        self.retain_terminal = int(retain_terminal)
        self._lock = threading.RLock()
        self._records: Dict[str, PlaneRecord] = {}
        self._pending: List[str] = []  # FIFO of rids awaiting dispatch
        self._ids = itertools.count()
        self.shed_total = 0
        self.duplicate_results_total = 0
        self.compacted_total = 0

    # -- construction / recovery -------------------------------------------

    @classmethod
    def load(cls, journal_path: str,
             retain_terminal: int = 0) -> "RequestPlane":
        """Rebuild a plane from a (possibly dead) router's journal.
        Non-terminal records — accepted AND dispatched, since a
        dispatched record whose router died has no worker anymore — go
        back to pending in acceptance order: the redrive-after-router-
        death path."""
        plane = cls(journal_path, retain_terminal=retain_terminal)
        raw = read_json(journal_path)
        max_id = -1
        # the lock makes the rebuild safe even if the caller hands the
        # plane to accepting threads before load() returns (and keeps
        # these writes honest under the shared-state lint)
        with plane._lock:
            for d in raw.get("records", []):
                rec = PlaneRecord.from_json(d)
                plane._records[rec.rid] = rec
                if rec.rid.startswith("r"):
                    try:
                        max_id = max(max_id, int(rec.rid[1:]))
                    except ValueError:
                        pass
                if rec.terminal():
                    rec._event.set()
                else:
                    if rec.state == DISPATCHED:
                        rec.redrives += 1
                    rec.state = ACCEPTED
                    rec.replica = None
                    plane._pending.append(rec.rid)
            plane._pending.sort(
                key=lambda rid: plane._records[rid].accepted_epoch_s)
            plane._ids = itertools.count(max_id + 1)
            plane.shed_total = int(raw.get("shed_total", 0))
        return plane

    def _compact_locked(self) -> None:
        """Evict the oldest terminal records past ``retain_terminal``
        (waiters keep their own record reference; only the plane's —
        and therefore the journal's — copy is dropped)."""
        if not self.retain_terminal:
            return
        terminal = [r for r in self._records.values() if r.terminal()]
        excess = len(terminal) - self.retain_terminal
        if excess <= 0:
            return
        terminal.sort(key=lambda r: r.accepted_epoch_s)
        for r in terminal[:excess]:
            del self._records[r.rid]
        self.compacted_total += excess

    def _unqueue_locked(self, rid: str) -> None:
        """Drop a record that just turned terminal from the pending FIFO.
        A record is re-queued by a failover's ``release`` while the worker
        that held it may still retry it elsewhere and complete it; left in
        the FIFO, ``checkout`` would mark the completed record dispatched
        again and a second worker would complete (and count) it twice.
        (The JAX package's plane leaves it queued.)"""
        if rid in self._pending:
            self._pending.remove(rid)

    def _flush_locked(self) -> None:
        if not self.journal_path:
            return
        atomic_write_json(self.journal_path, {
            "version": JOURNAL_VERSION,
            "written_epoch_s": time.time(),
            "shed_total": self.shed_total,
            "records": [r.to_json() for r in self._records.values()],
        })

    # -- admission ----------------------------------------------------------

    def accept(self, payload: dict, deadline_s: float) -> PlaneRecord:
        """Journal a new record (durable BEFORE return) and queue it."""
        with self._lock:
            rec = PlaneRecord(
                rid=f"r{next(self._ids):05d}", payload=dict(payload),
                deadline_epoch_s=time.time() + float(deadline_s),
                accepted_epoch_s=time.time())
            rec.trace_id = reqtrace.mint_trace_id(rec.rid)
            self._records[rec.rid] = rec
            self._pending.append(rec.rid)
            t0 = time.perf_counter()
            self._flush_locked()
            flush_s = time.perf_counter() - t0
        obs.inc("fleet_accepted_total",
                help="requests accepted into the fleet request plane "
                     "(journaled: completed or redrivable from here on)")
        # the first two trace stages: the acceptance anchor and the
        # durability cost paid before the ack
        reqtrace.stage(rec.trace_id, "accept", rid=rec.rid,
                       t_start=rec.accepted_epoch_s)
        reqtrace.stage(rec.trace_id, "journal_flush", dur_s=flush_s,
                       rid=rec.rid)
        return rec

    def note_shed(self) -> None:
        """Count an admission-time shed (no record: a shed request was
        never accepted, so it is outside the zero-loss set — the caller
        got its 429/503 + Retry-After instead)."""
        with self._lock:
            self.shed_total += 1
            self._flush_locked()

    # -- dispatch lifecycle --------------------------------------------------

    def checkout(self) -> Optional[PlaneRecord]:
        """Pop the oldest pending record and mark it dispatched."""
        with self._lock:
            if not self._pending:
                return None
            rec = self._records[self._pending.pop(0)]
            rec.state = DISPATCHED
            self._flush_locked()
            return rec

    def checkout_expired(self) -> Optional[PlaneRecord]:
        """Pop the oldest pending record whose deadline already expired
        — the capacity-gated router's escape hatch: even with zero
        dispatch capacity, a record must still FAIL loudly at its
        deadline rather than age silently in the queue."""
        with self._lock:
            for i, rid in enumerate(self._pending):
                rec = self._records[rid]
                if rec.remaining_s() <= 0.0:
                    self._pending.pop(i)
                    rec.state = DISPATCHED
                    self._flush_locked()
                    return rec
            return None

    def assign(self, rid: str, replica: str) -> None:
        """Record which replica the current attempt targets (the
        redrive map's key)."""
        with self._lock:
            rec = self._records.get(rid)
            if rec is None or rec.terminal():
                return
            rec.replica = replica
            rec.attempts += 1
            self._flush_locked()

    def release(self, rid: str, *, redrive: bool = False) -> bool:
        """Back to pending (front of the FIFO — a redriven record is
        the oldest work in the plane).  No-op on terminal records."""
        with self._lock:
            rec = self._records.get(rid)
            if rec is None or rec.terminal() or rid in self._pending:
                return False
            rec.state = ACCEPTED
            rec.replica = None
            if redrive:
                rec.redrives += 1
            self._pending.insert(0, rid)
            self._flush_locked()
        if redrive:
            obs.inc("fleet_redrive_total",
                    help="journaled requests re-queued off a dead/"
                         "failed replica to a survivor")
            reqtrace.stage(rec.trace_id, "redrive", rid=rid,
                           redrives=rec.redrives)
        return True

    def complete(self, rid: str, tokens: List[int],
                 replica: str) -> bool:
        """Idempotent terminal transition; ``False`` drops a hedged
        duplicate (first completion wins)."""
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return False
            if rec.terminal():
                self.duplicate_results_total += 1
                obs.inc("fleet_duplicate_results_total",
                        help="hedged dispatches finishing after their "
                             "record was already terminal (dropped)")
                return False
            rec.state = COMPLETED
            rec.tokens = list(tokens)
            rec.completed_by = replica
            rec.error = ""
            self._unqueue_locked(rid)
            self._compact_locked()
            self._flush_locked()
            rec._event.set()
        obs.inc("fleet_completed_total",
                help="fleet requests completed by some replica")
        e2e = max(0.0, time.time() - rec.accepted_epoch_s)
        obs.observe("reqtrace_e2e_seconds", e2e,
                    help="fleet request acceptance -> completion "
                         "(router-observed end-to-end latency)")
        reqtrace.finish(rec.trace_id, outcome="complete",
                        e2e_s=round(e2e, 6), rid=rid, replica=replica,
                        attempts=rec.attempts, redrives=rec.redrives)
        return True

    def fail(self, rid: str, error: str) -> bool:
        """Terminal failure (deadline/attempts exhausted) — counted
        loudly: a failed ACCEPTED request is exactly the loss the
        failover drill asserts to be zero."""
        with self._lock:
            rec = self._records.get(rid)
            if rec is None or rec.terminal():
                return False
            rec.state = FAILED
            rec.error = str(error)[:500]
            self._unqueue_locked(rid)
            self._compact_locked()
            self._flush_locked()
            rec._event.set()
        obs.inc("fleet_failed_total",
                help="accepted requests that exhausted their retry/"
                     "deadline budget (accepted-request LOSS)")
        reqtrace.finish(rec.trace_id, outcome="failed", rid=rid,
                        error=rec.error)
        return True

    # -- views --------------------------------------------------------------

    @property
    def pending_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_pending_age_s(self, now: Optional[float] = None) -> float:
        """Age (seconds) of the OLDEST record still awaiting dispatch —
        the ``fleet_queue_age_seconds`` gauge and the autoscaling
        supervisor's primary scale-up signal: depth alone can look
        small while one starved request ages past its deadline.
        Redriven records re-enter at the FRONT of the FIFO, so their
        original acceptance time keeps counting (a redrive must not
        reset the starvation clock).  0.0 when nothing is pending."""
        with self._lock:
            if not self._pending:
                return 0.0
            oldest = min(self._records[rid].accepted_epoch_s
                         for rid in self._pending)
        return max(0.0, (time.time() if now is None else now) - oldest)

    def get(self, rid: str) -> Optional[PlaneRecord]:
        with self._lock:
            return self._records.get(rid)

    def records(self) -> List[PlaneRecord]:
        with self._lock:
            return list(self._records.values())

    def assigned_to(self, replica: str) -> List[str]:
        """Rids whose current dispatch targets ``replica`` — the set a
        death hedge re-dispatches."""
        with self._lock:
            return [r.rid for r in self._records.values()
                    if r.state == DISPATCHED and r.replica == replica]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {s: 0 for s in (ACCEPTED, DISPATCHED, COMPLETED,
                                  FAILED)}
            for r in self._records.values():
                out[r.state] = out.get(r.state, 0) + 1
            out["pending"] = len(self._pending)
            out["shed"] = self.shed_total
            return out

    def all_terminal(self) -> bool:
        with self._lock:
            return all(r.terminal() for r in self._records.values())
