"""Span tracer — nested, named phases with a JSONL event stream;
counterpart of ``torchpruner_tpu/obs/spans.py``.

A :class:`Span` is one timed phase of a run (``attribution`` → ``plan`` →
``apply_plan`` → ``shard`` → ``retrain`` → ``eval``).  Spans nest: the
tracer keeps a per-thread stack, so a ``retrain`` span opened inside a
``prune_retrain`` span records its parent id, and the end-of-run summary
can attribute wall time to the innermost phase without double counting.

Each span also enters a ``torch.profiler.record_function`` of the same
name (where the JAX package enters a ``jax.profiler.TraceAnnotation``),
so the phases show up as named ``user_annotation`` regions in the
``torch.profiler`` traces of the capture windows (``obs.profile``) — the
runtime JSONL stream and the device trace share one vocabulary and can
be joined offline (``utils.trace_analysis`` ``--spans``).

Event schema (one JSON object per line, ``event`` discriminates)::

    {"event": "span_begin", "span": "s000001", "name": "retrain",
     "parent": "s000000", "depth": 1, "ts": <unix seconds>, ...meta}
    {"event": "span_end", "span": "s000001", "name": "retrain",
     "parent": "s000000", "depth": 1, "ts": ..., "dur_s": 12.3,
     "compile_count": 2, "compile_s": 1.8, "trace_count": 3, ...meta}

Compile attribution (``compile_*`` fields) is filled in by
:class:`~torchpruner_tpu_torch.obs.compile_watch.CompileWatcher` calling
:meth:`SpanTracer.attribute_compile` — each kernel build (``nvcc`` run
of ``ops/_build.py``, the port's only compile) charges the innermost
span active on the building thread.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: keep at most this many finished SpanRecords in memory (aggregates in
#: ``SpanTracer.totals`` are exact regardless — the cap only bounds the
#: per-span detail kept for programmatic access, e.g. bench leg rows)
MAX_RECORDS = 4096


@dataclass
class SpanRecord:
    """One finished (or active) span."""

    id: str
    name: str
    parent: Optional[str]
    depth: int
    t_start: float          # time.time() (wall, for the event stream)
    meta: Dict[str, Any] = field(default_factory=dict)
    t_mono: float = 0.0     # perf_counter() at start (for durations)
    tid: int = 0            # OS thread id (Perfetto track)
    dur_s: float = 0.0
    compile_count: int = 0
    compile_s: float = 0.0
    trace_count: int = 0


class _Stack(threading.local):
    def __init__(self):
        self.spans: List[SpanRecord] = []


class SpanTracer:
    """Allocates span ids, keeps the per-thread span stack, aggregates
    per-name wall time, and emits begin/end events to ``sink``.

    ``sink`` is any ``callable(dict)`` (usually a
    :class:`~torchpruner_tpu_torch.obs.exporters.JsonlWriter`); ``None`` keeps
    everything in memory only.  ``annotate=False`` skips the
    ``torch.profiler.record_function`` (tests).
    """

    def __init__(self, sink: Optional[Callable[[dict], None]] = None,
                 annotate: bool = True):
        self.sink = sink
        #: optional second consumer of the event stream (the HBM sampler
        #: hooks span edges here) — same never-raise contract as sink
        self.extra_sink: Optional[Callable[[dict], None]] = None
        self.annotate = annotate
        self._lock = threading.Lock()
        self._counter = 0
        self._stack = _Stack()
        #: finished spans, newest last (bounded by MAX_RECORDS)
        self.records: List[SpanRecord] = []
        #: exact per-name aggregates over ALL finished spans:
        #: name -> {"total_s", "calls", "compile_count", "compile_s",
        #:          "trace_count"}
        self.totals: Dict[str, Dict[str, float]] = {}

    # -- span lifecycle ----------------------------------------------------

    def _next_id(self) -> str:
        with self._lock:
            self._counter += 1
            return f"s{self._counter:06d}"

    def current(self) -> Optional[SpanRecord]:
        st = self._stack.spans
        return st[-1] if st else None

    def current_id(self) -> Optional[str]:
        rec = self.current()
        return rec.id if rec else None

    def span(self, name: str, **meta) -> "_SpanCtx":
        """``with tracer.span("retrain", target="fc1"): ...``"""
        return _SpanCtx(self, name, meta)

    def _begin(self, name: str, meta: dict) -> SpanRecord:
        parent = self.current()
        rec = SpanRecord(
            id=self._next_id(), name=name,
            parent=parent.id if parent else None,
            depth=len(self._stack.spans),
            t_start=time.time(), meta=dict(meta),
            t_mono=time.perf_counter(),
            tid=threading.get_native_id(),
        )
        self._stack.spans.append(rec)
        self._emit({
            "event": "span_begin", "span": rec.id, "name": rec.name,
            "parent": rec.parent, "depth": rec.depth, "ts": rec.t_start,
            "tid": rec.tid,
            **rec.meta,
        })
        return rec

    def _end(self, rec: SpanRecord):
        rec.dur_s = time.perf_counter() - rec.t_mono
        st = self._stack.spans
        if st and st[-1] is rec:
            st.pop()
        else:  # mis-nested exit (generator abandoned mid-span): best effort
            try:
                st.remove(rec)
            except ValueError:
                pass
        with self._lock:
            if len(self.records) < MAX_RECORDS:
                self.records.append(rec)
            agg = self.totals.setdefault(rec.name, {
                "total_s": 0.0, "calls": 0, "compile_count": 0,
                "compile_s": 0.0, "trace_count": 0,
            })
            agg["total_s"] += rec.dur_s
            agg["calls"] += 1
            agg["compile_count"] += rec.compile_count
            agg["compile_s"] += rec.compile_s
            agg["trace_count"] += rec.trace_count
        self._emit({
            "event": "span_end", "span": rec.id, "name": rec.name,
            "parent": rec.parent, "depth": rec.depth, "ts": time.time(),
            "tid": rec.tid,
            "dur_s": round(rec.dur_s, 6),
            "compile_count": rec.compile_count,
            "compile_s": round(rec.compile_s, 6),
            "trace_count": rec.trace_count,
            **rec.meta,
        })

    def _emit(self, event: dict):
        if self.sink is not None:
            try:
                self.sink(event)
            except Exception:  # an exporter failure must never kill the run
                pass
        if self.extra_sink is not None:
            try:
                self.extra_sink(event)
            except Exception:
                pass

    # -- compile attribution ----------------------------------------------

    def attribute_compile(self, kind: str, dur_s: float):
        """Charge one compile/trace event to the innermost active span on
        this thread (called by ``CompileWatcher``'s monitoring listener,
        which runs synchronously on the compiling thread)."""
        rec = self.current()
        if rec is None:
            return
        if kind == "compile":
            rec.compile_count += 1
            rec.compile_s += dur_s
        elif kind == "trace":
            rec.trace_count += 1

    # -- summaries ---------------------------------------------------------

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregates, ordered by total wall time descending."""
        with self._lock:
            items = sorted(self.totals.items(),
                           key=lambda kv: -kv[1]["total_s"])
            return {k: dict(v) for k, v in items}

    def find(self, span_id: str) -> Optional[SpanRecord]:
        with self._lock:
            for rec in self.records:
                if rec.id == span_id:
                    return rec
        return None


class _SpanCtx:
    """The context manager returned by :meth:`SpanTracer.span`."""

    __slots__ = ("tracer", "name", "meta", "rec", "_ann")

    def __init__(self, tracer: SpanTracer, name: str, meta: dict):
        self.tracer = tracer
        self.name = name
        self.meta = meta
        self.rec: Optional[SpanRecord] = None
        self._ann = None

    def __enter__(self) -> SpanRecord:
        self.rec = self.tracer._begin(self.name, self.meta)
        if self.tracer.annotate:
            try:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        return self.rec

    def __exit__(self, exc_type, exc, tb):
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        if self.rec is not None:
            self.tracer._end(self.rec)
        return False
