"""Exporters: JSONL event stream, Prometheus textfile, terminal summary.
(A copy of ``torchpruner_tpu/obs/exporters.py``, imports renamed.)

All file emission is gated by the session's multi-host check (only
``process_index == 0`` writes — see ``obs.configure``); exporters
themselves are host-agnostic and never raise into the run.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

from torchpruner_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)


class JsonlWriter:
    """Append JSON objects to ``path``, one per line, flushed per write
    (a crashed run keeps every event up to the crash).  The handle is
    opened once and held — not reopened per event.

    ``rotate_bytes > 0`` enables size-based rotation: when the file
    exceeds the cap after a write, it is renamed to ``path.1`` (existing
    ``path.1`` → ``path.2``, … up to ``backups``; the oldest falls off)
    and a fresh ``path`` is opened — long runs stop growing
    ``events.jsonl`` without bound.  Readers
    (``utils.profiling.load_span_events``) walk the rotated set oldest-
    first, so summaries still see the whole stream.  Off by default
    (0): tests and short runs keep the single-file layout."""

    def __init__(self, path: str, rotate_bytes: int = 0, backups: int = 3):
        self.path = path
        self.rotate_bytes = int(rotate_bytes or 0)
        self.backups = max(1, int(backups))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._size = self._f.tell()

    def __call__(self, obj: dict):
        line = json.dumps(obj) + "\n"
        self._f.write(line)
        self._f.flush()
        self._size += len(line)
        if self.rotate_bytes and self._size > self.rotate_bytes:
            self._rotate()

    def _rotate(self):
        try:
            self._f.close()
            for i in range(self.backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, self.path + ".1")
        except Exception:
            pass  # rotation failure must never kill the run
        self._f = open(self.path, "a")
        self._size = self._f.tell()

    def close(self):
        try:
            self._f.close()
        except Exception:
            pass


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format
    (counters as ``_total``-suffixed names they already carry, histograms
    as cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
    lines = []
    for m in registry:
        if isinstance(m, Counter):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} counter")
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            if m.value is None:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} gauge")
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} histogram")
            cum = 0
            for b, c in zip(m.buckets, m.counts):
                cum += c
                lines.append(f'{m.name}_bucket{{le="{_fmt(b)}"}} {cum}')
            cum += m.counts[-1]
            lines.append(f'{m.name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{m.name}_sum {_fmt(m.sum)}")
            lines.append(f"{m.name}_count {m.count}")
            if m.count:
                # bucket-estimated percentiles as companion gauges (a
                # textfile collector has no query engine to run
                # histogram_quantile, so the snapshot ships them)
                for k, v in m.percentiles().items():
                    lines.append(f"# TYPE {m.name}_{k} gauge")
                    lines.append(f"{m.name}_{k} {_fmt(v)}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def write_prometheus(registry: MetricsRegistry, path: str):
    """Atomic textfile write (node-exporter textfile-collector style:
    scrapers must never see a torn file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(prometheus_text(registry))
    os.replace(tmp, path)


def summary_table(
    phase_summary: Dict[str, Dict[str, float]],
    derived: Optional[Dict[str, Optional[float]]] = None,
    compile_totals: Optional[dict] = None,
    total_wall_s: Optional[float] = None,
) -> str:
    """The end-of-run terminal summary: per-phase wall/compile table plus
    the step-telemetry line.  ``total_wall_s`` (the root span / whole run)
    anchors the ``%`` column; per-phase rows are leaf-attributed (a parent
    span's own row excludes time its children claimed only in the sense
    that children get their own rows — the ``%`` column uses each row's
    total, so nested rows can sum past 100)."""
    lines = ["", "── observability summary " + "─" * 35]
    if phase_summary:
        w = max(len(n) for n in phase_summary)
        lines.append(
            f"{'phase':<{w}}  {'calls':>5}  {'wall s':>9}  {'%':>6}  "
            f"{'compile s':>9}  {'compiles':>8}"
        )
        denom = total_wall_s or sum(
            v["total_s"] for n, v in phase_summary.items()
        ) or 1.0
        for name, v in phase_summary.items():
            lines.append(
                f"{name:<{w}}  {v['calls']:>5d}  {v['total_s']:>9.3f}  "
                f"{100 * v['total_s'] / denom:>5.1f}%  "
                f"{v['compile_s']:>9.3f}  {int(v['compile_count']):>8d}"
            )
    if compile_totals:
        lines.append(
            f"compile: {compile_totals['compile_count']} compilations "
            f"({compile_totals['compile_s']:.3f}s), "
            f"{compile_totals['trace_count']} traces "
            f"({compile_totals['trace_s']:.3f}s)"
        )
    if derived and derived.get("steps"):
        parts = [f"steps {derived['steps']}",
                 f"step {1e3 * derived['step_time_mean_s']:.2f} ms"]
        if derived.get("step_time_p50_s") is not None:
            parts.append(
                "p50/p95/p99 "
                f"{1e3 * derived['step_time_p50_s']:.2f}/"
                f"{1e3 * derived['step_time_p95_s']:.2f}/"
                f"{1e3 * derived['step_time_p99_s']:.2f} ms")
        if derived.get("examples_per_s"):
            parts.append(f"{derived['examples_per_s']:.1f} ex/s")
        if derived.get("tokens_per_s"):
            parts.append(f"{derived['tokens_per_s']:.0f} tok/s")
        if derived.get("mfu") is not None:
            parts.append(f"MFU {100 * derived['mfu']:.1f}%")
        lines.append("train: " + ", ".join(parts))
    if total_wall_s is not None:
        lines.append(f"total wall: {total_wall_s:.3f}s")
    lines.append("─" * 60)
    return "\n".join(lines)
