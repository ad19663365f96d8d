"""Tracing and timing utilities — counterpart of
``torchpruner_tpu/utils/profiling.py``.

``torch.profiler`` traces (Chrome format, viewable in Perfetto) in place
of ``jax.profiler``'s, and steady-state wall-clock timing that respects
CUDA's asynchronous launches (a host clock around a launch measures the
enqueue, not the kernel, unless the time ends in a fence).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torchpruner_trace"):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/<unix ns>.pt.trace.json.gz`` (CPU ops, and CUDA kernels
    when CUDA is initialized)::

        with profiling.trace("logs/trace"):
            trainer.step(x, y)

    Summarize with ``python -m torchpruner_tpu_torch.utils.trace_analysis
    logs/trace``; view in ui.perfetto.dev."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{time.time_ns()}.pt.trace.json.gz"))


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return []


def hard_fence(out) -> None:
    """Block until ``out`` has actually been computed:
    ``torch.cuda.synchronize()`` on every device holding a leaf, then a
    one-element device-to-host read of the smallest leaf (a read cannot
    complete before the stream that writes it has run it).  On the CPU
    the read alone."""
    leaves = [t for t in _leaves(out) if t.numel()]
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    if leaves:
        smallest = min(leaves, key=lambda t: t.numel())
        smallest.reshape(-1)[0].item()


def time_fn(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    chained: bool = False,
    **kwargs,
) -> Dict[str, float]:
    """Steady-state wall-clock of ``fn(*args, **kwargs)``.

    Warms up (kernel builds, allocator), then measures two ways:

    - **per-call** (``p50_s``/``min_s``/``mean_s``): each call followed
      by a :func:`hard_fence`;
    - **chained** (``chained_mean_s``, only with ``chained=True``): all
      ``iters`` calls launched back to back with ONE fence at the end —
      the device runs its stream in order, so the last output fences
      them all, as a training loop without a per-step host read runs.
    """
    t0 = time.perf_counter()
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args, **kwargs)
    hard_fence(out)
    compile_s = time.perf_counter() - t0

    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        hard_fence(out)
        times.append(time.perf_counter() - t0)
    times.sort()

    stats = {
        "mean_s": sum(times) / len(times),
        "min_s": times[0],
        "p50_s": times[len(times) // 2],
        "compile_s": compile_s,
    }
    if chained:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        hard_fence(out)
        stats["chained_mean_s"] = (time.perf_counter() - t0) / iters
    return stats


def steady_s(stats: Dict[str, float]) -> float:
    """The steady-state seconds from a :func:`time_fn` result: the
    chained mean when measured, else the per-call fenced p50."""
    if stats.get("chained_mean_s"):
        return stats["chained_mean_s"]
    return stats["p50_s"]


def _params_probe(trainer, loss):
    """The returned loss and one element of the UPDATED params, so a fence
    on the result waits for the whole step (its update included)."""
    from torchpruner_tpu_torch.utils.tree import tree_leaves

    leaf = next(iter(tree_leaves(trainer.params)))
    return [loss, leaf.reshape(-1)[:1]]


def time_train_step(trainer, *args, iters: int = 10, warmup: int = 2,
                    chained: bool = False):
    """:func:`time_fn` over a ``Trainer.step`` call, fenced on the
    updated params as well as the returned loss."""

    def step_fenced(*a):
        return _params_probe(trainer, trainer.step(*a))

    return time_fn(step_fenced, *args, iters=iters, warmup=warmup,
                   chained=chained)


def time_train_multi_step(trainer, xs, ys, iters: int = 5, warmup: int = 2,
                          chained: bool = True):
    """:func:`time_fn` over ``Trainer.multi_step``, fenced on the updated
    params like :func:`time_train_step`.  Divide :func:`steady_s` by
    ``len(xs)`` for the per-step seconds."""

    def fenced(xs_, ys_):
        return _params_probe(trainer, trainer.multi_step(xs_, ys_)[-1])

    return time_fn(fenced, xs, ys, iters=iters, warmup=warmup,
                   chained=chained)


@dataclass
class StepTimer:
    """Accumulates per-phase wall-clock inside experiment loops (score /
    prune / recompile / finetune) — the breakdown the north-star metric
    needs (SURVEY.md §7 'recompilation economics').

    For new code prefer ``obs.span`` (same accounting plus JSONL events,
    trace annotations and compile attribution); :meth:`from_span_jsonl`
    rebuilds a StepTimer from an obs event stream so existing consumers
    of ``summary()`` can read either source.
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @classmethod
    def from_span_jsonl(cls, path: str) -> "StepTimer":
        """A StepTimer whose phases are the span names of an obs
        ``events.jsonl`` (every ``span_end``'s duration, keyed by name;
        latest run only — see :func:`load_span_events`)."""
        timer = cls()
        for name, v in span_phase_summary(path).items():
            timer.totals[name] = v["total_s"]
            timer.counts[name] = v["calls"]
        return timer

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "calls": self.counts[k],
                "mean_s": v / self.counts[k]}
            for k, v in self.totals.items()
        }


def load_span_events(path: str, latest_run: bool = True) -> List[dict]:
    """Parse an obs ``events.jsonl`` (one JSON object per line; malformed
    lines — e.g. the torn last line of a killed run — are skipped).

    Rotation-aware: a size-capped session renames the stream to
    ``events.jsonl.1`` … as it grows (``obs.configure(rotate_bytes=…)``),
    so the rotated backups are read first, oldest to newest, then the
    live file — one continuous stream.

    The stream is append-mode across sessions; every session opens with
    an ``obs_init`` marker.  ``latest_run`` (default) returns only the
    events after the LAST marker, so re-using an ``--obs-dir`` doesn't
    double-count earlier runs in phase summaries (same contract as
    ``trace_analysis.find_trace_files``)."""
    import glob
    import json
    import os
    import re

    rotated = []
    for p in glob.glob(path + ".*"):
        m = re.match(re.escape(path) + r"\.(\d+)$", p)
        if m:
            rotated.append((int(m.group(1)), p))
    # highest suffix = oldest; read oldest → newest → live file
    paths = [p for _, p in sorted(rotated, reverse=True)]
    if os.path.exists(path) or not paths:
        paths.append(path)

    events: List[dict] = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(ev, dict):
                    continue
                if latest_run and ev.get("event") == "obs_init":
                    events = []  # a new session starts: drop the earlier one
                events.append(ev)
    return events


def span_phase_summary(path: str) -> Dict[str, Dict[str, float]]:
    """Aggregate an obs event stream into per-phase runtime totals —
    the join key for offline trace summaries
    (``trace_analysis.summarize_trace(..., spans_jsonl=...)``)::

        {name: {"total_s", "calls", "compile_s", "compile_count",
                "trace_count"}}
    """
    out: Dict[str, Dict[str, float]] = {}
    for ev in load_span_events(path):
        if ev.get("event") != "span_end":
            continue
        agg = out.setdefault(ev.get("name", "?"), {
            "total_s": 0.0, "calls": 0, "compile_s": 0.0,
            "compile_count": 0, "trace_count": 0,
        })
        agg["total_s"] += float(ev.get("dur_s", 0.0))
        agg["calls"] += 1
        agg["compile_s"] += float(ev.get("compile_s", 0.0))
        agg["compile_count"] += int(ev.get("compile_count", 0))
        agg["trace_count"] += int(ev.get("trace_count", 0))
    return out
