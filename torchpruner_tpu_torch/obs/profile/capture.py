"""Programmatic ``torch.profiler`` capture windows on a step cadence —
counterpart of ``torchpruner_tpu/obs/profile/capture.py``.

:class:`ContinuousProfiler` owns the capture state machine of one obs
session, the JAX package's: two ways a window opens —

- **cadence** — ``every_steps > 0``: every N recorded steps, the next
  step boundary starts a ``window_steps``-step capture (the
  ``obs.record_step`` hot path ticks the profiler: one int compare when
  idle, so instrumented loops pay nothing between windows);
- **on-demand** — :meth:`request_window` (the serve front end's
  ``POST /profile``): the next step boundary opens one window regardless
  of cadence.  With no step loop running (an idle serving engine),
  :meth:`tick` from any loop boundary works the same.

**Many windows in one process.**  Each window is one
``torch.profiler.profile`` session, started at its first step boundary
and stopped at its last (:func:`start_session` / :func:`stop_session`,
which :class:`OneShotCapture` shares), as the JAX package starts and
stops one ``jax.profiler`` trace a window.  CUPTI is torn down at each
stop (``TEARDOWN_CUPTI=1`` unless the caller set it): kept set up across
sessions (``TEARDOWN_CUPTI=0``), later sessions on the H100 lost their
first kernels, more the longer CUPTI had lived (ROADMAP C3).  A window starts
and ends with a ``torch.cuda.synchronize()`` (when CUDA is initialized),
so its kernels belong to its steps; outside windows the hot path gains
no synchronize.

**A window's kernels are counted against the port's wrappers.**  At a
window's start and stop the profiler reads the launch counts of the
port's kernel wrappers (``ops.launches``); the window's kernel events
of each group's bodies must equal the growth of its wrappers' counts.
The shortfall is written into the window record
(``missing_kernel_events``) and added to
``profile_missing_kernel_events_total``; a window on CUDA whose trace
holds no device event at all (kernel, memcpy, memset) is counted in
``profile_empty_windows_total``.  Neither loss is ever silent.

Each window lands in ``<dir>/window_<k>/`` with a ``window.json``
sidecar (steps covered, their summed step-seconds from the telemetry
stopwatch, wall timestamps, device events, the wrappers' launches and
the window's own start / stop / export / compress seconds) — what joins
the trace's op table back to the span stream and lets ``kernel_table``
normalize per step.  The loop thread writes the window's plain trace;
a thread of its own gzips it and then writes the sidecar, and
:meth:`ContinuousProfiler.close` waits for it (on an 8B serve on the
H100 the export was most of a window's cost to the loop: PERF.md
section 7).  A failed start disables further windows (the JAX
package's rule).

A ``torch.profiler`` session belongs to the thread that started it: a
window is stopped on the thread that opened it (the engine loop, the
training loop).  A close from another thread (a shutdown racing a loop
that already returned) cannot stop that session; it records the window
as ``torn`` with no trace and disables further windows.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

WINDOW_META = "window.json"
#: the trace file each window exports (gzip, torch's Chrome format)
TRACE_FILENAME = "trace.pt.trace.json.gz"
#: the plain trace the loop thread writes, compressed off the loop
PLAIN_TRACE_FILENAME = "trace.pt.trace.json"

#: hard cap on windows per session — continuous profiling must bound
#: its disk/parse cost even on week-long runs (oldest evidence wins;
#: raise via ContinuousProfiler(max_windows=...))
DEFAULT_MAX_WINDOWS = 16

EMPTY_WINDOWS_COUNTER = "profile_empty_windows_total"
MISSING_EVENTS_COUNTER = "profile_missing_kernel_events_total"


def _cuda_live() -> bool:
    """True when this process has an initialized CUDA context."""
    try:
        import torch

        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:
        return False


def _sync() -> None:
    if _cuda_live():
        import torch

        torch.cuda.synchronize()


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if _cuda_live():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_session():
    """A synchronize, then one started ``torch.profiler`` session (the
    CPU, and CUDA when a context is live), CUPTI to be torn down at its
    stop (``TEARDOWN_CUPTI=1`` unless the caller set it)."""
    from torch.profiler import profile

    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    _sync()
    prof = profile(activities=_activities())
    prof.start()
    return prof


def stop_session(prof) -> None:
    """A synchronize, so every kernel of the session has run, then stop
    ``prof``."""
    _sync()
    prof.stop()


def window_event_counts(prof) -> Dict[str, Any]:
    """``{"events", "device_events", "kernel_events"}`` of a
    just-stopped profiler: every event it recorded, those on a device
    (kernels, memcpys, memsets; device-side annotation ranges aside),
    and the kernel events of each group of the port's wrappers
    (``ops.launches.GROUPS``), read from its in-memory kineto result —
    no parse of the exported trace on the caller's loop."""
    from torch.autograd import DeviceType

    from torchpruner_tpu_torch.obs.profile.kernels import base_kernel_name
    from torchpruner_tpu_torch.ops.launches import BODY_GROUP

    evs = prof.profiler.kineto_results.events()
    by_name: Dict[str, int] = {}
    for e in evs:
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            by_name[e.name()] = by_name.get(e.name(), 0) + 1
    groups: Dict[str, int] = {}
    for name, n in by_name.items():
        g = BODY_GROUP.get(base_kernel_name(name))
        if g is not None:
            groups[g] = groups.get(g, 0) + n
    return {"events": len(evs), "device_events": sum(by_name.values()),
            "kernel_events": groups}


def _compress(src: str, dst: str) -> None:
    """gzip ``src`` into ``dst`` and remove ``src``; ``dst`` appears
    whole (written as ``dst.part``, then renamed), and never beside
    ``src``, so a reader counts the window's events once."""
    part = dst + ".part"
    with open(src, "rb") as fin, \
            gzip.open(part, "wb", compresslevel=6) as fout:
        shutil.copyfileobj(fin, fout, 1 << 20)
    os.remove(src)
    os.replace(part, dst)


def _write_meta(w: Dict[str, Any]) -> None:
    try:
        with open(os.path.join(w["dir"], WINDOW_META), "w") as f:
            json.dump({k: v for k, v in w.items() if k != "dir"}, f)
    except OSError:
        pass


def _launch_counts() -> Dict[str, int]:
    from torchpruner_tpu_torch.ops.launches import counts

    return counts()


class ContinuousProfiler:
    """See module docstring.  ``emit`` is an optional ``callable(dict)``
    (the session's JSONL event writer) that receives
    ``profile_window_begin`` / ``profile_window_end`` markers;
    ``registry`` (the session's metrics) receives
    ``profile_empty_windows_total`` and
    ``profile_missing_kernel_events_total``."""

    def __init__(self, profile_dir: str, *, every_steps: int = 0,
                 window_steps: int = 3,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 emit=None, tracer=None, registry=None):
        self.profile_dir = profile_dir
        self.every_steps = max(0, int(every_steps))
        self.window_steps = max(1, int(window_steps))
        self.max_windows = max(1, int(max_windows))
        self.emit = emit
        self.tracer = tracer
        self.registry = registry
        if registry is not None:
            registry.counter(
                EMPTY_WINDOWS_COUNTER,
                "capture windows on CUDA whose trace held no device event")
            registry.counter(
                MISSING_EVENTS_COUNTER,
                "kernel launches of the port's wrappers inside capture "
                "windows that their traces lack")
        #: closed windows: {"index","dir","steps","step_seconds",
        #: "t_start_unix","wall_s","on_demand","events",
        #: "device_events","launches","kernel_events",
        #: "missing_kernel_events","capture_s"}
        self.windows: List[Dict[str, Any]] = []
        self.empty_windows = 0
        self.missing_kernel_events = 0
        self._steps_seen = 0
        self._want_window = False
        self._open: Optional[Dict[str, Any]] = None
        self._failed = False  # a failed start disables profiling
        self._prof = None     # the open window's torch.profiler session
        #: threads compressing closed windows' traces (joined by close)
        self._compressing: List[threading.Thread] = []
        #: guards arming against the window state: the request stays
        #: armed until its window is open, so a second request made
        #: while the (slow) first start runs is refused
        self._arm_lock = threading.Lock()

    # -- the step hook (hot path) -------------------------------------------

    def on_step(self, dt_s: float = 0.0) -> None:
        """One recorded step.  Opens/advances/closes windows at step
        boundaries; between windows it is one increment + compare."""
        self._steps_seen += 1
        if self._open is not None:
            self._open["steps"] += 1
            self._open["step_seconds"] += float(dt_s or 0.0)
            self._open["step_times"].append(round(float(dt_s or 0.0), 9))
            if self._open["steps"] >= self._open["target_steps"]:
                self._stop_window()
            return
        if self._want_window:
            self._start_window(on_demand=True)
            return
        if self.every_steps and len(self.windows) < self.max_windows \
                and self._steps_seen % self.every_steps == 0:
            self._start_window(on_demand=False)

    def tick(self) -> None:
        """A loop boundary that is not a step (an idle serving engine):
        lets an on-demand request open — and a stale window close — even
        when no steps are flowing."""
        if self._open is not None:
            # no steps arrived; close once the wall budget is well past
            # (window_steps at 1 s/step is a generous idle bound)
            if time.perf_counter() - self._open["t_mono"] \
                    > max(1.0, self.window_steps):
                self._stop_window()
        elif self._want_window:
            self._start_window(on_demand=True)

    def request_window(self) -> bool:
        """Arm one on-demand window (CLI / serve endpoint).  Returns
        False when a window is already open/armed, the session's
        window cap is reached, or profiling is disabled by an earlier
        failure — a True MUST mean a capture will actually happen."""
        with self._arm_lock:  # HTTP handler threads arm concurrently
            if self._failed or self._open is not None \
                    or self._want_window \
                    or len(self.windows) >= self.max_windows:
                return False
            self._want_window = True
            return True

    @property
    def active(self) -> bool:
        return self._open is not None

    @property
    def failed(self) -> bool:
        """True once a window failed to start (profiling disabled)."""
        return self._failed

    # -- window lifecycle ---------------------------------------------------

    def _span(self, name, **meta):
        import contextlib

        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **meta)

    def _start_window(self, on_demand: bool) -> None:
        if self._failed or len(self.windows) >= self.max_windows:
            self._want_window = False
            return
        index = len(self.windows)
        wdir = os.path.join(self.profile_dir, f"window_{index:03d}")
        t0 = time.perf_counter()
        try:
            os.makedirs(wdir, exist_ok=True)
            with self._span("profile_capture", window=index, edge="start"):
                base = _launch_counts()
                self._prof = start_session()
        except Exception:
            # another profiler already active, or an unwritable dir:
            # disable rather than retry-fail every N steps
            self._prof = None
            with self._arm_lock:
                self._failed = True
                self._want_window = False
            return
        opened = {
            "index": index, "dir": wdir, "steps": 0, "step_seconds": 0.0,
            "step_times": [], "target_steps": self.window_steps,
            "t_start_unix": time.time(), "t_mono": time.perf_counter(),
            "on_demand": on_demand, "thread": threading.get_ident(),
            "launch_base": base,
            "capture_s": {"start": round(time.perf_counter() - t0, 6)},
        }
        with self._arm_lock:
            self._open = opened
            self._want_window = False
        self._emit_marker("profile_window_begin", opened)

    def _stop_window(self) -> None:
        w, self._open = self._open, None
        if w is None:
            return
        prof, self._prof = self._prof, None
        base = w.pop("launch_base")
        w.pop("target_steps", None)
        w.update({"events": 0, "device_events": 0, "kernel_events": {}})
        if w.pop("thread") != threading.get_ident():
            # the session is another thread's: it cannot be stopped here
            self._failed = True
            w["torn"] = True
            w["wall_s"] = round(time.perf_counter() - w.pop("t_mono"), 6)
            self.windows.append(w)
            self._emit_marker("profile_window_end", w)
            return
        now = plain = None
        try:
            t0 = time.perf_counter()
            with self._span("profile_capture", window=w["index"],
                            edge="stop"):
                stop_session(prof)
                now = _launch_counts()
                w.update(window_event_counts(prof))
            t1 = time.perf_counter()
            # the loop thread writes the plain trace; its gzip (most of
            # an export's time) runs on a thread of its own
            path = os.path.join(w["dir"], PLAIN_TRACE_FILENAME)
            with self._span("profile_capture", window=w["index"],
                            edge="export"):
                prof.export_chrome_trace(path)
            plain = path
            w["capture_s"].update(stop=round(t1 - t0, 6),
                                  export=round(time.perf_counter() - t1,
                                               6))
        except Exception:
            pass  # keep what the collector already flushed
        w["wall_s"] = round(time.perf_counter() - w.pop("t_mono"), 6)
        if now is not None:
            w["launches"] = {g: now[g] - base[g] for g in now
                             if now[g] != base[g]}
            missing = sum(max(0, n - w["kernel_events"].get(g, 0))
                          for g, n in w["launches"].items())
            w["missing_kernel_events"] = missing
            if missing:
                self.missing_kernel_events += missing
                if self.registry is not None:
                    self.registry.counter(MISSING_EVENTS_COUNTER).inc(
                        missing)
        if _cuda_live() and not w["device_events"]:
            self.empty_windows += 1
            if self.registry is not None:
                self.registry.counter(EMPTY_WINDOWS_COUNTER).inc()
        self.windows.append(w)
        if plain is not None:
            t = threading.Thread(target=self._finish, args=(w, plain),
                                 name=f"profile_window_{w['index']}")
            self._compressing.append(t)
            t.start()
        else:
            _write_meta(w)
        self._emit_marker("profile_window_end", w)

    @staticmethod
    def _finish(w: Dict[str, Any], plain: str) -> None:
        """Off the loop: compress a window's trace, then write its
        sidecar with the compression's seconds."""
        t0 = time.perf_counter()
        try:
            _compress(plain, os.path.join(w["dir"], TRACE_FILENAME))
        except Exception:
            pass  # the plain trace stays readable
        w["capture_s"]["compress"] = round(time.perf_counter() - t0, 6)
        _write_meta(w)

    def _emit_marker(self, event: str, w: Dict[str, Any]) -> None:
        if self.emit is None:
            return
        try:
            self.emit({
                "event": event, "ts": time.time(), "window": w["index"],
                "steps": w.get("steps", 0), "on_demand": w["on_demand"],
            })
        except Exception:
            pass

    def close(self) -> List[Dict[str, Any]]:
        """Stop any open window and wait for every window's trace to be
        compressed; returns the closed-window records."""
        if self._open is not None:
            self._stop_window()
        for t in self._compressing:
            t.join()
        self._compressing = []
        return self.windows


class OneShotCapture:
    """One profiler capture window around an already-measured workload,
    writing the top-N per-kernel rows (``kernels.top_rows``) into
    ``row["kernels"]``.  Runs AFTER the timed section so trace overhead
    never pollutes the timing; any failure (another profiler active,
    parse errors) degrades to no row, never an error.  ``steps`` may be
    reassigned inside the block when the step count is only known
    afterwards::

        with OneShotCapture(result, steps=K):
            fn()
    """

    def __init__(self, row: Dict[str, Any], steps: int = 1, top: int = 5,
                 flops_per_step: Optional[float] = None,
                 key: str = "kernels"):
        self.row, self.steps, self.top = row, max(1, steps), top
        self.flops_per_step = flops_per_step
        self.key = key
        self._dir: Optional[str] = None
        self._prof = None

    def __enter__(self) -> "OneShotCapture":
        import shutil
        import tempfile

        try:
            self._dir = tempfile.mkdtemp(prefix="kernel_capture_")
            self._prof = start_session()
        except Exception:
            # the tmpdir must not leak — one per capture
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
            self._prof = None
        return self

    def __exit__(self, exc_type, exc, tb):
        import shutil

        if self._dir is None:
            return False
        try:
            stop_session(self._prof)
            self._prof.export_chrome_trace(
                os.path.join(self._dir, TRACE_FILENAME))
        except Exception:
            pass
        try:
            if exc_type is None:
                from torchpruner_tpu_torch.obs.profile.kernels import (
                    top_rows,
                )

                rows = top_rows(self._dir, steps=max(1, int(self.steps)),
                                top=self.top,
                                flops_per_step=self.flops_per_step)
                if rows:
                    self.row[self.key] = rows
        except Exception:  # profiling must never fail the measurement
            pass
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)
        return False


def scan_windows(profile_dir: str) -> List[Dict[str, Any]]:
    """Rebuild window records from ``window_*/window.json`` sidecars (or
    bare window dirs, for a run killed before the sidecar landed) — the
    offline path ``obs profile`` uses when the session never closed."""
    out: List[Dict[str, Any]] = []
    for wdir in sorted(glob.glob(os.path.join(profile_dir, "window_*"))):
        if not os.path.isdir(wdir):
            continue
        rec: Dict[str, Any] = {"dir": wdir, "steps": 0,
                               "step_seconds": 0.0, "step_times": [],
                               "on_demand": False, "index": len(out)}
        meta = os.path.join(wdir, WINDOW_META)
        if os.path.exists(meta):
            try:
                with open(meta) as f:
                    rec.update(json.load(f))
            except (OSError, ValueError):
                pass
        rec["dir"] = wdir
        out.append(rec)
    return out
