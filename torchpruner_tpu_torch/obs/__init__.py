"""Unified runtime telemetry: span tracing, step metrics, compile
accounting, exporters — counterpart of ``torchpruner_tpu/obs/__init__.py``
(``ObsSession`` and every module function of its ``__all__``).

One :class:`ObsSession` per process, installed with :func:`configure` and
torn down with :func:`shutdown`.  Instrumented code talks to the module
functions — :func:`span`, :func:`record_step`, :func:`current_span_id` —
which are no-ops (one global load + ``None`` check) when no session is
active, so libraries can instrument unconditionally and pay nothing
unless a driver turned telemetry on.

Typical driver::

    from torchpruner_tpu_torch import obs

    obs.configure(obs_dir="logs/obs")        # or obs_dir=None: summary only
    with obs.span("run", experiment=cfg.name):
        ...                                   # phases open nested spans
    print(obs.shutdown(), file=sys.stderr)    # summary table; writes
                                              # events.jsonl + metrics.prom

Multi-host: only ``process_index == 0`` emits the event stream, the
ledger, and the merged exports — but every process with an ``obs_dir``
writes its OWN metric shard (``metrics.shard<i>.json``) at close, and
process 0 merges the shards (sum counters, max/min gauges, merge
histograms — ``obs.aggregate``) before exporting ``metrics.prom`` and
``report.json``, so non-zero processes' counters no longer vanish.
The index is read lazily from ``torch.distributed.get_rank()`` (0 when
no process group is initialized) on first emission and can be
overridden for tests via ``configure(process_index=...)``.

On top of the runtime telemetry, the session keeps a **run ledger**
(``obs.ledger.ProvenanceRecorder`` → ``ledger.jsonl``): per-round prune
decisions with score distributions and eval/params/FLOPs trajectories,
written by ``core.pruner`` / ``prune_retrain`` / the robustness sweep
through the ``record_*`` module functions below.  At close the session
bundles ledger + derived metrics + phase summary into ``report.json``
and exports the span stream as a Perfetto/Chrome ``trace.json`` —
consumed by ``python -m torchpruner_tpu_torch obs report/diff`` (obs.report).

Design refs: JaxPruner's cheap per-step instrumentation argument
(arXiv:2304.14082) and the TPU structured-pruning study's MFU/step-time
reporting (arXiv:2107.04191) — see PAPERS.md.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

from torchpruner_tpu_torch.obs.compile_watch import CompileWatcher
from torchpruner_tpu_torch.obs.exporters import (
    JsonlWriter,
    prometheus_text,
    summary_table,
    write_prometheus,
)
from torchpruner_tpu_torch.obs.metrics import (
    MetricsRegistry,
    StepTelemetry,
    record_device_memory,
    train_flops_per_step,
)
from torchpruner_tpu_torch.obs.ledger import ProvenanceRecorder, score_distribution
from torchpruner_tpu_torch.obs.spans import SpanRecord, SpanTracer

__all__ = [
    "ObsSession", "configure", "get", "shutdown", "span",
    "current_span_id", "record_step", "record_grad_norm",
    "configure_step_flops", "record_capture", "capture_counts",
    "inc", "observe", "gauge_set", "counter_value", "emit_event",
    "request_profile_window", "profile_tick", "profile_step",
    "timeseries_tick",
    "record_scores", "record_prune", "record_round", "record_epoch",
    "record_sweep_layer", "record_serve", "record_reqtrace",
    "ledger_backfill", "active_incident_id",
    "annotate_run", "set_trial", "record_trial", "record_frontier",
    "MetricsRegistry", "StepTelemetry",
    "SpanTracer", "SpanRecord", "train_flops_per_step",
    "ProvenanceRecorder", "score_distribution",
    "prometheus_text", "summary_table",
]

EVENTS_FILENAME = "events.jsonl"
PROM_FILENAME = "metrics.prom"
PROFILE_DIRNAME = "profile"
PROFILE_FILENAME = "profile.json"

#: env override for event-stream rotation (bytes; 0 = off).  Kept as an
#: env rather than a config field so long-running drivers can cap the
#: stream without a code change.
ROTATE_ENV = "TORCHPRUNER_OBS_ROTATE_BYTES"

#: env defaults for the continuous profiler (capture a window every N
#: recorded steps / steps per window) — the knobs also exposed as
#: ``configure(profile_every=..., profile_steps=...)`` and the CLI's
#: ``--profile-every`` / ``--profile-steps``.
PROFILE_EVERY_ENV = "TORCHPRUNER_PROFILE_EVERY"
PROFILE_STEPS_ENV = "TORCHPRUNER_PROFILE_STEPS"

#: env defaults for the windowed time-series recorder (obs.timeseries):
#: window cadence in seconds (0 disables) and rotation cap in bytes —
#: also exposed as ``configure(ts_interval_s=...)``.
TS_INTERVAL_ENV = "TORCHPRUNER_TS_INTERVAL_S"

_session: Optional["ObsSession"] = None


def _process_rank() -> int:
    """This process's index in the run: ``torch.distributed``'s rank when
    it is initialized, else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def _current_cuda_device():
    """The current CUDA device (``torch.device``), or None without an
    initialized CUDA context — the device whose data-sheet peaks feed
    MFU and the roofline positions."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
    except Exception:
        pass
    return None


def _env_int(name: str, default: int = 0) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float = 0.0) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ObsSession:
    """The wiring: tracer + registry + step telemetry + compile watcher
    + (optional) file exporters rooted at ``obs_dir``."""

    def __init__(self, obs_dir: Optional[str] = None,
                 process_index: Optional[int] = None,
                 annotate: bool = True, watch_compiles: bool = True,
                 rotate_bytes: Optional[int] = None,
                 profile_every: Optional[int] = None,
                 profile_steps: Optional[int] = None,
                 ts_interval_s: Optional[float] = None):
        self.obs_dir = obs_dir
        self._process_index = process_index
        self._closed = False
        self.t_start = time.perf_counter()
        self.metrics = MetricsRegistry()
        self.run_meta: Dict[str, Any] = {}
        self.events: Optional[JsonlWriter] = None
        self.ledger: Optional[ProvenanceRecorder] = None
        self.timeseries = None
        self.anomaly = None
        self.incidents = None
        self.profiler = None
        self.hbm = None
        self.profile: Optional[Dict[str, Any]] = None
        self.param_bytes: Optional[float] = None
        if rotate_bytes is None:
            rotate_bytes = _env_int(ROTATE_ENV, 0)
        if profile_every is None:
            profile_every = _env_int(PROFILE_EVERY_ENV, 0)
        if profile_steps is None:
            profile_steps = _env_int(PROFILE_STEPS_ENV, 0) or 3
        if obs_dir and self.is_emitter:
            # a NEW session invalidates any previous session's metric
            # shards (they are written at close; anything on disk now is
            # a dead run's — merging it would double-count)
            from torchpruner_tpu_torch.obs.aggregate import clear_stale_shards

            try:
                clear_stale_shards(obs_dir)
            except Exception:
                pass
            self.events = JsonlWriter(os.path.join(obs_dir, EVENTS_FILENAME),
                                      rotate_bytes=rotate_bytes)
            self.ledger = ProvenanceRecorder(obs_dir)
            # windowed time-series: delta snapshots of this registry on
            # an interval cadence (obs.timeseries; 0 disables)
            if ts_interval_s is None:
                ts_interval_s = _env_float(TS_INTERVAL_ENV, 1.0)
            if ts_interval_s and ts_interval_s > 0:
                from torchpruner_tpu_torch.obs.timeseries import (
                    DEFAULT_ROTATE_BYTES,
                    TS_ROTATE_ENV,
                    TimeseriesRecorder,
                )

                try:
                    self.timeseries = TimeseriesRecorder(
                        self.metrics, obs_dir, interval_s=ts_interval_s,
                        rotate_bytes=_env_int(TS_ROTATE_ENV,
                                              DEFAULT_ROTATE_BYTES))
                except Exception:
                    self.timeseries = None
            # anomaly detection + incident correlation (obs.anomaly /
            # obs.incident): the detector rides the recorder's
            # per-window hook; any burn alert (record_serve) or anomaly
            # open routes to the correlator, which assembles a ledgered
            # incident from this session's evidence
            try:
                from torchpruner_tpu_torch.obs.anomaly import AnomalyDetector
                from torchpruner_tpu_torch.obs.incident import (
                    IncidentCorrelator,
                )

                self.incidents = IncidentCorrelator(
                    ledger=self.ledger, registry=self.metrics)
                if self.timeseries is not None:
                    self.anomaly = AnomalyDetector(
                        on_open=self._on_anomaly_open,
                        on_close=self._on_anomaly_close)
                    self.incidents.detector = self.anomaly
                    self.timeseries.on_window = \
                        self.anomaly.observe_window
            except Exception:
                self.anomaly = None
                self.incidents = None
        self.tracer = SpanTracer(sink=self.events, annotate=annotate)
        if obs_dir and self.is_emitter:
            # continuous profiling: the profiler exists whenever the
            # session has a dir (on-demand windows via
            # request_profile_window / the serve endpoint need it even
            # at cadence 0); the HBM sampler rides the span stream
            from torchpruner_tpu_torch.obs.profile import (
                ContinuousProfiler,
                HbmSampler,
            )

            self.profiler = ContinuousProfiler(
                os.path.join(obs_dir, PROFILE_DIRNAME),
                every_steps=profile_every, window_steps=profile_steps,
                emit=self.events, tracer=self.tracer,
                registry=self.metrics)
            # samples stay in memory (-> profile.json's hbm timeline);
            # the span stream keeps its span_begin/span_end-only schema
            self.hbm = HbmSampler(emit=None)
            self.tracer.extra_sink = self.hbm.on_event
        self.step = StepTelemetry(self.metrics)
        self.compiles = CompileWatcher(self.metrics, self.tracer)
        if watch_compiles:
            self.compiles.start()
        if self.events is not None:
            self.events({
                "event": "obs_init", "ts": time.time(), "pid": os.getpid(),
                "process_index": self.process_index,
            })

    def _on_anomaly_open(self, rec: Dict[str, Any]) -> None:
        """Detector callback (invoked outside its lock): ledger the
        anomaly and let it trigger an incident."""
        if self.ledger is not None:
            try:
                self.ledger.record(dict(rec))
            except Exception:
                pass
        if self.incidents is not None:
            try:
                self.incidents.trigger(
                    kind="anomaly", ts=rec.get("opened_ts"),
                    metric=rec.get("metric"),
                    anomaly_id=rec.get("anomaly_id"), z=rec.get("z"))
            except Exception:
                pass

    def _on_anomaly_close(self, rec: Dict[str, Any]) -> None:
        if self.ledger is not None:
            try:
                self.ledger.record(dict(rec))
            except Exception:
                pass

    def clear_stale_profile(self) -> None:
        """Invalidate a previous run's capture windows in a reused obs
        dir (the same new-session semantics the metric shards get) —
        called by :func:`configure` AFTER the old session closed, never
        from the constructor: windows live on disk DURING a run, so a
        wipe-before-close would destroy the outgoing session's evidence
        right before its ``_finalize_profile`` parses it."""
        if self.profiler is None or self.profiler.windows \
                or self.profiler.active:
            return
        import shutil

        try:
            shutil.rmtree(os.path.join(self.obs_dir, PROFILE_DIRNAME),
                          ignore_errors=True)
            path = os.path.join(self.obs_dir, PROFILE_FILENAME)
            if os.path.exists(path):
                os.remove(path)
        except OSError:
            pass

    # -- multi-host gate ---------------------------------------------------

    @property
    def process_index(self) -> int:
        if self._process_index is None:
            self._process_index = _process_rank()
        return self._process_index

    @property
    def is_emitter(self) -> bool:
        """True on the one process allowed to write files."""
        return self.process_index == 0

    # -- summaries / teardown ---------------------------------------------

    def derived(self) -> Dict[str, Optional[float]]:
        return self.step.derive()

    def summary(self) -> str:
        return summary_table(
            self.tracer.phase_summary(), self.derived(),
            self.compiles.counts(),
            total_wall_s=time.perf_counter() - self.t_start,
        )

    def close(self) -> str:
        """Stop listeners, flush files, return the terminal summary.
        Idempotent: a second close reports again but never re-touches the
        (already closed) event file."""
        self.compiles.stop()
        already_closed, self._closed = self._closed, True
        if not already_closed:
            if self is _session:
                # pending slowest-K request-trace exemplars flush into
                # the event stream before it closes (obs.reqtrace)
                try:
                    from torchpruner_tpu_torch.obs import reqtrace

                    reqtrace.session_flush()
                except Exception:
                    pass
            self._finalize_profile()      # kernel gauges BEFORE export
            if self.incidents is not None:
                # incident/anomaly count gauges BEFORE the final window
                # and shard ship — they must ride the merge into
                # report.json, `obs diff`, and the CI gates (set even
                # when 0, so the clean-run false-positive gate compares
                # a real number, not an absent metric)
                try:
                    self.incidents.finalize(self.metrics)
                except Exception:
                    pass
            if self.timeseries is not None:
                # final forced window + ts_* gauges, BEFORE the shard
                # ships (the gauges must ride the merge into report.json
                # and `obs diff`)
                try:
                    self.timeseries.close()
                except Exception:
                    pass
        derived = self.derived()          # writes derived gauges
        record_device_memory(self.metrics)
        text = summary_table(
            self.tracer.phase_summary(), derived, self.compiles.counts(),
            total_wall_s=time.perf_counter() - self.t_start,
        )
        if self.events is not None and not already_closed:
            self.events({
                "event": "run_summary", "ts": time.time(),
                "wall_s": round(time.perf_counter() - self.t_start, 6),
                "phases": self.tracer.phase_summary(),
                "derived": derived,
                "compiles": self.compiles.counts(),
                "metrics": self.metrics.snapshot(),
            })
            self.events.close()
        if self.obs_dir:
            # EVERY process ships its metric shard; process 0 then merges
            # whatever shards are present into the exported registry —
            # the cross-host aggregation path (obs.aggregate)
            from torchpruner_tpu_torch.obs import aggregate

            try:
                aggregate.write_shard(self.metrics, self.obs_dir,
                                      self.process_index)
            except Exception:
                pass
        if self.obs_dir and self.is_emitter:
            try:
                # every process reaches shutdown at the same program
                # point, but their shard writes race the merge — give
                # the peers a bounded window to land theirs (no-op
                # single-host; tunable for slow shared filesystems)
                aggregate.wait_for_peer_shards(
                    self.obs_dir, self.process_index)
            except Exception:
                pass
            try:
                merged = aggregate.merged_registry(
                    self.obs_dir, local=self.metrics,
                    process_index=self.process_index)
            except Exception:
                merged = self.metrics
            try:
                write_prometheus(
                    merged, os.path.join(self.obs_dir, PROM_FILENAME))
            except Exception:
                pass
            if not already_closed:
                self._export_artifacts(merged, derived)
        if self.ledger is not None and not already_closed:
            self.ledger.close()
        return text

    def _finalize_profile(self) -> None:
        """Close any open capture window, parse the windows into the
        ranked kernel table, install the ``kernel_*`` gate gauges, and
        write ``profile.json`` — all best-effort, all BEFORE the metric
        shard ships (the gauges must ride the merge into report.json)."""
        if self.profiler is None:
            return
        try:
            from torchpruner_tpu_torch.obs.profile import (
                build_profile,
                kernel_gauges,
            )

            windows = self.profiler.close()
            if not windows and self.hbm is not None \
                    and not self.hbm.timeline:
                return
            from torchpruner_tpu_torch.utils import flops as _flops

            dev = _current_cuda_device()
            peak_flops = self.step.peak_flops \
                or (_flops.peak_bf16_flops(dev) if dev is not None
                    else None)
            peak_bw = (_flops.peak_hbm_bw(dev) if dev is not None
                       else None)
            self.profile = build_profile(
                windows,
                flops_per_step=self.step.flops_per_step,
                param_bytes=self.param_bytes,
                peak_flops=peak_flops, peak_bw=peak_bw,
                hbm=(self.hbm.summary() if self.hbm is not None
                     else None),
                telemetry_step_s=self.step.derive().get(
                    "step_time_p50_s"))
            kernel_gauges(self.profile, self.metrics)
            from torchpruner_tpu_torch.obs.ledger import sanitize
            from torchpruner_tpu_torch.resilience.manifest import (
                atomic_write_json,
            )

            atomic_write_json(
                os.path.join(self.obs_dir, PROFILE_FILENAME),
                sanitize(self.profile), indent=1)
        except Exception:
            self.profile = self.profile or None

    def _export_artifacts(self, merged, derived) -> None:
        """trace.json (Perfetto) + report.json (ledger bundle) — each
        best-effort; a failing exporter must never fail the run."""
        from torchpruner_tpu_torch.obs import ledger as ledger_mod
        from torchpruner_tpu_torch.obs import trace_export

        try:
            trace_export.write_trace(
                os.path.join(self.obs_dir, EVENTS_FILENAME),
                profile_dir=os.path.join(self.obs_dir, PROFILE_DIRNAME))
        except Exception:
            pass
        try:
            report = ledger_mod.build_report(
                run_meta=self.run_meta,
                records=(self.ledger.records() if self.ledger else []),
                derived=derived,
                phases=self.tracer.phase_summary(),
                compiles=self.compiles.counts(),
                metrics=merged.snapshot(),
                wall_s=round(time.perf_counter() - self.t_start, 6),
                profile=self.profile,
            )
            ledger_mod.write_report(
                report,
                os.path.join(self.obs_dir, ledger_mod.REPORT_FILENAME))
        except Exception:
            pass


# -- module-level convenience (the instrumentation surface) -----------------


def configure(obs_dir: Optional[str] = None, *,
              process_index: Optional[int] = None, annotate: bool = True,
              watch_compiles: bool = True,
              rotate_bytes: Optional[int] = None,
              profile_every: Optional[int] = None,
              profile_steps: Optional[int] = None,
              ts_interval_s: Optional[float] = None) -> ObsSession:
    """Install the process-wide session (replacing any previous one).
    The new session is constructed BEFORE the old one is torn down, so a
    failing constructor (e.g. unwritable ``obs_dir``) leaves the previous
    session installed and intact.  ``rotate_bytes`` caps the event
    stream (size-based rotation to ``events.jsonl.1`` …; default off,
    env ``TORCHPRUNER_OBS_ROTATE_BYTES``).  ``profile_every`` opens a
    ``profile_steps``-step ``torch.profiler`` capture window every N
    recorded steps (0/None = on-demand only; envs
    ``TORCHPRUNER_PROFILE_EVERY`` / ``TORCHPRUNER_PROFILE_STEPS``) —
    see ``obs.profile``.  ``ts_interval_s`` sets the windowed
    time-series cadence (obs.timeseries; default 1 s, env
    ``TORCHPRUNER_TS_INTERVAL_S``, 0 disables)."""
    global _session
    new = ObsSession(obs_dir, process_index=process_index,
                     annotate=annotate, watch_compiles=watch_compiles,
                     rotate_bytes=rotate_bytes,
                     profile_every=profile_every,
                     profile_steps=profile_steps,
                     ts_interval_s=ts_interval_s)
    if _session is not None:
        _session.close()
    # only after the old session exported its own windows/profile.json
    new.clear_stale_profile()
    _session = new
    return new


def get() -> Optional[ObsSession]:
    return _session


def shutdown(print_to=None) -> str:
    """Tear down the active session; returns (and optionally prints) the
    end-of-run summary table.  No-op empty string without a session."""
    global _session
    if _session is None:
        return ""
    text = _session.close()
    _session = None
    if print_to is not None:
        print(text, file=print_to, flush=True)
    return text


def span(name: str, **meta):
    """Open a named phase span (no-op context manager when telemetry is
    off).  Usable as ``with obs.span("retrain", target=t):``."""
    s = _session
    if s is None:
        return contextlib.nullcontext()
    return s.tracer.span(name, **meta)


def current_span_id() -> Optional[str]:
    s = _session
    return s.tracer.current_id() if s is not None else None


def record_step(dt_s: float, examples: int, tokens: Optional[int] = None,
                steps: int = 1):
    """Per-train-step hot path — microseconds; see StepTelemetry."""
    s = _session
    if s is not None:
        s.step.on_step(dt_s, examples, tokens, steps)
        if s.profiler is not None:
            # capture-window state machine: one increment + compare when
            # no window is open or armed (obs.profile.capture)
            s.profiler.on_step(dt_s)
        if s.timeseries is not None:
            # one clock read + compare off-cadence (obs.timeseries)
            s.timeseries.maybe_tick()


def request_profile_window() -> bool:
    """Arm one on-demand profiler capture window (the serve frontend's
    ``POST /profile``, manual driver hooks); it opens at the next step
    boundary.  False without a session/profiler or when a window is
    already open/armed."""
    s = _session
    if s is None or s.profiler is None:
        return False
    return s.profiler.request_window()


def profile_tick() -> None:
    """A non-step loop boundary for the profiler (an idle serving
    engine's loop) — lets on-demand windows open and stale windows
    close when no training steps are flowing.  No-op otherwise."""
    s = _session
    if s is not None and s.profiler is not None:
        s.profiler.tick()


def profile_step(dt_s: float = 0.0) -> None:
    """Drive the profiler's capture cadence from a non-training step
    (a serving engine's decode step) WITHOUT recording it into the
    train step telemetry.  No-op without a session/profiler."""
    s = _session
    if s is not None and s.profiler is not None:
        s.profiler.on_step(dt_s)


def timeseries_tick() -> None:
    """A loop-boundary hook for the windowed time-series recorder —
    the serving engine's run loop and the fleet router's tick call it
    so windows keep flowing when no ``record_step`` is (obs.timeseries;
    one clock read + compare off-cadence).  No-op without a session."""
    s = _session
    if s is not None and s.timeseries is not None:
        s.timeseries.maybe_tick()


def record_grad_norm(gnorm) -> None:
    s = _session
    if s is not None:
        s.step.on_grad_norm(float(gnorm))


def record_capture(hits: int = 0, misses: int = 0,
                   prefix_flops_saved: float = 0.0) -> None:
    """Attribution capture-cache accounting (one-pass sweep engine,
    attributions.base.ActivationCache).  ``hits``/``misses`` count
    SCORING PASSES (one metric run or ablation walk) whose prefix
    forward was read from / recomputed despite the cache;
    ``prefix_flops_saved`` adds to the monotone gauge of estimated
    prefix FLOPs the cache avoided (utils.flops.prefix_flops_estimate).
    No-op without a session."""
    s = _session
    if s is None:
        return
    if hits:
        s.metrics.counter(
            "attrib_capture_hits_total",
            "scoring passes whose eval-site activation came from the "
            "one-pass capture cache").inc(hits)
    if misses:
        s.metrics.counter(
            "attrib_capture_misses_total",
            "scoring passes that recomputed the prefix forward despite "
            "an installed capture cache").inc(misses)
    if prefix_flops_saved:
        g = s.metrics.gauge(
            "prefix_flops_saved",
            "estimated prefix forward FLOPs avoided by capture reuse "
            "(monotone within a session)")
        g.set((g.value or 0.0) + prefix_flops_saved)


def capture_counts() -> Dict[str, float]:
    """Current capture-cache totals (zeros without a session) — what the
    bench sweep leg surfaces next to its wall/compile accounting."""
    s = _session
    if s is None:
        return {"capture_hits": 0, "capture_misses": 0,
                "prefix_flops_saved": 0.0}

    def val(name):
        m = s.metrics.get(name)
        return m.value if m is not None and m.value is not None else 0

    return {
        "capture_hits": int(val("attrib_capture_hits_total")),
        "capture_misses": int(val("attrib_capture_misses_total")),
        "prefix_flops_saved": float(val("prefix_flops_saved")),
    }


def inc(name: str, n: float = 1, help: str = "") -> None:
    """Bump a named counter (no-op without a session) — the generic
    instrumentation hook subsystems like ``resilience`` use for their
    ``*_total`` counters without each holding a registry reference."""
    s = _session
    if s is not None:
        s.metrics.counter(name, help).inc(n)


def observe(name: str, value: float, help: str = "") -> None:
    """Record one observation into a named histogram (no-op without a
    session) — e.g. ``checkpoint_write_seconds``."""
    s = _session
    if s is not None:
        s.metrics.histogram(name, help).observe(value)


def gauge_set(name: str, value: float, help: str = "") -> None:
    s = _session
    if s is not None:
        s.metrics.gauge(name, help).set(value)


def emit_event(event: dict) -> None:
    """Append one raw event to the session's ``events.jsonl`` stream
    (no-op without a session or a file-backed emitter) — the hook the
    request tracer (``obs.reqtrace``) and the fleet router's
    clock-offset probe use to ride the span stream's file without being
    spans."""
    s = _session
    if s is not None and s.events is not None:
        try:
            s.events(event)
        except Exception:
            pass


def counter_value(name: str) -> float:
    """Current value of a named counter/gauge (0 without a session or
    before the first bump) — lets tests and smoke scripts assert on
    recovery counters without walking the registry."""
    s = _session
    if s is None:
        return 0.0
    v = getattr(s.metrics.get(name), "value", None)
    return float(v) if v is not None else 0.0


# -- run ledger (provenance) -------------------------------------------------
# All no-ops without a session or without an obs_dir (the ledger lives on
# disk; in-memory-only sessions have no recorder).  Emitter-gated like the
# event stream: in SPMD every process reaches the same decisions, so one
# ledger per run is the truth, not a shard.


def annotate_run(**meta) -> None:
    """Attach run-level metadata (experiment name, preset, config hash)
    to the session — lands in ``report.json``'s ``run`` block."""
    s = _session
    if s is not None:
        s.run_meta.update(meta)


def record_scores(site: str, scores, *, method: str = "", run: int = 0,
                  layer: str = "") -> None:
    """Ledger a per-site attribution score distribution (compact
    percentiles, not raw scores).  Skipped for non-1-D score arrays
    (``reduction='none'`` row matrices have no single distribution)."""
    s = _session
    if s is None or s.ledger is None:
        return
    import numpy as _np

    if _np.ndim(scores) != 1:
        return
    s.ledger.record_scores(site, scores, method=method, run=run,
                           layer=layer)


def record_prune(target: str, drop, n_units: int, *,
                 simulate: bool = False) -> None:
    """Ledger the concrete prune decision (site + dropped rows)."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record_prune(target, drop, n_units, simulate=simulate)


def record_round(*, target: str, **fields) -> None:
    """Ledger one prune round's headline record (decision + score
    distribution + pre/post eval + cost).  Resume-safe: deduped on
    ``target``."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record_round(target=target, **fields)


def record_epoch(**fields) -> None:
    s = _session
    if s is not None and s.ledger is not None and "epoch" in fields:
        s.ledger.record_epoch(**fields)


def record_sweep_layer(*, layer: str, **fields) -> None:
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record_sweep_layer(layer=layer, **fields)


def record_serve(*, kind: str, **fields) -> None:
    """Ledger one serving-engine event (``kind`` = "summary" |
    "hot_swap" | ...): ties served traffic back to the checkpoint's
    prune provenance (digests, widths) next to the run's latency
    metrics.  Informational records — never deduped."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record({"event": "serve", "kind": kind, **fields})
        if kind == "slo_burn" and s.incidents is not None:
            # burn alerts open incidents wherever --obs-dir is set —
            # serve frontends ledger burns directly, the fleet's
            # _collect_burn_alerts re-records replica burns (carrying
            # the original timestamp), so both planes correlate through
            # this one hook (obs.incident)
            try:
                s.incidents.trigger(
                    kind="slo_burn",
                    ts=fields.get("burn_ts") or fields.get("ts"),
                    metric=fields.get("metric"),
                    replica=fields.get("replica"),
                    burn_fast=fields.get("burn_fast"),
                    burn_slow=fields.get("burn_slow"))
            except Exception:
                pass


def active_incident_id() -> Optional[str]:
    """The correlation id in effect right now — the incident still
    inside its lookback horizon, else the oldest open anomaly, else
    ``None``.  The supervisor stamps this onto every ``scale_decision``
    record so postmortems link decision→signal without timestamp
    guessing.  No-op ``None`` without a session/correlator."""
    s = _session
    if s is None or s.incidents is None:
        return None
    try:
        return s.incidents.active_id()
    except Exception:
        return None


def record_reqtrace(**fields) -> None:
    """Ledger one request-trace analysis record (the fleet drill's
    latency budget + slowest-K exemplar waterfalls + assembly counts)
    — rendered by ``obs report``'s latency-budget section.
    Informational — never deduped."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record({"event": "reqtrace", **fields})


def set_trial(trial_id: Optional[str],
              campaign_id: Optional[str] = None) -> None:
    """Stamp every subsequent ledger record with a campaign trial
    identity (``trial_id``/``campaign_id`` — ``None`` clears).  The
    search driver's satellite: records from concurrent trials pointed
    at one shared obs dir stay dedup-keyed and groupable PER TRIAL
    (``obs report`` renders a trial column; ``obs diff`` matches rounds
    per trial).  No-op without a session/ledger."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.set_context(trial_id=trial_id, campaign_id=campaign_id)


def record_trial(*, trial_id: str, status: str, **fields) -> None:
    """Ledger one campaign-trial status transition (``status`` =
    "excluded" | "done" | "early_stopped" | "failed") — the per-trial
    provenance trail the search driver leaves next to its frontier
    record.  Deduped per (trial, status)."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record({"event": "trial", "trial_id": trial_id,
                         "status": status, **fields})


def record_frontier(**fields) -> None:
    """Ledger one campaign frontier summary (search/frontier.py): the
    non-dominated point set with provenance digests, dominated/early-
    stopped/excluded counts, and the FLOPs-bucket best accuracies —
    rendered by ``obs report``'s frontier section.  Informational —
    never deduped."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record({"event": "frontier", **fields})


def record_plan(**fields) -> None:
    """Ledger one auto-parallelism planner run (analysis/planner.py):
    the winner/baseline labels, candidate/feasible counts, predicted
    margins, and the winner's probe drift — the provenance behind a
    config the planner chose, rendered by ``obs report``'s plan
    section.  Informational records — never deduped."""
    s = _session
    if s is not None and s.ledger is not None:
        s.ledger.record({"event": "plan", **fields})


def ledger_backfill(records, kind: str = "round") -> int:
    """Rehydrate ledger records from a RunManifest history on resume
    (``kind`` = "round" | "epoch") — keeps the ledger continuous when a
    resumed run points at a fresh obs dir.  Returns records written."""
    s = _session
    if s is None or s.ledger is None:
        return 0
    if kind == "epoch":
        return s.ledger.backfill_epochs(records)
    return s.ledger.backfill_rounds(records)


def runtime_snapshot() -> Dict[str, Any]:
    """The cost snapshot a round record embeds: steps/step-time/MFU so
    far, compile totals, and the HBM high-water gauge — cheap reads of
    already-accumulated state (no device sync)."""
    s = _session
    if s is None:
        return {}
    record_device_memory(s.metrics)
    d = s.step.derive()
    c = s.compiles.counts()
    hbm = [m.value for m in s.metrics
           if getattr(m, "name", "").startswith("hbm_bytes_in_use")
           and getattr(m, "value", None) is not None]
    return {
        "steps": d.get("steps"),
        "step_time_mean_s": d.get("step_time_mean_s"),
        "mfu": d.get("mfu"),
        "compile_s": c.get("compile_s"),
        "compile_count": c.get("compile_count"),
        "hbm_bytes_max": (max(hbm) if hbm else None),
    }


def configure_step_flops(flops_per_step: Optional[float] = None,
                         peak_flops: Optional[float] = None,
                         param_bytes: Optional[float] = None):
    """Give the step telemetry its MFU denominators (training FLOPs per
    step and the card's data-sheet peak).  When ``peak_flops`` is omitted,
    the current CUDA device's bf16 peak is looked up (None on the CPU or
    an unlisted card — MFU then stays unreported rather than guessed).  ``param_bytes``
    (live parameter bytes) feeds the profile subsystem's per-kernel
    weight-traffic byte estimates (obs.profile.kernels)."""
    s = _session
    if s is None:
        return
    if param_bytes is not None:
        s.param_bytes = float(param_bytes)
    if peak_flops is None:
        from torchpruner_tpu_torch.utils.flops import peak_bf16_flops

        dev = _current_cuda_device()
        peak_flops = peak_bf16_flops(dev) if dev is not None else None
    s.step.configure(flops_per_step=flops_per_step, peak_flops=peak_flops)
