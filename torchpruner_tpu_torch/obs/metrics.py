"""Counters / gauges / histograms and low-overhead step telemetry;
counterpart of ``torchpruner_tpu/obs/metrics.py`` (the registry, the
step telemetry and ``train_flops_per_step`` are copies; the device
memory gauges read ``torch.cuda.memory_stats``).

The registry is deliberately tiny — names are flat strings (Prometheus
conventions: ``_total`` counters, ``_seconds`` durations, base-unit
gauges), values are floats, and the per-step hot path does no I/O, no
locking beyond a plain attribute store, and no derived math.  Everything
expensive (examples/s, tokens/s, MFU) is computed once at export time
from the accumulated sums, so instrumenting a millisecond-scale compiled
step costs microseconds (asserted in tests/test_obs.py's timing guard).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: default histogram buckets for step wall time (seconds) — log-spaced
#: from 100 µs (tiny CPU smoke steps) to 100 s (cold full-size steps)
STEP_TIME_BUCKETS = tuple(
    round(10.0 ** (e / 2.0), 6) for e in range(-8, 5)
)


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, None

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "min", "max")

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = STEP_TIME_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float):
        self.observe_n(v, 1)

    def observe_n(self, v: float, n: int):
        """``n`` identical observations in one call (a ``multi_step``
        dispatch of K optimizer steps records K per-step times at once)."""
        self.sum += v * n
        self.count += n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += n
                return
        self.counts[-1] += n

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile from the bucket counts (linear
        interpolation inside the landing bucket, the standard Prometheus
        ``histogram_quantile`` estimator) — clamped to the observed
        min/max so a wide bucket cannot report a value outside what was
        actually seen.  ``None`` on an empty histogram."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        prev_bound = min(self.min, self.buckets[0] if self.buckets else
                         self.min)
        for i, b in enumerate(self.buckets):
            c = self.counts[i]
            if cum + c >= target:
                if c:
                    lo = prev_bound if i else min(self.min, b)
                    frac = (target - cum) / c
                    v = lo + frac * (b - lo)
                else:
                    v = b
                return float(min(max(v, self.min), self.max))
            cum += c
            prev_bound = b
        # +Inf tail: everything above the last finite bound
        return float(self.max)

    def percentiles(self) -> Dict[str, Optional[float]]:
        """The p50/p95/p99 trio every exporter surfaces (snapshot,
        stderr table, Prometheus gauges)."""
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Name → metric store; create-on-first-use accessors."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, help)
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name, help)
        return m

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = STEP_TIME_BUCKETS
                  ) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, help, buckets)
        return m

    def __iter__(self):
        return iter(self._metrics.values())

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, float]:
        """Flat scalar view (histograms as ``name_sum``/``name_count``
        plus ``name_p50``/``name_p95``/``name_p99`` when non-empty)."""
        out: Dict[str, float] = {}
        for m in self:
            if isinstance(m, Histogram):
                out[m.name + "_sum"] = m.sum
                out[m.name + "_count"] = m.count
                if m.count:
                    for k, v in m.percentiles().items():
                        out[f"{m.name}_{k}"] = v
            elif m.value is not None:
                out[m.name] = m.value
        return out


# -- step telemetry ---------------------------------------------------------


def train_flops_per_step(forward_flops: float) -> float:
    """Training-step FLOPs from a *forward* FLOPs count (e.g.
    ``utils.flops.model_cost`` at the training batch size): backward ≈ 2×
    forward, so fwd+bwd ≈ 3× — the standard MFU accounting (PaLM appendix
    B; the optimizer update is O(params), negligible next to the
    matmuls)."""
    return 3.0 * forward_flops


@dataclass
class StepTelemetry:
    """Accumulates per-step wall time / examples / tokens, derives
    throughput and MFU at export.

    ``flops_per_step`` is the *training* FLOPs of one optimizer step
    (use :func:`train_flops_per_step` on a forward count);
    ``peak_flops`` the accelerator's spec-sheet peak
    (``utils.flops.peak_bf16_flops``).  Either may be absent — MFU is
    then reported as ``None`` rather than guessed.

    The per-step hot path is :meth:`on_step` — a handful of float adds
    and one histogram insert, no allocation beyond the call frame.
    """

    registry: MetricsRegistry
    flops_per_step: Optional[float] = None
    peak_flops: Optional[float] = None
    _hist: Histogram = field(default=None, repr=False)
    _steps: Counter = field(default=None, repr=False)
    _examples: Counter = field(default=None, repr=False)
    _tokens: Counter = field(default=None, repr=False)
    _flops: Counter = field(default=None, repr=False)

    def __post_init__(self):
        r = self.registry
        self._hist = r.histogram(
            "step_time_seconds", "train-step wall time (return-to-return "
            "within a stepping streak, so async device time surfaced by "
            "the caller's fence rolls into the next step's interval)")
        self._steps = r.counter("steps_total", "optimizer steps")
        self._examples = r.counter("examples_total", "training examples")
        self._tokens = r.counter("tokens_total", "training tokens (LM)")
        self._flops = r.counter(
            "model_flops_total", "model FLOPs executed by recorded steps "
            "(flops_per_step at the time each step ran)")

    def configure(self, *, flops_per_step: Optional[float] = None,
                  peak_flops: Optional[float] = None):
        if flops_per_step is not None:
            self.flops_per_step = float(flops_per_step)
        if peak_flops is not None:
            self.peak_flops = float(peak_flops)

    def on_step(self, dt_s: float, examples: int,
                tokens: Optional[int] = None, steps: int = 1):
        """``steps > 1``: one dispatch covering K optimizer steps
        (``Trainer.multi_step``) — ``dt_s`` is the whole dispatch,
        recorded as K equal per-step observations."""
        self._hist.observe_n(dt_s / steps, steps)
        self._steps.inc(steps)
        self._examples.inc(examples)
        if tokens:
            self._tokens.inc(tokens)
        if self.flops_per_step:
            # accumulate per step, not at export: flops_per_step is
            # re-aimed after every prune (the model shrinks), and the
            # final value must not retroactively reprice earlier steps
            self._flops.inc(self.flops_per_step * steps)

    def on_grad_norm(self, gnorm: float):
        self.registry.gauge(
            "grad_norm", "global gradient norm (opt-in)").set(gnorm)

    # -- derived -----------------------------------------------------------

    def derive(self) -> Dict[str, Optional[float]]:
        """Throughput/MFU from the accumulated sums.  Also writes the
        derived values back into the registry as gauges so exporters see
        them without knowing this class."""
        h = self._hist
        wall = h.sum
        pcts = h.percentiles() if h.count else {}
        out: Dict[str, Optional[float]] = {
            "steps": h.count,
            "step_time_mean_s": h.mean,
            "step_time_min_s": (h.min if h.count else None),
            "step_time_max_s": (h.max if h.count else None),
            "step_time_p50_s": pcts.get("p50"),
            "step_time_p95_s": pcts.get("p95"),
            "step_time_p99_s": pcts.get("p99"),
            "examples_per_s": (self._examples.value / wall if wall else None),
            "tokens_per_s": (
                self._tokens.value / wall
                if wall and self._tokens.value else None),
            "mfu": None,
        }
        if self._flops.value and self.peak_flops and wall:
            out["mfu"] = self._flops.value / wall / self.peak_flops
        # gauges are written unconditionally so the textfile schema is
        # stable across platforms: 0 for absent throughput, NaN for an
        # MFU whose denominators are unknown (no peak spec off the card)
        r = self.registry
        r.gauge("examples_per_s", "training examples per second").set(
            out["examples_per_s"] or 0.0)
        r.gauge("tokens_per_s", "training tokens per second").set(
            out["tokens_per_s"] or 0.0)
        r.gauge("mfu", "model-FLOPs utilization (achieved/peak)").set(
            out["mfu"] if out["mfu"] is not None else float("nan"))
        return out


def record_device_memory(registry: MetricsRegistry) -> Dict[str, int]:
    """Best-effort per-device live-bytes gauges from
    ``torch.cuda.memory_stats`` (the caching allocator's
    ``allocated_bytes.all.current`` / ``.peak``), under the JAX package's
    names ``hbm_bytes_in_use_device{i}`` and ``hbm_bytes_peak_device{i}``.
    Records nothing without an initialized CUDA context (the CPU), as the
    JAX package records nothing off the TPU.  Returns the bytes read,
    keyed by gauge name."""
    out: Dict[str, int] = {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            b = stats.get("allocated_bytes.all.current")
            if b is None:
                continue
            name = f"hbm_bytes_in_use_device{d}"
            registry.gauge(name, "live device bytes").set(b)
            out[name] = int(b)
            peak = stats.get("allocated_bytes.all.peak")
            if peak is not None:
                registry.gauge(f"hbm_bytes_peak_device{d}",
                               "device bytes high-water mark").set(peak)
    except Exception:
        pass
    return out
