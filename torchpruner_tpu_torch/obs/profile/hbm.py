"""HBM timeline: allocation watermarks per span phase — counterpart of
``torchpruner_tpu/obs/profile/hbm.py``.

:class:`HbmSampler` rides the span stream (the tracer's extra sink):
every ``span_begin``/``span_end`` edge takes one bounded-cost sample of
``torch.cuda.memory_stats`` per device — live bytes, the allocator's
peak, and a **fragmentation estimate**, the share of the caching
allocator's reserved bytes that no live tensor uses.  On the CPU there
are no device stats and the sampler falls back to host RSS, so the
timeline is never empty and the same assertions run in the CPU tests.

Why span edges and not a poller thread: phases are exactly the
boundaries where allocation regimes change (a prune shrinks params, a
quant swap shrinks weights, a prefill grows a cache), so the watermark
*per phase* is the delta a prune/quant variant is judged on — and edges
need no extra thread, no clock, and throttle naturally (a minimum
inter-sample interval guards pathological span churn like per-request
serve spans).

The timeline lands in ``profile.json`` under ``hbm`` and renders in
``obs profile`` as a per-phase watermark table.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

#: minimum seconds between samples — span churn (per-request serve
#: spans) must not turn every edge into a memory_stats() syscall storm
MIN_SAMPLE_INTERVAL_S = 0.02

MAX_SAMPLES = 4096


def _device_sample() -> Dict[str, Dict[str, float]]:
    """Per-device live/peak/fragmentation snapshot (empty without an
    initialized CUDA context), in the JAX package's record keys:
    ``bytes_in_use`` / ``peak_bytes_in_use`` are the caching allocator's
    allocated bytes (``torch.cuda.memory_stats``), ``bytes_limit`` the
    card's total memory (``torch.cuda.mem_get_info``), and
    ``fragmentation`` the share of the allocator's reserved bytes that
    no live tensor uses, ``(reserved - allocated) / reserved``."""
    out: Dict[str, Dict[str, float]] = {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            in_use = stats.get("allocated_bytes.all.current")
            if in_use is None:
                continue
            rec: Dict[str, float] = {
                "bytes_in_use": float(in_use),
                "peak_bytes_in_use": float(
                    stats.get("allocated_bytes.all.peak", in_use)),
                "bytes_limit": float(torch.cuda.mem_get_info(d)[1]),
            }
            reserved = stats.get("reserved_bytes.all.current")
            if reserved:
                rec["bytes_reserved"] = float(reserved)
                rec["fragmentation"] = max(
                    0.0, (reserved - in_use) / float(reserved))
            out[f"device{d}"] = rec
    except Exception:
        pass
    return out


def _host_rss_bytes() -> Optional[float]:
    try:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * 4096.0
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return float(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss) * 1024.0
        except Exception:
            return None


class HbmSampler:
    """Span-edge memory sampler (see module docstring)."""

    def __init__(self, emit=None, max_samples: int = MAX_SAMPLES):
        self.emit = emit
        self.max_samples = max_samples
        self.timeline: List[Dict[str, Any]] = []
        self._t_last = 0.0

    def on_event(self, ev: dict) -> None:
        """Tracer extra-sink hook: sample at span edges."""
        kind = ev.get("event")
        if kind not in ("span_begin", "span_end"):
            return
        now = time.perf_counter()
        if now - self._t_last < MIN_SAMPLE_INTERVAL_S \
                or len(self.timeline) >= self.max_samples:
            return
        self._t_last = now
        devices = _device_sample()
        sample: Dict[str, Any] = {
            "ts": ev.get("ts", time.time()),
            "phase": ev.get("name", "?"),
            "edge": "begin" if kind == "span_begin" else "end",
        }
        if devices:
            sample["devices"] = devices
            in_use = [v.get("bytes_in_use") for v in devices.values()
                      if v.get("bytes_in_use") is not None]
            if in_use:
                sample["bytes_in_use_max"] = max(in_use)
            frags = [v.get("fragmentation") for v in devices.values()
                     if v.get("fragmentation") is not None]
            if frags:
                sample["fragmentation_max"] = max(frags)
        else:
            rss = _host_rss_bytes()
            if rss is None:
                return
            sample["host_rss_bytes"] = rss
            sample["bytes_in_use_max"] = rss
        self.timeline.append(sample)
        if self.emit is not None:
            try:
                self.emit({"event": "hbm_sample", **sample})
            except Exception:
                pass

    def summary(self) -> Dict[str, Any]:
        """Per-phase watermark table + the raw (bounded) timeline."""
        phases: Dict[str, Dict[str, Any]] = {}
        for s in self.timeline:
            b = s.get("bytes_in_use_max")
            if b is None:
                continue
            agg = phases.setdefault(s["phase"], {
                "peak_bytes": b, "first_bytes": b, "last_bytes": b,
                "fragmentation": s.get("fragmentation_max"),
                "samples": 0,
            })
            agg["peak_bytes"] = max(agg["peak_bytes"], b)
            agg["last_bytes"] = b
            if s.get("fragmentation_max") is not None:
                agg["fragmentation"] = max(
                    agg["fragmentation"] or 0.0, s["fragmentation_max"])
            agg["samples"] += 1
        for agg in phases.values():
            agg["delta_bytes"] = int(agg["last_bytes"]
                                     - agg["first_bytes"])
            agg["peak_bytes"] = int(agg["peak_bytes"])
            agg.pop("first_bytes", None)
            agg.pop("last_bytes", None)
        peak = max((s.get("bytes_in_use_max", 0.0)
                    for s in self.timeline), default=None)
        return {
            "phases": phases,
            "peak_bytes": (int(peak) if peak else None),
            "source": ("device" if any("devices" in s
                                       for s in self.timeline)
                       else "host_rss"),
            "timeline": self.timeline[-512:],
        }
