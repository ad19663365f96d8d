"""Cross-host metric aggregation via per-process shard files.
(A copy of ``torchpruner_tpu/obs/aggregate.py``; the process count
comes from ``torch.distributed``.)

The obs session gates FILE exporters on ``process_index == 0``, which
used to mean every non-zero process's counters/gauges simply vanished —
a pod run reported 1/N of its examples and none of the other hosts' HBM
pressure.  The fix is filesystem-mediated (no collective, no network
dependency at teardown, kill-safe): every process with an ``obs_dir``
writes its registry as ``metrics.shard<i>.json`` at close, and process 0
merges whatever shards are present before exporting ``metrics.prom`` /
``report.json``.

Merge semantics (per metric name):

- **counters** — summed (work is partitioned, totals add).
- **gauges** — merged value is the MAX across shards (worst-case
  semantics: HBM high-water, grad norm); when shards disagree a
  companion ``<name>_min`` gauge carries the MIN, so the spread is
  visible without a per-host series explosion.
- **histograms** — bucket-wise count sum + sum/count/min/max combine
  (all sessions share the same bucket boundaries; a shard with foreign
  buckets is kept un-merged under its own name suffix rather than
  silently mis-binned).

Shard files are atomic (tmp + replace) and carry the writing process's
index, so a straggler re-writing its shard after the merge only affects
the NEXT export, never tears the current one.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional

from torchpruner_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

SHARD_PATTERN = "metrics.shard*.json"


def shard_path(obs_dir: str, process_index: int) -> str:
    return os.path.join(obs_dir, f"metrics.shard{process_index}.json")


def registry_to_shard(registry: MetricsRegistry,
                      process_index: int) -> Dict[str, Any]:
    counters: Dict[str, Any] = {}
    gauges: Dict[str, Any] = {}
    hists: Dict[str, Any] = {}
    for m in registry:
        if isinstance(m, Counter):
            counters[m.name] = {"value": m.value, "help": m.help}
        elif isinstance(m, Gauge):
            if m.value is not None:
                gauges[m.name] = {"value": m.value, "help": m.help}
        elif isinstance(m, Histogram):
            hists[m.name] = {
                "help": m.help,
                "buckets": list(m.buckets),
                "counts": list(m.counts),
                "sum": m.sum,
                "count": m.count,
                "min": (None if m.count == 0 else m.min),
                "max": (None if m.count == 0 else m.max),
            }
    return {
        "process_index": int(process_index),
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
    }


def write_shard(registry: MetricsRegistry, obs_dir: str,
                process_index: int) -> str:
    """Atomic durable per-process shard write (the shared tmp + fsync +
    replace helper); returns the path."""
    from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

    path = shard_path(obs_dir, process_index)
    atomic_write_json(path, registry_to_shard(registry, process_index),
                      indent=None)
    return path


#: how long the emitter waits at close for peer processes' shards
#: (seconds; every process closes at the same program point, so the
#: peers' writes are normally milliseconds behind — the cap only
#: matters when a peer died)
SHARD_WAIT_ENV = "TORCHPRUNER_OBS_SHARD_WAIT_S"


def process_count() -> int:
    """The number of processes of the run: ``torch.distributed``'s world
    size when it is initialized, else 1."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def wait_for_peer_shards(obs_dir: str, process_index: int,
                         timeout_s: Optional[float] = None) -> bool:
    """Bounded wait for every OTHER process's shard file before the
    emitter merges — without it a multi-host close would usually merge
    before the workers' writes land and export host 0's metrics only
    (the exact symptom the shards exist to fix).  Returns True when all
    peers' shards are present; merging proceeds either way (a crashed
    peer must not block the export forever)."""
    import time

    n = process_count()
    if n <= 1:
        return True
    if timeout_s is None:
        try:
            timeout_s = float(os.environ.get(SHARD_WAIT_ENV, "15") or 15)
        except ValueError:
            timeout_s = 15.0
    peers = [shard_path(obs_dir, i) for i in range(n)
             if i != process_index]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(os.path.exists(p) for p in peers):
            return True
        time.sleep(0.05)
    return all(os.path.exists(p) for p in peers)


def clear_stale_shards(obs_dir: str) -> None:
    """Delete shard files left by a PREVIOUS session of this obs dir —
    called by the emitter at session INIT (shards are only written at
    close, so anything present when a new session opens is stale; a
    dead run's shard from a larger process count would otherwise be
    merged into the new run's export, double-counting)."""
    for path in glob.glob(os.path.join(obs_dir, SHARD_PATTERN)):
        try:
            os.unlink(path)
        except OSError:
            pass


def load_shards(obs_dir: str) -> List[Dict[str, Any]]:
    """Every parseable shard in ``obs_dir``, ordered by process index.
    Unreadable/torn shards are skipped (merging must never fail the
    export)."""
    shards = []
    for path in sorted(glob.glob(os.path.join(obs_dir, SHARD_PATTERN))):
        if not re.search(r"metrics\.shard\d+\.json$", path):
            continue
        try:
            with open(path) as f:
                shard = json.load(f)
        except Exception:
            continue
        if isinstance(shard, dict):
            shards.append(shard)
    shards.sort(key=lambda s: s.get("process_index", 0))
    return shards


def merge_shards(shards: List[Dict[str, Any]]) -> MetricsRegistry:
    """The merged registry (see module docstring for per-type rules)."""
    reg = MetricsRegistry()
    gauge_seen: Dict[str, List[float]] = {}
    for shard in shards:
        for name, c in shard.get("counters", {}).items():
            reg.counter(name, c.get("help", "")).inc(float(c.get("value", 0)))
        for name, g in shard.get("gauges", {}).items():
            v = g.get("value")
            if v is None:
                continue
            gauge_seen.setdefault(name, []).append(float(v))
            cur = reg.gauge(name, g.get("help", ""))
            if cur.value is None or _max_nan_safe(float(v), cur.value):
                cur.set(v)
        for name, h in shard.get("histograms", {}).items():
            buckets = tuple(h.get("buckets", ()))
            cur = reg.get(name)
            if isinstance(cur, Histogram) and cur.buckets != buckets:
                # foreign bucket layout: keep it separate, never mis-bin
                name = f"{name}_p{shard.get('process_index', 0)}"
                cur = None
            hist = reg.histogram(name, h.get("help", ""), buckets=buckets)
            counts = h.get("counts", [])
            if len(counts) == len(hist.counts):
                hist.counts = [a + int(b)
                               for a, b in zip(hist.counts, counts)]
            hist.sum += float(h.get("sum", 0.0))
            hist.count += int(h.get("count", 0))
            if h.get("min") is not None:
                hist.min = min(hist.min, float(h["min"]))
            if h.get("max") is not None:
                hist.max = max(hist.max, float(h["max"]))
    # gauge spread: a companion _min where shards actually disagree
    for name, vals in gauge_seen.items():
        if len(vals) > 1 and min(vals) != max(vals):
            reg.gauge(name + "_min",
                      "min across process shards (max is the primary "
                      "series)").set(min(vals))
    return reg


def _max_nan_safe(new: float, cur: float) -> bool:
    """True when ``new`` should replace ``cur`` under max-merge (a NaN
    never beats a real value; a real value always beats NaN)."""
    import math

    if math.isnan(new):
        return False
    if math.isnan(cur):
        return True
    return new > cur


def merged_registry(obs_dir: str,
                    local: Optional[MetricsRegistry] = None,
                    process_index: int = 0) -> MetricsRegistry:
    """The export-time entry point: merge every shard in ``obs_dir``;
    when no shard for ``process_index`` is on disk yet, ``local`` stands
    in for it (the common single-host case where close() merges before
    any other process existed)."""
    shards = load_shards(obs_dir)
    if local is not None and not any(
            s.get("process_index") == process_index for s in shards):
        shards.append(registry_to_shard(local, process_index))
        shards.sort(key=lambda s: s.get("process_index", 0))
    return merge_shards(shards)
