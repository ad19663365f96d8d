"""Per-kernel step-time attribution from profiler captures — counterpart
of ``torchpruner_tpu/obs/profile/kernels.py``.

A capture window (``obs.profile.capture.ContinuousProfiler``) is a
``torch.profiler`` trace of a few consecutive steps.  This module turns
one or more windows into the table of which kernels the step actually
spent its milliseconds in, normalized per step, ranked, and positioned
on the roofline.

Attribution pipeline:

- ``utils.trace_analysis.summarize_trace`` parses the window's
  ``*.trace.json.gz`` into per-op totals (device kernel, memcpy and
  memset events on CUDA; top-level ``cpu_op`` events on the CPU).
- Op names are normalized to a stable **base kernel name**: the port's
  kernels and the libraries' carry demangled C++ signatures, such as
  ``void (anonymous namespace)::fwd_tf32x3<8, true>(float const*, ...)``;
  the return type, the namespaces, the template arguments and the
  parameter list are dropped (``fwd_tf32x3``), so tables from different
  template instances and runs line up.  XLA's numeric suffixes
  (``dot.4`` → ``dot``) are stripped too, so a JAX run's names normalize
  the same way.
- Times divide by the steps the window covered → **ms per step**, the
  unit the per-kernel gates compare (window length cancels out).
- ``coverage`` = summed op ms ÷ the step span measured by the obs step
  telemetry over the same window; ``1 - coverage`` is the device's idle
  share of the window's steps (host gaps between kernels).
- Each ranked kernel gets a **roofline position**
  (``utils.flops.roofline_position``) from the step FLOPs and weight
  bytes attributed to compute-category kernels in proportion to their
  time, against the card's data-sheet peaks (H100 only; ``None``
  elsewhere).

The ranked table is exported two ways: ``profile.json`` (full rows, per
window and merged) and ``kernel_<base>_ms`` / ``kernel_<base>_pct``
gauges in the session metrics — which is what lets ``obs diff --gate``
fail on a kernel regression that an unchanged total step time hides.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

#: categories whose ops execute model FLOPs (the roofline's compute side)
COMPUTE_CATEGORIES = ("matmul", "convolution", "attention")

#: how many ranked kernels become ``kernel_*`` gauges (bounds the metric
#: namespace; the full table lives in profile.json)
MAX_KERNEL_GAUGES = 12


#: library wrappers whose first template argument names the kernel
_WRAPPERS = ("Kernel", "Kernel2", "device_kernel", "kernel")


def _strip_args(name: str):
    """Split a demangled name into (qualified head with template
    arguments dropped, first template argument or None): characters
    inside ``<...>`` and everything from the first top-level ``(`` on
    are removed."""
    head, first, depth, cur = [], None, 0, []
    for ch in name:
        if ch == "<":
            depth += 1
            if depth == 1:
                cur = []
                continue
        elif ch == ">" and depth:
            depth -= 1
            if depth == 0:
                if first is None:
                    first = "".join(cur)
                continue
        elif ch == "(" and depth == 0:
            break
        if depth == 0:
            head.append(ch)
        elif depth >= 1:
            cur.append(ch)
    if first is not None and "," in first:
        # the first argument only (depth-aware split)
        d, out = 0, []
        for ch in first:
            if ch in "<(":
                d += 1
            elif ch in ">)":
                d -= 1
            elif ch == "," and d == 0:
                break
            out.append(ch)
        first = "".join(out)
    return "".join(head).strip(), first


def base_kernel_name(name: str) -> str:
    """Stable kernel identity: drop a demangled signature's return type,
    namespaces, template arguments and parameter list
    (``void (anonymous namespace)::dq_mma<4>(...)`` → ``dq_mma``;
    ``aten::addmm`` → ``addmm``; a library wrapper such as
    ``cutlass::Kernel2<X>`` takes its argument's name), and XLA's
    ``.N`` / ``.clone`` / ``.remat`` suffixes (``dot.4`` → ``dot``)."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    head, first = _strip_args(s)
    base = head.split("::")[-1].strip() if "::" in head else head
    if base in _WRAPPERS and first:
        inner = base_kernel_name(first.strip())
        if inner and inner != "op":
            base = inner
    base = re.sub(r"\.(\d+|clone|remat)", "", base)
    base = re.sub(r"[^0-9A-Za-z_]+", "_", base).strip("_")
    return base or "op"


def kernel_scalar_name(base: str, unit: str = "ms") -> str:
    return f"kernel_{base}_{unit}"


def summarize_window(window_dir: str, top: int = 200) -> Optional[Dict]:
    """Raw per-op summary of one capture window's trace files (None when
    the window holds no parseable trace — a torn capture)."""
    from torchpruner_tpu_torch.utils.trace_analysis import summarize_trace

    try:
        return summarize_trace(window_dir, top=top, latest_run=False)
    except (FileNotFoundError, ValueError, OSError):
        return None


def merge_ops(summaries: List[Dict]) -> Dict[str, Dict[str, Any]]:
    """Fold the windows' ``top_ops`` into per-base-kernel totals:
    ``{base: {"ms", "count", "category", "ops": {raw names}}}``."""
    out: Dict[str, Dict[str, Any]] = {}
    for s in summaries:
        for op in s.get("top_ops", []):
            base = base_kernel_name(op.get("name", ""))
            agg = out.setdefault(base, {
                "ms": 0.0, "count": 0, "category": op.get("category",
                                                          "other"),
                "ops": set(),
            })
            agg["ms"] += float(op.get("ms", 0.0))
            agg["count"] += int(op.get("count", 0))
            agg["ops"].add(op.get("name", ""))
    return out


def kernel_table(merged: Dict[str, Dict[str, Any]], *,
                 steps: int,
                 step_time_s: Optional[float] = None,
                 flops_per_step: Optional[float] = None,
                 param_bytes: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 peak_bw: Optional[float] = None,
                 top: int = 25) -> List[Dict[str, Any]]:
    """The ranked per-kernel rows: name, ms/step, % of the attributed
    total, launch count/step, and a roofline position per kernel."""
    from torchpruner_tpu_torch.utils.flops import roofline_position

    steps = max(1, int(steps))
    total_ms = sum(v["ms"] for v in merged.values()) or 1.0
    compute_ms = sum(v["ms"] for v in merged.values()
                     if v["category"] in COMPUTE_CATEGORIES)
    rows: List[Dict[str, Any]] = []
    for base, v in sorted(merged.items(), key=lambda kv: -kv[1]["ms"]):
        ms_per_step = v["ms"] / steps
        t_s = ms_per_step / 1e3
        share = (v["ms"] / compute_ms) \
            if compute_ms and v["category"] in COMPUTE_CATEGORIES else 0.0
        flops = (flops_per_step * share) if flops_per_step else None
        # weight traffic only (see module docstring) — errs low
        bytes_moved = (3.0 * param_bytes * share) if param_bytes else None
        rows.append({
            "kernel": base,
            "category": v["category"],
            "ms_per_step": round(ms_per_step, 4),
            "pct_of_step": round(100.0 * v["ms"] / total_ms, 1),
            "launches_per_step": round(v["count"] / steps, 2),
            "ops": sorted(v["ops"])[:8],
            "roofline": roofline_position(
                flops, bytes_moved, t_s,
                peak_flops=peak_flops, peak_bw=peak_bw),
        })
        if len(rows) >= top:
            break
    # coverage: do the attributed op milliseconds explain the measured
    # step span? (host gaps push it < 1, multi-core overlap pushes > 1)
    if step_time_s:
        measured_ms = step_time_s * 1e3
        for r in rows:
            r["pct_of_measured_step"] = round(
                100.0 * r["ms_per_step"] / measured_ms, 1)
    return rows


def build_profile(windows: List[Dict[str, Any]], *,
                  flops_per_step: Optional[float] = None,
                  param_bytes: Optional[float] = None,
                  peak_flops: Optional[float] = None,
                  peak_bw: Optional[float] = None,
                  hbm: Optional[Dict[str, Any]] = None,
                  telemetry_step_s: Optional[float] = None,
                  top: int = 25) -> Dict[str, Any]:
    """Assemble the ``profile.json`` payload from closed capture-window
    records (``ContinuousProfiler.windows``): the merged ranked kernel
    table, per-window summaries, coverage vs the telemetry-measured step
    span, and the HBM timeline."""
    summaries, used = [], []
    steps = 0
    step_seconds = 0.0
    step_times: List[float] = []
    for w in windows:
        s = summarize_window(w["dir"])
        if s is None:
            continue
        summaries.append(s)
        used.append({k: w.get(k) for k in
                     ("index", "dir", "steps", "step_seconds",
                      "t_start_unix", "wall_s", "on_demand", "launches",
                      "missing_kernel_events")})
        used[-1]["op_ms"] = s.get("total_ms")
        steps += int(w.get("steps") or 0)
        step_seconds += float(w.get("step_seconds") or 0.0)
        step_times.extend(w.get("step_times") or [])
    merged = merge_ops(summaries)
    # the per-step denominator, in preference order: the session
    # telemetry's p50 over ALL steps (mostly un-profiled — in-window
    # steps carry the trace collector's own overhead, large on CPU),
    # else the MEDIAN in-window step time (one epoch-boundary step
    # with eval + retrace rolled into its return-to-return dt would
    # dominate a mean), else the plain mean
    if telemetry_step_s:
        step_time_s: Optional[float] = float(telemetry_step_s)
    elif step_times:
        step_time_s = float(sorted(step_times)[len(step_times) // 2])
    else:
        step_time_s = (step_seconds / steps) if steps else None
    rows = kernel_table(
        merged, steps=steps or 1, step_time_s=step_time_s,
        flops_per_step=flops_per_step, param_bytes=param_bytes,
        peak_flops=peak_flops, peak_bw=peak_bw, top=top)
    total_op_ms = sum(s.get("total_ms", 0.0) for s in summaries)
    coverage = (total_op_ms / (steps * step_time_s * 1e3)) \
        if steps and step_time_s else None
    by_category: Dict[str, float] = {}
    for s in summaries:
        for cat, ms in (s.get("by_category") or {}).items():
            by_category[cat] = by_category.get(cat, 0.0) + ms
    return {
        "windows": used,
        # the port's wrappers' launches inside the windows that their
        # traces lack (capture.ContinuousProfiler); 0 when none is lost
        "missing_kernel_events": sum(int(w.get("missing_kernel_events")
                                         or 0) for w in used),
        "steps_profiled": steps,
        "step_time_mean_s": (round(step_time_s, 6) if step_time_s
                             else None),
        "op_ms_total": round(total_op_ms, 3),
        "coverage": (round(coverage, 3) if coverage is not None else None),
        "by_category": {k: round(v, 3) for k, v in
                        sorted(by_category.items(), key=lambda kv: -kv[1])},
        "kernels": rows,
        "hbm": hbm or {},
        "peaks": {"peak_flops": peak_flops, "peak_bw": peak_bw},
    }


def kernel_gauges(profile: Dict[str, Any],
                  registry) -> Dict[str, float]:
    """Install the per-kernel gate scalars into ``registry``:
    ``kernel_<base>_ms`` (ms per step) and ``kernel_<base>_pct`` (share
    of attributed op time) for the top :data:`MAX_KERNEL_GAUGES` rows,
    plus the profile headline gauges.  Returns what was set."""
    out: Dict[str, float] = {}
    for r in profile.get("kernels", [])[:MAX_KERNEL_GAUGES]:
        out[kernel_scalar_name(r["kernel"], "ms")] = r["ms_per_step"]
        out[kernel_scalar_name(r["kernel"], "pct")] = r["pct_of_step"]
    if profile.get("coverage") is not None:
        out["profile_coverage"] = profile["coverage"]
    out["profile_windows_total"] = float(len(profile.get("windows", [])))
    if profile.get("steps_profiled"):
        out["profile_steps_total"] = float(profile["steps_profiled"])
    for name, v in out.items():
        help_ = ""
        if name.startswith("kernel_"):
            help_ = ("per-kernel step-time attribution from profiler "
                     "capture windows (ms per step / % of attributed "
                     "op time)")
        registry.gauge(name, help_).set(v)
    return out


def top_rows(window_dir: str, *, steps: int = 1, top: int = 5,
             flops_per_step: Optional[float] = None,
             param_bytes: Optional[float] = None) -> List[Dict[str, Any]]:
    """Compact top-N kernel rows for ONE capture directory — what the
    bench legs attach next to their timing rows.  Empty on a torn or
    op-less capture (never raises)."""
    try:
        s = summarize_window(window_dir)
        if s is None:
            return []
        from torchpruner_tpu_torch.obs import _current_cuda_device
        from torchpruner_tpu_torch.utils import flops as F

        dev = _current_cuda_device()
        peak_flops = F.peak_bf16_flops(dev) if dev is not None else None
        peak_bw = F.peak_hbm_bw(dev) if dev is not None else None
        rows = kernel_table(
            merge_ops([s]), steps=steps, flops_per_step=flops_per_step,
            param_bytes=param_bytes, peak_flops=peak_flops,
            peak_bw=peak_bw, top=top)
        return [{
            "kernel": r["kernel"], "category": r["category"],
            "ms_per_step": r["ms_per_step"],
            "pct_of_step": r["pct_of_step"],
            "bound": r["roofline"]["bound"],
            "pct_peak_flops": (round(r["roofline"]["pct_peak_flops"], 2)
                               if r["roofline"]["pct_peak_flops"]
                               is not None else None),
        } for r in rows]
    except Exception:  # profiling must never fail a bench leg
        return []


# -- rendering ---------------------------------------------------------------


def _fmt(v, fmt=".3f"):
    return format(v, fmt) if isinstance(v, (int, float)) else ""


def format_profile(profile: Dict[str, Any], top: Optional[int] = None
                   ) -> str:
    """Markdown rendering of a profile payload (the ``obs profile``
    CLI's output)."""
    lines: List[str] = ["# kernel profile"]
    bits = []
    if profile.get("windows"):
        bits.append(f"{len(profile['windows'])} capture window(s)")
    if profile.get("steps_profiled"):
        bits.append(f"{profile['steps_profiled']} steps")
    if profile.get("step_time_mean_s"):
        bits.append(f"step {1e3 * profile['step_time_mean_s']:.3f} ms")
    if profile.get("op_ms_total") is not None:
        bits.append(f"op time {profile['op_ms_total']:.1f} ms")
    if profile.get("coverage") is not None:
        bits.append(f"coverage {100 * profile['coverage']:.0f}% of "
                    "measured step span")
        # the device's idle share of the profiled steps: host gaps
        bits.append(f"device idle {100 * (1 - profile['coverage']):.0f}%")
    if bits:
        lines += ["", ", ".join(bits)]
    if profile.get("missing_kernel_events"):
        lines += ["", f"**{profile['missing_kernel_events']} kernel "
                      "launch(es) of the port's wrappers missing from the "
                      "windows' traces**: their tables undercount"]
    rows = profile.get("kernels", [])[: top or None]
    if rows:
        lines += ["", "| kernel | category | ms/step | % step | "
                      "launches/step | bound | % peak FLOP/s | "
                      "intensity (FLOP/B) |",
                  "|---|---|---|---|---|---|---|---|"]
        for r in rows:
            rf = r.get("roofline") or {}
            lines.append(
                f"| `{r['kernel']}` | {r['category']} "
                f"| {_fmt(r['ms_per_step'])} | {_fmt(r['pct_of_step'], '.1f')} "
                f"| {_fmt(r['launches_per_step'], '.2f')} "
                f"| {rf.get('bound', '')} "
                f"| {_fmt(rf.get('pct_peak_flops'), '.2f')} "
                f"| {_fmt(rf.get('intensity_flops_per_byte'), '.1f')} |")
    else:
        lines += ["", "(no kernel rows — no capture windows, or the "
                      "traces held no op events)"]
    cats = profile.get("by_category") or {}
    if cats:
        lines += ["", "| category | ms |", "|---|---|"]
        for cat, ms in cats.items():
            lines.append(f"| {cat} | {ms:.1f} |")
    hbm = profile.get("hbm") or {}
    phases = hbm.get("phases") or {}
    if phases:
        lines += ["", "| phase (HBM watermark) | peak bytes | Δ bytes "
                      "| frag est | samples |", "|---|---|---|---|---|"]
        for name, v in phases.items():
            lines.append(
                f"| {name} | {int(v.get('peak_bytes') or 0)} "
                f"| {int(v.get('delta_bytes') or 0):+d} "
                f"| {_fmt(v.get('fragmentation'), '.3f')} "
                f"| {v.get('samples', 0)} |")
    return "\n".join(lines)


def load_profile(run_dir: str) -> Optional[Dict[str, Any]]:
    """A run's profile payload: ``profile.json`` when the session closed
    cleanly, else re-parsed from whatever ``profile/window_*`` capture
    dirs survived (a SIGKILLed run must still be profileable).  Also
    accepts the profile.json FILE directly, or a report.json carrying a
    ``profile`` block."""
    import json

    if os.path.isfile(run_dir):
        with open(run_dir) as f:
            payload = json.load(f)
        return payload.get("profile", payload)
    path = os.path.join(run_dir, "profile.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    report = os.path.join(run_dir, "report.json")
    if os.path.exists(report):
        with open(report) as f:
            prof = json.load(f).get("profile")
        if prof:
            return prof
    from torchpruner_tpu_torch.obs.profile.capture import scan_windows

    windows = scan_windows(os.path.join(run_dir, "profile"))
    if not windows:
        return None
    return build_profile(windows)
