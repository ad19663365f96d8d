"""Offline summarizer for ``torch.profiler`` traces — counterpart of
``torchpruner_tpu/utils/trace_analysis.py``, which parses XLA's traces.

``torch.profiler``'s ``export_chrome_trace`` writes a Chrome-trace JSON
(``*.pt.trace.json``, gzip-compressed when the name ends in ``.gz``)
whose complete events (``ph == "X"``) carry per-op timings.  This module
turns that into the table PERF.md needs — top ops by total time, grouped
into categories — without TensorBoard in the loop.

**Op events** (:func:`file_op_events`):

- on CUDA, the device events: ``cat`` ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``.  The CPU-side events of the same trace (``cpu_op``,
  ``cuda_runtime``, ``user_annotation`` — the obs spans and
  ``ProfilerStep#N`` markers — and ``gpu_user_annotation``) are not ops;
- on the CPU (a trace with no device event), the ``cpu_op`` events at
  the top level of each thread: an op nested inside another op of its
  thread (``aten::linear`` → ``aten::addmm``) is part of its parent's
  time, the way the JAX package counts the CPU backend's thunk events.

**Categories** (:func:`categorize`), first match wins, on the op's base
name (``obs.profile.kernels.base_kernel_name``: return type, namespaces,
template arguments and parameter list dropped) and its lower-cased raw
name:

1. ``attention`` — the port's flash bodies ``fwd_*`` / ``dq_*`` /
   ``dkv_*`` (but the dequant body ``dq_mma``) and decode attention's
   ``decode_*`` (``decode_split``);
2. ``matmul`` — the port's block-sparse bodies ``bs_*`` and the dequant
   body ``dq_mma``;
3. ``convolution`` — a raw name holding ``conv`` or ``cudnn``
   (cuDNN's convolutions, ``aten::convolution`` on the CPU);
4. ``matmul`` — a raw name holding ``gemm``, ``nvjet``, ``xmma``,
   ``cutlass`` or ``matmul``, or a base name ``mm`` / ``addmm`` /
   ``bmm`` / ``baddbmm`` / ``linear`` (cuBLAS / CUTLASS GEMMs; ATen's
   products on the CPU);
5. ``copy/layout`` — ``Memcpy*`` / ``Memset*`` and raw names holding
   ``copy``, ``transpose``, ``cat`` or ``index``;
6. ``reduce`` — raw names holding ``reduce``, ``sum``, ``softmax`` or
   ``norm``;
7. ``fusion/elementwise`` — everything else.

CLI: ``python -m torchpruner_tpu_torch.utils.trace_analysis LOG_DIR
[--top N]`` (the directory given to ``profiling.trace`` or a capture
window's directory).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional

#: ``cat`` of the device op events in a ``torch.profiler`` trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_PRODUCT_BASES = ("mm", "addmm", "bmm", "baddbmm", "linear", "matmul")


def categorize(name: str) -> str:
    """The op's category (module docstring: the rule, in order)."""
    from torchpruner_tpu_torch.obs.profile.kernels import base_kernel_name

    base = base_kernel_name(name)
    low = name.lower()
    if base.startswith(("fwd_", "dkv_", "decode_")) or (
            base.startswith("dq_") and base != "dq_mma"):
        return "attention"
    if base.startswith("bs_") or base == "dq_mma":
        return "matmul"
    if "conv" in low or "cudnn" in low:
        return "convolution"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                              "matmul")) or base in _PRODUCT_BASES:
        return "matmul"
    if low.startswith(("memcpy", "memset")) or any(
            t in low for t in ("copy", "transpose", "cat", "index")):
        return "copy/layout"
    if any(t in low for t in ("reduce", "sum", "softmax", "norm")):
        return "reduce"
    return "fusion/elementwise"


def find_trace_files(log_dir: str, latest_run: bool = True) -> List[str]:
    """Trace files under ``log_dir`` (``*.trace.json[.gz]``, recursively).
    With ``latest_run`` only the newest file is returned (by name, then
    modification time), so a reused trace directory does not
    double-count earlier sessions."""
    files = sorted(set(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*.trace.json"),
                    recursive=True)))
    if latest_run and len(files) > 1:
        return [max(files, key=lambda p: (os.path.getmtime(p), p))]
    return files


def load_trace_events(path: str) -> List[dict]:
    """The ``traceEvents`` of one Chrome-trace file (gzip or plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    if isinstance(data, list):
        return data
    return data.get("traceEvents", [])


def _top_level(events: List[dict]) -> List[dict]:
    """The events not nested inside another of their (pid, tid)."""
    by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: List[dict] = []
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (float(e.get("ts", 0.0)),
                                            -float(e.get("dur", 0.0)))):
            ts = float(e.get("ts", 0.0))
            if ts >= end:
                out.append(e)
                end = ts + float(e.get("dur", 0.0))
    return out


def file_op_events(path: str) -> List[dict]:
    """The per-op complete events of one trace file (module docstring:
    the device events on CUDA, the top-level ``cpu_op`` events on the
    CPU): ``[{"name", "ts", "dur", "pid", "tid"}, ...]`` (µs) — ONE rule
    shared by :func:`summarize_trace` and the Perfetto merge
    (``obs.trace_export``)."""
    events = [e for e in load_trace_events(path)
              if e.get("ph") == "X" and "dur" in e and e.get("name")]
    ops = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not ops:
        ops = _top_level([e for e in events if e.get("cat") == "cpu_op"])
    return [{"name": e["name"], "ts": float(e.get("ts", 0.0)),
             "dur": float(e["dur"]), "pid": e.get("pid", 0),
             "tid": e.get("tid", 0)} for e in ops]


def summarize_trace(log_dir: str, top: int = 25,
                    latest_run: bool = True,
                    spans_jsonl: Optional[str] = None) -> Dict:
    """Aggregate the trace files of ``log_dir`` (the newest only with
    ``latest_run``).

    Returns ``{"total_ms", "by_category": {cat: ms}, "top_ops":
    [{"name", "ms", "pct", "category", "count"}, ...], "files"}``.

    ``spans_jsonl`` joins an obs event stream (``--obs-dir``'s
    ``events.jsonl``) into the summary as a ``"phases"`` block —
    per-phase wall seconds and compile accounting next to the op table.
    """
    files = find_trace_files(log_dir, latest_run=latest_run)
    if not files:
        raise FileNotFoundError(
            f"no *.trace.json[.gz] under {log_dir!r} — pass the directory "
            f"given to profiling.trace() or a capture window's directory")
    durs: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for path in files:
        for e in file_op_events(path):
            name = e["name"]
            durs[name] = durs.get(name, 0.0) + e["dur"]  # microseconds
            counts[name] = counts.get(name, 0) + 1
    total_us = sum(durs.values()) or 1.0
    by_cat: Dict[str, float] = {}
    cats = {name: categorize(name) for name in durs}
    for name, us in durs.items():
        by_cat[cats[name]] = by_cat.get(cats[name], 0.0) + us
    top_ops = [
        {
            "name": name,
            "ms": round(us / 1e3, 3),
            "pct": round(100.0 * us / total_us, 1),
            "category": cats[name],
            "count": counts[name],
        }
        for name, us in sorted(durs.items(), key=lambda kv: -kv[1])[:top]
    ]
    out = {
        "total_ms": round(total_us / 1e3, 3) if durs else 0.0,
        "by_category": {
            k: round(v / 1e3, 3)
            for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])
        },
        "top_ops": top_ops,
        "files": files,
    }
    if spans_jsonl:
        from torchpruner_tpu_torch.utils.profiling import span_phase_summary

        out["phases"] = {
            k: {"total_s": round(v["total_s"], 3), "calls": v["calls"],
                "compile_s": round(v["compile_s"], 3),
                "compile_count": v["compile_count"]}
            for k, v in sorted(span_phase_summary(spans_jsonl).items(),
                               key=lambda kv: -kv[1]["total_s"])
        }
    return out


def markdown_summary(summary: Dict, top: Optional[int] = None) -> str:
    lines = [
        f"Total op time: {summary.get('total_ms', 0.0):.1f} ms",
        "",
        "| category | ms | % |",
        "|---|---|---|",
    ]
    total = summary.get("total_ms") or 1.0
    for cat, ms in summary.get("by_category", {}).items():
        lines.append(f"| {cat} | {ms:.1f} | {100 * ms / total:.1f} |")
    lines += ["", "| op | category | ms | % | calls |", "|---|---|---|---|---|"]
    for op in summary.get("top_ops", [])[: top or None]:
        lines.append(
            f"| `{op.get('name', '?')}` | {op.get('category', 'other')} "
            f"| {op.get('ms', 0)} | {op.get('pct', 0)} "
            f"| {op.get('count', 0)} |"
        )
    if summary.get("phases"):
        lines += ["", "| phase (runtime spans) | wall s | calls | "
                      "compile s | compiles |", "|---|---|---|---|---|"]
        for name, v in summary["phases"].items():
            lines.append(
                f"| {name} | {v['total_s']} | {v['calls']} "
                f"| {v['compile_s']} | {v['compile_count']} |"
            )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", action="store_true")
    ap.add_argument(
        "--spans", metavar="EVENTS_JSONL",
        help="obs runtime event stream (--obs-dir's events.jsonl) to join "
             "as a per-phase timing table",
    )
    args = ap.parse_args(argv)
    summary = summarize_trace(args.log_dir, top=args.top,
                              spans_jsonl=args.spans)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(markdown_summary(summary))


if __name__ == "__main__":
    main()
