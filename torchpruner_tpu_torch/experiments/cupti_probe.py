"""How many kernel events ``torch.profiler`` sessions lose on the card, by
how CUPTI is handled between sessions (ROADMAP C3).

Each session synchronizes, starts a ``torch.profiler.profile`` (CPU and
CUDA), launches ``k`` one-kernel ops (``x.add_(1.0)``), synchronizes and
stops; its in-memory kineto result is then counted: the kernels it holds
against the launches made, and which launches lost their kernel.

Two loops:

- ``edge`` — every 15 s, three sessions of 40 kernels with a 0.3 ms
  sleep between launches: a plain one, one that sleeps 20 ms between the
  final synchronize and the stop (``pad_s``), and one that sleeps 20 ms
  between the start and the first launch (``head_pad_s``).  With
  ``--late`` the first 60 % of the time passes with no session (CUPTI
  not yet set up).  The record also holds the offset of each kernel's
  start from its launch (min and median), the first kernel's and the
  first launch's start after the session's start, and the time from the
  last kernel's end to the stop.
- ``burst`` — back to back, 0.2 s apart: sessions of 40 kernels (every
  fourth of 400), a 0.2 ms sleep every 10 launches, with the start and
  stop walls.

``--teardown`` sets ``TEARDOWN_CUPTI`` (``1``: CUPTI torn down at every
stop; ``0``: kept set up; ``unset``: torch's default) before torch is
imported; ``--no-lazy-reinit`` sets ``DISABLE_CUPTI_LAZY_REINIT=1``.
One JSON line a session goes to stdout and to ``--out``, and a summary
line ends the run.  On the card only::

    python -m torchpruner_tpu_torch.experiments.cupti_probe --loop edge \\
        --teardown 0 --seconds 240 --out logs/cupti_keep.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _session(x, k, *, sleep_every, sleep_s, pad_s=0.0, head_pad_s=0.0):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t_call = time.time_ns()
    p.start()
    t_started = time.time_ns()
    t1 = time.perf_counter()
    if head_pad_s:
        time.sleep(head_pad_s)
    for i in range(k):
        x.add_(1.0)
        if sleep_every and i % sleep_every == 0 and i < k - 1:
            time.sleep(sleep_s)
    torch.cuda.synchronize()
    if pad_s:
        time.sleep(pad_s)
    t2 = time.perf_counter()
    t_stop = time.time_ns()
    p.stop()
    t3 = time.perf_counter()
    evs = p.profiler.kineto_results.events()
    kern = [e for e in evs if e.device_type() != DeviceType.CPU
            and not e.is_user_annotation()]
    launch = [e for e in evs if e.device_type() == DeviceType.CPU
              and "aunch" in e.name()]
    by_corr = {e.correlation_id(): e for e in launch}
    offs, matched = [], set()
    for kk in kern:
        c = kk.correlation_id()
        if c in by_corr:
            offs.append(kk.start_ns() - by_corr[c].start_ns())
            matched.add(c)
    ordered = sorted(launch, key=lambda e: e.start_ns())
    offs.sort()
    return {
        "k": k, "pad_s": pad_s, "head_pad_s": head_pad_s,
        "kernels": len(kern), "launches": len(launch),
        "lost_positions": [i for i, e in enumerate(ordered)
                           if e.correlation_id() not in matched],
        "start_ms": round((t1 - t0) * 1e3, 3),
        "stop_ms": round((t3 - t2) * 1e3, 3),
        "min_launch_to_start_us": offs[0] / 1e3 if offs else None,
        "med_launch_to_start_us": (offs[len(offs) // 2] / 1e3
                                   if offs else None),
        "first_kernel_after_start_us": (
            (min(e.start_ns() for e in kern) - t_started) / 1e3
            if kern else None),
        "first_launch_after_start_us": (
            (min(e.start_ns() for e in launch) - t_started) / 1e3
            if launch else None),
        "stop_after_last_kernel_end_us": (
            (t_stop - max(e.end_ns() for e in kern)) / 1e3
            if kern else None),
        "trace_start_minus_call_us": (
            p.profiler.kineto_results.trace_start_ns() - t_call) / 1e3,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loop", choices=("edge", "burst"), default="edge")
    ap.add_argument("--teardown", choices=("0", "1", "unset"),
                    default="unset")
    ap.add_argument("--no-lazy-reinit", action="store_true")
    ap.add_argument("--late", action="store_true")
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.teardown == "unset":
        os.environ.pop("TEARDOWN_CUPTI", None)
    else:
        os.environ["TEARDOWN_CUPTI"] = args.teardown
    if args.no_lazy_reinit:
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("cupti_probe: needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "w") if args.out else None
    x = torch.ones(1 << 16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    agg = {"sessions": 0, "empty": 0, "short": 0, "lost": 0}

    def emit(rec):
        rec["age_s"] = round(time.time() - t0, 3)
        agg["sessions"] += 1
        agg["empty"] += rec["kernels"] == 0
        agg["short"] += 0 < rec["kernels"] < rec["k"]
        agg["lost"] += rec["k"] - rec["kernels"]
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def idle_until(t):
        while time.time() < t:
            x.add_(1.0)
            time.sleep(0.01)

    if args.loop == "edge":
        begin = t0 + (0.6 * args.seconds if args.late else 0.0)
        idle_until(begin)
        i = 0
        while time.time() - t0 < args.seconds:
            for pad, head in ((0.0, 0.0), (0.02, 0.0), (0.0, 0.02)):
                emit(_session(x, 40, sleep_every=1, sleep_s=0.0003,
                              pad_s=pad, head_pad_s=head))
            i += 1
            idle_until(begin + 15.0 * i)
        emit(_session(x, 40, sleep_every=1, sleep_s=0.0003))
    else:
        n = 0
        while time.time() - t0 < args.seconds:
            emit(_session(x, 400 if n % 4 == 3 else 40, sleep_every=10,
                          sleep_s=0.0002))
            n += 1
            time.sleep(0.2)
    print("SUMMARY " + json.dumps(dict(agg, loop=args.loop,
                                       teardown=args.teardown,
                                       no_lazy_reinit=args.no_lazy_reinit,
                                       late=args.late)), flush=True)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
