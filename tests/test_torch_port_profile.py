"""The port's kernel profiler (``torchpruner_tpu_torch/obs/profile`` and
``utils/trace_analysis.py``) on ``torch.profiler`` traces.

- a hand-written trace in ``torch.profiler``'s Chrome format (``kernel``,
  ``cuda_runtime`` and ``cpu_op`` events, demangled templated C++ names)
  gives the expected base names, categories, per-step ms, launches and
  ``coverage`` — exact arithmetic on the written numbers;
- ``ContinuousProfiler`` takes three windows in one process (two on the
  cadence, one on demand), one profiler session each, every window
  holding op events, on a tiny CPU model; a close from a thread that did
  not open the window tears it instead of touching another thread's
  profiler session;
- a window holds its kernel events against the port's wrappers' launch
  counts (``ops.launches``), and a shortfall is written into the window
  and counted; the wrapper groups name every ``__global__`` kernel of
  ``csrc/``;
- ``utils/profiling.py``: ``trace``, ``time_fn``, ``time_train_step``
  and the span-stream summaries;
- on the card (``cuda`` marker, skips here) the same three windows each
  hold kernel events, with no empty window and no missing launch.

This file imports no JAX, so it runs as it is on the GPU machine:
``python -m pytest --noconftest tests/test_torch_port_profile.py``.
"""

import gzip
import json
import os
import time

import pytest
import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.obs.profile import (
    ContinuousProfiler,
    base_kernel_name,
    build_profile,
    kernel_gauges,
    load_profile,
)
from torchpruner_tpu_torch.obs.profile.capture import TRACE_FILENAME
from torchpruner_tpu_torch.obs.metrics import MetricsRegistry
from torchpruner_tpu_torch.utils import trace_analysis as TA

FWD = "void (anonymous namespace)::fwd_tf32x3<8, true>(float const*, " \
      "float const*, float const*, float*, float*, int, int, int, float)"
DQ = "void (anonymous namespace)::dq_mma<4>(__nv_bfloat16 const*, " \
     "signed char const*, float const*, float*, int, int, int)"
DEC = "void (anonymous namespace)::decode_split<__nv_bfloat16, " \
      "__nv_bfloat16, 8, 4>(__nv_bfloat16 const*, int const*, int)"
GEMM = "nvjet_tst_128x64_64x6_2x1_v_bz_TNT"
ELT = "void at::native::vectorized_elementwise_kernel<4, " \
      "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, " \
      "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)"


@pytest.fixture(autouse=True)
def _clean_session():
    obs.shutdown()
    yield
    obs.shutdown()


def _write_trace(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"stream": 7}}


def _window_dir(tmp_path, index, steps, step_s, events):
    wdir = tmp_path / "profile" / f"window_{index:03d}"
    wdir.mkdir(parents=True)
    _write_trace(str(wdir / TRACE_FILENAME), events)
    meta = {"index": index, "steps": steps,
            "step_seconds": steps * step_s,
            "step_times": [step_s] * steps, "on_demand": False,
            "t_start_unix": 1000.0 + index, "wall_s": 1.0}
    (wdir / "window.json").write_text(json.dumps(meta))
    return dict(meta, dir=str(wdir))


def test_base_names_and_categories_of_torch_kernel_names():
    assert base_kernel_name(FWD) == "fwd_tf32x3"
    assert base_kernel_name(DQ) == "dq_mma"
    assert base_kernel_name(DEC) == "decode_split"
    assert base_kernel_name(ELT) == "vectorized_elementwise_kernel"
    assert base_kernel_name(
        "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn"
        "_align4>(cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4"
        "::Params)") == "cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4"
    assert base_kernel_name("Memcpy HtoD (Pageable -> Device)") \
        == "Memcpy_HtoD"
    assert base_kernel_name("aten::addmm") == "addmm"
    assert base_kernel_name("dot.17.clone") == "dot"  # XLA's suffixes
    want = {FWD: "attention", DEC: "attention",
            "void (anonymous namespace)::dq_wgmma<64>(CUtensorMap)":
                "attention",
            "void (anonymous namespace)::dkv_wgmma<64>(CUtensorMap)":
                "attention",
            DQ: "matmul",
            "void (anonymous namespace)::bs_wgmma<0, 192>(CUtensorMap)":
                "matmul",
            GEMM: "matmul", "sm90_xmma_gemm_bf16bf16_bf16f32": "matmul",
            "aten::addmm": "matmul",
            "void cudnn::engines_precompiled::nhwcToNchwKernel<float>(x)":
                "convolution",
            "aten::convolution": "convolution",
            "Memcpy HtoD (Pageable -> Device)": "copy/layout",
            "void at::native::reduce_kernel<512, 1>(x)": "reduce",
            ELT: "fusion/elementwise", "aten::relu": "fusion/elementwise"}
    assert {n: TA.categorize(n) for n in want} == want


def test_parse_device_trace_kernel_table_per_step_and_coverage(tmp_path):
    """Two steps of 1 ms each: per step one fwd (0.1 ms), two dq_mma
    (0.2 ms each), one GEMM (0.15 ms) and one memcpy (0.05 ms).  The
    cuda_runtime launches and cpu_ops on the host are not op events."""
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "python"}}]
    t = 0.0
    for _ in range(2):
        events += [
            _kernel(FWD, t, 100.0), _kernel(DQ, t + 150, 200.0),
            _kernel(DQ, t + 400, 200.0), _kernel(GEMM, t + 650, 150.0),
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD "
             "(Device -> Device)", "pid": 0, "tid": 7, "ts": t + 850,
             "dur": 50.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": t, "dur": 900.0},
            {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1,
             "tid": 1, "ts": t, "dur": 950.0},
            {"ph": "X", "cat": "user_annotation", "name": "serve_prefill",
             "pid": 1, "tid": 1, "ts": t, "dur": 990.0},
            {"ph": "X", "cat": "gpu_user_annotation",
             "name": "serve_prefill", "pid": 0, "tid": 7, "ts": t,
             "dur": 990.0},
        ]
        t += 1000.0
    w = _window_dir(tmp_path, 0, steps=2, step_s=1e-3, events=events)
    ops = TA.file_op_events(os.path.join(w["dir"], TRACE_FILENAME))
    assert len(ops) == 10  # 5 device ops a step, nothing from the host
    prof = build_profile([w])
    rows = {r["kernel"]: r for r in prof["kernels"]}
    # ms per step and launches per step: exact on the written numbers
    assert rows["dq_mma"]["ms_per_step"] == pytest.approx(0.4)
    assert rows["dq_mma"]["launches_per_step"] == 2.0
    assert rows["fwd_tf32x3"]["ms_per_step"] == pytest.approx(0.1)
    assert rows["fwd_tf32x3"]["category"] == "attention"
    assert rows[base_kernel_name(GEMM)]["category"] == "matmul"
    assert rows["Memcpy_DtoD"]["category"] == "copy/layout"
    assert prof["op_ms_total"] == pytest.approx(1.4)
    # coverage = 0.7 ms of ops per 1 ms step; the idle share is 0.3
    assert prof["coverage"] == pytest.approx(0.7)
    assert [r["kernel"] for r in prof["kernels"]][0] == "dq_mma"
    gauges = kernel_gauges(prof, MetricsRegistry())
    assert gauges["kernel_dq_mma_ms"] == pytest.approx(0.4)
    assert gauges["profile_coverage"] == pytest.approx(0.7)
    # the offline path: scan the window dirs when no profile.json exists
    assert load_profile(str(tmp_path))["coverage"] == pytest.approx(0.7)


def test_parse_cpu_trace_counts_top_level_ops_only(tmp_path):
    """On the CPU the op events are the cpu_ops at the top of each
    thread: aten::linear (nested addmm inside) and aten::relu."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1,
         "tid": 1, "ts": 10.0, "dur": 80.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "pid": 1,
         "tid": 1, "ts": 120.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "pid": 1,
         "tid": 2, "ts": 0.0, "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#3",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 200.0},
    ]
    path = str(tmp_path / "t.pt.trace.json.gz")
    _write_trace(path, events)
    ops = TA.file_op_events(path)
    assert sorted((o["name"], o["dur"]) for o in ops) == [
        ("aten::linear", 100.0), ("aten::relu", 20.0), ("aten::relu", 30.0)]
    s = TA.summarize_trace(str(tmp_path), latest_run=False)
    assert s["total_ms"] == pytest.approx(0.15)
    assert s["by_category"] == {"matmul": 0.1, "fusion/elementwise": 0.05}


def _tiny_step(lin, x):
    t0 = time.perf_counter()
    with obs.span("step"):
        lin(x).relu().sum()
    return time.perf_counter() - t0


def test_three_windows_in_one_process_on_the_cpu(tmp_path):
    """Cadence every 4 steps, 2-step windows: the first cadence window,
    then one armed on demand, then the next cadence window — a profiler
    session each, every window holding op events."""
    session = obs.configure(str(tmp_path), profile_every=4,
                            profile_steps=2)
    prof = session.profiler
    prof.max_windows = 3
    lin = torch.nn.Linear(32, 32)
    x = torch.randn(8, 32)
    armed = False
    for _ in range(16):
        obs.record_step(_tiny_step(lin, x), 8)
        if len(prof.windows) == 1 and not armed:
            armed = obs.request_profile_window()
    assert armed
    obs.shutdown()
    assert [w["on_demand"] for w in prof.windows] == [False, True, False]
    assert all(w["steps"] == 2 for w in prof.windows)
    assert all(w["events"] > 0 for w in prof.windows)
    assert not prof.failed and prof.empty_windows == 0
    # no port kernel runs on the CPU: nothing launched, nothing missing
    assert all(w["launches"] == {} and w["missing_kernel_events"] == 0
               for w in prof.windows)
    # each trace was compressed off the loop: the gzip alone remains
    assert all(set(w["capture_s"]) == {"start", "stop", "export",
                                       "compress"}
               for w in prof.windows)
    assert all(sorted(os.listdir(w["dir"])) == ["trace.pt.trace.json.gz",
                                                "window.json"]
               for w in prof.windows)
    profile = json.loads((tmp_path / "profile.json").read_text())
    assert len(profile["windows"]) == 3
    names = {r["kernel"] for r in profile["kernels"]}
    assert {"linear", "relu"} <= names
    # the spans rode into the windows as record_function annotations
    trace = TA.load_trace_events(os.path.join(
        prof.windows[0]["dir"], TRACE_FILENAME))
    assert any(e.get("cat") == "user_annotation" and e["name"] == "step"
               for e in trace)
    # the Perfetto export merges spans and the windows' ops
    merged = json.loads((tmp_path / "trace.json").read_text())
    cats = {e.get("cat") for e in merged["traceEvents"]}
    assert {"obs", "device_op"} <= cats


_TORN = """
import os, sys, threading, time, torch
from torchpruner_tpu_torch import obs
session = obs.configure(sys.argv[1], profile_every=1, profile_steps=5)
lin = torch.nn.Linear(8, 8)
def steps():
    for _ in range(2):
        t0 = time.perf_counter()
        lin(torch.randn(2, 8)).sum()
        obs.record_step(time.perf_counter() - t0, 2)
t = threading.Thread(target=steps)
t.start()
t.join(timeout=60)
assert not t.is_alive() and session.profiler.active
obs.shutdown()  # this thread did not open the window
(w,) = session.profiler.windows
assert w["torn"] and w["events"] == 0, w
assert session.profiler.failed and not session.profiler.request_window()
print("ok", flush=True)
# the session left on the ended thread cannot be stopped from here, and
# torch's teardown of it at interpreter exit is not safe: leave at once
os._exit(0)
"""


def test_window_closed_from_another_thread_is_torn(tmp_path):
    """In a child process: the profiler session it leaves behind, on a
    thread that has ended, must not outlive the test (torch cannot stop
    a session from another thread)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _TORN, str(tmp_path)],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_window_counts_launches_its_trace_lacks(tmp_path):
    """Launches that the port's wrappers count inside a window but whose
    kernels the window's trace lacks are written into the window and
    counted in ``profile_missing_kernel_events_total`` — here three
    dequant launches counted with no kernel run (on the CPU the trace
    holds no kernel)."""
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    reg = MetricsRegistry()
    prof = ContinuousProfiler(str(tmp_path), every_steps=0,
                              window_steps=1, registry=reg)
    before = FM.dequant_matmul.launches
    try:
        assert prof.request_window()
        prof.on_step(0.001)  # opens the window
        FM.dequant_matmul.launches += 3
        prof.on_step(0.001)  # closes it
    finally:
        FM.dequant_matmul.launches = before
    (w,) = prof.close()
    assert w["launches"] == {"dequant_matmul": 3}
    assert w["kernel_events"] == {} and w["missing_kernel_events"] == 3
    assert prof.missing_kernel_events == 3
    assert reg.get("profile_missing_kernel_events_total").value == 3
    meta = json.loads((tmp_path / "window_000" / "window.json").read_text())
    assert meta["missing_kernel_events"] == 3
    # profile.json carries the shortfall, and obs profile prints it
    from torchpruner_tpu_torch.obs.profile.kernels import format_profile

    profile = build_profile(prof.windows)
    assert profile["missing_kernel_events"] == 3
    assert profile["windows"][0]["launches"] == {"dequant_matmul": 3}
    assert "3 kernel launch(es)" in format_profile(profile)


def test_wrapper_groups_name_every_kernel_of_the_sources():
    """``ops.launches``: every wrapper exists and counts its launches, and
    the groups' bodies are exactly the ``__global__`` kernels of
    ``csrc/*.cu`` — a kernel added there must be given to a group."""
    import glob
    import re

    from torchpruner_tpu_torch.ops import launches as LA

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = ""
    for path in glob.glob(os.path.join(root, "torchpruner_tpu_torch",
                                       "csrc", "*.cu")):
        with open(path) as f:
            src += f.read()
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
        src))
    assert kernels == set(LA.BODY_GROUP)
    counts = LA.counts()
    assert set(counts) == set(LA.GROUPS)
    assert all(isinstance(n, int) and n >= 0 for n in counts.values())


def test_cupti_probe_needs_the_card(monkeypatch, capsys):
    """``experiments/cupti_probe.py`` measures sessions on the card only:
    without CUDA it exits 2 before touching a device."""
    from torchpruner_tpu_torch.experiments import cupti_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TEARDOWN_CUPTI", "unchanged")
    monkeypatch.setenv("DISABLE_CUPTI_LAZY_REINIT", "unchanged")
    assert cupti_probe.main(["--loop", "burst", "--teardown", "1",
                             "--no-lazy-reinit", "--seconds", "0"]) == 2
    assert os.environ["TEARDOWN_CUPTI"] == "1"
    assert "needs a CUDA device" in capsys.readouterr().err


def test_request_window_refused_while_armed_or_at_cap(tmp_path):
    prof = ContinuousProfiler(str(tmp_path), every_steps=0,
                              window_steps=1, max_windows=1)
    assert prof.request_window()
    assert not prof.request_window()  # already armed
    prof.on_step(0.001)               # opens it
    assert not prof.request_window()  # open
    prof.on_step(0.001)               # closes it
    assert len(prof.windows) == 1
    assert not prof.request_window()  # the cap


def test_profiling_utils_trace_timers_and_span_summaries(tmp_path):
    """``utils/profiling.py`` on the CPU: ``trace`` writes a trace that
    ``summarize_trace`` reads, ``time_fn`` / ``time_train_step`` report
    their keys, and the span-stream readers aggregate one session's
    ``events.jsonl`` (the latest run only)."""
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.models import digits_fc_tiny
    from torchpruner_tpu_torch.train import optim
    from torchpruner_tpu_torch.train.loop import Trainer
    from torchpruner_tpu_torch.utils import profiling
    from torchpruner_tpu_torch.utils.losses import cross_entropy_loss

    lin = torch.nn.Linear(16, 16)
    with profiling.trace(str(tmp_path / "t")):
        lin(torch.randn(4, 16)).relu()
    s = TA.summarize_trace(str(tmp_path / "t"))
    assert {"linear", "relu"} <= {base_kernel_name(o["name"])
                                  for o in s["top_ops"]}
    stats = profiling.time_fn(lin, torch.randn(4, 16), iters=3,
                              chained=True)
    assert {"mean_s", "min_s", "p50_s", "compile_s",
            "chained_mean_s"} <= set(stats)
    assert profiling.steady_s(stats) == stats["chained_mean_s"]
    model = digits_fc_tiny()
    params, _ = init_model(model, 0, device="cpu")
    trainer = Trainer.create(model, optim.sgd(0.01), cross_entropy_loss,
                             params=params, device="cpu")
    x = torch.randn(8, 64)
    y = torch.zeros(8, dtype=torch.int64)
    st = profiling.time_train_step(trainer, x, y, iters=2, warmup=1)
    assert st["p50_s"] > 0 and trainer.step_count == 3
    events = tmp_path / "events.jsonl"
    with open(events, "w") as f:
        for run in range(2):  # a reused obs dir: the latest run counts
            f.write(json.dumps({"event": "obs_init", "ts": run}) + "\n")
            for dur in (0.5, 0.25):
                f.write(json.dumps({"event": "span_end", "name": "retrain",
                                    "dur_s": dur * (run + 1),
                                    "compile_s": 0.1,
                                    "compile_count": 1}) + "\n")
    agg = profiling.span_phase_summary(str(events))
    assert agg["retrain"]["calls"] == 2
    assert agg["retrain"]["total_s"] == pytest.approx(1.5)
    timer = profiling.StepTimer.from_span_jsonl(str(events))
    assert timer.summary()["retrain"]["mean_s"] == pytest.approx(0.75)


@pytest.mark.cuda
def test_three_windows_hold_kernel_events_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the windows' kernel events come "
                    "from the card)")
    dev = torch.device("cuda")
    session = obs.configure(str(tmp_path), profile_every=4,
                            profile_steps=2)
    prof = session.profiler
    prof.max_windows = 3
    a = torch.randn(512, 512, device=dev)
    armed = False
    for _ in range(16):
        t0 = time.perf_counter()
        (a @ a).relu_().sum()
        obs.record_step(time.perf_counter() - t0, 512)
        if len(prof.windows) == 1 and not armed:
            armed = obs.request_profile_window()
    obs.shutdown()
    assert armed and len(prof.windows) == 3
    assert all(w["device_events"] > 0 for w in prof.windows)
    assert prof.empty_windows == 0 and not prof.failed
    assert session.metrics.get("profile_empty_windows_total").value == 0
    assert prof.missing_kernel_events == 0
    assert session.metrics.get(
        "profile_missing_kernel_events_total").value == 0
