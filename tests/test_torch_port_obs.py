"""The port's telemetry host plane (``torchpruner_tpu_torch/obs``) against
the JAX package's ``torchpruner_tpu/obs`` on the same inputs, on the CPU.

Parity (same operations, same inputs, both packages):

- the metrics registry: byte-equal ``prometheus_text`` and
  ``summary_table``, equal ``StepTelemetry.derive``;
- the ledger: equal ``score_distribution`` and ledger records (the
  records' wall-clock ``ts`` aside), equal ``build_report``;
- aggregation: equal shard merges, and each package merges the other's
  shards;
- request traces and the Perfetto export: equal latency budgets and
  equal ``trace_events_from_spans`` of one span stream (a torn span
  included);
- time series on an injected clock: equal windows; equal anomalies from
  the same windows; equal incident bundles, correlations and offline
  reconstructions;
- reports: ``obs report`` and ``obs diff --gate`` give the same output
  and exit code in either package, each reading the other's run
  directory.

Comparisons are exact (``==``): both sides run the same Python and numpy
arithmetic on the same numbers.  The port-side rules ported from
``tests/test_obs.py``: span nesting and event order, an exception still
closes its span, no-session cost, no files from a non-zero process
index, and a failing ``configure`` keeps the previous session.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import json
import math
import os
import time

import numpy as np
import pytest

import torchpruner_tpu.obs as jobs
import torchpruner_tpu_torch.obs as tobs
from torchpruner_tpu.obs import aggregate as jagg
from torchpruner_tpu.obs import anomaly as janom
from torchpruner_tpu.obs import exporters as jexp
from torchpruner_tpu.obs import incident as jinc
from torchpruner_tpu.obs import ledger as jled
from torchpruner_tpu.obs import metrics as jmet
from torchpruner_tpu.obs import report as jrep
from torchpruner_tpu.obs import reqtrace as jreq
from torchpruner_tpu.obs import timeseries as jts
from torchpruner_tpu.obs import trace_export as jtx
from torchpruner_tpu_torch.obs import aggregate as tagg
from torchpruner_tpu_torch.obs import anomaly as tanom
from torchpruner_tpu_torch.obs import exporters as texp
from torchpruner_tpu_torch.obs import incident as tinc
from torchpruner_tpu_torch.obs import ledger as tled
from torchpruner_tpu_torch.obs import metrics as tmet
from torchpruner_tpu_torch.obs import report as trep
from torchpruner_tpu_torch.obs import reqtrace as treq
from torchpruner_tpu_torch.obs import timeseries as tts
from torchpruner_tpu_torch.obs import trace_export as ttx
from torchpruner_tpu_torch.obs.spans import SpanTracer

BOTH = (("jax", jmet, jexp, jled, jagg), ("torch", tmet, texp, tled, tagg))


@pytest.fixture(autouse=True)
def _clean_sessions():
    jobs.shutdown()
    tobs.shutdown()
    yield
    jobs.shutdown()
    tobs.shutdown()


def _drive_registry(reg):
    reg.counter("serve_requests_total", "requests submitted").inc(3)
    reg.counter("examples_total", "training examples").inc(2.5)
    reg.gauge("serve_queue_depth", "requests waiting").set(7)
    reg.gauge("mfu", "model-FLOPs utilization").set(float("nan"))
    h = reg.histogram("serve_ttft_seconds", "arrival -> first token")
    for v in (0.0004, 0.003, 0.02, 0.02, 1.5, 250.0):
        h.observe(v)
    reg.histogram("step_seconds").observe_n(0.01, 4)
    return reg


def _drive_steps(tel):
    tel.configure(flops_per_step=3e9, peak_flops=989e12)
    for dt, ex, tok in ((0.01, 32, 512), (0.012, 32, 512),
                        (0.011, 32, None), (0.5, 64, 1024)):
        tel.on_step(dt, ex, tok)
    tel.on_step(0.03, 96, 1536, steps=3)
    tel.on_grad_norm(1.25)
    return tel.derive()


# -- registry and exporters ---------------------------------------------------


def test_registry_prometheus_and_summary_table_byte_equal():
    out = {}
    for name, met, exp, _, _ in BOTH:
        reg = _drive_registry(met.MetricsRegistry())
        derived = _drive_steps(met.StepTelemetry(reg))
        phases = {"run": {"total_s": 2.0, "calls": 1, "compile_s": 0.5,
                          "compile_count": 2, "trace_count": 0},
                  "retrain": {"total_s": 1.25, "calls": 3,
                              "compile_s": 0.0, "compile_count": 0,
                              "trace_count": 0}}
        compiles = {"compile_count": 2, "compile_s": 0.5, "trace_count": 0,
                    "trace_s": 0.0, "lower_count": 1, "lower_s": 0.01}
        out[name] = (exp.prometheus_text(reg), derived,
                     exp.summary_table(phases, derived, compiles,
                                       total_wall_s=2.5))
    jt, jd, js = out["jax"]
    tt, td, ts = out["torch"]
    assert tt == jt
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert ts == js
    assert "serve_ttft_seconds_bucket" in tt


# -- the ledger ----------------------------------------------------------------


def _drive_ledger(led, rec):
    scores = np.random.default_rng(3).normal(size=64)
    drop = np.argsort(scores)[:16]
    rec.record_scores("block1_mlp/fc1", scores, method="Taylor", run=0,
                      layer="block1_mlp/fc1")
    rec.record_prune("block1_mlp/fc1", drop, 64)
    rec.record_round(target="block1_mlp/fc1", round=0, method="taylor",
                     policy="fraction", n_dropped=16, simulate=False,
                     score_dist=led.score_distribution(scores, drop),
                     pre={"loss": 0.7, "acc": 0.5},
                     post={"loss": 0.6, "acc": 0.55}, params=1234,
                     flops=5.5e6, widths={"block1_mlp/fc1": 48},
                     prune_time=0.01, runtime={"steps": 4})
    rec.record_round(target="block1_mlp/fc1", round=0)  # deduped
    rec.record_epoch(epoch=0, train_loss=0.9, test_loss=0.8, test_acc=0.6,
                     seconds=1.0)
    rec.record_sweep_layer(layer="conv1", eval_layer="conv1_relu",
                           methods={"taylor": {"auc_mean": 1.5}})
    rec.record({"event": "serve", "kind": "summary", "decode_steps": 9})
    return scores, drop


def test_score_distribution_and_ledger_records_equal(tmp_path):
    recs, dists, reports = {}, {}, {}
    for name, _, _, led, _ in BOTH:
        rec = led.ProvenanceRecorder(str(tmp_path / name))
        scores, drop = _drive_ledger(led, rec)
        dists[name] = led.score_distribution(scores, drop)
        rec.close()
        recs[name] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in led.load_ledger(
                          str(tmp_path / name / led.LEDGER_FILENAME))]
        reports[name] = led.build_report(
            run_meta={"experiment": "x"}, records=recs[name],
            derived={"steps": 4}, phases={}, compiles={}, metrics={},
            wall_s=1.0)
    assert dists["torch"] == dists["jax"]
    assert recs["torch"] == recs["jax"] and len(recs["jax"]) == 6
    assert json.dumps(reports["torch"], sort_keys=True) \
        == json.dumps(reports["jax"], sort_keys=True)


# -- aggregation -----------------------------------------------------------------


def _shard_registries(met):
    a = _drive_registry(met.MetricsRegistry())
    b = met.MetricsRegistry()
    b.counter("serve_requests_total").inc(4)
    b.gauge("serve_queue_depth").set(2)
    b.histogram("serve_ttft_seconds").observe(0.05)
    return a, b


def test_shard_merges_equal_and_cross_read(tmp_path):
    snaps = {}
    for name, met, _, _, agg in BOTH:
        a, b = _shard_registries(met)
        d = str(tmp_path / name)
        os.makedirs(d)
        agg.write_shard(a, d, 0)
        agg.write_shard(b, d, 1)
        snaps[name] = agg.merge_shards(agg.load_shards(d)).snapshot()
    assert json.dumps(snaps["torch"], sort_keys=True) \
        == json.dumps(snaps["jax"], sort_keys=True)
    assert snaps["jax"]["serve_requests_total"] == 7
    # each package merges the other's shards
    cross_t = tagg.merge_shards(tagg.load_shards(str(tmp_path / "jax")))
    cross_j = jagg.merge_shards(jagg.load_shards(str(tmp_path / "torch")))
    for snap in (cross_t.snapshot(), cross_j.snapshot()):
        assert json.dumps(snap, sort_keys=True) \
            == json.dumps(snaps["jax"], sort_keys=True)


# -- request traces and the Perfetto export ----------------------------------------


def test_reqtrace_latency_budget_equal():
    out = {}
    for name, met, mod in (("jax", jmet, jreq), ("torch", tmet, treq)):
        reg = met.MetricsRegistry()
        rng = np.random.default_rng(1)
        for _ in range(20):
            q, a, p = rng.uniform(0.0, 0.02, size=3)
            reg.histogram("reqtrace_stage_replica_queue_seconds") \
                .observe(q)
            reg.histogram("reqtrace_stage_admission_seconds").observe(a)
            reg.histogram("reqtrace_stage_prefill_seconds").observe(p)
            reg.histogram("reqtrace_stage_decode_seconds").observe(10 * p)
            reg.histogram("serve_ttft_seconds").observe(q + a + p)
        out[name] = mod.latency_budget(reg.snapshot())
    assert out["torch"] is not None
    assert json.dumps(out["torch"], sort_keys=True) \
        == json.dumps(out["jax"], sort_keys=True)


def _span_stream():
    evs = [{"event": "obs_init", "ts": 100.0, "pid": 7,
            "process_index": 0}]
    t = 100.0
    for i, (name, parent) in enumerate((("run", None), ("setup", "s0"),
                                        ("retrain", "s0"))):
        evs.append({"event": "span_begin", "span": f"s{i}", "name": name,
                    "parent": parent, "depth": 0 if parent is None else 1,
                    "ts": t + i, "tid": 11, "target": "fc1"})
        if name != "run":
            evs.append({"event": "span_end", "span": f"s{i}", "name": name,
                        "parent": parent, "depth": 1, "ts": t + i + 0.5,
                        "dur_s": 0.5, "tid": 11})
    # "run" never ends: a torn stream, closed synthetically
    evs.append({"event": "req_stage", "trace": "t1", "stage": "prefill",
                "ts": 101.2, "dur_s": 0.1, "pid": 7})
    return evs


def test_trace_export_of_one_span_stream_equal(tmp_path):
    evs = _span_stream()
    jt = jtx.trace_events_from_spans(evs)
    tt = ttx.trace_events_from_spans(evs)
    assert tt == jt and any(e.get("args", {}).get("torn") for e in tt)
    # the file writers agree too (no profile windows)
    for name, mod in (("jax", jtx), ("torch", ttx)):
        d = tmp_path / name
        d.mkdir()
        path = d / "events.jsonl"
        path.write_text("".join(json.dumps(e) + "\n" for e in evs))
        mod.write_trace(str(path))
    assert (tmp_path / "torch" / "trace.json").read_text() \
        == (tmp_path / "jax" / "trace.json").read_text()


# -- time series, anomalies, incidents -----------------------------------------------


def _record_series(met, ts_mod, d, clock):
    reg = met.MetricsRegistry()
    clock[0] = 1000.0
    rec = ts_mod.TimeseriesRecorder(reg, d, interval_s=1.0)
    t = 1000.0
    for w in range(6):
        reg.counter("serve_decode_steps_total").inc(10 + w)
        reg.gauge("serve_queue_depth").set(w % 3)
        for v in (0.01 * (w + 1), 0.02, 0.4 if w == 4 else 0.03):
            reg.histogram("serve_token_seconds").observe(v)
        t += 1.0
        assert rec.maybe_tick(now=t)
    assert not rec.maybe_tick(now=t + 0.5)  # not due
    clock[0] = t + 0.5
    rec.close()
    return ts_mod.load_series(d)


def test_timeseries_windows_equal_on_injected_clock(tmp_path, monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    out = {}
    for name, met, mod in (("jax", jmet, jts), ("torch", tmet, tts)):
        meta, windows = _record_series(met, mod, str(tmp_path / name),
                                       clock)
        out[name] = windows
        out[name + "_agg"] = mod.aggregate_windows(windows,
                                                   "serve_token_seconds")
        out[name + "_seg"] = mod.segment_percentiles(
            windows, "serve_token_seconds")
    assert len(out["jax"]) == 7  # six ticks and the forced final window
    for key in ("", "_agg", "_seg"):
        assert json.dumps(out["torch" + key], sort_keys=True) \
            == json.dumps(out["jax" + key], sort_keys=True)


def _windows():
    ws = []
    for i in range(14):
        sig = 100.0 if i in (9, 10, 11) else 10.0 + (i % 3)
        ws.append({"kind": "ts_window", "seq": i + 1, "ts": 100.0 + i,
                   "dur_s": 1.0, "gauges": {"sig_latency": sig},
                   "counters": {"serve_slo_breach_total": 1.0 if i == 10
                                else 0.0}})
    return ws


def test_anomalies_and_incident_bundles_equal(tmp_path):
    out = {}
    records = [{"event": "serve", "kind": "chaos_injection",
                "replica": "replica0", "ts": 990.0},
               {"event": "serve", "kind": "hot_swap", "ts": 960.0}]
    trigger = {"kind": "slo_burn", "ts": 1000.0, "metric": "token",
               "replica": "replica0", "burn_fast": 50.0,
               "burn_slow": 20.0}
    for name, anom, inc in (("jax", janom, jinc), ("torch", tanom, tinc)):
        det = anom.AnomalyDetector(gauge_prefixes=("sig_",), min_history=4,
                                   k=2, z_threshold=8.0)
        seen = [a for w in _windows() for a in det.observe_window(w)]
        out[name] = {
            "online": seen, "anomalies": det.anomalies,
            "offline": anom.detect_series(_windows(),
                                          gauge_prefixes=("sig_",),
                                          min_history=4, k=2,
                                          z_threshold=8.0),
            "incident": inc.assemble_incident(
                trigger, records, incident_id="inc-1", lookback_s=100.0),
            "correlated": inc.correlate(
                [trigger, dict(trigger, ts=1050.0),
                 {"kind": "anomaly", "ts": 5000.0, "anomaly_id": "anom-1",
                  "metric": "x_p99"}], records, lookback_s=100.0),
        }
        d = tmp_path / name
        d.mkdir()
        with open(d / jled.LEDGER_FILENAME, "w") as f:
            for r in records + [dict(trigger, event="serve",
                                     burn_ts=1000.0)]:
                f.write(json.dumps(r) + "\n")
        out[name]["run"] = inc.assemble_run_incidents(str(d),
                                                      lookback_s=100.0)
    assert out["jax"]["anomalies"]  # the planted spike opened one
    assert out["jax"]["incident"]["top_suspect"]["class"] \
        == "chaos_injection"
    assert json.dumps(out["torch"], sort_keys=True) \
        == json.dumps(out["jax"], sort_keys=True)


# -- reports: each package reads the other's run directory -----------------------


def _synthetic_run(obs_mod, d, scale=1.0):
    """A session with spans, steps, a serve summary and two rounds —
    the same calls in either package."""
    obs_mod.configure(d, process_index=0, annotate=False,
                      ts_interval_s=0)
    obs_mod.annotate_run(experiment="parity", kind="prune_retrain",
                         model="digits_fc", method="taylor")
    with obs_mod.span("run"):
        for i in range(4):
            obs_mod.record_step(0.01 * scale, 32)
        obs_mod.inc("serve_requests_total", 4)
        obs_mod.observe("serve_ttft_seconds", 0.02 * scale)
        obs_mod.gauge_set("serve_gen_tokens_per_s", 100.0 / scale)
        for r, target in enumerate(("fc1", "fc2")):
            scores = np.arange(10.0) * scale
            obs_mod.record_round(
                target=target, round=r, method="taylor", policy="fraction",
                n_dropped=3, simulate=False,
                score_dist=obs_mod.score_distribution(scores, [0, 1, 2]),
                pre={"loss": 0.5, "acc": 0.8},
                post={"loss": 0.5 * scale, "acc": 0.8 / scale},
                params=100 - 10 * r, flops=1e6, widths={target: 7},
                prune_time=0.1)
    obs_mod.shutdown()


def test_obs_report_and_diff_read_either_packages_run_dir(tmp_path,
                                                          capsys):
    dirs = {}
    for name, mod, scale in (("jax_a", jobs, 1.0), ("torch_a", tobs, 1.0),
                             ("torch_b", tobs, 1.3)):
        dirs[name] = str(tmp_path / name)
        _synthetic_run(mod, dirs[name], scale)
    gates = tmp_path / "gates.json"
    gates.write_text(json.dumps({
        "step_time_p50_s": {"max_increase_pct": 10.0},
        "round_post_acc": {"max_decrease": 0.01},
        "score_p50_drift": {"max": 0.5}, "missing_rounds": {"max": 0}}))

    def run(main, argv):
        rc = main(argv)
        return rc, capsys.readouterr().out

    for d in (dirs["jax_a"], dirs["torch_a"]):
        jr = run(jrep.obs_main, ["report", d])
        tr = run(trep.obs_main, ["report", d])
        assert tr == jr and jr[0] == 0 and "fc2" in jr[1]
        assert run(trep.obs_main, ["report", d, "--json"]) \
            == run(jrep.obs_main, ["report", d, "--json"])
    # the JAX run against the port's: same numbers, green gates
    argv = ["diff", dirs["jax_a"], dirs["torch_a"], "--gate", str(gates)]
    jd, td = run(jrep.obs_main, argv), run(trep.obs_main, argv)
    assert td == jd and jd[0] == 0
    # a slower, less accurate port run trips both gates in both readers
    argv = ["diff", dirs["jax_a"], dirs["torch_b"], "--gate", str(gates)]
    jd, td = run(jrep.obs_main, argv), run(trep.obs_main, argv)
    assert td == jd and jd[0] != 0


# -- port-side rules (tests/test_obs.py's own) ------------------------------------


def test_span_nesting_and_event_ordering():
    events = []
    tracer = SpanTracer(sink=events.append, annotate=True)
    with tracer.span("outer", run=1) as outer:
        assert tracer.current_id() == outer.id
        with tracer.span("inner") as inner:
            assert inner.parent == outer.id and inner.depth == 1
        with tracer.span("inner") as inner2:
            assert inner2.parent == outer.id
    assert tracer.current_id() is None
    assert [(e["event"], e["name"]) for e in events] == [
        ("span_begin", "outer"), ("span_begin", "inner"),
        ("span_end", "inner"), ("span_begin", "inner"),
        ("span_end", "inner"), ("span_end", "outer")]
    assert len({e["span"] for e in events}) == 3
    agg = tracer.phase_summary()
    assert agg["inner"]["calls"] == 2 and agg["outer"]["calls"] == 1


def test_span_exception_still_closes():
    tobs.configure(process_index=0)
    with pytest.raises(RuntimeError):
        with tobs.span("boom"):
            raise RuntimeError("x")
    assert tobs.current_span_id() is None
    assert tobs.get().tracer.phase_summary()["boom"]["calls"] == 1


def test_no_session_cost_and_hot_path_budget():
    """Without a session every hook is one global load and a None check
    (<= 20 µs a call, as the JAX package's budget); with one,
    ``record_step`` stays <= 100 µs."""
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        tobs.record_step(0.001, 32, 64)
        with tobs.span("x"):
            pass
        tobs.inc("c_total")
        tobs.profile_step(0.001)
    assert (time.perf_counter() - t0) / n < 20e-6
    tobs.configure(process_index=0, annotate=False, watch_compiles=False)
    tobs.record_step(0.001, 32, 64)
    t0 = time.perf_counter()
    for _ in range(n):
        tobs.record_step(0.001, 32, 64)
    assert (time.perf_counter() - t0) / n < 100e-6


def test_non_zero_process_index_emits_no_files(tmp_path):
    session = tobs.configure(str(tmp_path / "obs"), process_index=1)
    assert not session.is_emitter and session.profiler is None
    with tobs.span("phase"):
        assert tobs.current_span_id() is not None
    tobs.shutdown()
    assert not os.path.exists(tmp_path / "obs" / "events.jsonl")
    assert not os.path.exists(tmp_path / "obs" / "metrics.prom")
    # ...but its metric shard ships for process 0 to merge
    assert os.path.exists(tmp_path / "obs" / "metrics.shard1.json")


def test_process_zero_emits_files_and_rank_defaults_to_zero(tmp_path):
    session = tobs.configure(str(tmp_path / "obs"))
    assert session.process_index == 0  # no process group initialized
    with tobs.span("phase"):
        pass
    tobs.shutdown()
    events = [json.loads(l) for l in
              open(tmp_path / "obs" / "events.jsonl")]
    assert [e["event"] for e in events] == [
        "obs_init", "span_begin", "span_end", "run_summary"]
    prom = (tmp_path / "obs" / "metrics.prom").read_text()
    assert "compile_count_total 0" in prom.splitlines()


def test_configure_failure_keeps_previous_session(tmp_path):
    first = tobs.configure(str(tmp_path / "ok"))
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    with pytest.raises(OSError):
        tobs.configure(str(blocker / "obs"))
    assert tobs.get() is first


def test_compile_watcher_counts_kernel_builds_and_loads():
    """The port's compiles are ``ops/_build`` nvcc builds: a build charges
    compile_count / compile_seconds and the innermost span, a load the
    lower_* counters (fed here through the build hook)."""
    from torchpruner_tpu_torch.ops import _build

    session = tobs.configure(process_index=0)
    with tobs.span("setup") as sp:
        _build._report("build", "flash_attention", 2.5)
        _build._report("load", "flash_attention", 0.01)
    c = session.compiles.counts()
    assert c["compile_count"] == 1 and c["compile_s"] == 2.5
    assert c["lower_count"] == 1 and c["trace_count"] == 0
    assert c["by_executable"] == [{"name": "flash_attention", "count": 1,
                                   "seconds": 2.5}]
    assert sp.compile_count == 1 and sp.compile_s == 2.5
    tobs.shutdown()
    assert not _build.listeners  # unregistered at shutdown


def test_device_memory_and_peaks_are_none_on_the_cpu():
    from torchpruner_tpu_torch.utils import flops as F

    reg = tmet.MetricsRegistry()
    assert tmet.record_device_memory(reg) == {}
    assert F.peak_bf16_flops("cpu") is None
    assert F.peak_hbm_bw("cpu") is None
    # data-sheet H100 values by device name (the SXM part at 700 W)
    assert F.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert F.peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert F.peak_bf16_flops("NVIDIA H100 PCIe") == 756e12
    assert F.peak_bf16_flops("TPU v5e") is None
    # an unlisted H100 variant reads None, not the SXM part's peaks
    assert F.peak_bf16_flops("NVIDIA H100 NVL") is None
    assert F.peak_hbm_bw("NVIDIA H100 NVL") is None
    pos = F.roofline_position(2e12, 1e9, 1e-2, peak_flops=989e12,
                              peak_bw=3.35e12)
    assert pos["bound"] == "compute"
    assert math.isclose(pos["pct_peak_flops"], 100 * 2e14 / 989e12)
