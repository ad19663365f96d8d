"""The telemetry plane wired into the port's serving engine, prune loop,
trainer, capture engine and CLI, against the JAX package's wiring on the
CPU.  Each package runs inside its own obs session.

- **Serving.**  Tiny Llama serves the same traffic in both packages
  (whole-bucket prefill; then chunked prefill with prefix pages): every
  ``serve_*`` counter equal, the latency histograms' and request-trace
  stages' observation counts equal, and each request's request-trace
  stage sequence equal.  The two engines use their own random weights:
  the schedule, and so every count, depends only on the traffic.
- **Prune loop.**  ``mnist_mlp_shapley`` (the JAX Shapley permutations)
  and ``bert_glue_sensitivity`` (BERT-tiny), both ``--smoke`` with 64
  examples a split, from the JAX initial weights: the ledger's ``round``
  records equal (score distributions within 1e-5 relative of the score span — both loops
  compute the same f32 scores, summed in other orders; losses and
  accuracies within 1e-4 as the loop parity tests hold them; FLOPs and
  timings left out: XLA's cost analysis and the port's FLOP counter
  count differently), and the spans' names and nesting equal.
- **Gradient norm.**  The ``grad_norm`` gauge of one step from the same
  params and batch within 1e-5 relative (f32 gradients, other summation
  orders).
- **Capture engine.**  The cached 8-method sweep of one layer: its
  capture counters and saved prefix FLOPs equal, its ``capture_fill`` span present in both,
  and the sweep ledger's AUCs within 1e-4 (as the capture tests hold
  them).
- **CLI.**  ``--obs-dir`` writes the run directory and ``obs report``
  renders it; ``--no-obs`` writes nothing; ``--profile-every`` needs
  ``--obs-dir``; the summary table goes to stderr even when the run
  crashes.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchpruner_tpu.obs as jobs
import torchpruner_tpu_torch.obs as tobs
from torchpruner_tpu.core import layers as JL
from torchpruner_tpu.core.segment import SegmentedModel as JModel
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.data import datasets as JD
from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.models import llama_tiny as j_llama_tiny
from torchpruner_tpu.obs import reqtrace as jreq
from torchpruner_tpu.serve.engine import ServeEngine as JEngine
from torchpruner_tpu.serve.traffic import open_loop as j_open_loop
from torchpruner_tpu.serve.traffic import (
    shared_prefix_requests as j_shared,
)
from torchpruner_tpu.serve.traffic import synthetic_requests as j_synth
from torchpruner_tpu.train.loop import Trainer as JTrainer
from torchpruner_tpu.utils.losses import cross_entropy_loss as j_ce
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch.__main__ import main as port_main
from torchpruner_tpu_torch.convert import model_from_reference
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.core.segment import init_model as p_init_model
from torchpruner_tpu_torch.data import datasets as PD
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.experiments import prune_retrain as PPR
from torchpruner_tpu_torch.models import llama_tiny as p_llama_tiny
from torchpruner_tpu_torch.obs import reqtrace as treq
from torchpruner_tpu_torch.serve.engine import ServeEngine as PEngine
from torchpruner_tpu_torch.serve.traffic import open_loop as p_open_loop
from torchpruner_tpu_torch.serve.traffic import (
    shared_prefix_requests as p_shared,
)
from torchpruner_tpu_torch.serve.traffic import synthetic_requests as p_synth
from torchpruner_tpu_torch.train import optim as PO
from torchpruner_tpu_torch.train.loop import Trainer as PTrainer
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce

from test_torch_port_capture import (
    jax_sweep,
    port_sweep,
    small_setup,
)
from test_torch_port_prune import jax_perms, torch_tree
from test_torch_port_robustness import feed_jax_draws


@pytest.fixture(autouse=True)
def _clean_sessions():
    jobs.shutdown()
    tobs.shutdown()
    yield
    jobs.shutdown()
    tobs.shutdown()
    jreq.reset()
    treq.reset()


def _events(d):
    with open(os.path.join(d, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _span_tree(events, keep=None):
    """``(name, parent name, depth, target)`` of every span, in order."""
    names = {}
    out = []
    for e in events:
        if e.get("event") != "span_begin":
            continue
        names[e["span"]] = e["name"]
        if keep is None or e["name"] in keep:
            out.append((e["name"], names.get(e.get("parent")),
                        e["depth"], e.get("target")))
    return out


# -- serving ------------------------------------------------------------------


SERVE_CASES = {
    # whole-bucket prefill, two slots recycled
    "bucketed": dict(engine=dict(n_slots=2, max_len=64),
                     traffic="synthetic"),
    # chunked prefill over prefix pages (chunk = page: both engines
    # accept it)
    "chunked_prefix": dict(engine=dict(n_slots=2, max_len=64, page_len=8,
                                       prefix_pages=8, prefill_chunk=8),
                           traffic="shared"),
}


def _requests(kind, synth, shared):
    if kind == "synthetic":
        reqs = synth(6, vocab=256, prompt_lens=[4, 9, 21],
                     max_new=[5, 8, 3], seed=3)
    else:
        reqs = shared(5, vocab=256, n_prefixes=2, prefix_len=16,
                      suffix_lens=[3, 5, 9], max_new=[6, 8], seed=11)
    # traced, as the fleet mints them; by position: request ids count
    # every request the process made
    for i, r in enumerate(reqs):
        r.trace_id = f"t{i}"
    return reqs


def _serve_package(name, d, case):
    spec = SERVE_CASES[case]
    if name == "jax":
        obs_mod, rt = jobs, jreq
        model = j_llama_tiny()
        params, _ = j_init_model(model, seed=0)
        eng = JEngine(model, params, cache_dtype=jnp.float32,
                      **spec["engine"])
        reqs = _requests(spec["traffic"], j_synth, j_shared)
        traffic = j_open_loop(reqs, stagger_steps=1)
    else:
        obs_mod, rt = tobs, treq
        model = p_llama_tiny()
        params, _ = p_init_model(model, seed=0, device="cpu")
        eng = PEngine(model, params, device="cpu", **spec["engine"])
        reqs = _requests(spec["traffic"], p_synth, p_shared)
        traffic = p_open_loop(reqs, stagger_steps=1)
    rt.reset(sample_every=1)  # every request's stages in the stream
    session = obs_mod.configure(d, process_index=0, ts_interval_s=0)
    summary = eng.run(traffic)
    snap = session.metrics.snapshot()
    obs_mod.shutdown()
    return summary, snap, _events(d)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serving_counters_histograms_and_request_stages_match_jax(
        case, tmp_path):
    out = {n: _serve_package(n, str(tmp_path / n), case)
           for n in ("jax", "torch")}
    (j_sum, j_snap, j_ev), (t_sum, t_snap, t_ev) = out["jax"], out["torch"]
    counters = {k for k in j_snap if k.startswith("serve_")
                and k.endswith("_total")}
    assert {"serve_requests_total", "serve_completed_total",
            "serve_decode_steps_total",
            "serve_prefill_tokens_total"} <= counters
    assert {k: t_snap.get(k) for k in counters} \
        == {k: j_snap[k] for k in counters}
    assert {k for k in t_snap if k.startswith("serve_")
            and k.endswith("_total")} == counters
    # histogram observation counts (the values are latencies)
    hists = [k[:-len("_count")] for k in j_snap if k.endswith("_count")
             and (k.startswith("serve_") or k.startswith("reqtrace_"))]
    assert "serve_ttft_seconds" in hists and "serve_token_seconds" in hists
    assert {h: t_snap.get(h + "_count") for h in hists} \
        == {h: j_snap[h + "_count"] for h in hists}
    assert {k: v for k, v in t_snap.items() if k.startswith("reqtrace_")
            and k.endswith("_total")} \
        == {k: v for k, v in j_snap.items() if k.startswith("reqtrace_")
            and k.endswith("_total")}
    # the engine's own summary agrees with its counters
    assert t_snap["serve_decode_steps_total"] == t_sum["decode_steps"]
    assert t_snap["serve_completed_total"] == t_sum["requests_completed"]
    assert t_snap["serve_prefill_tokens_total"] == t_sum["prefilled_tokens"]

    def stages(events):
        seq = {}
        for e in events:
            if e.get("event") == "req_stage":
                seq.setdefault(e["trace"], []).append(e["stage"])
        return seq

    seq = stages(t_ev)
    assert seq == stages(j_ev)
    assert all(s[-2:] == ["decode", "complete"] and "first_token" in s
               for s in seq.values())
    spans = [e["name"] for e in t_ev if e.get("event") == "span_begin"]
    want = "serve_prefill_chunk" if case == "chunked_prefix" \
        else "serve_prefill"
    assert spans.count(want) \
        == [e["name"] for e in j_ev
            if e.get("event") == "span_begin"].count(want) > 0


# -- the prune loop ---------------------------------------------------------------


LOOP_CASES = [pytest.param("mnist_mlp_shapley", None, id="mlp_shapley"),
              pytest.param("bert_glue_sensitivity", 0, id="bert_tiny")]

#: splits injected into both loops, (split, examples): the smoke
#: presets' test splits take most of the CPU time of a round's two
#: evaluations
LOOP_SPLITS = (("train", 64), ("val", 64), ("test", 64))


@pytest.mark.parametrize("preset,finetune", LOOP_CASES)
def test_prune_loop_ledger_rounds_and_spans_match_jax(preset, finetune,
                                                      tmp_path,
                                                      monkeypatch):
    over = {} if finetune is None else {"finetune_epochs": finetune}
    cfg_j = dataclasses.replace(JPS.get_preset(preset, smoke=True), **over,
                                log_path=str(tmp_path / "j.csv"))
    cfg_p = dataclasses.replace(PPS.get_preset(preset, smoke=True), **over,
                                log_path=str(tmp_path / "p.csv"))
    datasets = {pkg: tuple(load(cfg_j.dataset, s, n=n, seed=cfg_j.seed)
                           for s, n in LOOP_SPLITS)
                for pkg, load in (("jax", JD.load_dataset),
                                  ("port", PD.load_dataset))}
    jobs.configure(str(tmp_path / "jax"), process_index=0, ts_interval_s=0)
    with jobs.span("run"):
        j_hist = JPR.run_prune_retrain(cfg_j, verbose=False,
                                       datasets=datasets["jax"])
    jobs.shutdown()
    j_model = JPR.MODEL_REGISTRY[cfg_j.model][0]

    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jparams, jstate = j_init_model(j_model(), seed=seed)
        return torch_tree(jparams), torch_tree(jstate)

    def draw(self, n, S):
        self._calls += 1
        return jax_perms(self.seed, self._calls, n, S)

    monkeypatch.setattr(PS, "init_model", jax_init)
    monkeypatch.setattr(PA.ShapleyAttributionMetric, "_draw_perms", draw)
    tobs.configure(str(tmp_path / "torch"), process_index=0,
                   ts_interval_s=0)
    with tobs.span("run"):
        p_hist = PPR.run_prune_retrain(cfg_p, verbose=False, device="cpu",
                                       datasets=datasets["port"])
    tobs.shutdown()
    assert len(p_hist) == len(j_hist) == 2

    def rounds(d):
        with open(os.path.join(d, "ledger.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return [r for r in recs if r.get("event") == "round"]

    jr, tr = rounds(str(tmp_path / "jax")), rounds(str(tmp_path / "torch"))
    assert len(jr) == len(tr) == 2
    for t, j in zip(tr, jr):
        for key in ("target", "round", "method", "policy", "n_dropped",
                    "simulate", "params", "widths"):
            assert t[key] == j[key], key
        assert t["runtime"]["steps"] == j["runtime"]["steps"]
        for which in ("pre", "post"):
            for f in ("loss", "acc"):
                assert abs(t[which][f] - j[which][f]) <= 1e-4
        td, jd = t["score_dist"], j["score_dist"]
        assert td.keys() == jd.keys()
        span = max(abs(jd["max"] - jd["min"]), 1e-12)
        for k, v in jd.items():
            if isinstance(v, float):
                assert abs(td[k] - v) <= 1e-5 * span, k
            else:
                assert td[k] == v, k
    keep = {"run", "prune_retrain", "setup", "attribution", "eval",
            "prune", "plan", "apply_plan", "retrain", "flops"}
    t_tree = _span_tree(_events(str(tmp_path / "torch")), keep)
    assert t_tree == _span_tree(_events(str(tmp_path / "jax")), keep)
    assert t_tree[:3] == [("run", None, 0, None),
                          ("prune_retrain", "run", 1, None),
                          ("setup", "prune_retrain", 2, None)]


# -- the gradient norm ---------------------------------------------------------------


def test_grad_norm_gauge_matches_jax():
    jm = JModel((JL.Dense("fc1", 8), JL.Activation("r", "relu"),
                 JL.Dense("out", 3)), (6,))
    jparams, _ = j_init_model(jm, seed=0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=(8,)).astype(np.int32)
    pparams = torch_tree(jparams)  # before the JAX step donates jparams
    js = jobs.configure(process_index=0)
    jt = JTrainer.create(jm, optax.sgd(0.01), j_ce, params=jparams,
                         grad_norm=True)
    jt.step(jnp.asarray(x), jnp.asarray(y))
    want = js.metrics.get("grad_norm").value
    ts = tobs.configure(process_index=0)
    pt = PTrainer.create(model_from_reference(jm), PO.sgd(0.01), p_ce,
                         params=pparams, device="cpu", grad_norm=True)
    pt.step(x, y)
    got = ts.metrics.get("grad_norm").value
    assert want > 0 and abs(got - want) <= 1e-5 * want
    # the config field is no longer refused
    from torchpruner_tpu_torch.utils.config import ExperimentConfig

    assert "obs_grad_norm" not in " ".join(
        ExperimentConfig(obs_grad_norm=True).unported())


# -- the capture engine ---------------------------------------------------------------


def test_capture_counters_and_sweep_ledger_match_jax(tmp_path, monkeypatch):
    feed_jax_draws(monkeypatch)
    jm, jparams, jstate, pm, params, state, batches = small_setup()
    jobs.configure(str(tmp_path / "jax"), process_index=0, ts_interval_s=0)
    jax_sweep(jm, jparams, jstate, batches, layers=["fc1"])
    j_counts = jobs.capture_counts()
    jobs.shutdown()
    tobs.configure(str(tmp_path / "torch"), process_index=0,
                   ts_interval_s=0)
    port_sweep(pm, params, state, batches, capture=True, layers=["fc1"])
    t_counts = tobs.capture_counts()
    tobs.shutdown()
    # 11 scoring passes a layer (the panel's runs and the walk)
    assert t_counts == j_counts and t_counts["capture_hits"] == 11
    for d in ("jax", "torch"):
        assert "capture_fill" in [e["name"] for e in
                                  _events(str(tmp_path / d))
                                  if e.get("event") == "span_begin"]

    def layers(d):
        with open(os.path.join(str(tmp_path / d), "ledger.jsonl")) as f:
            return [r for r in map(json.loads, f)
                    if r.get("event") == "sweep_layer"]

    jl, tl = layers("jax"), layers("torch")
    assert [r["layer"] for r in tl] == [r["layer"] for r in jl]
    for t, j in zip(tl, jl):
        assert t["methods"].keys() == j["methods"].keys()
        for m in j["methods"]:
            assert t["methods"][m]["n_runs"] == j["methods"][m]["n_runs"]
            assert abs(t["methods"][m]["auc_mean"]
                       - j["methods"][m]["auc_mean"]) <= 1e-4


# -- the CLI -------------------------------------------------------------------------


def test_cli_obs_dir_no_obs_and_profile_flags(tmp_path, capsys):
    obs_dir = tmp_path / "obs"
    argv = ["--preset", "mnist_mlp_shapley", "--smoke", "--cpu"]
    assert port_main(argv + ["--obs-dir", str(obs_dir), "--profile-every",
                             "4", "--profile-steps", "2"]) == 0
    cap = capsys.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1])["steps"] == 2
    assert "observability summary" in cap.err
    for f in ("events.jsonl", "ledger.jsonl", "metrics.prom",
              "report.json", "trace.json", "profile.json"):
        assert (obs_dir / f).exists(), f
    profile = json.loads((obs_dir / "profile.json").read_text())
    assert len(profile["windows"]) >= 1 and profile["kernels"]
    tree = _span_tree(_events(str(obs_dir)), {"run", "prune_retrain"})
    assert tree[:2] == [("run", None, 0, None),
                        ("prune_retrain", "run", 1, None)]
    assert port_main(["obs", "report", str(obs_dir)]) == 0
    assert "mnist_mlp_shapley" in capsys.readouterr().out
    assert port_main(["obs", "profile", str(obs_dir)]) == 0
    assert "| kernel |" in capsys.readouterr().out
    # --no-obs: no session, no summary
    assert port_main(argv + ["--no-obs"]) == 0
    assert "observability summary" not in capsys.readouterr().err
    for bad in (["--profile-every", "4"],
                ["--no-obs", "--obs-dir", str(obs_dir)]):
        with pytest.raises(SystemExit):
            port_main(argv + bad)
        capsys.readouterr()


def test_cli_flushes_telemetry_when_the_run_crashes(tmp_path, capsys,
                                                    monkeypatch):
    def boom(cfg, device=None):
        with tobs.span("setup"):
            raise RuntimeError("planted")

    monkeypatch.setattr("torchpruner_tpu_torch.__main__.run_experiment",
                        boom)
    obs_dir = tmp_path / "obs"
    with pytest.raises(RuntimeError):
        port_main(["--preset", "mnist_mlp_shapley", "--smoke", "--cpu",
                   "--obs-dir", str(obs_dir)])
    assert "observability summary" in capsys.readouterr().err
    assert tobs.get() is None
    names = [e["name"] for e in _events(str(obs_dir))
             if e.get("event") == "span_end"]
    assert names == ["setup", "run"]
