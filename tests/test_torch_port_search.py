"""search/ of the port against the JAX package's, on the CPU.

- grid: trial ids, overrides, spec digests, campaign ids and the
  materialized trial configs of ``digits_smoke`` and of a JSON spec are
  the JAX package's;
- frontier: the JAX package's dominance / Pareto / rung-matched
  early-stop / artifact cases, run through both packages on the same
  inputs (equal flags, equal artifacts, equal digests, volatile fields
  ignored alike), its gauges and ledger record, the manifest;
- pricing: ``price_campaign`` in both packages (per trial ``feasible``,
  ``excluded_by``, the reasons' stage, the memory watermark, the queue
  order), the memory gate under ``TORCHPRUNER_PLAN_HBM_BYTES``, a dead
  ``layer_fractions`` key, a non-numeric fraction.  The port's cost
  stage is a roofline (ROADMAP C2z): its milliseconds differ, its
  decisions may not;
- the CLI: ``search --report`` renders a frontier, ``search`` without a
  campaign is refused.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from torchpruner_tpu.search import driver as JD  # noqa: E402
from torchpruner_tpu.search import frontier as JF  # noqa: E402
from torchpruner_tpu.search import grid as JG  # noqa: E402
from torchpruner_tpu.search import pricing as JP  # noqa: E402
from torchpruner_tpu_torch.search import driver as PD  # noqa: E402
from torchpruner_tpu_torch.search import frontier as PF  # noqa: E402
from torchpruner_tpu_torch.search import grid as PG  # noqa: E402
from torchpruner_tpu_torch.search import pricing as PP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_spec(G):
    """A JSON-file campaign beside the preset: an explicit layerwise
    grid over taylor and weight norm with a target filter."""
    return G.CampaignSpec.from_any({
        "name": "json_grid", "base": "mnist_mlp_shapley", "smoke": True,
        "common": {"policy": "fraction", "finetune_epochs": 1},
        "axes": {"method": ["taylor", "weight_norm"],
                 "layer_fractions": [{"fc1": 0.25}, {"fc2": 0.5}]},
        "trials": [{"id": "filtered", "target_filter": ["fc1"],
                    "fraction": 0.3, "seed": 3}],
        "jobs": 3, "max_trial_cost_ratio": 4.0,
    })


# -- grid ---------------------------------------------------------------------


@pytest.mark.parametrize("which", ["digits_smoke", "json"])
def test_grid_equals_jax(which, tmp_path):
    if which == "digits_smoke":
        j, p = JG.digits_smoke(), PG.digits_smoke()
        assert p.campaign_id == "digits_smoke-549f2cee"
    else:
        path = tmp_path / "spec.json"
        path.write_text(json.dumps(_json_spec(JG).to_dict()))
        j = JG.CampaignSpec.from_any(str(path))
        p = PG.CampaignSpec.from_any(str(path))
    assert p.to_dict() == j.to_dict()
    assert p.digest() == j.digest() and p.campaign_id == j.campaign_id
    jt, pt = j.enumerate_trials(), p.enumerate_trials()
    assert [(t.trial_id, t.overrides) for t in pt] == \
        [(t.trial_id, t.overrides) for t in jt]
    assert [t.label() for t in pt] == [t.label() for t in jt]
    for a, b in zip(jt, pt):
        jc = j.trial_config(a, str(tmp_path / a.trial_id))
        pc = p.trial_config(b, str(tmp_path / b.trial_id))
        for f in ("name", "model", "dataset", "experiment", "method",
                  "method_kwargs", "policy", "fraction", "layer_fractions",
                  "target_filter", "finetune_epochs", "lr", "seed",
                  "batch_size", "run_dir", "log_path",
                  "checkpoint_every_steps"):
            assert getattr(pc, f) == getattr(jc, f), (a.trial_id, f)


def test_grid_identity_and_refusals():
    spec = PG.digits_smoke()
    assert dataclasses.replace(spec, jobs=7).digest() == spec.digest()
    assert dataclasses.replace(spec, trial_devices=2).digest() == \
        spec.digest()
    assert dataclasses.replace(spec, axes={}).digest() != spec.digest()
    bad = PG.CampaignSpec(name="x", axes={"not_a_field": [1, 2]})
    with pytest.raises(ValueError, match="not_a_field"):
        bad.enumerate_trials()
    with pytest.raises(KeyError, match="digits_smoke"):
        PG.CampaignSpec.from_any("no_such_campaign")
    with pytest.raises(ValueError, match="unknown campaign keys"):
        PG.CampaignSpec.from_any({"name": "x", "nope": 1})


# -- dominance and the frontier -----------------------------------------------

DOMINATES = [
    ((10, 0.9), (10, 0.8), 0.0), ((5, 0.8), (10, 0.8), 0.0),
    ((10, 0.8), (10, 0.8), 0.0), ((11, 0.95), (10, 0.8), 0.0),
    ((10, 0.81), (10, 0.80), 0.02), ((10, 0.83), (10, 0.80), 0.02),
    ((5, 0.80), (10, 0.80), 0.02),
]


def test_dominates_equals_jax():
    got = [PF.dominates(q, p, margin=m) for q, p, m in DOMINATES]
    assert got == [JF.dominates(q, p, margin=m) for q, p, m in DOMINATES]
    assert got == [True, True, False, False, False, True, True]


@pytest.mark.parametrize("seed", range(3))
def test_pareto_flags_equal_jax_and_order_independent(seed):
    rng = np.random.default_rng(seed)
    pts = [(float(f), float(a)) for f, a in rng.uniform(0, 1, size=(40, 2))]
    flags = PF.pareto_flags(pts, margin=0.03)
    assert flags == JF.pareto_flags(pts, margin=0.03)
    perm = list(pts)
    np.random.default_rng(seed + 10).shuffle(perm)
    base = dict(zip(pts, flags))
    assert [base[p] for p in perm] == PF.pareto_flags(perm, margin=0.03)
    near = [(10.0, 0.90), (10.0, 0.89), (10.0, 0.80)]
    assert PF.pareto_flags(near, margin=0.02) == [True, True, False]


CURVES = [
    ([(20.0, 0.4)], [[(20.0, 0.45), (5.0, 0.9)]], 0.1, 1),
    ([(20.0, 0.1)], [[(20.0, 0.45), (5.0, 0.9)]], 0.1, 1),
    ([(20.0, 0.2), (5.0, 0.85)], [[(20.0, 0.8), (5.0, 0.9)]], 0.1, 1),
    ([(20.0, 0.2), (5.0, 0.5)], [[(20.0, 0.8), (5.0, 0.9)]], 0.1, 1),
    ([(10.0, 0.4)], [[(10.0, 0.5)]], 0.1, 1),
    ([(10.0, 0.39)], [[(10.0, 0.5)]], 0.1, 1),
    ([], [[(10.0, 0.9)]], 0.1, 1),
    ([(10.0, 0.1)], [], 0.1, 1),
    ([(10.0, 0.1)], [[(10.0, 0.9)]], 0.1, 2),
    ([(10.0, 0.1), (5.0, 0.1)], [[(10.0, 0.9)]], 0.1, 1),
    ([(8.0, 0.1)], [[(10.0, 0.9)]], 0.1, 1),
]


def test_curve_dominated_equals_jax():
    got = [PF.curve_dominated(p, c, margin=m, min_points=k)
           for p, c, m, k in CURVES]
    assert got == [JF.curve_dominated(p, c, margin=m, min_points=k)
                   for p, c, m, k in CURVES]
    assert got == [False, True, False, True, False, True, False, False,
                   False, False, False]


def _fake(D, G):
    spec = G.digits_smoke()
    manifest = D.CampaignManifest(
        name=spec.name, campaign_id=spec.campaign_id,
        spec_digest=spec.digest(),
        trials={
            "t0": {"overrides": {"fraction": 0.25}, "status": "done",
                   "pricing": {"predicted_step_ms": 0.03,
                               "predicted_trial_s": 1.0}},
            "t1": {"overrides": {"fraction": 0.5}, "status": "done"},
            "t2": {"overrides": {"fraction": 0.5, "lr": 3.0},
                   "status": "early_stopped"},
            "t3": {"overrides": {"finetune_epochs": 512},
                   "status": "excluded",
                   "pricing": {"excluded_by": "cost",
                               "reasons": ["512x the median"]}},
        })
    results = {
        "t0": {"final_acc": 0.9, "final_loss": 0.3, "params": 5962,
               "flops": 24000.0, "rounds": 2, "checkpoint": "ckpt-000002",
               "checkpoint_digest": "abc123", "ledger_run_id": "c:t0",
               "curve": [[30000.0, 0.5], [24000.0, 0.9]],
               "step_time_mean_s": 0.001, "wall_s": 5.0},
        "t1": {"final_acc": 0.6, "final_loss": 0.9, "params": 3466,
               "flops": 14000.0, "rounds": 2, "checkpoint": "ckpt-000002",
               "checkpoint_digest": "def456", "ledger_run_id": "c:t1",
               "curve": [[20000.0, 0.4], [14000.0, 0.6]],
               "step_time_mean_s": 0.001, "wall_s": 5.0},
    }
    return spec, manifest, results


def _both_frontiers(mutate=None):
    out = []
    for D, F, G in ((JD, JF, JG), (PD, PF, PG)):
        spec, manifest, results = _fake(D, G)
        if mutate:
            mutate(results)
        out.append(F.build_frontier(spec=spec, manifest=manifest,
                                    results=results, dense_flops=32000.0,
                                    margin=0.02))
    return out


def test_build_frontier_equals_jax():
    j, p = _both_frontiers()
    assert p == j
    assert p["counts"] == {"trials": 4, "completed": 2, "non_dominated": 2,
                           "dominated": 0, "early_stopped": 1,
                           "excluded": 1, "failed": 0}
    assert p["buckets"]["frontier_best_acc_flops_le_50pct"] == 0.6
    assert PF.frontier_digest(p) == JF.frontier_digest(j) \
        == p["frontier_digest"]
    assert PF.format_frontier(p) == JF.format_frontier(j)
    pts = [{"accuracy": 0.9, "flops": 80.0}, {"accuracy": 0.7,
                                               "flops": 40.0}]
    assert PF.bucket_scalars(pts, 100.0, [0.25, 0.5, 1.0]) == \
        JF.bucket_scalars(pts, 100.0, [0.25, 0.5, 1.0])


@pytest.mark.parametrize("change,same", [
    ({"wall_s": 99.0, "step_time_mean_s": 0.5,
      "checkpoint": "ckpt-000007", "obs_dir": "/elsewhere"}, True),
    ({"final_acc": 0.91}, False),
    ({"checkpoint_digest": "zzz"}, False),
])
def test_frontier_digest_volatile_fields_like_jax(change, same):
    base_j, base_p = _both_frontiers()

    def mutate(results):
        results["t0"] = dict(results["t0"], **change)

    j, p = _both_frontiers(mutate)
    assert p["frontier_digest"] == j["frontier_digest"]
    assert (p["frontier_digest"] == base_p["frontier_digest"]) is same
    assert (j["frontier_digest"] == base_j["frontier_digest"]) is same


def test_frontier_gauges_ledger_and_write(tmp_path):
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.obs.report import format_report, load_run
    from torchpruner_tpu_torch.resilience.manifest import read_json

    _, fr = _both_frontiers()
    PF.write_frontier(fr, str(tmp_path / "frontier.json"))
    assert read_json(str(tmp_path / "frontier.json")) == fr
    obs.configure(str(tmp_path / "obs"))
    try:
        PF.record_obs(fr)
        assert obs.counter_value("frontier_points_total") == 2
        assert obs.counter_value("frontier_early_stopped_total") == 1
        assert obs.counter_value("frontier_best_acc_flops_le_50pct") == 0.6
    finally:
        obs.shutdown()
    rep = load_run(str(tmp_path / "obs"))
    assert rep["frontier"] and rep["metrics"]["frontier_best_acc"] == 0.9
    md = format_report(rep)
    assert "frontier: 2 point(s), 2 non-dominated" in md
    assert "<=50pct=0.6" in md


def test_campaign_manifest_crosses_packages(tmp_path):
    m = PD.CampaignManifest(name="x", campaign_id="x-1", spec_digest="d",
                            trials={"t0": {"status": "pending"}})
    m.save(str(tmp_path))
    assert JD.CampaignManifest.load(str(tmp_path)) == \
        JD.CampaignManifest(**dataclasses.asdict(m))
    bad = dataclasses.replace(m, kind="serve")
    bad.save(str(tmp_path))
    with pytest.raises(ValueError, match="search"):
        PD.CampaignManifest.load(str(tmp_path))


def test_run_campaign_refuses_grid_mismatch(tmp_path):
    spec = PG.digits_smoke()
    PD.CampaignManifest(name=spec.name, campaign_id=spec.campaign_id,
                        spec_digest="somethingelse").save(str(tmp_path))
    with pytest.raises(ValueError, match="different grid"):
        PD.run_campaign(spec, str(tmp_path), jobs=1, cpu=True)


def test_chaos_and_worker_env(tmp_path):
    assert PD.SearchChaos.from_any('{"kill_after_trials": 2}') == \
        PD.SearchChaos(kill_after_trials=2)
    with pytest.raises(ValueError, match="unknown search chaos"):
        PD.SearchChaos.from_any({"nope": 1})
    spec = dataclasses.replace(PG.digits_smoke(), trial_devices=2)
    env = PD._worker_env(spec, 1, cpu=False)
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert PD._worker_env(PG.digits_smoke(), 1, cpu=False) == \
        dict(os.environ)
    assert PD._worker_env(spec, 1, cpu=True) == dict(os.environ)
    # a trial whose config has a mesh runs under torchrun, one rank a
    # device of the mesh
    meshed = PG.CampaignSpec.from_any({
        "name": "m", "base": "bert_glue_sensitivity", "smoke": True,
        "trials": [{"fraction": 0.5}]})
    tid = meshed.enumerate_trials()[0].trial_id
    cmd = PD._worker_cmd(meshed, str(tmp_path), tid, {}, cpu=True)
    assert cmd[1:3] == ["-m", "torchpruner_tpu_torch"] and "--cpu" in cmd
    base = meshed.base_config()
    mesh_cfg = tmp_path / "mesh.json"
    base.mesh = {"data": 2}
    base.to_json(str(mesh_cfg))
    meshed = dataclasses.replace(meshed, base=str(mesh_cfg))
    cmd = PD._worker_cmd(meshed, str(tmp_path), tid, {}, cpu=True)
    assert cmd[1:5] == ["-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=2"]
    assert cmd[5:7] == ["-m", "torchpruner_tpu_torch"]


# -- pricing ------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_pricings(tmp_path_factory):
    out = {}
    for name, G, P in (("jax", JG, JP), ("port", PG, PP)):
        spec = G.digits_smoke()
        out[name] = P.price_campaign(spec, spec.enumerate_trials(),
                                     str(tmp_path_factory.mktemp(name)))
    return out["jax"], out["port"]


def _decisions(pricing):
    return {tid: (p["feasible"], p["excluded_by"], len(p["reasons"]),
                  p.get("n_rounds"), p.get("predicted_hbm_bytes_per_chip"),
                  p.get("steps_per_epoch"))
            for tid, p in pricing.items()}


def _queue(pricing):
    return sorted((t for t, p in pricing.items() if not p["excluded_by"]),
                  key=lambda t: (pricing[t].get("predicted_trial_s")
                                 or float("inf"), t))


def test_pricing_decisions_equal_jax(both_pricings):
    j, p = both_pricings
    assert _decisions(p) == _decisions(j)
    assert _queue(p) == _queue(j)
    victim = "t08_over_budget"
    assert p[victim]["excluded_by"] == "cost"
    assert "median" in p[victim]["reasons"][0]
    assert f"- `{victim}` [cost]:" in PP.format_exclusions(p)
    ok = [v for v in p.values() if not v["excluded_by"]]
    assert len(ok) == 8
    assert {v["predicted_hbm_bytes_per_chip"] for v in ok} == {105808}
    # one program shape: one roofline shared by every survivor
    assert len({v["predicted_step_ms"] for v in ok}) == 1
    assert {v["bound"] for v in ok} == {"compute"}
    assert {v["predicted_comm_ms"] for v in ok} == {None}


def test_pricing_roofline_is_the_train_step_count():
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments.presets import MODEL_REGISTRY
    from torchpruner_tpu_torch.utils.flops import (
        CPU_COST_DEFAULTS,
        model_cost,
        train_step_roofline,
    )

    spec = PG.digits_smoke()
    cfg = spec.base_config()
    model = MODEL_REGISTRY[cfg.model][0]()
    params, state = init_model(model, device="cpu")
    _, flops = model_cost(model, params, state, batch_size=cfg.batch_size)
    r = train_step_roofline(flops, 105808)
    assert r["compute_ms"] == pytest.approx(
        3 * flops / CPU_COST_DEFAULTS["flops"] * 1e3)
    assert r["memory_ms"] == pytest.approx(
        105808 / CPU_COST_DEFAULTS["hbm"] * 1e3)
    assert r["step_ms"] == max(r["compute_ms"], r["memory_ms"])
    assert train_step_roofline(1.0, 1e12)["bound"] == "hbm"


def test_pricing_hbm_gate_via_env_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHPRUNER_PLAN_HBM_BYTES", "1024")
    got = []
    for G, P in ((JG, JP), (PG, PP)):
        spec = G.digits_smoke()
        pricing = P.price_campaign(spec, spec.enumerate_trials()[:2],
                                   str(tmp_path))
        got.append(_decisions(pricing))
        for p in pricing.values():
            assert p["excluded_by"] == "hbm"
            assert any("watermark" in r for r in p["reasons"])
    assert got[1] == got[0]


@pytest.mark.parametrize("case", ["dead_layer_fraction", "non_numeric"])
def test_pricing_config_gate_equals_jax(case, tmp_path):
    trials = {
        "dead_layer_fraction": [
            ("t00_dead", {"policy": "fraction",
                          "layer_fractions": {"conv9": 0.5}}),
            ("t01_bad_frac", {"policy": "fraction", "fraction": 1.5})],
        "non_numeric": [
            ("t00_null_frac", {"policy": "fraction", "fraction": None}),
            ("t01_ok", {"policy": "fraction", "fraction": 0.5})],
    }[case]
    got = []
    for G, P in ((JG, JP), (PG, PP)):
        pricing = P.price_campaign(
            G.digits_smoke(), [G.TrialSpec(t, o) for t, o in trials],
            str(tmp_path))
        got.append((_decisions(pricing),
                    {t: p["reasons"] for t, p in pricing.items()
                     if p["excluded_by"] == "config"}))
    assert got[1] == got[0]
    first = got[1][0][trials[0][0]]
    assert first[1] == "config"


# -- CLI ----------------------------------------------------------------------


def test_search_report_cli(tmp_path, capsys):
    from torchpruner_tpu_torch.__main__ import main

    _, fr = _both_frontiers()
    PF.write_frontier(fr, str(tmp_path / "frontier.json"))
    assert main(["search", "--report", "--campaign-dir",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.strip() == PF.format_frontier(fr).strip()
    assert main(["search", "--report", "--frontier-out",
                 str(tmp_path / "frontier.json")]) == 0
    with pytest.raises(SystemExit):
        main(["search"])
    with pytest.raises(SystemExit):
        main(["search", "--run-trial", "t00"])
