"""The port's live campaign driver on the CPU: subprocess workers running
the real prune-retrain loop (the JAX package's ``_tiny_spec`` drills of
``tests/test_search.py``).

- the uninterrupted campaign through the CLI: 3 trials completed,
  ``t03_doomed_lr`` early-stopped, ``t04_over_budget`` excluded by
  ``cost``, provenance on every point, the frontier on disk consistent
  with its digest, the campaign's obs counters, each trial's stamped
  rounds, its worker log, and the CPU it ran on;
- the kill -9 drills through the CLI: the driver (and its workers)
  SIGKILLed after the second completion, and again right after an
  early-stop decision is recorded; each resumed campaign reproduces the
  uninterrupted campaign's ``frontier_digest``;
- a trial whose config has a mesh: its worker runs under ``torchrun``,
  two gloo ranks, done at its first attempt with rank 0's result.

Every worker computes on one thread (``OMP_NUM_THREADS=1``), so runs
reduce in the same order and their results are bit-equal.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import json
import os
import signal
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torchpruner_tpu_torch.search.driver import CampaignManifest  # noqa: E402
from torchpruner_tpu_torch.search.frontier import (  # noqa: E402
    frontier_digest,
)
from torchpruner_tpu_torch.search.grid import CampaignSpec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_spec() -> CampaignSpec:
    """The JAX package's reduced digits campaign: 3 healthy trials, one
    doomed (diverging LR, 4 epochs a round), one over budget."""
    return CampaignSpec(
        name="tiny_ci",
        base="mnist_mlp_shapley",
        smoke=True,
        common={"policy": "fraction", "finetune_epochs": 1, "lr": 0.05,
                "method_kwargs": {}},
        axes={"method": ["weight_norm"], "fraction": [0.25, 0.5, 0.75]},
        trials=[
            {"id": "doomed_lr", "method": "random", "fraction": 0.5,
             "finetune_epochs": 4, "lr": 3.0},
            {"id": "over_budget", "method": "weight_norm",
             "fraction": 0.5, "finetune_epochs": 512},
        ],
        jobs=2,
        early_stop={"margin": 0.15, "min_rounds": 1},
        max_trial_cost_ratio=16.0,
    )


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("spec") / "spec.json"
    path.write_text(json.dumps(_tiny_spec().to_dict()))
    return path


def _cli(spec_path, campaign_dir, *extra, check=True):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "torchpruner_tpu_torch", "search",
         str(spec_path), "--cpu", "--campaign-dir", str(campaign_dir),
         "--poll-s", "0.2", *extra],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    if check:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def reference(spec_path, tmp_path_factory):
    """The uninterrupted campaign: ``(campaign dir, frontier, stdout)``."""
    d = tmp_path_factory.mktemp("ref")
    r = _cli(spec_path, d)
    return d, json.load(open(d / "frontier.json")), r.stdout


def test_campaign_end_to_end(reference):
    from torchpruner_tpu_torch.obs.report import load_run

    d, fr, out = reference
    assert fr["counts"]["completed"] == 3
    assert fr["early_stopped"] == ["t03_doomed_lr"]
    assert [(e["trial_id"], e["excluded_by"]) for e in fr["excluded"]] == \
        [("t04_over_budget", "cost")]
    assert fr["campaign_id"] == _tiny_spec().campaign_id
    for p in fr["points"]:
        assert p["config"].get("fraction") in (0.25, 0.5, 0.75)
        assert p["checkpoint_digest"] and p["ledger_run_id"]
        assert p["accuracy"] is not None and p["flops"] > 0
        assert p["predicted_step_ms"] > 0
    assert frontier_digest(fr) == fr["frontier_digest"]
    assert fr["frontier_digest"][:12] in out
    rep = load_run(str(d / "obs"))
    assert rep["metrics"]["search_trials_early_stopped_total"] == 1
    assert rep["metrics"]["search_trials_completed_total"] == 3
    assert rep["metrics"]["frontier_points_total"] == 3
    assert rep["metrics"]["search_excluded_total"] == 1
    m = CampaignManifest.load(str(d))
    assert m.status == "done"
    done = sorted(t for t, st in m.trials.items() if st["status"] == "done")
    assert len(done) == 3
    for tid in done:
        tdir = d / "trials" / tid
        one = load_run(str(tdir / "obs"))
        assert one["rounds"] and all(
            r["trial_id"] == tid for r in one["rounds"])
        assert one["run"]["campaign_id"] == m.campaign_id
        assert (tdir / "worker.log").exists()
        assert json.load(open(tdir / "result.json"))["device"] == "cpu"
    assert m.trials["t03_doomed_lr"]["early_stop"]["at_points"] >= 1


def test_kill9_after_two_trials_resumes_to_the_same_frontier(
        reference, spec_path, tmp_path):
    _, ref, _ = reference
    killed = _cli(spec_path, tmp_path, "--chaos",
                  '{"kill_after_trials": 2}', check=False)
    assert killed.returncode == -signal.SIGKILL, (
        killed.returncode, killed.stderr[-2000:])
    m = CampaignManifest.load(str(tmp_path))
    assert sum(1 for s in m.trials.values() if s["status"] == "done") >= 2
    assert any(s["status"] in ("pending", "running")
               for s in m.trials.values())
    _cli(spec_path, tmp_path)
    got = json.load(open(tmp_path / "frontier.json"))
    assert got["frontier_digest"] == ref["frontier_digest"], (
        got["counts"], ref["counts"])
    assert CampaignManifest.load(str(tmp_path)).resumes == 1


def test_kill9_on_early_stop_resumes_to_the_same_frontier(
        reference, spec_path, tmp_path):
    _, ref, _ = reference
    killed = _cli(spec_path, tmp_path, "--chaos",
                  '{"kill_on_early_stop": true}', check=False)
    assert killed.returncode == -signal.SIGKILL
    m = CampaignManifest.load(str(tmp_path))
    assert any(s["status"] == "early_stop_requested"
               for s in m.trials.values()), \
        {t: s["status"] for t, s in m.trials.items()}
    _cli(spec_path, tmp_path)
    got = json.load(open(tmp_path / "frontier.json"))
    assert got["frontier_digest"] == ref["frontier_digest"]
    m = CampaignManifest.load(str(tmp_path))
    assert m.trials["t03_doomed_lr"]["status"] == "early_stopped"


def test_meshed_trial_runs_under_torchrun(tmp_path):
    """A trial on a ``{"data": 2}`` mesh: two ranks under ``torchrun``,
    rank 0 alone reads the run's outcome and writes the result (a rank
    that read the manifest before rank 0's last commit used to fail the
    attempt)."""
    from torchpruner_tpu_torch.experiments.presets import get_preset
    from torchpruner_tpu_torch.resilience.manifest import read_json

    base = get_preset("bert_glue_sensitivity", smoke=True)
    base.mesh = {"data": 2}
    base.finetune_epochs = 0
    base.to_json(str(tmp_path / "base.json"))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "name": "meshed", "base": str(tmp_path / "base.json"),
        "trials": [{"policy": "fraction", "fraction": 0.5}], "jobs": 1}))
    _cli(spec, tmp_path / "camp")  # a world of one refuses a 2-rank mesh
    m = CampaignManifest.load(str(tmp_path / "camp"))
    [(tid, st)] = m.trials.items()
    assert st["status"] == "done" and st["attempts"] == 1, st
    res = read_json(str(tmp_path / "camp" / "trials" / tid / "result.json"))
    assert res["rounds"] == 2 and res["device"] == "cpu"
    log = (tmp_path / "camp" / "trials" / tid / "worker.log").read_text()
    assert "ChildFailedError" not in log
