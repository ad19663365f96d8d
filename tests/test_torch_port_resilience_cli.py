"""Kill, preempt and resume the port's runs through its CLI, on the CPU.

The CLI itself is the worker: ``python -m torchpruner_tpu_torch
--config ... --cpu --resume DIR`` runs uninterrupted (U), killed by the
chaos module's SIGKILL (K: the child's return code is -9) and resumed
with the same command without ``--chaos`` (R).  Every child runs with
two CPU threads, so U and R reduce in the same order.

- ``train`` on the digits MLP killed mid-epoch: R's final checkpoint
  (params, optimizer state) is U's bit for bit (equal digests), and its
  generator state too;
- ``bert_glue_sensitivity --smoke`` (``finetune_epochs`` 1, batch 64)
  killed in its second target's retrain: R scores nothing again (no
  ``attribution`` span), its records equal U's and its final params are
  U's bit for bit; the widths equal the JAX loop's from the JAX initial
  weights;
- the robustness sweep preempted after its first layer (the
  ``PreemptionHandler`` flag, as the JAX package's test sets it), then
  resumed: its curves equal the uninterrupted sweep's;
- a corrupted checkpoint: the resume fails with
  ``CheckpointCorruptError`` and a non-zero exit.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import json
import os
import signal
import subprocess
import sys

from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu_torch.__main__ import main as p_main
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.resilience import runner as prunner
from torchpruner_tpu_torch.resilience.manifest import RunManifest, read_json
from torchpruner_tpu_torch.utils.config import ExperimentConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(cfg_path, run_dir, *extra, wait=True):
    """The port's CLI on the CPU in a child process (two threads)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("TORCHPRUNER_CHAOS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchpruner_tpu_torch", "--config",
         cfg_path, "--cpu", "--resume", str(run_dir), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    return _finish(proc) if wait else proc


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def _final(run_dir):
    m = RunManifest.load(str(run_dir))
    return m, read_json(os.path.join(str(run_dir), m.checkpoint,
                                     "spec.json"))


def _kill_resume(cfg_path, tmp_path, kill_at, *extra, r_extra=(),
                 meanwhile=lambda: None):
    """U and K side by side (``meanwhile()`` runs here while they do),
    then R (with ``r_extra`` too); returns the three results."""
    u = _cli(cfg_path, tmp_path / "u", *extra, wait=False)
    k = _cli(cfg_path, tmp_path / "k", "--chaos",
             json.dumps({"kill_at_step": kill_at}), *extra, wait=False)
    meanwhile()
    u, k = _finish(u), _finish(k)
    assert u[0] == 0, u[2][-3000:]
    assert k[0] == -signal.SIGKILL, (k[0], k[2][-3000:])
    m = RunManifest.load(str(tmp_path / "k"))
    assert m.checkpoint and m.status == "running" and m.step < kill_at
    r = _cli(cfg_path, tmp_path / "k", *extra, *r_extra)
    assert r[0] == 0, r[2][-3000:]
    return u, k, r


def test_train_killed_and_resumed_ends_bit_equal(tmp_path):
    cfg = ExperimentConfig(
        name="res_cli", model="digits_fc_tiny", dataset="digits_flat",
        experiment="train", epochs=2, batch_size=32, eval_batch_size=64,
        lr=0.05, checkpoint_every_steps=10,
        log_path=str(tmp_path / "log.csv"))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    u, _, r = _kill_resume(path, tmp_path, 55, "--no-obs")
    mu, su = _final(tmp_path / "u")
    mk, sk = _final(tmp_path / "k")
    assert (mk.status, mk.resumes, mk.step) == ("done", 1, mu.step)
    assert sk["digest"] == su["digest"]  # params and optimizer state
    assert sk["extra"]["rng"] == su["extra"]["rng"]
    assert [e["test_loss"] for e in mk.records] == \
        [e["test_loss"] for e in mu.records]
    assert json.loads(r[1].splitlines()[-1]) == \
        json.loads(u[1].splitlines()[-1])
    assert "resumed from ckpt-" in r[1]


def _span_names(obs_dir):
    with open(os.path.join(obs_dir, "events.jsonl")) as f:
        return [e["name"] for e in map(json.loads, f)
                if e.get("event") == "span_begin"]


def test_prune_loop_killed_mid_retrain_resumes_to_the_same_records(
        tmp_path):
    over = {"finetune_epochs": 1, "batch_size": 64}
    cfg = dataclasses.replace(PPS.get_preset("bert_glue_sensitivity", True),
                              **over, log_path=str(tmp_path / "log.csv"))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    jcfg = dataclasses.replace(JPS.get_preset("bert_glue_sensitivity", True),
                               **dict(over, finetune_epochs=0),
                               log_path=str(tmp_path / "jax.csv"))
    jhist = []
    # 10,000 training examples: 157 steps a round; the kill lands in the
    # second target's retrain
    _, _, r = _kill_resume(
        path, tmp_path, 157 + 80,
        r_extra=("--obs-dir", str(tmp_path / "obs")),
        meanwhile=lambda: jhist.extend(JPR.run_prune_retrain(
            jcfg, verbose=False)))
    mu, su = _final(tmp_path / "u")
    mk, sk = _final(tmp_path / "k")
    assert (mk.status, mk.resumes, len(mk.records)) == ("done", 1, 2)
    # every field but the prune's wall time, floats bit for bit
    assert [dict(r, prune_time=0) for r in mk.records] == \
        [dict(r, prune_time=0) for r in mu.records]
    assert sk["digest"] == su["digest"] and sk["widths"] == su["widths"]
    # R resumed at the second target's retrain anchor: no scoring
    names = _span_names(str(tmp_path / "obs"))
    assert "resume" in names and "retrain" in names
    assert "attribution" not in names
    assert r[1].count("pruned ") == 1
    assert [r["widths"] for r in mk.records] == [h.widths for h in jhist]
    assert [r["n_dropped"] for r in mk.records] == \
        [h.n_dropped for h in jhist]


def test_sweep_preempted_after_its_first_layer_resumes_to_the_same_curves(
        tmp_path, monkeypatch, capsys):
    def cfg(name):
        return ExperimentConfig(
            name="res_sweep", model="digits_fc_tiny", dataset="digits_flat",
            experiment="robustness", method="taylor", score_examples=48,
            eval_batch_size=48, results_path=str(tmp_path / f"{name}.json"),
            log_path=str(tmp_path / "log.csv"))

    def run(name, run_dir):
        path = str(tmp_path / f"{name}_cfg.json")
        cfg(name).to_json(path)
        assert p_main(["--config", path, "--cpu", "--no-obs", "--resume",
                       str(tmp_path / run_dir)]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    full = run("full", "u")
    real_init = prunner.SweepJournal.__init__

    def preempting(self, c):
        real_init(self, c)
        self.pre.request()  # SIGTERM's flag, before the first layer ends

    monkeypatch.setattr(prunner.SweepJournal, "__init__", preempting)
    run("cut", "k")
    m = RunManifest.load(str(tmp_path / "k"))
    assert m.status == "preempted" and m.completed == ["fc1"]
    assert not os.path.exists(tmp_path / "cut.json")
    monkeypatch.setattr(prunner.SweepJournal, "__init__", real_init)
    resumed = run("cut", "k")
    m = RunManifest.load(str(tmp_path / "k"))
    assert m.status == "done" and m.resumes == 1
    assert m.completed == ["fc1", "fc2"]
    assert resumed == full
    def curves(name):
        res = read_json(str(tmp_path / f"{name}.json"))["results"]
        return {layer: {m: [{k: v for k, v in r.items() if k != "seconds"}
                            for r in runs] for m, runs in methods.items()}
                for layer, methods in res.items()}

    assert curves("cut") == curves("full")  # every curve, exactly


def test_corrupted_checkpoint_is_refused_on_resume(tmp_path):
    kw = dict(name="res_corrupt", model="digits_fc_tiny",
              dataset="digits_flat", experiment="train", epochs=1,
              batch_size=32, eval_batch_size=64, lr=0.05,
              log_path=str(tmp_path / "log.csv"))
    path = str(tmp_path / "cfg.json")
    # the run's one commit (the epoch's end) is corrupted after its write
    ExperimentConfig(**kw, chaos={"corrupt_checkpoint": True}).to_json(path)
    rc, _, err = _cli(path, tmp_path / "run", "--no-obs")
    assert rc == 0, err[-3000:]
    ExperimentConfig(**dict(kw, epochs=2)).to_json(path)
    rc, out, err = _cli(path, tmp_path / "run", "--no-obs")
    assert rc != 0
    assert "CheckpointCorruptError" in err and "digest" in err
    m = RunManifest.load(str(tmp_path / "run"))
    assert m.resumes == 0 and m.epoch == 1  # nothing silently restored


def test_train_then_sweep_journals_each_phase_in_its_own_directory(
        tmp_path, capsys, monkeypatch):
    cfg = ExperimentConfig(
        name="res_two_phase", model="digits_fc_tiny", dataset="digits_flat",
        experiment="train_robustness", epochs=1, batch_size=32, lr=0.05,
        method="weight_norm", score_examples=48, eval_batch_size=48,
        log_path=str(tmp_path / "log.csv"))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    argv = ["--config", path, "--cpu", "--no-obs", "--resume",
            str(tmp_path / "run")]
    assert p_main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    train = RunManifest.load(str(tmp_path / "run" / "train"))
    sweep = RunManifest.load(str(tmp_path / "run" / "sweep"))
    assert (train.kind, train.status) == ("train", "done")
    assert (sweep.kind, sweep.status) == ("robustness", "done")
    assert sweep.completed == ["fc1", "fc2"]
    # run again: training resumes past its last epoch, the sweep skips
    # both layers, and the summary is the same
    assert p_main(argv) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again == first
    assert RunManifest.load(str(tmp_path / "run" / "train")).resumes == 1
    # a train phase preempted (SIGTERM's flag at its first step): the
    # sweep does not start
    class Preempting(prunner.PreemptionHandler):
        requested = True

    monkeypatch.setattr(prunner, "PreemptionHandler", Preempting)
    argv[-1] = str(tmp_path / "cut")
    assert p_main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {}
    cut = RunManifest.load(str(tmp_path / "cut" / "train"))
    assert (cut.status, cut.step) == ("preempted", 1)
    assert not os.path.exists(tmp_path / "cut" / "sweep")
