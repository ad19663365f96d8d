"""The port's drivers over a mesh, in spawned worlds of 2 CPU ranks
(gloo, a ``file://`` store under ``tmp_path``): only rank 0 writes, a
SIGTERM to rank 0 alone stops both ranks at the same step, and a
checkpoint written from the mesh restores at world size 1 and in the
JAX package with the digests of a world-1 save.

- the prune loop (``bert_glue_sensitivity --smoke``) through the CLI on
  ``{"data": 2}`` with ``--obs-dir`` and ``--resume``: one summary line,
  the CSV's rows once, one manifest, the records those of the same
  config without a mesh;
- the robustness sweep on ``{"data": 2}``: the AUCs of the sweep
  without a mesh;
- a resilient ``train`` run on ``{"data": 2}`` with ZeRO, rank 0
  SIGTERMed after its third step;
- the same run to its end: its last checkpoint restored in one process
  and saved again has the same digest, and the JAX package restores
  the same params and seals the same digest for them.

Tolerances (those of ``test_torch_port_prune.py``): losses and
accuracies rtol 1e-4; AUCs rtol 1e-4 (an AUC is a
mean loss increase, a difference of two f32 means some 50 times larger,
whose sums the mesh groups by half-batches).
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import contextlib
import dataclasses
import io
import json
import os
import signal

import numpy as np

from test_torch_port_parallel_train import _np_tree, run_world

LOOP_RTOL = 1e-4
AUC_RTOL = 1e-4


def _w_cli(rank, argv):
    from torchpruner_tpu_torch import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _loop_cfg(tmp_path, tag, **kw):
    """The smoke preset as shipped (no fine-tune: the sharded retrain is
    held in ``test_torch_port_parallel_train.py`` and by the card)."""
    from torchpruner_tpu_torch.experiments.presets import get_preset

    cfg = dataclasses.replace(
        get_preset("bert_glue_sensitivity", smoke=True),
        log_path=str(tmp_path / f"{tag}.csv"), **kw)
    path = str(tmp_path / f"{tag}.json")
    cfg.to_json(path)
    return path


def _rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_prune_loop_on_a_mesh_writes_once(tmp_path, capsys):
    from torchpruner_tpu_torch.__main__ import main as p_main
    from torchpruner_tpu_torch.resilience.manifest import RunManifest

    mesh_cfg = _loop_cfg(tmp_path, "mesh", mesh={"data": 2})
    res = run_world(2, _w_cli, tmp_path, [
        "--config", mesh_cfg, "--cpu", "--obs-dir", str(tmp_path / "obs"),
        "--resume", str(tmp_path / "run")])
    assert [rc for rc, _ in res] == [0, 0]
    assert len(res[0][1].strip().splitlines()) >= 1
    summary = json.loads(res[0][1].strip().splitlines()[-1])
    assert not any(line.startswith("{") for line in
                   res[1][1].strip().splitlines())
    rows = _rows(str(tmp_path / "mesh.csv"))
    assert len(rows) == summary["steps"] == 2
    m = RunManifest.load(str(tmp_path / "run"))
    assert m.status == "done" and m.completed == [r["layer"] for r in rows]
    assert m.checkpoint in os.listdir(tmp_path / "run")
    assert os.path.exists(tmp_path / "obs" / "events.jsonl")
    # the same config without a mesh, in this process
    plain_cfg = _loop_cfg(tmp_path, "plain")
    assert p_main(["--config", plain_cfg, "--cpu", "--no-obs"]) == 0
    capsys.readouterr()
    want = _rows(str(tmp_path / "plain.csv"))
    for got, w in zip(rows, want):
        assert (got["layer"], got["widths"], got["n_params"]) == \
            (w["layer"], w["widths"], w["n_params"])
        for k in ("test_loss", "test_acc", "test_loss_pp", "test_acc_pp"):
            np.testing.assert_allclose(float(got[k]), float(w[k]),
                                       rtol=LOOP_RTOL, atol=LOOP_RTOL)


def _w_loop(rank, cfg, params_np, state_np):
    from torchpruner_tpu_torch.convert import params_from_numpy
    from torchpruner_tpu_torch.core import segment as PS
    from torchpruner_tpu_torch.experiments import prune_retrain as PPR
    from torchpruner_tpu_torch.parallel import train as PT

    def jax_init(model, seed=0, dtype=None, device=None):
        return (params_from_numpy(params_np, device=device),
                params_from_numpy(state_np, device=device))

    PS.init_model = PT.init_model = jax_init
    hist = PPR.run_prune_retrain(cfg, verbose=False, device="cpu")
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k != "prune_time"} for r in hist]


def test_prune_loop_on_a_mesh_drops_the_ragged_scoring_tail(tmp_path,
                                                            monkeypatch):
    """96 scoring examples in batches of 64: on ``{"data": 2}`` the port,
    as the JAX loop on a JAX mesh of two devices, scores the first batch
    alone, and so drops the same units (the records after the prune
    would differ if either scored the 32-row tail)."""
    import jax

    from torchpruner_tpu import parallel as JP
    from torchpruner_tpu.core.segment import init_model as j_init_model
    from torchpruner_tpu.experiments import presets as JPS
    from torchpruner_tpu.experiments import prune_retrain as JPR
    from torchpruner_tpu_torch.experiments.presets import get_preset

    over = dict(mesh={"data": 2}, score_examples=96, eval_batch_size=64)
    cfg_j = dataclasses.replace(
        JPS.get_preset("bert_glue_sensitivity", smoke=True), **over,
        log_path=str(tmp_path / "j.csv"))
    make_mesh = JP.make_mesh
    monkeypatch.setattr(JP, "make_mesh", lambda axes: make_mesh(
        axes, devices=jax.devices()[:2]))
    j_hist = JPR.run_prune_retrain(cfg_j, verbose=False)
    jparams, jstate = j_init_model(JPR.MODEL_REGISTRY[cfg_j.model][0](),
                                   seed=cfg_j.seed)
    cfg_p = dataclasses.replace(
        get_preset("bert_glue_sensitivity", smoke=True), **over,
        log_path=str(tmp_path / "p.csv"))
    res = run_world(2, _w_loop, tmp_path, cfg_p, _np_tree(jparams),
                    _np_tree(jstate))
    assert res[0] == res[1] and len(res[0]) == len(j_hist) == 2
    for p, j in zip(res[0], j_hist):
        assert (p["layer"], p["widths"], p["n_dropped"], p["n_params"]) \
            == (j.layer, j.widths, j.n_dropped, j.n_params)
        for f in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            np.testing.assert_allclose(p[f], getattr(j, f), rtol=LOOP_RTOL,
                                       atol=LOOP_RTOL, err_msg=f)


def _sweep_cfg(tmp_path, tag, **kw):
    from torchpruner_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(
        name="sweep", model="digits_fc_tiny", dataset="digits_flat",
        experiment="robustness", method="taylor", score_examples=48,
        eval_batch_size=24, log_path=str(tmp_path / f"{tag}.csv"),
        results_path=str(tmp_path / f"{tag}_results.json"), **kw)
    path = str(tmp_path / f"{tag}.json")
    cfg.to_json(path)
    return path


def test_robustness_sweep_on_a_mesh_matches_one_process(tmp_path, capsys):
    from torchpruner_tpu_torch.__main__ import main as p_main

    res = run_world(2, _w_cli, tmp_path, [
        "--config", _sweep_cfg(tmp_path, "mesh", mesh={"data": 2}),
        "--cpu", "--no-obs"])
    assert [rc for rc, _ in res] == [0, 0]
    got = json.loads(res[0][1].strip().splitlines()[-1])
    assert p_main(["--config", _sweep_cfg(tmp_path, "plain"), "--cpu",
                   "--no-obs"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"taylor"}
    np.testing.assert_allclose(got["taylor"], want["taylor"],
                               rtol=AUC_RTOL)
    assert os.path.exists(tmp_path / "mesh_results.json")


def _train_cfg(tmp_path, tag, **kw):
    from torchpruner_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(
        name="mesh_train", model="digits_fc_tiny", dataset="digits_flat",
        experiment="train", epochs=1, batch_size=32, eval_batch_size=64,
        lr=0.05, mesh={"data": 2}, zero=True,
        log_path=str(tmp_path / f"{tag}.csv"),
        run_dir=str(tmp_path / f"{tag}_run"), **kw)
    return cfg


def _w_preempt(rank, cfg, stop_after):
    from torchpruner_tpu_torch.experiments.train_model import run_train
    from torchpruner_tpu_torch.parallel import train as PT

    orig = PT.ShardedTrainer.step

    def step(self, x, y):
        loss = orig(self, x, y)
        if rank == 0 and self.step_count == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return loss

    PT.ShardedTrainer.step = step
    trainer, history = run_train(cfg, device="cpu", verbose=False)
    return trainer.step_count, len(history)


def test_sigterm_to_rank_zero_stops_both_ranks(tmp_path):
    from torchpruner_tpu_torch.resilience.manifest import RunManifest

    cfg = _train_cfg(tmp_path, "pre", checkpoint_every_steps=1)
    res = run_world(2, _w_preempt, tmp_path, cfg, 3)
    assert res == [(3, 0), (3, 0)]
    m = RunManifest.load(cfg.run_dir)
    assert (m.status, m.step) == ("preempted", 3)


def _w_train(rank, cfg):
    from torchpruner_tpu_torch.experiments.train_model import run_train

    trainer, history = run_train(cfg, device="cpu", verbose=False)
    return _np_tree(trainer.full_params()), len(history)


def test_mesh_checkpoint_restores_at_world_one_and_in_jax(tmp_path):
    from torchpruner_tpu import checkpoint as JC
    from torchpruner_tpu_torch import checkpoint as PC
    from torchpruner_tpu_torch.resilience.manifest import (
        RunManifest,
        read_json,
    )
    from torchpruner_tpu_torch.resilience.runner import scaled_optimizer

    cfg = _train_cfg(tmp_path, "full")
    res = run_world(2, _w_train, tmp_path, cfg)
    assert res[0][1] == res[1][1] == 1
    m = RunManifest.load(cfg.run_dir)
    ckpt = os.path.join(cfg.run_dir, m.checkpoint)
    digest = read_json(os.path.join(ckpt, "spec.json"))["digest"]
    # restored in one process and saved again: the same digest
    tx = scaled_optimizer(cfg, 1, m.lr_scale)
    model, params, state, opt, meta = PC.restore_checkpoint(
        ckpt, tx=tx, device="cpu")
    for path, arr in _flat(_np_tree(params)).items():
        np.testing.assert_array_equal(arr, _flat(res[0][0])[path])
    PC.save_checkpoint(str(tmp_path / "w1"), model, params, state, opt,
                       step=meta["step"], extra=meta.get("extra"))
    assert read_json(str(tmp_path / "w1" / "spec.json"))["digest"] == digest
    # the JAX package restores the same params and seals the same digest
    jmodel, jparams, jstate, _, _ = JC.restore_checkpoint(ckpt)
    for path, arr in _flat(_np_tree(params)).items():
        np.testing.assert_array_equal(np.asarray(_flat(jparams)[path]), arr)
    JC.save_checkpoint(str(tmp_path / "j"), jmodel, jparams, jstate)
    PC.save_checkpoint(str(tmp_path / "p"), model, params, state)
    assert read_json(str(tmp_path / "j" / "spec.json"))["digest"] == \
        read_json(str(tmp_path / "p" / "spec.json"))["digest"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}
