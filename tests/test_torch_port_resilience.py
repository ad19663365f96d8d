"""The port's resilience layer against the JAX package's, on the CPU.

- the run manifest: round trip, kind guard, and a ``manifest.json`` of
  either package loading in the other; atomic writes;
- ``retry``: the deterministic jitter's delays and the deadline /
  exhaustion ordering equal to the JAX module's for the same seeds;
- ``chaos``: the same specs parse to the same configs and fail with the
  same errors; an injection fires once at its exact step (tensors and
  numpy batches; an integer batch is left as it is);
- ``StepGuard`` streaks, ``is_oom_error`` on torch's OOM types and
  nothing else, ``next_accum_for_oom``;
- the guarded step: a non-finite step leaves params, BatchNorm state and
  optimizer state bit-equal (plain, ``accum_steps`` 2, ``remat``, a
  ``param_transform``), and without a guard or chaos the step makes no
  added call;
- ``optim.scale``: one state structure for every LR backoff, so a
  checkpoint saved before a backoff restores after it;
- a resilient ``train`` run under ``nan_at_step``, ``oom_at_step`` and a
  non-finite streak, and one under ``fail_data_at_step``, from the JAX
  initial weights on the digits MLP with SGD (dropout 0), against the
  JAX run: skipped steps, ``accum_steps``, ``lr_scale``, rollbacks,
  counters, and the final params within ``run_train`` parity's 1e-4;
- the prune loop's recoveries, a non-finite streak rolled back with the
  LR backed off and an OOM rolled back at doubled ``accum_steps``,
  against the JAX loop under the same faults: records, manifest and
  counters; a prune resume that fails on a corrupted checkpoint gives
  the SIGTERM handler back;
- a JAX run directory refused by ``--resume``, naming the package;
- the serve engine's ``slow_steps_ms`` hook.

The CLI kill-and-resume runs are in
``tests/test_torch_port_resilience_cli.py``.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from torchpruner_tpu import obs as jobs
from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu.experiments import train_model as JTM
from torchpruner_tpu.resilience import chaos as jchaos
from torchpruner_tpu.resilience import guards as jguards
from torchpruner_tpu.resilience import manifest as jmanifest
from torchpruner_tpu.resilience import retry as jretry
from torchpruner_tpu.utils.config import ExperimentConfig as JConfig
from torchpruner_tpu_torch import obs as pobs
from torchpruner_tpu_torch.__main__ import main as p_main
from torchpruner_tpu_torch.checkpoint import (
    opt_structure,
    restore_checkpoint,
    save_checkpoint,
)
from torchpruner_tpu_torch.convert import params_from_numpy
from torchpruner_tpu_torch.core import layers as PL
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.experiments import prune_retrain as PPR
from torchpruner_tpu_torch.experiments import train_model as PTM
from torchpruner_tpu_torch.resilience import chaos as pchaos
from torchpruner_tpu_torch.resilience import guards as pguards
from torchpruner_tpu_torch.resilience import manifest as pmanifest
from torchpruner_tpu_torch.resilience import retry as pretry
from torchpruner_tpu_torch.resilience import runner as prunner
from torchpruner_tpu_torch.train import optim
from torchpruner_tpu_torch.train.loop import Trainer
from torchpruner_tpu_torch.utils.config import ExperimentConfig
from torchpruner_tpu_torch.utils.losses import cross_entropy_loss as p_ce

#: ``run_train`` parity's tolerance (tests/test_torch_port_robustness.py)
ABS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    pchaos.disable()  # never leak an injection into the next test
    jchaos.disable()


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# -- manifest ----------------------------------------------------------------


def test_manifest_round_trip_kind_guard_and_cross_package(tmp_path):
    m = pmanifest.RunManifest(kind="train", experiment="e", epoch=3,
                              batch_cursor=7, completed=["fc1"],
                              lr_scale=0.25, stage={"losses": [1.5]})
    m.save(str(tmp_path / "p"))
    m2 = pmanifest.RunManifest.load(str(tmp_path / "p"))
    assert dataclasses.asdict(m2) == dataclasses.asdict(m)
    with pytest.raises(ValueError, match="refusing to resume"):
        pmanifest.RunManifest.load_or_new(str(tmp_path / "p"),
                                          kind="robustness", experiment="e")
    fresh = pmanifest.RunManifest.load_or_new(str(tmp_path / "new"),
                                              kind="prune_retrain",
                                              experiment="x")
    assert fresh.kind == "prune_retrain" and not fresh.checkpoint
    # either package reads the other's manifest.json, field for field
    j = jmanifest.RunManifest(kind="prune_retrain", experiment="e",
                              checkpoint="ckpt-000002-s00000010", step=10,
                              completed=["a", "b"], accum_steps=2,
                              rollbacks=1, status="preempted",
                              stage={"phase": "retrain", "target": "b"})
    j.save(str(tmp_path / "j"))
    assert dataclasses.asdict(pmanifest.RunManifest.load(
        str(tmp_path / "j"))) == dataclasses.asdict(j)
    assert dataclasses.asdict(jmanifest.RunManifest.load(
        str(tmp_path / "p"))) == dataclasses.asdict(m)
    assert [f.name for f in dataclasses.fields(pmanifest.RunManifest)] == \
        [f.name for f in dataclasses.fields(jmanifest.RunManifest)]


def test_atomic_write_json_never_leaves_partials(tmp_path):
    p = tmp_path / "x.json"
    pmanifest.atomic_write_json(str(p), {"a": 1})
    pmanifest.atomic_write_json(str(p), {"a": 2, "b": [1.5]})
    jmanifest.atomic_write_json(str(tmp_path / "j.json"),
                                {"a": 2, "b": [1.5]})
    assert json.load(open(p)) == {"a": 2, "b": [1.5]}
    assert p.read_bytes() == (tmp_path / "j.json").read_bytes()
    assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp.")] == []

    def boom(_):
        raise TypeError("not serializable")

    with pytest.raises(TypeError):
        pmanifest.atomic_write_json(str(p), {"a": object()}, default=boom)
    assert json.load(open(p)) == {"a": 2, "b": [1.5]}  # old file intact
    assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp.")] == []


# -- retry -------------------------------------------------------------------


def test_retry_delays_equal_jax_for_the_same_seeds():
    for seed in (0, 1, 7, 123, 2**40 + 5):
        for kw in ({}, {"base_delay_s": 0.02, "factor": 3.0},
                   {"jitter": 0.0}, {"max_delay_s": 0.1, "jitter": 0.9}):
            p = pretry.RetryPolicy(seed=seed, tries=8, **kw)
            j = jretry.RetryPolicy(seed=seed, tries=8, **kw)
            assert [p.delay(a) for a in range(1, 9)] == \
                [j.delay(a) for a in range(1, 9)]


def _retry_outcomes(R):
    """The retry scenarios of the JAX package's tests run through module
    ``R``: what each returned or raised, with the calls and sleeps."""
    out = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    slept = []
    out.append((R.retry_call(flaky, policy=R.RetryPolicy(
        tries=4, base_delay_s=0.01), sleep=slept.append), calls["n"],
        slept))
    for fn, pol in ((lambda: (_ for _ in ()).throw(OSError("always")),
                     R.RetryPolicy(tries=2, base_delay_s=0.0)),
                    (lambda: {}["x"], R.RetryPolicy(tries=5))):
        try:
            R.retry_call(fn, policy=pol, sleep=lambda _s: None)
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            out.append(type(e).__name__)
    n = {"n": 0}

    def count(_t):
        n["n"] += 1
        raise OSError("x")

    for deadline, pol in (
            (R.Deadline(t_end=0.0, budget_s=0.0), R.RetryPolicy(tries=5)),
            (R.Deadline.after(0.5), R.RetryPolicy(tries=5, base_delay_s=10.0,
                                                  jitter=0.0))):
        try:
            R.with_retries(count, policy=pol, deadline=deadline,
                           sleep=lambda _s: None)
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, n["n"],
                        type(e.__cause__).__name__))
    boom = OSError("real failure")

    def slow_fail(_t):
        time.sleep(0.3)
        raise boom

    try:
        R.with_retries(slow_fail, policy=R.RetryPolicy(
            tries=2, base_delay_s=0.0, jitter=0.0),
            deadline=R.Deadline.after(0.5), sleep=lambda _s: None)
    except Exception as e:  # noqa: BLE001
        out.append(e is boom)
    seen = []
    R.with_retries(lambda t: seen.append(t), attempt_timeout_s=3.0)
    out.append(seen)

    @R.retriable(R.RetryPolicy(tries=3, base_delay_s=0.0), label="unit")
    def twice(state=[0]):
        state[0] += 1
        if state[0] < 2:
            raise ConnectionError("flap")
        return state[0]

    out.append(twice())
    return out


def test_retry_and_deadline_ordering_equal_jax():
    jobs.configure(None, watch_compiles=False)
    pobs.configure(None)
    try:
        got, want = _retry_outcomes(pretry), _retry_outcomes(jretry)
        assert got == want
        assert got[0][0] == "ok" and got[1:3] == ["OSError", "KeyError"]
        assert got[3] == ("DeadlineExceeded", 0, "NoneType")
        assert got[4] == ("DeadlineExceeded", 1, "OSError")
        assert got[5] is True and got[6] == [3.0]
        for name in ("resilience_retries_total",
                     "resilience_retries_unit_total",
                     "resilience_deadline_exceeded_total"):
            assert pobs.counter_value(name) == jobs.counter_value(name) > 0
    finally:
        pobs.shutdown()
        jobs.shutdown()


# -- chaos -------------------------------------------------------------------


CHAOS_SPECS = [
    None, {}, {"nan_at_step": 3}, '{"kill_at_step": 12, "once": false}',
    {"oom_at_step": 0, "fail_data_at_step": 2},
    {"corrupt_checkpoint": True}, {"delay_callback_s": 0.01},
    {"slow_steps_ms": 2.5}, {"nan_at_step": -1}, {"nan_at_stepp": 3},
    {"kill_at_step": 1, "bogus": 2, "zzz": 0}, "{not json",
]


def _chaos_outcome(C, spec):
    try:
        cfg = C.ChaosConfig.from_any(spec)
        return ("ok", dataclasses.asdict(cfg), cfg.any_active())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("error", type(e).__name__, str(e))


def test_chaos_config_parsing_and_errors_equal_jax(tmp_path):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps({"oom_at_step": 4}))
    for spec in CHAOS_SPECS + [str(path)]:
        assert _chaos_outcome(pchaos, spec) == _chaos_outcome(jchaos, spec), \
            spec
    assert _chaos_outcome(pchaos, str(path))[1]["oom_at_step"] == 4
    assert pchaos.configure({"nan_at_step": -1}) is None
    assert not pchaos.active()
    with pytest.raises(ValueError, match="unknown chaos keys"):
        ExperimentConfig(chaos={"nan_at_stepp": 1})
    os.environ[pchaos.ENV_VAR] = '{"oom_at_step": 9}'
    try:
        assert pchaos.configure(None).oom_at_step == 9  # the env var
        pchaos.disable()  # does not fall back to the env var
        assert not pchaos.active()
    finally:
        del os.environ[pchaos.ENV_VAR]


def test_chaos_fires_once_at_the_exact_step(caplog):
    pobs.configure(None)
    try:
        pchaos.configure({"nan_at_step": 2})
        x = np.ones((4, 3), np.float32)
        assert np.isfinite(pchaos.poison_batch(1, x)).all()
        assert np.isnan(pchaos.poison_batch(2, x)).all()
        assert np.isfinite(pchaos.poison_batch(2, x)).all()  # once
        pchaos.configure({"nan_at_step": 0})
        t = torch.ones(2, 5)
        assert torch.isnan(pchaos.poison_batch(0, t)).all()
        assert pchaos.poison_batch(0, t) is t
        # integer batches cannot carry a NaN: warned, counted as fired,
        # left as they are
        pchaos.configure({"nan_at_step": 1})
        ids = torch.arange(6).reshape(2, 3)
        with caplog.at_level("WARNING", logger="torchpruner_tpu_torch"):
            assert pchaos.poison_batch(1, ids) is ids
        assert "cannot represent NaN" in caplog.text
        assert pchaos.poison_batch(1, np.ones(3, np.float32)).sum() == 3
        pchaos.configure({"oom_at_step": 0, "fail_data_at_step": 3})
        pchaos.maybe_oom(1)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as ei:
            pchaos.maybe_oom(0)
        assert pguards.is_oom_error(ei.value)
        with pytest.raises(OSError):
            pchaos.maybe_fail_data(3)
        pchaos.maybe_fail_data(3)  # once
        # a resumed process disarms what the cursor already passed
        pchaos.configure({"kill_at_step": 5, "nan_at_step": 9})
        pchaos.disarm_through(5)
        pchaos.maybe_kill(5)  # would SIGKILL this process if armed
        assert np.isnan(pchaos.poison_batch(9, x)).all()
        pchaos.configure({"slow_steps_ms": 3.0})
        t0 = time.perf_counter()
        pchaos.maybe_slow_step()
        pchaos.maybe_slow_step()
        assert time.perf_counter() - t0 >= 0.006
        # nan(2) + nan(0) + int(1) + oom + data + nan(9) + slow (once)
        assert pobs.counter_value("chaos_injections_total") == 7
    finally:
        pobs.shutdown()


# -- guards ------------------------------------------------------------------


def test_step_guard_streaks_and_oom_classification():
    pobs.configure(None)
    try:
        for G in (pguards, jguards):
            g = G.StepGuard(max_bad_steps=3)
            seq = [g.observe(b) for b in (False, True, True, False, True,
                                          True)]
            with pytest.raises(G.NonFiniteStreakError) as ei:
                g.observe(True)
            assert seq == [False, True, True, False, True, True]
            assert ei.value.streak == 3 and g.total_skips == 5
            g.reset()
            assert g.consecutive == 0
        assert pobs.counter_value("resilience_nan_skips_total") == 5
    finally:
        pobs.shutdown()
    oom = [torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                  "2.00 GiB"),
           RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB "
                        "(GPU 0; 79.10 GiB total capacity)"),
           RuntimeError("[enforce fail at alloc_cpu.cpp:117] DefaultCPU"
                        "Allocator: not enough memory: you tried to "
                        "allocate 8 bytes. Out of memory"),
           pchaos.InjectedResourceExhausted(3), MemoryError(),
           RuntimeError("RESOURCE_EXHAUSTED: ..."),
           RuntimeError("OOM while staging the batch")]
    other = [ValueError("shape mismatch"), RuntimeError("no ROOM left"),
             RuntimeError("index out of range in self"),
             OSError("chaos: transient data-loading failure"),
             KeyError("memory")]
    assert all(pguards.is_oom_error(e) for e in oom)
    assert not any(pguards.is_oom_error(e) for e in other)
    for accum in (1, 2, 4, 8):
        for batch in (1, 8, 12, 32, 33):
            assert pguards.next_accum_for_oom(accum, batch) == \
                jguards.next_accum_for_oom(accum, batch)


def test_preemption_handler_sigterm_sets_flag():
    with pguards.PreemptionHandler() as pre:
        assert not pre.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert pre.requested


# -- the guarded step --------------------------------------------------------


def _bn_model():
    return PS.SegmentedModel((
        PL.Dense("fc1", 16), PL.BatchNorm("bn1"), PL.Activation("r1", "relu"),
        PL.Residual("blk", body=(PL.Dense("inner", 16),
                                 PL.Activation("r", "relu"),
                                 PL.Dense("proj", 16))),
        PL.Dense("out", 3)), (8,))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _bundle(tr):
    return [t.clone() for t in _flat([tr.params, tr.state, tr.opt_state])]


GUARD_CASES = {
    "plain": {},
    "accum_steps_2": {"accum_steps": 2},
    "remat": {"remat": True},
    "param_transform": {"param_transform": lambda p: {
        **p, "fc1": {**p["fc1"], "w": p["fc1"]["w"] * 0.5}}},
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guarded_step_skips_and_holds_the_bundle(case):
    pobs.configure(None)
    try:
        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 16, 8)).astype(np.float32)
        y = rng.integers(0, 3, size=(3, 16))
        guard = pguards.StepGuard(max_bad_steps=2)
        tr = Trainer.create(_bn_model(), optim.adam(1e-2), p_ce, seed=0,
                            device="cpu", guard=guard, **GUARD_CASES[case])
        tr.step(x[0], y[0])
        before = _bundle(tr)
        bad = x[1].copy()
        bad[3, 2] = np.nan  # one NaN entry poisons loss and grads
        loss = tr.step(bad, y[1])
        assert not torch.isfinite(loss)
        after = _bundle(tr)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert guard.total_skips == 1 and guard.consecutive == 1
        assert tr.step_count == 2
        assert pobs.counter_value("resilience_nan_skips_total") == 1
        assert torch.isfinite(tr.step(x[2], y[2]))
        assert guard.consecutive == 0
        assert not all(torch.equal(a, b) for a, b in zip(after, _bundle(tr)))
        tr.step(bad, y[1])
        with pytest.raises(pguards.NonFiniteStreakError):
            tr.step(bad, y[1])
    finally:
        pobs.shutdown()


def test_embedding_gradient_is_the_same_every_run():
    """The Embedding rule's backward adds a repeated token's gradients in
    a fixed order (indexing's accumulating ``index_put`` did not: on
    several CPU threads the BERT smoke retrain drifted 1e-9 between two
    identical runs, so a resumed run could not equal an uninterrupted
    one; at these shapes on 8 threads most of 20 backward passes
    differed)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.normal(size=(128, 32)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, 128, size=(64, 16)))
        g = torch.from_numpy(rng.normal(size=(64, 16, 32)).astype(
            np.float32))
        spec = PL.Embedding("tok", 128, 32)
        grads = []
        for _ in range(20):
            leaf = w.clone().requires_grad_()
            out, _ = PL.apply_layer(spec, {"emb": leaf}, {}, ids)
            assert torch.equal(out.detach(), w[ids])
            grads.append(torch.autograd.grad((out * g).sum(), leaf)[0])
        assert all(torch.equal(grads[0], x) for x in grads[1:])
        want = np.zeros((128, 32), np.float64)
        np.add.at(want, ids.numpy(), g.numpy().astype(np.float64))
        np.testing.assert_allclose(grads[0].numpy(), want, rtol=0,
                                   atol=1e-5)
    finally:
        torch.set_num_threads(threads)


def test_unguarded_step_makes_no_added_call(monkeypatch):
    """Without a guard, ``grad_norm`` or chaos, a step computes no norm,
    makes no host read of a flag and calls no chaos hook."""
    from torchpruner_tpu_torch.train import loop

    calls = []
    monkeypatch.setattr(loop, "global_norm",
                        lambda t: calls.append("norm"))
    for hook in ("maybe_kill", "maybe_oom", "poison_batch"):
        monkeypatch.setattr(pchaos, hook,
                            lambda *a, _h=hook: calls.append(_h))
    tr = Trainer.create(_bn_model(), optim.sgd(0.1), p_ce, seed=0,
                        device="cpu")
    x = np.ones((4, 8), np.float32)
    tr.step(x, np.zeros(4, np.int64))
    assert calls == [] and tr.step_count == 1


def test_scale_stage_keeps_the_state_structure(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    model = _bn_model()
    params, state = PS.init_model(model, 0, device="cpu")
    base = optim.adam(1e-3)
    structs = {opt_structure(optim.chain(base, optim.scale(s)).init(params))
               for s in (1.0, 0.5, 0.125)}
    assert len(structs) == 1
    g = np.random.default_rng(0).normal(size=(7,)).astype(np.float32)
    got, st = optim.scale(0.375).update({"g": torch.from_numpy(g)}, {},
                                        None)
    want, _ = optax.scale(0.375).update({"g": jnp.asarray(g)},
                                        optax.scale(0.375).init(None))
    assert st == {}
    np.testing.assert_array_equal(got["g"].numpy(),
                                  np.asarray(jax.device_get(want["g"])))
    tx1 = optim.chain(base, optim.scale(1.0))
    tr = Trainer.create(model, tx1, p_ce, seed=0, device="cpu")
    tr.step(np.ones((4, 8), np.float32), np.zeros(4, np.int64))
    save_checkpoint(str(tmp_path / "c"), model, tr.params, tr.state,
                    tr.opt_state)
    _, _, _, opt, _ = restore_checkpoint(
        str(tmp_path / "c"), tx=optim.chain(base, optim.scale(0.5)),
        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_flat(opt),
                                                 _flat(tr.opt_state)))


# -- the resilient train run against the JAX package's -------------------------


def _jax_init_in_port(monkeypatch):
    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jp, js = j_init_model(JPR.MODEL_REGISTRY["digits_fc_tiny"][0](),
                              seed=seed)
        return (params_from_numpy(numpy_tree(jp), device=device),
                params_from_numpy(numpy_tree(js), device=device))

    monkeypatch.setattr(PS, "init_model", jax_init)


def _train_kw(run_dir, **kw):
    base = dict(name="res_test", model="digits_fc_tiny",
                dataset="digits_flat", experiment="train", epochs=2,
                batch_size=32, eval_batch_size=64, lr=0.05,
                run_dir=str(run_dir), checkpoint_every_steps=5,
                log_path=os.path.join(str(run_dir), "log.csv"))
    base.update(kw)
    return base


def _streak(monkeypatch, C, steps):
    """Poison each step of ``steps`` the first time it runs — a streak
    of non-finite steps that a rollback replays clean."""
    fired = set()
    real = C.poison_batch

    def poison(step, x):
        if step in steps and step not in fired:
            fired.add(step)
            return np.full_like(np.asarray(x), np.nan)
        return real(step, x)

    monkeypatch.setattr(C, "poison_batch", poison)


COUNTERS = ("resilience_nan_skips_total", "resilience_rollbacks_total",
            "resilience_oom_retries_total", "resilience_ragged_drops_total",
            "resilience_resumes_total", "chaos_injections_total",
            "resilience_retries_total", "resilience_retries_data_fetch_total")


def _prune_kw(run_dir, **kw):
    """The JAX package's resumable prune-loop test's config
    (tests/test_resilience.py ``_prune_cfg``): fc1 and fc2 of the
    digits MLP, a quarter of each dropped, one retrain epoch each."""
    base = dict(name="res_prune", model="digits_fc_tiny",
                dataset="digits_flat", method="weight_norm",
                policy="fraction", fraction=0.25, finetune_epochs=1,
                score_examples=32, batch_size=32, eval_batch_size=64,
                lr=0.05, run_dir=str(run_dir),
                log_path=os.path.join(str(run_dir), "log.csv"))
    base.update(kw)
    return base


#: per loop: the JAX package's run, the port's, and its config
LOOPS = {"train": (JTM.run_train, PTM.run_train, _train_kw),
         "prune": (JPR.run_prune_retrain, PPR.run_prune_retrain, _prune_kw)}


def _run_both(tmp_path, monkeypatch, streak=(), loop="train", **kw):
    _jax_init_in_port(monkeypatch)
    _streak(monkeypatch, pchaos, streak)
    _streak(monkeypatch, jchaos, streak)
    j_run, p_run, make_kw = LOOPS[loop]
    runs = {}
    for name, obs_mod, run, Cfg in (
            ("jax", jobs, j_run, JConfig),
            ("port", pobs, p_run, ExperimentConfig)):
        if obs_mod is jobs:
            obs_mod.configure(None, watch_compiles=False)
        else:
            obs_mod.configure(None)
        try:
            cfg = Cfg(**make_kw(tmp_path / name, **kw))
            extra = {} if name == "jax" else {"device": "cpu"}
            out = run(cfg, verbose=False, **extra)
            runs[name] = {
                "manifest": pmanifest.RunManifest.load(cfg.run_dir),
                "counters": {c: obs_mod.counter_value(c) for c in COUNTERS}}
            if loop == "train":
                runs[name]["trainer"], runs[name]["hist"] = out
            else:
                runs[name]["records"] = out
        finally:
            obs_mod.shutdown()
            jchaos.disable()
            pchaos.disable()
    return runs["jax"], runs["port"]


def _same_run(j, p):
    assert p["counters"] == j["counters"]
    mj, mp = j["manifest"], p["manifest"]
    for k in ("step", "epoch", "batch_cursor", "lr_scale", "accum_steps",
              "rollbacks", "resumes", "status"):
        assert getattr(mp, k) == getattr(mj, k), k
    assert p["trainer"].step_count == j["trainer"].step_count
    assert p["trainer"].accum_steps == j["trainer"].accum_steps
    assert len(p["hist"]) == len(j["hist"])
    for a, b in zip(p["hist"], j["hist"]):
        for k in ("train_loss", "test_loss", "test_acc"):
            assert abs(a[k] - b[k]) <= ABS_TOL, (k, a[k], b[k])
    jp = numpy_tree(j["trainer"].params)
    for layer, leaves in p["trainer"].params.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(v.numpy(), jp[layer][k], rtol=0,
                                       atol=ABS_TOL)


def test_resilient_train_matches_jax_under_nan_oom_and_a_streak(
        tmp_path, monkeypatch):
    """One run: a NaN batch at step 3 (skipped), a synthetic OOM at step
    12 (rolled back to step 10 at accum_steps 2, each epoch's 17-example
    tail then dropped and counted), two poisoned steps 22-23 (a streak
    at max_bad_steps 2: rolled back to step 20 with lr_scale 0.5)."""
    j, p = _run_both(tmp_path, monkeypatch, streak=(22, 23),
                     guard_nonfinite=True, max_bad_steps=2,
                     chaos={"nan_at_step": 3, "oom_at_step": 12})
    _same_run(j, p)
    m = p["manifest"]
    assert (m.status, m.accum_steps, m.rollbacks, m.lr_scale) == \
        ("done", 2, 1, 0.5)
    c = p["counters"]
    assert c["resilience_nan_skips_total"] == 3
    assert c["resilience_rollbacks_total"] == 2
    assert c["resilience_oom_retries_total"] == 1
    assert c["resilience_ragged_drops_total"] == 2


def test_resilient_train_retries_a_transient_data_failure_like_jax(
        tmp_path, monkeypatch):
    j, p = _run_both(tmp_path, monkeypatch, epochs=1,
                     chaos={"fail_data_at_step": 3})
    _same_run(j, p)
    assert p["trainer"].step_count == -(-1297 // 32)
    assert p["counters"]["resilience_retries_data_fetch_total"] == 1


def test_prune_loop_recovers_like_jax_from_a_streak_and_an_oom(
        tmp_path, monkeypatch):
    """The prune loop's two recoveries against the JAX loop's under the
    same faults, from the JAX initial weights.  The loop prunes fc2
    first (``prune_order`` reverse): a NaN batch at step 5 (skipped)
    and two poisoned steps 20-21 in fc2's retrain (a streak at
    max_bad_steps 2: back to fc2's mid-round anchor, step 0, with
    lr_scale 0.5), then a synthetic OOM at step 50 in fc1's retrain
    (the failed trainer's trees dropped, back to fc1's anchor, step 41,
    at accum_steps 2, the 17-example tail then dropped and counted)."""
    j, p = _run_both(tmp_path, monkeypatch, streak=(20, 21), loop="prune",
                     guard_nonfinite=True, max_bad_steps=2,
                     chaos={"nan_at_step": 5, "oom_at_step": 50})
    assert p["counters"] == j["counters"]
    mj, mp = j["manifest"], p["manifest"]
    for k in ("step", "epoch", "completed", "lr_scale", "accum_steps",
              "rollbacks", "resumes", "status"):
        assert getattr(mp, k) == getattr(mj, k), k
    assert (mp.status, mp.step, mp.rollbacks, mp.lr_scale,
            mp.accum_steps) == ("done", 81, 1, 0.5, 2)
    c = p["counters"]
    assert c["resilience_nan_skips_total"] == 3
    assert c["resilience_rollbacks_total"] == 1
    assert c["resilience_oom_retries_total"] == 1
    assert c["resilience_ragged_drops_total"] == 1
    assert [r.layer for r in p["records"]] == ["fc2", "fc1"]
    for a, b in zip(p["records"], j["records"]):
        assert (a.layer, a.n_dropped, a.widths, a.n_params) == \
            (b.layer, b.n_dropped, b.widths, b.n_params)
        for f in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            assert abs(getattr(a, f) - getattr(b, f)) <= ABS_TOL, (
                f, getattr(a, f), getattr(b, f))
    # the records the manifest committed are the ones returned
    assert [r["layer"] for r in mp.records] == ["fc2", "fc1"]


def test_failed_prune_resume_gives_the_sigterm_handler_back(tmp_path):
    """A resume that fails before the target loop (its checkpoint
    corrupted: ``CheckpointCorruptError`` from the restore) leaves the
    process's SIGTERM handler as it found it."""
    from torchpruner_tpu_torch.checkpoint import CheckpointCorruptError

    cfg = ExperimentConfig(**_prune_kw(tmp_path / "run",
                                       target_filter=("fc2",)))
    pobs.configure(None)
    try:
        PPR.run_prune_retrain(cfg, verbose=False, device="cpu")
        m = pmanifest.RunManifest.load(cfg.run_dir)
        assert pchaos.corrupt_checkpoint_bytes(
            os.path.join(cfg.run_dir, m.checkpoint), force=True)
        before = signal.getsignal(signal.SIGTERM)
        with pytest.raises(CheckpointCorruptError):
            PPR.run_prune_retrain(cfg, verbose=False, device="cpu")
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        pobs.shutdown()


def test_first_step_oom_rolls_back_to_the_seeded_start(tmp_path):
    """An OOM before anything is committed (a first step that does not
    fit) restarts from the seeded init at doubled ``accum_steps``: the
    run equals one configured at ``accum_steps`` 2 from the start."""
    runs = []
    for name, kw in (("oom", {"chaos": {"oom_at_step": 0}}),
                     ("accum2", {"accum_steps": 2})):
        pobs.configure(None)
        try:
            cfg = ExperimentConfig(**_train_kw(tmp_path / name, epochs=1,
                                               checkpoint_every_steps=0,
                                               **kw))
            trainer, hist = PTM.run_train(cfg, verbose=False, device="cpu")
            runs.append((trainer, hist, pmanifest.RunManifest.load(
                cfg.run_dir), pobs.counter_value(
                    "resilience_rollbacks_total")))
        finally:
            pobs.shutdown()
            pchaos.disable()
    (t1, h1, m1, rb1), (t2, h2, m2, rb2) = runs
    assert (m1.accum_steps, m1.status, rb1) == (2, "done", 1)
    assert (m2.accum_steps, rb2) == (0, 0)
    assert t1.step_count == t2.step_count == 1297 // 32
    assert [h["test_loss"] for h in h1] == [h["test_loss"] for h in h2]
    for a, b in zip(_flat(t1.params), _flat(t2.params)):
        assert torch.equal(a, b)


def test_jax_run_directory_refused_by_resume(tmp_path, capsys):
    jobs.configure(None, watch_compiles=False)
    try:
        JTM.run_train(JConfig(**_train_kw(tmp_path / "jax", epochs=1)),
                      verbose=False)
    finally:
        jobs.shutdown()
    cfg = ExperimentConfig(**_train_kw(tmp_path / "unused", epochs=2))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    with pytest.raises(ValueError, match=r"torchpruner_tpu \(the JAX "
                                         r"package\)"):
        p_main(["--config", path, "--cpu", "--no-obs", "--resume",
                str(tmp_path / "jax")])
    # the manifest itself reads
    m = pmanifest.RunManifest.load(str(tmp_path / "jax"))
    assert m.kind == "train" and m.status == "done"
    with pytest.raises(ValueError, match="JAX PRNG key"):
        prunner.rng_from_list([0, 42], "cpu")
    gen = torch.Generator().manual_seed(3)
    with pytest.raises(ValueError, match="cannot resume on cuda"):
        prunner.rng_from_list(prunner.rng_to_list(gen), "cuda")
    back = prunner.rng_from_list(prunner.rng_to_list(gen), "cpu")
    assert torch.equal(torch.rand(5, generator=back),
                       torch.rand(5, generator=gen))


# -- the serve engine's slow-step hook ---------------------------------------


def _decode_step_walls(slow_ms):
    from torchpruner_tpu_torch.models import llama_tiny
    from torchpruner_tpu_torch.serve import ServeEngine, synthetic_requests

    model = llama_tiny()
    params, _ = PS.init_model(model, seed=0, device="cpu")
    eng = ServeEngine(model, params, device="cpu", n_slots=2, max_len=64,
                      page_len=8)
    reqs = synthetic_requests(2, vocab=256, prompt_lens=[5], max_new=[6],
                              seed=3)
    if slow_ms:
        pchaos.configure({"slow_steps_ms": slow_ms})
    for r in reqs:
        eng.submit(r)
    eng.step()  # admit and prefill (then the first decode)
    walls = []
    while any(r.state != "done" for r in reqs):
        t0 = time.perf_counter()
        eng.step()
        walls.append(time.perf_counter() - t0)
    pchaos.disable()
    return walls, [list(r.tokens) for r in reqs]


def test_engine_slow_step_hook(monkeypatch):
    calls = []
    real = pchaos.maybe_slow_step

    def counted():
        calls.append(1)
        real()

    monkeypatch.setattr(pchaos, "maybe_slow_step", counted)
    walls0, toks0 = _decode_step_walls(0)
    assert calls == []  # chaos unset: the path makes no extra call
    walls1, toks1 = _decode_step_walls(40.0)
    assert toks1 == toks0
    assert len(calls) == len(walls1) + 1  # every decode step, the first too
    assert min(walls1) >= 0.040  # every step's wall grew by the stall
