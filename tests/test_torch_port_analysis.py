"""analysis/ of the port against the JAX package's, on the CPU.

- the memory watermark (``predicted_hbm_bytes_per_chip``) equals the JAX
  package's for bert_tiny / llama_tiny over single-device, data-parallel
  and 2x2 meshes, FSDP and TP, ZeRO off and on;
- plan lint: ``lint_model_plans`` finds what the JAX package finds on
  every tiny model of the registry, and each corruption of a known-good
  plan (the JAX package's golden cases) fires the same finding through
  both; ``apply_plan`` raises ``PlanError`` before touching a tensor; a
  plan the JAX package serialized loads in the port and slices the same;
- sharding lint: the same findings as the JAX package's on bert_tiny,
  llama_tiny and vit_tiny over 2x2 FSDP and TP meshes, and the JAX
  package's sharding cases through both;
- host lint: every source fixture of ``tests/test_host_lint.py`` gives
  the same findings through both scanners; the port's whole-package scan
  is clean (after its waivers) and fast, and so is the JAX package's
  scan of the port under the port's waivers; stale and reasonless
  waivers are errors; the ``lint-host`` exit codes;
- the repaired races (ROADMAP C8-C10): ``ContinuousProfiler`` arming
  from another thread while the loop closes windows;
- the CLI: ``--lint`` / ``--lint-plan`` exit codes, ``--plan`` refused.
"""

import _torch_threads  # noqa: F401  (caps torch's threads)
import ast
import dataclasses
import itertools
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import optax  # noqa: E402

from torchpruner_tpu import models as JMOD  # noqa: E402
from torchpruner_tpu.analysis import host_lint as JH  # noqa: E402
from torchpruner_tpu.analysis import plan_lint as JPL  # noqa: E402
from torchpruner_tpu.analysis import sharding_lint as JSL  # noqa: E402
from torchpruner_tpu.core import plan as JPLAN  # noqa: E402
from torchpruner_tpu.core.graph import group_for as j_group_for  # noqa: E402
from torchpruner_tpu.core.pruner import plan_for_group as j_plan  # noqa: E402
from torchpruner_tpu.core.segment import init_model as j_init  # noqa: E402
from torchpruner_tpu.experiments.prune_retrain import (  # noqa: E402
    MODEL_REGISTRY as J_REGISTRY,
)
from torchpruner_tpu.utils.flops import (  # noqa: E402
    predicted_hbm_bytes_per_chip as j_watermark,
)
from torchpruner_tpu_torch import models as PMOD  # noqa: E402
from torchpruner_tpu_torch.analysis import (  # noqa: E402
    host_lint as PH,
    lint_config,
    lint_preset,
    severity_config,
)
from torchpruner_tpu_torch.analysis import plan_lint as PPL  # noqa: E402
from torchpruner_tpu_torch.analysis import sharding_lint as PSL  # noqa: E402
from torchpruner_tpu_torch.core import plan as PPLAN  # noqa: E402
from torchpruner_tpu_torch.core.graph import group_for  # noqa: E402
from torchpruner_tpu_torch.core.pruner import plan_for_group  # noqa: E402
from torchpruner_tpu_torch.core.segment import init_model  # noqa: E402
from torchpruner_tpu_torch.experiments.presets import (  # noqa: E402
    MODEL_REGISTRY,
    PRESETS,
)
from torchpruner_tpu_torch.train import optim  # noqa: E402
from torchpruner_tpu_torch.utils.flops import (  # noqa: E402
    predicted_hbm_bytes_per_chip,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(findings):
    return [(f.check, f.severity, f.path) for f in findings]


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# -- the memory watermark -----------------------------------------------------

WATERMARK_CASES = [
    (m, mesh, part, zero)
    for m, mesh, part, zero in itertools.product(
        ["bert_tiny", "llama_tiny"],
        [{}, {"data": 2}, {"data": 2, "model": 2}], ["fsdp", "tp"],
        [False, True])
    if not (zero and "data" not in mesh)
]


@pytest.mark.parametrize("name,mesh,partition,zero", WATERMARK_CASES)
def test_watermark_equals_jax(name, mesh, partition, zero):
    got = predicted_hbm_bytes_per_chip(
        MODEL_REGISTRY[name][0](), mesh, partition=partition, zero=zero,
        tx=optim.adam(1e-3), batch_per_chip=4)
    want = j_watermark(
        J_REGISTRY[name][0](), mesh, partition=partition, zero=zero,
        tx=optax.adam(1e-3), batch_per_chip=4)
    assert got == want


def test_hbm_capacity_is_chip_less_by_default(monkeypatch):
    from torchpruner_tpu_torch.utils.flops import (
        CPU_HBM_CAPACITY_BYTES,
        hbm_capacity,
    )

    monkeypatch.delenv("TORCHPRUNER_PLAN_HBM_BYTES", raising=False)
    assert hbm_capacity() == CPU_HBM_CAPACITY_BYTES
    assert hbm_capacity("cpu") == CPU_HBM_CAPACITY_BYTES
    monkeypatch.setenv("TORCHPRUNER_PLAN_HBM_BYTES", "1024")
    assert hbm_capacity() == 1024.0


# -- plan lint ----------------------------------------------------------------

TINY = sorted(k for k in MODEL_REGISTRY if k.endswith("_tiny"))


@pytest.mark.parametrize("name", TINY)
def test_model_plans_lint_like_jax(name):
    got = PPL.lint_model_plans(MODEL_REGISTRY[name][0]())
    want = JPL.lint_model_plans(J_REGISTRY[name][0]())
    assert [(f.check, f.severity, f.path, f.message) for f in got] == \
        [(f.check, f.severity, f.path, f.message) for f in want]


def test_abstract_trees_hold_no_bytes():
    model = MODEL_REGISTRY["bert_tiny"][0]()
    state = torch.random.get_rng_state()
    params, _ = PPL.abstract_trees(model)
    assert torch.equal(state, torch.random.get_rng_state())  # no draws
    leaves = [v for layer in params.values() for v in _leaves(layer)]
    assert leaves and all(t.device.type == "meta" for t in leaves)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


FAMILIES = [("digits_fc", "fc1"), ("digits_convnet", "conv1"),
            ("llama_tiny", "block1_ffn/gate")]


def _corrupt(plan, i, **changes):
    """``plan`` with slice ``i`` replaced by a mutated copy."""
    slices = list(plan.slices)
    slices[i] = dataclasses.replace(slices[i], **changes)
    return dataclasses.replace(plan, slices=tuple(slices))


def _corruptions(plan):
    def corrupt(i, **changes):
        return _corrupt(plan, i, **changes)

    return {
        "missing-path": corrupt(0, path=("definitely", "missing")),
        "axis": corrupt(0, axis=9),
        "fan-out": corrupt(0, fan_out=7),
        "unit-count": dataclasses.replace(plan, n_units=plan.n_units - 1),
        "overlap": dataclasses.replace(
            plan, slices=plan.slices + (plan.slices[0],)),
        "empty": dataclasses.replace(plan, n_units=0),
    }


@pytest.mark.parametrize("family,target", FAMILIES)
def test_golden_corruptions_like_jax(family, target):
    jm, pm = getattr(JMOD, family)(), getattr(PMOD, family)()
    jplan = j_plan(jm, j_group_for(jm, target))
    pplan = plan_for_group(pm, group_for(pm, target))
    assert PPLAN.plan_to_dict(pplan) == JPLAN.plan_to_dict(jplan)
    jp, js = JPL.abstract_trees(jm)
    pp, ps = PPL.abstract_trees(pm)
    assert PPL.lint_plan(pplan, pp, ps) == []
    jc, pc = _corruptions(jplan), _corruptions(pplan)
    for kind in jc:
        want = JPL.lint_plan(jc[kind], jp, js)
        got = PPL.lint_plan(pc[kind], pp, ps)
        assert want, kind
        assert [(f.check, f.severity, f.path, f.message) for f in got] == \
            [(f.check, f.severity, f.path, f.message) for f in want], kind
    # a state-carrying group without its state tree
    assert rows(PPL.lint_plan(pplan, pp, None)) == \
        rows(JPL.lint_plan(jplan, jp, None))


def test_apply_plan_preflight_raises_before_touching_a_tensor():
    model = PMOD.digits_fc()
    params, state = init_model(model, device="cpu")
    before = {k: {n: t.clone() for n, t in v.items()}
              for k, v in params.items()}
    plan = plan_for_group(model, group_for(model, "fc1"))
    bad = _corrupt(plan, 0, path=("fc9", "w"))
    with pytest.raises(PPLAN.PlanError) as ei:
        PPLAN.apply_plan(bad, [0], params, state=state)
    assert "fc9/w" in str(ei.value) and "plan/missing-path" in str(ei.value)
    assert isinstance(ei.value, ValueError)
    with pytest.raises(PPLAN.PlanError, match="axis 6"):
        PPLAN.apply_plan(_corrupt(plan, 0, axis=6), [0], params,
                         state=state)
    for k, v in params.items():
        for n, t in v.items():
            assert torch.equal(t, before[k][n])
    p2, _, _ = PPLAN.apply_plan(plan, [0], params, state=state)
    assert p2["fc1"]["w"].shape[1] == params["fc1"]["w"].shape[1] - 1


def test_severity_override_silences_the_preflight():
    model = PMOD.digits_convnet()
    params, state = init_model(model, device="cpu")
    plan = plan_for_group(model, group_for(model, "conv1"))
    with pytest.raises(PPLAN.PlanError):  # state required, not given
        PPLAN.apply_plan(plan, [0], params, state=None)
    severity_config.overrides["plan/missing-collection"] = "warning"
    try:
        p2, _, _ = PPLAN.apply_plan(plan, [0], params, state=None)
        assert p2["conv1"]["w"].shape[3] == params["conv1"]["w"].shape[3] - 1
    finally:
        severity_config.overrides.pop("plan/missing-collection")


@pytest.mark.parametrize("family,target", FAMILIES)
def test_jax_serialized_plan_slices_the_same(family, target, tmp_path):
    jm = getattr(JMOD, family)()
    jparams, jstate = j_init(jm, seed=0)
    jplan = j_plan(jm, j_group_for(jm, target))
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(JPLAN.plan_to_dict(jplan)))
    pplan = PPLAN.plan_from_dict(json.loads(path.read_text()))
    drop = [0, 3, 5]
    jp, js, _ = JPLAN.apply_plan(jplan, drop, jparams, state=jstate)
    pp, ps, _ = PPLAN.apply_plan(pplan, drop, torch_tree(jparams),
                                 state=torch_tree(jstate))
    for a, b in ((pp, jp), (ps, js)):
        for (pa, x), (_, y) in zip(_flat(a), _flat(b)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=pa)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


# -- sharding lint ------------------------------------------------------------


def _msg(f):
    # MemoryBudget.report says "per-rank" in the port, "per-chip" in JAX
    return f.message.replace("per-rank:", "per-chip:")


@pytest.mark.parametrize("name,partition", list(itertools.product(
    ["bert_tiny", "llama_tiny", "vit_tiny"], ["fsdp", "tp"])))
def test_sharding_lint_like_jax(name, partition):
    mesh = {"data": 2, "model": 2}
    got = PSL.lint_sharding(MODEL_REGISTRY[name][0](), mesh,
                            partition=partition)
    want = JSL.lint_sharding(J_REGISTRY[name][0](), mesh,
                             partition=partition)
    assert [(*r, _msg(f)) for r, f in zip(rows(got), got)] == \
        [(*r, f.message) for r, f in zip(rows(want), want)]
    if name == "bert_tiny" and partition == "fsdp":
        assert rows(got) == [("sharding/hbm-delta", "info", "<per-chip>")]


SHARDING_CASES = {
    "gqa-breaking": ("llama_tiny", {"data": 1, "model": 2}, "tp",
                     "block1_attn/attn", [2, 3]),
    "gqa-even": ("llama_tiny", {"data": 1, "model": 2}, "tp",
                 "block1_attn/attn", [0, 3]),
    "ffn-shrink": ("llama_tiny", {"model": 2}, "fsdp", "block1_ffn/gate",
                   list(range(32))),
}


@pytest.mark.parametrize("case", sorted(SHARDING_CASES))
def test_sharding_cases_like_jax(case):
    name, mesh, part, target, drop = SHARDING_CASES[case]
    kw = dict(partition=part, targets=[target], drops={target: drop},
              min_size=4)
    got = PSL.lint_sharding(MODEL_REGISTRY[name][0](), mesh, **kw)
    want = JSL.lint_sharding(J_REGISTRY[name][0](), mesh, **kw)
    assert [(*r, _msg(f)) for r, f in zip(rows(got), got)] == \
        [(*r, f.message) for r, f in zip(rows(want), want)]
    checks = [f.check for f in got]
    assert ("sharding/gqa-indivisible" in checks) == (case == "gqa-breaking")


def test_replication_fallback_like_jax():
    from torchpruner_tpu.core import layers as JL
    from torchpruner_tpu.core.segment import SegmentedModel as JSM
    from torchpruner_tpu_torch.convert import model_from_reference

    jm = JSM(layers=(JL.Dense("fc1", 128, use_bias=False),
                     JL.Activation("act", "relu"),
                     JL.Dense("fc2", 4, use_bias=False)),
             input_shape=(17,))
    pm = model_from_reference(jm)
    for drop, n in (([0], 1), ([], 0)):
        kw = dict(partition="fsdp", targets=["fc1"], drops={"fc1": drop},
                  min_size=4)
        got = PSL.lint_sharding(pm, {"model": 2}, **kw)
        want = JSL.lint_sharding(jm, {"model": 2}, **kw)
        assert rows(got) == rows(want)
        fb = [f.path for f in got
              if f.check == "sharding/replicated-fallback"]
        assert fb == ["fc1/w"][:n]


def test_lint_config_with_broken_plan_reports_instead_of_crashing():
    from torchpruner_tpu_torch.utils.config import ExperimentConfig

    model = PMOD.digits_fc()
    plan = plan_for_group(model, group_for(model, "fc1"))
    bad = _corrupt(plan, 0, path=("fc9", "w"))
    cfg = ExperimentConfig(name="broken", model="digits_fc",
                           mesh={"model": 2})
    report = lint_config(cfg, model=model, plans=[bad], host=False)
    assert not report.ok
    assert [f.check for f in report.errors] == ["plan/missing-path"]
    assert not any(f.lint == "sharding" for f in report.findings)
    clean = lint_config(cfg, model=model, plans=[plan], host=False)
    assert clean.ok and any(f.check == "sharding/hbm-delta"
                            for f in clean.findings)


@pytest.mark.parametrize("smoke", [True, False])
def test_every_preset_lints_clean(smoke):
    for name in PRESETS:
        report = lint_preset(name, smoke=smoke)
        assert report.ok, f"{name}: {report.format()}"


def test_shard_params_fallback_line_follows_the_severity(caplog):
    from torchpruner_tpu_torch.parallel.sharding import shard_params

    class Mesh:  # rank 0 of a two-rank model axis
        mesh_dim_names = ("model",)
        mesh = np.zeros((2,))

        @staticmethod
        def get_coordinate():
            return [0]

    tree = {"w": torch.ones(33, 513), "small": torch.ones(2)}
    with caplog.at_level(logging.INFO, logger="torchpruner_tpu_torch"):
        shard_params(tree, Mesh(), min_size=4)
    assert any("sharding/replicated-fallback" in r.message
               and "w (33, 513)" in r.message for r in caplog.records)
    caplog.clear()
    severity_config.overrides["sharding/replicated-fallback"] = "ignore"
    try:
        with caplog.at_level(logging.DEBUG, logger="torchpruner_tpu_torch"):
            shard_params(tree, Mesh(), min_size=4)
        assert not caplog.records
    finally:
        severity_config.overrides.pop("sharding/replicated-fallback")


# -- host lint ----------------------------------------------------------------


def _host_fixtures():
    """Every Python source the JAX package's host-lint tests scan: the
    string constants of tests/test_host_lint.py that hold a def or a
    class."""
    path = os.path.join(REPO, "tests", "test_host_lint.py")
    tree = ast.parse(open(path).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str) and \
                ("def " in node.value.value or "class " in node.value.value):
            name = node.targets[0].id if isinstance(
                node.targets[0], ast.Name) else "src"
            out[f"{name}@{node.lineno}"] = node.value.value
    return out


HOST_FIXTURES = _host_fixtures()


@pytest.mark.parametrize("name", sorted(HOST_FIXTURES))
def test_host_fixture_findings_equal_jax(name):
    src = HOST_FIXTURES[name]
    got = PH.scan_source(src, f"synthetic/{name}.py")
    want = JH.scan_source(src, f"synthetic/{name}.py")
    assert [(*r, f.message) for r, f in zip(rows(got), got)] == \
        [(*r, f.message) for r, f in zip(rows(want), want)]


def test_host_fixtures_cover_every_check():
    assert len(HOST_FIXTURES) >= 10
    fired = {f.check for src in HOST_FIXTURES.values()
             for f in PH.scan_source(src, "x.py")}
    assert {"host/unlocked-shared-write", "host/blocking-under-lock",
            "host/lock-order", "host/torn-write", "host/daemon-leak",
            "host/wallclock-in-digest"} <= fired


def test_whole_port_package_scan_is_clean_and_fast():
    PH._scan_cache.clear()
    t0 = time.perf_counter()
    fs = PH.lint_host([os.path.join(REPO, "torchpruner_tpu_torch")])
    assert time.perf_counter() - t0 < 10.0
    assert [f.format() for f in fs if f.severity != "info"] == []
    waived = sorted(f.path.split(":")[0] for f in fs)
    assert waived == ["torchpruner_tpu_torch/fleet/plane.py",
                      "torchpruner_tpu_torch/ops/_build.py"]
    assert [f for f in PH.lint_host() if f.severity != "info"] == []
    assert PH.default_waivers_path() == os.path.join(
        REPO, "torchpruner_tpu_torch", "analysis", "host_lint_waivers.json")
    assert PH.host_lint_default_paths() == tuple(
        os.path.join(REPO, "torchpruner_tpu_torch", d)
        for d in ("fleet", "serve", "search", "obs", "resilience"))


def test_jax_scan_of_the_port_is_covered_by_the_port_waivers():
    fs = JH.lint_host([os.path.join(REPO, "torchpruner_tpu_torch")],
                      waivers_path=PH.default_waivers_path())
    assert [f.format() for f in fs if f.severity != "info"] == []


@pytest.mark.parametrize("kind", ["stale", "reasonless", "waived"])
def test_waiver_semantics(kind, tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(HOST_FIXTURES[next(k for k in HOST_FIXTURES
                                      if k.startswith("BLOCKING"))])
    entry = {"check": "host/blocking-under-lock", "file": "mod.py",
             "reason": "the point"}
    if kind == "stale":
        mod.write_text("x = 1\n")
    if kind == "reasonless":
        entry["reason"] = " "
    wfile = tmp_path / "w.json"
    wfile.write_text(json.dumps({"waivers": [entry]}))
    fs = PH.lint_host([str(mod)], waivers_path=str(wfile))
    want = JH.lint_host([str(mod)], waivers_path=str(wfile))
    assert rows(fs) == rows(want)
    errors = [f.check for f in fs if f.severity == "error"]
    assert errors == {"stale": ["host/stale-waiver"],
                      "reasonless": ["host/bad-waiver"],
                      "waived": []}[kind]


def test_lint_host_exit_codes(tmp_path, monkeypatch, capsys):
    out = tmp_path / "f.json"
    assert PH.host_lint_main([os.path.join(REPO, "torchpruner_tpu_torch"),
                              "--json", str(out)]) == 0
    assert json.loads(out.read_text())["errors"] == 0
    monkeypatch.setenv("TORCHPRUNER_LINT_PLANT", "unlocked_write")
    assert PH.host_lint_main([os.path.join(REPO, "torchpruner_tpu_torch",
                                           "search")]) == 1
    assert "host/unlocked-shared-write" in capsys.readouterr().out
    monkeypatch.delenv("TORCHPRUNER_LINT_PLANT")
    r = subprocess.run([sys.executable, "-m", "torchpruner_tpu_torch",
                        "lint-host"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 error(s), 0 warning(s)" in r.stdout


# -- the repaired races -------------------------------------------------------


class _FakeSession:
    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            f.write("{}")


def test_profiler_arm_while_the_loop_closes_windows(tmp_path, monkeypatch):
    """An HTTP thread arms windows (``request_window``) while the loop
    thread runs steps that open and close them.  Every True must be a
    window that is captured, the cap is never passed, and no window is
    recorded twice — a window that is stopping holds its slot, so an arm
    made meanwhile sees the cap it will reach."""
    from torchpruner_tpu_torch.obs.profile import capture as C

    def slow_stop(prof):  # widen the stop, where the race was
        time.sleep(0.002)

    monkeypatch.setattr(C, "start_session", lambda: _FakeSession())
    monkeypatch.setattr(C, "stop_session", slow_stop)
    monkeypatch.setattr(C, "window_event_counts",
                        lambda prof: {"events": 0, "device_events": 0,
                                      "kernel_events": {}})
    for max_windows in (1, 3):
        prof = C.ContinuousProfiler(str(tmp_path / str(max_windows)),
                                    window_steps=1, max_windows=max_windows)
        stop = threading.Event()
        armed = []

        def arm():
            while not stop.is_set():
                if prof.request_window():
                    armed.append(1)

        t = threading.Thread(target=arm, daemon=True)
        t.start()
        deadline = time.perf_counter() + 5.0
        while len(prof.windows) < max_windows \
                and time.perf_counter() < deadline:
            prof.on_step(0.001)
        for _ in range(50):  # let any late arm surface
            prof.on_step(0.001)
        stop.set()
        t.join()
        windows = prof.close()
        assert len(windows) == max_windows
        assert len(armed) == max_windows
        assert [w["index"] for w in windows] == list(range(max_windows))
        assert all(w["on_demand"] for w in windows)
        assert not prof._want_window


def test_profiler_close_from_another_thread_stops_once(tmp_path,
                                                        monkeypatch):
    from torchpruner_tpu_torch.obs.profile import capture as C

    monkeypatch.setattr(C, "start_session", lambda: _FakeSession())
    monkeypatch.setattr(C, "stop_session", lambda prof: None)
    monkeypatch.setattr(C, "window_event_counts",
                        lambda prof: {"events": 0, "device_events": 0,
                                      "kernel_events": {}})
    prof = C.ContinuousProfiler(str(tmp_path), window_steps=100)
    assert prof.request_window()
    prof.on_step()  # opens on this thread
    closer = threading.Thread(target=prof.close)
    closer.start()
    closer.join()
    prof.on_step()  # the loop finds the window gone
    prof.close()
    assert len(prof.windows) == 1 and prof.windows[0].get("torn")
    assert prof.failed and not prof.request_window()


def test_scheduler_shed_counts_under_the_queue_lock():
    """``_tenant_shed_locked`` (was ``_tenant_shed``): every caller holds
    the queue lock, which the name now says; the per-reason and
    per-tenant counts still land."""
    from torchpruner_tpu_torch.serve import scheduler as S

    assert not hasattr(S.Scheduler, "_tenant_shed")
    src = open(S.__file__).read()
    tree = ast.parse(src)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == "_tenant_shed_locked"]
    assert len(calls) == 3
    assert [f for f in PH.scan_source(src, "serve/scheduler.py")
            if f.severity != "info"] == []


# -- CLI ----------------------------------------------------------------------


def test_cli_lint_exit_codes(tmp_path, capsys):
    from torchpruner_tpu_torch.__main__ import main

    assert main(["--lint", "bert_glue_sensitivity", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "lint: bert_glue_sensitivity" in out and "0 error(s)" in out
    model = PMOD.digits_fc()
    plan = plan_for_group(model, group_for(model, "fc1"))
    d = PPLAN.plan_to_dict(_corrupt(plan, 0, path=("fc9", "w")))
    path = tmp_path / "bad_plan.json"
    path.write_text(json.dumps(d))
    assert main(["--lint", "mnist_mlp_shapley", "--smoke",
                 "--lint-plan", str(path)]) == 1
    out = capsys.readouterr().out
    assert "plan/missing-path" in out and "fc9/w" in out
    assert PPLAN.plan_from_dict(PPLAN.plan_to_dict(plan)) == plan
    with pytest.raises(SystemExit) as e:
        main(["--preset", "mnist_mlp_shapley", "--lint-plan", str(path)])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        main(["--preset", "mnist_mlp_shapley", "--plan", "auto"])
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err
