"""The port's figures (``torchpruner_tpu_torch/utils/plotting.py``) on the
CPU against the JAX package's: on the same fake results each function
draws what the JAX one draws (every line's x / y data, labels, colours,
bars, texts and titles, read back from the returned figures); and the
VGG smoke sweep with ``plot_dir`` writes one ``robustness_<layer>.png`` a
swept layer plus ``auc_summary.png``.  matplotlib is needed here; the
card's machine has none, so the figures are held on the CPU only."""

import _torch_threads  # noqa: F401  (caps torch's threads)
import dataclasses
import os

import numpy as np
import pytest

from torchpruner_tpu.utils import plotting as JP
from torchpruner_tpu_torch.utils import plotting as PP

METHODS = ("sv", "taylor", "sensitivity", "random", "mystery")


def fake_results(seed=0, n_units=12):
    """``layerwise_robustness``-shaped results: two layers, a stochastic
    method with three runs, the others one."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer in ("conv1", "block2/fc1"):
        out[layer] = {}
        for m in METHODS:
            runs = []
            for _ in range(3 if m in ("sv", "random") else 1):
                loss = np.cumsum(rng.uniform(0, 0.2, n_units)) + 0.3
                acc = 1.0 - np.cumsum(rng.uniform(0, 0.05, n_units))
                runs.append({"loss": loss.tolist(), "acc": acc.tolist(),
                             "base_loss": 0.3, "base_acc": 1.0})
            out[layer][m] = runs
    return out


class Rec:
    def __init__(self, i):
        self.layer = f"block{i}_mlp/fc1"
        self.pre_acc = 0.9 - 0.01 * i
        self.post_acc = 0.85 - 0.02 * i
        self.n_params = 1000 - 100 * i


def describe(fig):
    """What a figure draws, axis by axis, as plain data."""
    from matplotlib.colors import to_hex

    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "lines": [(ln.get_label(), to_hex(ln.get_color()),
                       np.asarray(ln.get_xdata(), float).tolist(),
                       np.asarray(ln.get_ydata(), float).tolist(),
                       ln.get_linestyle(), ln.get_marker(),
                       ln.get_linewidth()) for ln in ax.get_lines()],
            "fills": [(to_hex(c.get_facecolor()[0], keep_alpha=True),
                       [p.vertices.tolist() for p in c.get_paths()])
                      for c in ax.collections],
            "bars": [(p.get_x(), p.get_y(), p.get_width(), p.get_height(),
                      to_hex(p.get_facecolor())) for p in ax.patches],
            "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
            "yticks": [t.get_text() for t in ax.get_yticklabels()],
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
            "legend": [t.get_text() for t in legend.get_texts()]
            if legend else None,
            "size": tuple(fig.get_size_inches()), "dpi": fig.dpi,
        })
    return axes


def _aucs(results):
    return {m: float(np.mean([np.mean(r["loss"]) for r in runs]))
            for m, runs in results["conv1"].items()}


CASES = {
    "curves_loss": lambda M, r: M.plot_robustness_curves(r, "conv1"),
    "curves_acc": lambda M, r: M.plot_robustness_curves(
        r, "block2/fc1", metric="acc"),
    "auc_summary": lambda M, r: M.plot_auc_summary(_aucs(r)),
    "auc_with_reference": lambda M, r: M.plot_auc_summary(
        _aucs(r), reference={"sv": 0.5, "taylor": 0.7, "ghost": 1.0}),
    "prune_history": lambda M, r: M.plot_prune_history(
        [Rec(i) for i in range(1, 5)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_figure_matches_jax(case):
    import matplotlib.pyplot as plt

    results = fake_results()
    got, want = CASES[case](PP, results), CASES[case](JP, results)
    try:
        d = describe(got)
        assert d == describe(want)
        assert d and any(a["lines"] or a["bars"] for a in d)
    finally:
        plt.close(got)
        plt.close(want)


def test_method_styles_match_jax():
    assert PP.METHOD_STYLE == JP.METHOD_STYLE
    assert PP.method_style("mystery") == JP.method_style("mystery")


def test_saved_figures_are_closed(tmp_path):
    import matplotlib.pyplot as plt

    before = len(plt.get_fignums())
    PP.plot_robustness_curves(fake_results(), "conv1",
                              save_path=str(tmp_path / "c.png"))
    PP.plot_prune_history([Rec(1), Rec(2)],
                          save_path=str(tmp_path / "h.png"))
    assert len(plt.get_fignums()) == before
    assert (tmp_path / "c.png").stat().st_size > 0
    assert (tmp_path / "h.png").stat().st_size > 0


def test_vgg_smoke_sweep_writes_its_figures(tmp_path):
    """The smoke preset's sweep on three layers with ``plot_dir``: one
    curve figure a swept layer plus the AUC summary, after the results;
    the results file is the one written without ``plot_dir``."""
    import json

    from torchpruner_tpu_torch.experiments import presets as PPS
    from torchpruner_tpu_torch.experiments import robustness as PR

    over = dict(target_filter=("conv2", "conv13", "fc1"),
                method_kwargs={"sv_samples": 2},
                log_path=str(tmp_path / "l.csv"))
    plots = tmp_path / "figs"
    cfg = dataclasses.replace(
        PPS.get_preset("vgg16_digits32_layerwise", smoke=True), **over,
        plot_dir=str(plots), results_path=str(tmp_path / "r.json"))
    aucs = PR.run_robustness_config(cfg, verbose=False, device="cpu")
    assert sorted(os.listdir(plots)) == [
        "auc_summary.png", "robustness_conv13.png", "robustness_conv2.png",
        "robustness_fc1.png"]
    assert all((plots / f).stat().st_size > 0 for f in os.listdir(plots))
    plain = dataclasses.replace(cfg, plot_dir="",
                                results_path=str(tmp_path / "p.json"))
    assert PR.run_robustness_config(plain, verbose=False,
                                    device="cpu") == aucs
    assert json.load(open(tmp_path / "r.json"))["auc_summary"] == aucs
