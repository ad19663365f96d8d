"""Figure helpers for the robustness experiments.
(A copy of ``torchpruner_tpu/utils/plotting.py``: numpy and
matplotlib only.)

The reference ships plot machinery for its paper figures — a method →
(label, color) mapping, per-layer robustness curves, and the AUC summary
(reference experiments/utils/utils.py:77-113, VGG notebook cells 10-11).
This is the same deliverable for this framework, driven by
:func:`~torchpruner_tpu_torch.experiments.robustness.layerwise_robustness`
results.

Design rules applied (colorblind-validated 8-slot categorical palette,
fixed hue order so a method keeps its color across figures, one axis per
chart, recessive grid, 2px lines, labels in neutral ink):

matplotlib is an optional dependency (present in the reference's setup.py
install_requires); every entry point raises a clear ImportError when it is
missing and never imports it at module load.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

#: fixed method -> (display label, color) assignment; the order is the
#: palette's canonical hue order and NEVER re-flows when a subset of
#: methods is plotted (color follows the method, not its rank).
METHOD_STYLE: Dict[str, tuple] = {
    "sv": ("Shapley value", "#2a78d6"),
    "sv_mean+2std": ("Shapley value (mean+2std)", "#eb6834"),
    "taylor": ("Taylor", "#1baf7a"),
    "sensitivity": ("Sensitivity", "#eda100"),
    "weight_norm": ("Weight norm", "#e87ba4"),
    "random": ("Random", "#008300"),
    "apoz": ("APoZ", "#4a3aa7"),
    "taylor_signed": ("Taylor (signed)", "#e34948"),
}
_TEXT = "#52514e"
_GRID = "#e6e5e1"


def method_style(name: str) -> tuple:
    """(label, color) for a method name; unknown methods get a neutral."""
    return METHOD_STYLE.get(name, (name, "#6b6a66"))


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover - matplotlib is installed
        raise ImportError(
            "plotting needs matplotlib (pip install matplotlib)"
        ) from e


def _style_axis(ax):
    ax.grid(True, color=_GRID, linewidth=0.6, axis="y")
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_GRID)
    ax.tick_params(colors=_TEXT, labelsize=8)


def plot_robustness_curves(
    results,
    layer: str,
    *,
    metric: str = "loss",
    save_path: Optional[str] = None,
):
    """One layer's robustness curves: test loss (or accuracy) as units are
    removed in ascending-score order, one line per method — the per-layer
    panel of the reference's figure (VGG notebook cell 10).  Stochastic
    methods show the mean across runs with a shaded min-max band."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.4, 3.4), dpi=150)
    for name, runs in results[layer].items():
        label, color = method_style(name)
        curves = np.stack([np.asarray(r[metric]) for r in runs])
        xs = np.arange(1, curves.shape[1] + 1)
        ax.plot(xs, curves.mean(0), color=color, linewidth=2, label=label)
        if len(runs) > 1:
            ax.fill_between(
                xs, curves.min(0), curves.max(0), color=color, alpha=0.15,
                linewidth=0,
            )
    base = next(iter(results[layer].values()))[0][f"base_{metric}"]
    ax.axhline(base, color=_GRID, linewidth=1, linestyle="--")
    ax.set_xlabel("units removed (ascending score)", color=_TEXT, fontsize=9)
    ax.set_ylabel(f"test {metric}", color=_TEXT, fontsize=9)
    ax.set_title(layer, color="#0b0b0b", fontsize=10)
    _style_axis(ax)
    ax.legend(fontsize=7, frameon=False, labelcolor=_TEXT)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)  # saved figures don't accumulate in the manager
    return fig


def plot_auc_summary(
    aucs: Dict[str, float],
    *,
    reference: Optional[Dict[str, float]] = None,
    save_path: Optional[str] = None,
):
    """The loss-increase-AUC comparison (reference notebook cell 11):
    horizontal bars, best (lowest) method on top, each bar in its method's
    fixed color with the value direct-labeled.  ``reference`` optionally
    overlays the reference's numbers as markers for a parity figure."""
    plt = _plt()
    order = sorted(aucs, key=aucs.get)
    fig, ax = plt.subplots(figsize=(5.4, 0.42 * len(order) + 1.2), dpi=150)
    ys = np.arange(len(order))[::-1]
    vals = [aucs[m] for m in order]
    colors = [method_style(m)[1] for m in order]
    ax.barh(ys, vals, height=0.62, color=colors)
    span = max(vals) - min(min(vals), 0) or 1.0
    for y, v in zip(ys, vals):
        ax.text(v + 0.02 * span, y, f"{v:.3f}", va="center",
                fontsize=7, color=_TEXT)
    if reference:
        for y, m in zip(ys, order):
            if m in reference:
                ax.plot(reference[m], y, marker="D", markersize=5,
                        color="#0b0b0b", linestyle="none")
        ax.plot([], [], marker="D", markersize=5, color="#0b0b0b",
                linestyle="none", label="reference")
        ax.legend(fontsize=7, frameon=False, labelcolor=_TEXT)
    ax.set_yticks(ys)
    ax.set_yticklabels([method_style(m)[0] for m in order], fontsize=8,
                       color=_TEXT)
    ax.set_xlabel("avg. test-loss increase per unit removed (lower = "
                  "better ranking)", color=_TEXT, fontsize=8)
    _style_axis(ax)
    ax.grid(False, axis="y")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)  # saved figures don't accumulate in the manager
    return fig


def plot_prune_history(
    records: Sequence,
    *,
    save_path: Optional[str] = None,
):
    """Accuracy and parameter count across the prune-retrain loop
    (:class:`~torchpruner_tpu_torch.experiments.prune_retrain.PruneStepRecord`
    list) — two stacked single-axis panels, never a dual-axis chart."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(5.4, 4.2), dpi=150, sharex=True
    )
    xs = np.arange(len(records))
    pre = [r.pre_acc for r in records]
    post = [r.post_acc for r in records]
    ax1.plot(xs, pre, color="#2a78d6", linewidth=2, label="before prune")
    ax1.plot(xs, post, color="#eb6834", linewidth=2, label="after prune")
    ax1.set_ylabel("test accuracy", color=_TEXT, fontsize=9)
    ax1.legend(fontsize=7, frameon=False, labelcolor=_TEXT)
    _style_axis(ax1)
    ax2.plot(xs, [r.n_params for r in records], color="#1baf7a", linewidth=2)
    ax2.set_ylabel("parameters", color=_TEXT, fontsize=9)
    ax2.set_xlabel("prune step", color=_TEXT, fontsize=9)
    ax2.set_xticks(xs)
    ax2.set_xticklabels([r.layer for r in records], rotation=30,
                        ha="right", fontsize=7)
    _style_axis(ax2)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)  # saved figures don't accumulate in the manager
    return fig
