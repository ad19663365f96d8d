"""Layerwise-robustness ablation sweep — counterpart of
``torchpruner_tpu/experiments/robustness.py``: for each prunable layer
and attribution method, zero the layer's units one at a time in
ascending-score order at its evaluation site and record the test loss
and accuracy after each removal.

The walk batches the rankings as Shapley batches its permutations (the
JAX package ``vmap``s them): per data batch the eval-site activation is
computed once, and each of the ``n`` unit steps is ONE suffix call on
``R x B`` rows, every ranking's copy of the batch under its own
cumulative mask.  The base metrics come from the unmasked suffix;
logits are promoted to f32 before the loss.

The sweep runs uncached: every metric and walk recomputes the prefix
forward.  The JAX package's one-pass capture engine (``cfg.capture``)
computes the same numbers from a shared activation; the port accepts
the flag and runs the uncached path (ROADMAP A2c adds the cache).  A
mesh (A7), ``run_dir`` (A8) and ``plot_dir`` (A8) raise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from torchpruner_tpu_torch.attributions.base import prefix_fn
from torchpruner_tpu_torch.core.graph import (
    find_best_evaluation_layer,
    pruning_graph,
)
from torchpruner_tpu_torch.core.segment import SegmentedModel, init_model
from torchpruner_tpu_torch.train.loop import to_device
from torchpruner_tpu_torch.utils.device import (
    resolve_device,
    strict_fp32_matmul,
)
from torchpruner_tpu_torch.utils.losses import correct_per_example
from torchpruner_tpu_torch.utils.tree import cast_floats, device_of


@torch.no_grad()
def _walk_batch(model: SegmentedModel, eval_layer: str, loss_fn, params,
                state, z: torch.Tensor, y: torch.Tensor,
                rankings: torch.Tensor):
    """The cumulative-ablation walk of every ranking on one batch, from
    the eval-site activation ``z``: per-ranking ``(loss_sums, corrects)``
    of shape ``(R, n)``, then the unmasked suffix's loss sum, correct
    count and prediction count."""
    R, n = rankings.shape
    B = z.shape[0]

    def suffix(zz):
        logits, _ = model.apply(params, zz, state=state, train=False,
                                from_layer=eval_layer)
        return logits.float()

    zs = z.repeat((R,) + (1,) * (z.ndim - 1))  # row r*B + b is z[b]
    ys = y.repeat((R,) + (1,) * (y.ndim - 1))
    # the mask in the activation's dtype: a f32 mask would promote a
    # bf16 suffix back to f32
    mask = torch.ones((R, n), dtype=z.dtype, device=z.device)
    rows = (R * B,) + (1,) * (z.ndim - 2) + (n,)
    r_idx = torch.arange(R, device=z.device)
    loss_sums = torch.empty((R, n), dtype=torch.float32, device=z.device)
    corrects = torch.empty((R, n), dtype=torch.int64, device=z.device)
    for t in range(n):
        mask[r_idx, rankings[:, t]] = 0  # cumulative zeroing
        logits = suffix(zs * mask.repeat_interleave(B, dim=0).reshape(rows))
        loss_sums[:, t] = loss_fn(logits, ys).view(R, B).sum(dim=1)
        correct, _ = correct_per_example(logits, ys)
        corrects[:, t] = correct.view(R, B).sum(dim=1)
    base = suffix(z)
    base_correct, per = correct_per_example(base, y)
    return (loss_sums, corrects, loss_fn(base, y).sum(), base_correct.sum(),
            per * B)


def ablation_curves_batch(model: SegmentedModel, params, state, layer: str,
                          rankings, data, loss_fn, *,
                          eval_layer: Optional[str] = None,
                          compute_dtype=None) -> List[Dict[str, np.ndarray]]:
    """Simulated pruning of ``layer``'s units in each ranking's order:
    ``rankings`` is ``(R, n)``; returns R dicts ``{"loss": (n,), "acc":
    (n,), "base_loss", "base_acc"}``, the mean test loss and accuracy
    after each cumulative removal at ``eval_layer`` (default: the layer
    itself).  ``compute_dtype`` (``torch.bfloat16``) runs the forwards
    on params and inputs cast to it."""
    eval_layer = eval_layer or layer
    dev = device_of(params)
    rankings = torch.as_tensor(np.asarray(rankings, dtype=np.int64),
                               device=dev)
    if compute_dtype is not None:
        params = cast_floats(params, compute_dtype)
    prefix = prefix_fn(model, eval_layer)
    tot_l = tot_c = None
    base_l = base_c = 0.0
    n_examples = n_preds = 0
    for x, y in (data() if callable(data) else data):
        x, y = to_device(x, dev), to_device(y, dev)
        if compute_dtype is not None:
            x = cast_floats(x, compute_dtype)
        z = prefix(params, state, x)
        l, c, bl, bc, n_pred = _walk_batch(model, eval_layer, loss_fn,
                                           params, state, z, y, rankings)
        tot_l = l if tot_l is None else tot_l + l
        tot_c = c if tot_c is None else tot_c + c
        base_l += float(bl)
        base_c += float(bc)
        n_examples += x.shape[0]
        n_preds += int(n_pred)
    tot_l, tot_c = tot_l.cpu().numpy(), tot_c.cpu().numpy()
    return [{"loss": tot_l[r] / n_examples, "acc": tot_c[r] / n_preds,
             "base_loss": base_l / n_examples, "base_acc": base_c / n_preds}
            for r in range(rankings.shape[0])]


def ablation_curve(model: SegmentedModel, params, state, layer: str,
                   ranking, data, loss_fn, *,
                   eval_layer: Optional[str] = None,
                   compute_dtype=None) -> Dict[str, np.ndarray]:
    """:func:`ablation_curves_batch` for one ranking."""
    return ablation_curves_batch(
        model, params, state, layer, np.asarray(ranking)[None], data,
        loss_fn, eval_layer=eval_layer, compute_dtype=compute_dtype)[0]


def loss_increase_auc(curve: Dict[str, np.ndarray]) -> float:
    """Mean test-loss increase per unit removed (lower = a better
    ranking)."""
    return float(np.mean(curve["loss"] - curve["base_loss"]))


def metric_factory(method: str, model, params, batches, loss_fn, *,
                   state=None, compute_dtype=None, seed: int = 0,
                   reduction="mean", **kw) -> Callable:
    """``make(run=0)``: a fresh ``method`` metric seeded ``seed + run``,
    so the stochastic repeats of a method draw different randomness."""
    from torchpruner_tpu_torch.experiments.prune_retrain import build_metric

    def make(run: int = 0):
        return build_metric(method, model, params, batches, loss_fn,
                            state=state, reduction=reduction, seed=seed + run,
                            compute_dtype=compute_dtype, **kw)

    return make


def method_panel(model, params, batches, loss_fn, *, state=None,
                 compute_dtype=None, sv_samples: int = 5, seed: int = 0,
                 **shapley_kw) -> Dict[str, Callable]:
    """The reference's 8-method panel (random, weight_norm, apoz,
    sensitivity, taylor, signed taylor, Shapley, Shapley at mean+2std)
    as metric factories for :func:`layerwise_robustness`."""

    def factory(method, **kw):
        return metric_factory(method, model, params, batches, loss_fn,
                              state=state, compute_dtype=compute_dtype,
                              seed=seed, **kw)

    shapley = dict(shapley_kw, sv_samples=sv_samples)
    return {
        "random": factory("random"),
        "weight_norm": factory("weight_norm"),
        "apoz": factory("apoz"),
        "sensitivity": factory("sensitivity"),
        "taylor": factory("taylor"),
        "taylor_signed": factory("taylor", signed=True),
        "sv": factory("shapley", **shapley),
        "sv_mean+2std": factory("shapley", reduction="mean+2std", **shapley),
    }


def layerwise_robustness(model: SegmentedModel, params, state, test_data,
                         methods: Dict[str, Callable], loss_fn, *,
                         layers: Optional[Sequence[str]] = None,
                         runs_stochastic: int = 3,
                         stochastic: Sequence[str] = ("random", "shapley",
                                                      "sv"),
                         find_best_evaluation_layer_: bool = True,
                         compute_dtype=None, verbose: bool = True
                         ) -> Dict[str, Dict[str, List[Dict]]]:
    """The sweep: every layer (default: every prunable layer) x every
    method, ``runs_stochastic`` runs of a method whose name contains a
    ``stochastic`` word.  Per layer, every (method, run) is scored, then
    ONE batched walk ablates all the rankings at the layer's evaluation
    site (the post-BN/activation layer, whatever site a method scored
    at).  Returns ``results[layer][method] = [{scores, loss, acc,
    base_loss, base_acc, auc, seconds}, ...]``; ``seconds`` is the run's
    scoring time plus its share of the walk."""
    if layers is None:
        layers = [g.target for g in pruning_graph(model)]
    results: Dict[str, Dict[str, List[Dict]]] = {}
    for layer in layers:
        results[layer] = {}
        eval_layer = (find_best_evaluation_layer(model, layer)
                      if find_best_evaluation_layer_ else layer)
        pending = []  # (name, scores, score seconds)
        for name, factory in methods.items():
            n_runs = (runs_stochastic
                      if any(s in name.lower() for s in stochastic) else 1)
            for run in range(n_runs):
                t0 = time.perf_counter()
                scores = factory(run).run(
                    layer,
                    find_best_evaluation_layer=find_best_evaluation_layer_)
                pending.append((name, scores, time.perf_counter() - t0))
        if not pending:
            continue
        t0 = time.perf_counter()
        curves = ablation_curves_batch(
            model, params, state, layer,
            np.stack([np.argsort(s) for _, s, _ in pending]), test_data,
            loss_fn, eval_layer=eval_layer, compute_dtype=compute_dtype)
        walk_share = (time.perf_counter() - t0) / len(pending)
        for (name, scores, score_s), curve in zip(pending, curves):
            results[layer].setdefault(name, []).append({
                "scores": scores, "loss": curve["loss"], "acc": curve["acc"],
                "base_loss": curve["base_loss"],
                "base_acc": curve["base_acc"],
                "auc": loss_increase_auc(curve),
                "seconds": score_s + walk_share})
        if verbose:
            for name, runs in results[layer].items():
                aucs = [r["auc"] for r in runs]
                print(f"[robustness] {layer} / {name}: auc "
                      f"{np.mean(aucs):.4f} ± {np.std(aucs):.4f} "
                      f"({runs[0]['seconds']:.1f}s/run)", flush=True)
    return results


def _per_method_aucs(results) -> Dict[str, List[float]]:
    per_method: Dict[str, List[float]] = {}
    for layer in results.values():
        for method, runs in layer.items():
            per_method.setdefault(method, []).extend(r["auc"] for r in runs)
    return per_method


def auc_summary(results) -> Dict[str, float]:
    """Mean AUC per method across layers and runs."""
    return {m: float(np.mean(v)) for m, v in _per_method_aucs(results).items()}


def auc_summary_std(results) -> Dict[str, Dict[str, float]]:
    """``{method: {"mean", "std", "n"}}`` over the per-run AUCs."""
    return {m: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                "n": len(v)}
            for m, v in _per_method_aucs(results).items()}


def _write_results(path: str, name: str, aucs, results) -> None:
    """The JAX package's results layout: config name, AUC summary, and
    every run's arrays as lists."""
    def listify(r):
        return {k: np.asarray(v).tolist() if isinstance(v, np.ndarray)
                else v for k, v in r.items()}

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"config": name, "auc_summary": aucs,
                   "results": {layer: {m: [listify(r) for r in runs]
                                       for m, runs in methods.items()}
                               for layer, methods in results.items()}}, f)


def run_robustness_config(cfg, *, model=None, datasets=None, params=None,
                          state=None, verbose: bool = True,
                          device=None) -> Dict[str, float]:
    """Config-driven sweep on ``device`` (``None`` = ``cuda``; raises
    without a GPU unless ``device="cpu"``): ``cfg.method == "all"`` runs
    :func:`method_panel`, any other method alone, over the prunable
    layers ``cfg.target_filter`` keeps, on ``cfg.score_examples`` test
    examples.  Sweeps ``params`` / ``state`` when given (trained
    weights), else a seeded init.  Writes ``cfg.results_path`` when set;
    returns the AUC summary."""
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        LOSS_REGISTRY,
        check_ported,
        compute_dtype,
        filter_targets,
        resolve_model_and_data,
    )

    check_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32_matmul()
    model, (_, _, test) = resolve_model_and_data(cfg, model, datasets)
    if len(test) > cfg.score_examples:
        test = test.subset(cfg.score_examples, seed=cfg.seed)
    if params is None:
        params, state = init_model(model, seed=cfg.seed, device=dev)
    loss_fn = LOSS_REGISTRY[cfg.loss]
    sdtype = compute_dtype(cfg.score_dtype)
    test_batches = test.batches(cfg.eval_batch_size)
    if cfg.method == "all":
        methods = method_panel(model, params, test_batches, loss_fn,
                               state=state, compute_dtype=sdtype,
                               seed=cfg.seed, **cfg.method_kwargs)
    else:
        methods = {cfg.method: metric_factory(
            cfg.method, model, params, test_batches, loss_fn, state=state,
            compute_dtype=sdtype, seed=cfg.seed, reduction=cfg.reduction,
            **cfg.method_kwargs)}
    results = layerwise_robustness(
        model, params, state, test_batches, methods, loss_fn,
        layers=filter_targets([g.target for g in pruning_graph(model)], cfg),
        find_best_evaluation_layer_=cfg.find_best_evaluation_layer,
        compute_dtype=sdtype, verbose=verbose)
    aucs = auc_summary(results)
    if cfg.results_path:
        _write_results(cfg.results_path, cfg.name, aucs, results)
        if verbose:
            print(f"[robustness] wrote results to {cfg.results_path}",
                  flush=True)
    return aucs


def run_train_robustness(cfg, *, verbose: bool = True,
                         device=None) -> Dict[str, float]:
    """The two-phase protocol as one command: train ``cfg.model`` on
    ``cfg.dataset`` (:func:`~.train_model.run_train`), then sweep the
    trained weights (:func:`run_robustness_config`); the model and the
    splits are resolved once for both."""
    from torchpruner_tpu_torch.experiments.prune_retrain import (
        check_ported,
        resolve_model_and_data,
    )
    from torchpruner_tpu_torch.experiments.train_model import run_train

    check_ported(cfg)
    model, datasets = resolve_model_and_data(cfg, None, None)
    trainer, history = run_train(cfg, model=model, datasets=datasets,
                                 verbose=verbose, device=device)
    if verbose and history:
        print(f"[{cfg.name}] trained: test acc "
              f"{history[-1]['test_acc']:.4f} — starting sweep", flush=True)
    return run_robustness_config(
        cfg, model=trainer.model, datasets=datasets, params=trainer.params,
        state=trainer.state, verbose=verbose, device=device)
