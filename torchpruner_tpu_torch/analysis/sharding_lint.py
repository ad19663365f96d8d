"""Pass 2 — sharding lint: find the tensors a prune step silently
de-shards, the attention groups it breaks for tensor parallelism, and
what the per-rank memory budget does — all from shapes.
(The port of ``torchpruner_tpu/analysis/sharding_lint.py``: the same
checks, severities and messages.)

This pass is shape arithmetic, not a program analysis.  Post-prune
shapes are recomputed the honest way: the SAME ``apply_plan`` that
executes real surgery runs over ``meta`` tensor trees (no bytes), and
the SAME placement rules (``fsdp_sharding`` / ``tp_sharding``,
``parallel/sharding.py``) assign specs over a mesh given as
``{axis: size}`` (the JAX package's ``AbstractMesh``) — so the lint can
disagree with production behavior only if production itself changes.
No device, no process group.

Reported hazards:

- ``sharding/replicated-fallback`` (warning): a tensor that was sharded
  before the prune whose surviving axis no longer divides the mesh — the
  FSDP rule then silently replicates it onto every rank;
- ``sharding/tp-fallback`` (warning): a param the pruning-graph TP rule
  claims whose post-prune shape fails the divisibility check, demoting a
  column/row-parallel matmul to the FSDP rule;
- ``sharding/tp-head-indivisible`` (warning) /
  ``sharding/gqa-indivisible`` (error): an attention layer whose
  surviving query heads no longer divide the model axis, or no longer
  spread evenly over their KV heads;
- ``sharding/hbm-delta`` (info) / ``sharding/hbm-overflow`` (error): the
  per-rank parameter/grad/optimizer/activation byte budget before and
  after the prune (``parallel/memory.py``), and whether it fits a given
  memory size.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchpruner_tpu_torch.analysis.findings import Finding
from torchpruner_tpu_torch.analysis.plan_lint import abstract_trees
from torchpruner_tpu_torch.core import layers as L

PASS = "sharding"


def simulate_prune(
    model, params, state, target: str, drop: Sequence[int]
) -> Tuple[Any, Any, Any]:
    """``(model', params', state')`` after pruning ``drop`` from
    ``target`` — the spec rebuilt in Python, the ``meta`` trees
    re-shaped through ``apply_plan`` (nothing materialized)."""
    from torchpruner_tpu_torch.core.graph import group_for
    from torchpruner_tpu_torch.core.plan import apply_plan
    from torchpruner_tpu_torch.core.pruner import (
        plan_for_group,
        pruned_model_spec,
    )

    group = group_for(model, target)
    plan = plan_for_group(model, group)
    drop = np.unique(np.asarray(drop, dtype=np.int64).reshape(-1))
    new_params, new_state, _ = apply_plan(plan, drop, params, state=state)
    return pruned_model_spec(model, group, drop), new_params, new_state


def uniform_drops(
    model, targets: Sequence[str], fraction: float, bucket: int = 1
) -> Dict[str, np.ndarray]:
    """The lowest-index ``fraction`` of each target's units (bucket-
    rounded like the real policy) — the shape template a fraction-policy
    sweep will produce.  Shapes, and therefore every check in this pass,
    depend only on the COUNT."""
    from torchpruner_tpu_torch.core.pruner import score_drop_indices

    out = {}
    for t in targets:
        n = L.n_units(model.layer(t))
        out[t] = score_drop_indices(
            np.arange(n, dtype=np.float64), policy="fraction",
            fraction=fraction, bucket=bucket,
        )
    return out


def _shardings(model, params, mesh, partition: str, min_size: int):
    from torchpruner_tpu_torch.parallel.sharding import (
        fsdp_sharding,
        tp_sharding,
    )

    if partition == "tp":
        return tp_sharding(model, params, mesh, min_size=min_size)
    return fsdp_sharding(params, mesh, min_size=min_size)


def _spec_leaves(shardings) -> List[Tuple[str, Any]]:
    """``[(a/b/c path, spec)]`` in the JAX package's flattening order
    (dict keys sorted at every level)."""
    from torchpruner_tpu_torch.parallel.sharding import leaf_paths

    return [("/".join(path), spec)
            for path, spec in sorted(leaf_paths(shardings),
                                     key=lambda e: e[0])]


def lint_sharding(
    model,
    mesh_axes: Dict[str, int],
    *,
    partition: str = "fsdp",
    targets: Optional[Sequence[str]] = None,
    drops: Optional[Dict[str, Sequence[int]]] = None,
    fraction: float = 0.25,
    bucket: int = 1,
    min_size: int = 2 ** 14,
    tx=None,
    batch_per_chip: int = 1,
    param_dtype=torch.float32,
    compute_dtype=None,
    remat: bool = False,
    hbm_bytes: Optional[int] = None,
    zero: bool = False,
) -> List[Finding]:
    """Findings for pruning ``targets`` of ``model`` (by ``fraction``, or
    explicit per-target ``drops``) under a ``mesh_axes`` mesh.

    ``targets=None`` prunes every group the static graph derives (the
    classifier head excluded), mirroring a full sweep.  ``zero`` counts
    optimizer slots at their ZeRO weight-update placement
    (``ShardedTrainer(zero=True)``) in the memory budget, so the
    hbm-delta/overflow findings match what the trainer will plan.
    """
    from torchpruner_tpu_torch.core.graph import pruning_graph
    from torchpruner_tpu_torch.parallel.sharding import leaf_paths

    mesh = dict(mesh_axes)  # what the placement rules take, no devices
    params, state = abstract_trees(model)
    findings: List[Finding] = []

    if targets is None:
        targets = [g.target for g in pruning_graph(model)]
    if drops is None:
        drops = uniform_drops(model, targets, fraction, bucket)

    pre_model, pre_params = model, params
    post_model, post_params, post_state = model, params, state
    for t in targets:
        if not len(np.asarray(drops.get(t, ()), dtype=np.int64)):
            continue
        post_model, post_params, post_state = simulate_prune(
            post_model, post_params, post_state, t, drops[t]
        )

    pre_sh = _shardings(pre_model, pre_params, mesh, partition, min_size)
    post_sh = _shardings(post_model, post_params, mesh, partition, min_size)

    # --- replication fallback: sharded before, replicated after ---------
    pre_specs = dict(_spec_leaves(pre_sh))
    post_shapes = {
        "/".join(path): tuple(leaf.shape)
        for path, leaf in leaf_paths(post_params)
    }
    for path, spec in _spec_leaves(post_sh):
        pre = pre_specs.get(path)
        was_sharded = pre is not None and any(a is not None for a in pre)
        now_replicated = all(a is None for a in spec)
        if was_sharded and now_replicated:
            shape = post_shapes.get(path, ())
            findings.append(Finding(
                "warning", PASS, "sharding/replicated-fallback", path,
                f"was sharded {tuple(pre)} pre-prune; post-prune shape "
                f"{shape} divides no mesh axis, so it silently replicates "
                f"onto all {int(np.prod(list(mesh_axes.values())))} chips",
            ))

    # --- TP claims that no longer hold ---------------------------------
    if partition == "tp":
        from torchpruner_tpu_torch.parallel.sharding import tp_specs

        claimed = tp_specs(post_model, mesh)
        actual = dict(_spec_leaves(post_sh))
        for (layer, pname), spec in claimed.items():
            path = f"{layer}/{pname}"
            got = actual.get(path)
            if got is not None and tuple(got) != tuple(spec):
                findings.append(Finding(
                    "warning", PASS, "sharding/tp-fallback", path,
                    f"pruning-graph TP wants {tuple(spec)} but the "
                    f"post-prune shape {post_shapes.get(path, ())} fails "
                    f"the divisibility check — demoted to the FSDP rule",
                ))
        findings += _lint_gqa(post_model, mesh_axes)

    # --- per-rank memory budget ----------------------------------------
    from torchpruner_tpu_torch.parallel.memory import training_memory

    budgets = []
    for m, p, sh in (
        (pre_model, pre_params, pre_sh),
        (post_model, post_params, post_sh),
    ):
        budgets.append(training_memory(
            m, sh, dict(mesh_axes), tx=tx, batch_per_chip=batch_per_chip,
            param_dtype=param_dtype, compute_dtype=compute_dtype,
            remat=remat, params=p, zero=zero,
        ))
    pre_b, post_b = budgets
    gib = 2.0 ** 30
    findings.append(Finding(
        "info", PASS, "sharding/hbm-delta", "<per-chip>",
        f"{pre_b.total_bytes / gib:.3f} GiB -> "
        f"{post_b.total_bytes / gib:.3f} GiB "
        f"({(post_b.total_bytes - pre_b.total_bytes) / gib:+.3f} GiB); "
        f"post-prune: {post_b.report()}",
    ))
    if hbm_bytes is not None and not post_b.fits(hbm_bytes):
        findings.append(Finding(
            "error", PASS, "sharding/hbm-overflow", "<per-chip>",
            f"post-prune budget {post_b.total_bytes / gib:.2f} GiB exceeds "
            f"85% of {hbm_bytes / gib:.0f} GiB HBM",
        ))
    return findings


def _lint_gqa(model, mesh_axes: Dict[str, int]) -> List[Finding]:
    """GQA hazards of the CURRENT (already-pruned) model spec under
    head-axis tensor parallelism."""
    size = mesh_axes.get("model", 1)
    if size <= 1:
        return []
    findings: List[Finding] = []
    for path, spec in _walk_layers(model.layers, ()):
        if not isinstance(spec, L.MultiHeadAttention):
            continue
        if spec.num_heads % size:
            findings.append(Finding(
                "warning", PASS, "sharding/tp-head-indivisible", path,
                f"{spec.num_heads} query heads do not divide the model "
                f"axis ({size}) — the whole attention group falls back to "
                f"the FSDP rule",
            ))
            continue
        if spec.kv_heads == spec.num_heads and spec.kv_group is None:
            continue  # MHA proper: KV sliced alongside Q, always aligned
        assigned = Counter(spec.head_kv_index())
        # count over ALL kv heads: one left with zero surviving query
        # heads is as broken as an overloaded one
        counts = {k: assigned.get(k, 0) for k in range(spec.kv_heads)}
        uneven = len(set(counts.values())) > 1
        if uneven or spec.kv_heads % size:
            findings.append(Finding(
                "error", PASS, "sharding/gqa-indivisible", path,
                f"surviving query heads map onto KV heads as {counts}"
                + (" (uneven groups)" if uneven else "")
                + f"; head-axis sharding over {size} chips would misalign "
                f"query heads with the KV heads they read — re-prune with "
                f"a KV-group-respecting drop set",
            ))
    return findings


def _walk_layers(layers, prefix) -> List[Tuple[str, Any]]:
    out = []
    for l in layers:
        path = prefix + (l.name,)
        if isinstance(l, L.Residual):
            out += _walk_layers(l.body + l.shortcut, path)
        else:
            out.append(("/".join(path), l))
    return out
