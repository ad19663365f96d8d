"""Per-rank memory accounting for sharded training — counterpart of
``torchpruner_tpu/parallel/memory.py``.

Given a model's shapes and a placement, compute how many bytes of
parameters, gradients and optimizer slots land on each rank, without
materializing anything: the optimizer state is laid out by running the
port's ``tx.init`` (``train/optim.py``) on ``meta`` tensors, and its
param-shaped leaves take their param's spec.  ``ShardedTrainer`` places
real state by the same rules, so a rank's held bytes equal the plan.

The activation estimate is coarse (per-layer output sizes for one
microbatch, halved by remat).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from torchpruner_tpu_torch.parallel.sharding import (
    leaf_paths,
    zero_update_spec,
)

#: device memory per card (bytes) by CUDA device name, as
#: ``torch.cuda.get_device_properties(0).total_memory`` reports it on
#: that card (the H100 entry read on the card: ``chip_smoke.py`` phase
#: 30 prints it); :func:`hbm_bytes` asks the card itself
HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 85_017_493_504,
}


def hbm_bytes(device=None) -> int:
    """The card's memory as the CUDA runtime reports it, else the
    table's entry for its name."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            device or torch.cuda.current_device()).total_memory)
    raise RuntimeError("no CUDA device: look the card up in HBM_BYTES")


@dataclass
class MemoryBudget:
    """Per-rank byte accounting for one training configuration."""

    params_bytes: int
    grads_bytes: int
    opt_bytes: int
    activations_bytes: int  # coarse estimate, one microbatch
    largest_replicated: tuple  # (path, bytes): the first thing to shard

    @property
    def total_bytes(self) -> int:
        return (self.params_bytes + self.grads_bytes + self.opt_bytes
                + self.activations_bytes)

    def fits(self, hbm_bytes: int, headroom: float = 0.85) -> bool:
        """True when the budget fits within ``headroom`` of the card's
        memory (the rest goes to temporaries and collective buffers)."""
        return self.total_bytes <= hbm_bytes * headroom

    def report(self) -> str:
        gib = 2.0**30
        path, rb = self.largest_replicated
        return (
            f"per-rank: params {self.params_bytes / gib:.2f} GiB, "
            f"grads {self.grads_bytes / gib:.2f} GiB, "
            f"opt {self.opt_bytes / gib:.2f} GiB, "
            f"activations ~{self.activations_bytes / gib:.2f} GiB "
            f"(total {self.total_bytes / gib:.2f} GiB); "
            f"largest replicated tensor: {path} ({rb / gib:.2f} GiB)")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def sharded_bytes(shape, dtype, spec, mesh_shape: Dict[str, int]) -> int:
    """Bytes of one array's piece on a rank under ``spec``; per-dim
    extents round up, so a budget never undercounts."""
    extents = list(shape)
    for d, axis in enumerate(spec):
        if axis is None or d >= len(extents):
            continue
        k = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            k *= mesh_shape[a]
        extents[d] = -(-extents[d] // k)
    n = int(np.prod(extents)) if extents else 1
    return n * _itemsize(dtype)


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(tuple(shapes), device="meta")


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def param_spec_for(path, shape, param_specs: Dict[tuple, tuple]):
    """The param spec of an optimizer-state leaf: the param whose path
    is the longest suffix of ``path`` and whose shape is ``shape``;
    None for a leaf that mirrors no param (step counts)."""
    best = None
    for ppath, (pshape, spec) in param_specs.items():
        if (len(path) >= len(ppath) and tuple(path[-len(ppath):]) == ppath
                and tuple(shape) == pshape
                and (best is None or len(ppath) > len(best[0]))):
            best = (ppath, spec)
    return None if best is None else best[1]


def opt_specs(opt_state, params, specs, replicated=()):
    """Spec tree of ``opt_state``: a param-shaped leaf takes its param's
    spec from ``specs``, any other leaf ``replicated``."""
    table = {path: (tuple(leaf.shape), spec) for (path, leaf), (_, spec)
             in zip(_leaves_with_paths(params), leaf_paths(specs))}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [walk(v, prefix + (str(i),)) for i, v in enumerate(tree)]
            return out if isinstance(tree, list) else type(tree)(out)
        if not isinstance(tree, torch.Tensor):
            return replicated
        s = param_spec_for(prefix, tuple(tree.shape), table)
        return replicated if s is None else s

    return walk(opt_state, ())


def training_memory(model, shardings, mesh_shape: Dict[str, int], *,
                    tx=None, batch_per_chip: int = 1,
                    param_dtype=torch.float32, compute_dtype=None,
                    remat: bool = False, seed: int = 0, params=None,
                    zero: bool = False, data_axis: str = "data"
                    ) -> MemoryBudget:
    """Per-rank byte budget for training ``model`` under ``shardings``
    (a spec tree matching the params: ``fsdp_sharding`` / ``tp_sharding``
    over a ``{axis: size}`` dict, no devices needed).  Gradients mirror
    the parameter placement; optimizer slots are counted from ``tx.init``
    on ``meta`` tensors, param-shaped slots placed like their param, at
    the ZeRO update placement with ``zero=True``.  ``params`` (any tree
    of tensors, ``meta`` included) overrides the model's shapes, as for
    a pruned model.  ``seed`` is the JAX signature's and unused: shapes
    do not depend on it."""
    del seed
    if params is None:
        params = _meta_tree(model.param_shapes())
    flat_p = list(_leaves_with_paths(params))
    flat_s = list(leaf_paths(shardings))
    if len(flat_p) != len(flat_s):
        raise ValueError(
            f"shardings tree has {len(flat_s)} leaves, params {len(flat_p)}")

    p_bytes = 0
    largest_rep = ("", 0)
    table = {}
    # in sorted path order, as JAX flattens a dict: the first of equally
    # large replicated leaves is the one named
    for (path, leaf), (_, spec) in sorted(zip(flat_p, flat_s),
                                          key=lambda e: e[0][0]):
        shape = tuple(leaf.shape)
        table[path] = (shape, spec)
        p_bytes += sharded_bytes(shape, param_dtype, spec, mesh_shape)
        if all(a is None for a in spec):
            full = int(np.prod(shape)) * _itemsize(param_dtype)
            if full > largest_rep[1]:
                largest_rep = ("/".join(path), full)
    g_bytes = p_bytes  # gradients arrive in the params' dtype/placement

    opt_bytes = 0
    if tx is not None:
        def to_meta(tree):
            if isinstance(tree, dict):
                return {k: to_meta(v) for k, v in tree.items()}
            return torch.empty(tuple(tree.shape), dtype=param_dtype,
                               device="meta")

        meta = to_meta(params)
        for path, leaf in _leaves_with_paths(tx.init(meta)):
            if not isinstance(leaf, torch.Tensor):
                continue
            spec = param_spec_for(path, tuple(leaf.shape), table)
            if spec is None:
                opt_bytes += int(np.prod(leaf.shape) or 1) \
                    * _itemsize(leaf.dtype)
                continue
            if zero:
                spec = zero_update_spec(tuple(leaf.shape), spec, mesh_shape,
                                        data_axis)
            opt_bytes += sharded_bytes(tuple(leaf.shape), leaf.dtype, spec,
                                       mesh_shape)

    act_dtype = compute_dtype if compute_dtype is not None else param_dtype
    act = 0
    for shp in getattr(model, "shapes", ()):
        out_shape = shp[1] if isinstance(shp, tuple) and len(shp) == 2 \
            else shp
        act += int(np.prod(out_shape)) * batch_per_chip
    act_bytes = act * _itemsize(act_dtype)
    if remat:
        act_bytes //= 2

    return MemoryBudget(
        params_bytes=int(p_bytes), grads_bytes=int(g_bytes),
        opt_bytes=int(opt_bytes), activations_bytes=int(act_bytes),
        largest_replicated=largest_rep)


def held_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` this rank holds."""
    return sum(t.numel() * t.element_size()
               for _, t in _leaves_with_paths(tree)
               if isinstance(t, torch.Tensor))
