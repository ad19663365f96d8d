"""Placement rules: how params and batches map onto the mesh —
counterpart of ``torchpruner_tpu/parallel/sharding.py``, whose rules are
pure functions of shapes and are copied here to the letter.

A placement is a :class:`P`, the JAX ``PartitionSpec`` transcribed: one
entry per tensor dimension, ``None`` (replicated), an axis name, or a
tuple of axis names.  A tuple splits its dimension over the product of
the axes MODEL-MAJOR in the order listed, as JAX does: under
``("model", "data")`` the rank at ``(data=d, model=m)`` holds piece
``m * |data| + d``.  DTensor's per-mesh-dimension ``Shard`` on a
``("data", "model")`` mesh would split it data-major, so the port keeps
every placement as a :class:`P` tuple and moves the pieces with explicit
collectives (``parallel/collectives.py``); no DTensor is made.

FSDP (:func:`fsdp_spec`) shards each large-enough parameter's largest
divisible axis over ``model``.  Tensor parallelism (:func:`tp_specs`) is
derived from the pruning graph: a prune group's target is a Megatron
column-parallel layer (its unit axis sharded) and its consumers the
matching row-parallel layers (their input axis sharded; the partial
sums are reduced after the product).  Anything the graph does not
claim falls back to the FSDP rule.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.parallel.mesh import axis_index, mesh_axes
from torchpruner_tpu_torch.utils.tree import tree_map


class P(tuple):
    """``PartitionSpec``: ``P(None, "model")``, ``P(("model", "data"))``,
    ``P()`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def batch_sharding(mesh, axis: str = "data") -> P:
    """Shard axis 0 (batch) over the data axis; replicate the rest."""
    return P(axis)


def replicate(mesh) -> P:
    return P()


def fsdp_spec(shape, mesh, axis="model", min_size: int = 2**14) -> P:
    """Shard the largest dim divisible by the mesh axis; replicate small
    or indivisible arrays.  ``axis`` may be a tuple of mesh axes (e.g.
    ``("data", "model")``) for ZeRO-style sharding over the full mesh;
    falls back to the first axis alone when a dim divides it but not
    the product.  ``mesh`` is a ``DeviceMesh`` or ``{axis: size}``."""
    shp = mesh_axes(mesh)
    axes = axis if isinstance(axis, tuple) else (axis,)
    axes = tuple(a for a in axes if a in shp)
    if not axes:
        return P()
    size = int(np.prod([shp[a] for a in axes]))
    if size == 1 or int(np.prod(shape)) < min_size:
        return P()
    dims = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in dims:
        if shape[d] % size == 0:
            spec = [None] * len(shape)
            spec[d] = axes if len(axes) > 1 else axes[0]
            return P(*spec)
    if len(axes) > 1:  # partial: shard over the first axis alone
        return fsdp_spec(shape, mesh, axes[0], min_size)
    return P()


def fsdp_sharding(tree, mesh, axis="model", min_size: int = 2**14):
    """Spec tree (the structure of ``tree``) under the FSDP rule."""
    return tree_map(lambda leaf: fsdp_spec(tuple(leaf.shape), mesh, axis,
                                           min_size), tree)


def zero_update_spec(shape, spec, mesh_shape: Dict[str, int],
                     data_axis: str = "data") -> P:
    """One array's ZeRO weight-update placement: ``spec`` (the param's
    model-axis placement) with ``data_axis`` added on a divisible dim —
    the domain where gradients are reduce-scattered, the optimizer
    state lives and the 1/N update applies.  Prefers the largest dim
    the param placement left unsharded; otherwise extends a sharded dim
    to ``(model_axes..., data)`` when the compound size still divides.
    A leaf none of whose dims divide, and a scalar, keep ``spec``."""
    n = int(mesh_shape.get(data_axis, 1))
    if n <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries for a in _axes(e)}
    if data_axis in used:  # already data-sharded (full-mesh tuple FSDP)
        return spec
    order = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in order:
        if entries[d] is None and shape[d] % n == 0:
            entries[d] = data_axis
            return P(*entries)
    for d in order:
        e = entries[d]
        if e is None:
            continue
        ax = _axes(e)
        k = n
        for a in ax:
            k *= int(mesh_shape.get(a, 1))
        if shape[d] % k == 0:
            entries[d] = tuple(ax) + (data_axis,)
            return P(*entries)
    return spec


def zero_update_sharding(tree, shardings, mesh, data_axis: str = "data"):
    """Param-shaped spec tree of the ZeRO update domain: each leaf's
    placement from ``shardings`` with the data axis added per
    :func:`zero_update_spec`."""
    shp = mesh_axes(mesh)
    return tree_map(lambda leaf, sh: zero_update_spec(
        tuple(leaf.shape), sh, shp, data_axis), tree, shardings)


def _tp_target_specs(spec, size: int) -> Dict[str, P]:
    """Column-parallel specs for a prune-group target (unit axis sharded)."""
    if isinstance(spec, L.Dense) and spec.features % size == 0:
        return {"w": P(None, "model"), "b": P("model")}
    if isinstance(spec, L.Conv) and spec.features % size == 0:
        return {"w": P(None, None, None, "model"), "b": P("model")}
    if isinstance(spec, L.GatedDense) and spec.features % size == 0:
        return {
            "wg": P(None, "model"), "wu": P(None, "model"),
            "bg": P("model"), "bu": P("model"),
        }
    if isinstance(spec, L.MultiHeadAttention) and spec.num_heads % size == 0:
        out = {
            "wq": P(None, "model", None), "bq": P("model", None),
            "wo": P("model", None, None), "bo": P(),
        }
        if spec.kv_heads % size == 0:
            out.update({
                "wk": P(None, "model", None), "bk": P("model", None),
                "wv": P(None, "model", None), "bv": P("model", None),
            })
        return out
    if isinstance(spec, L.MoE) and spec.n_experts % size == 0:
        # expert parallelism: each rank holds n_experts/size experts
        return {
            "wg": P("model", None, None),
            "wu": P("model", None, None),
            "wo": P("model", None, None),
            "router": P(None, "model"),
        }
    return {}


def _tp_consumer_specs(spec, in_width: int, size: int) -> Dict[str, P]:
    """Row-parallel specs for a group consumer (input axis sharded; the
    partial sums are reduced after the product).  Biases stay
    replicated (added once after the reduce)."""
    if in_width % size:
        return {}
    if isinstance(spec, L.Dense):
        return {"w": P("model", None)}
    if isinstance(spec, L.Conv):
        return {"w": P(None, None, "model", None)}
    if isinstance(spec, L.GatedDense):
        return {"wg": P("model", None), "wu": P("model", None)}
    if isinstance(spec, L.MultiHeadAttention):
        return {
            "wq": P("model", None, None),
            "wk": P("model", None, None),
            "wv": P("model", None, None),
        }
    if isinstance(spec, L.MoE):
        return {
            "router": P("model", None),
            "wg": P(None, "model", None),
            "wu": P(None, "model", None),
        }
    return {}


def tp_specs(model, mesh, axis: str = "model") -> Dict[Tuple[str, str], P]:
    """``{(layer_path, param_name): P}`` tensor-parallel assignments
    derived from the pruning graph (column-parallel targets, row-parallel
    consumers; first claim wins where a layer is in several groups)."""
    from torchpruner_tpu_torch.core.graph import pruning_graph

    size = mesh_axes(mesh).get(axis, 1)
    if size == 1:
        return {}
    out: Dict[Tuple[str, str], P] = {}

    def rename(p: P) -> P:
        return P(*(axis if x == "model" else x for x in p))

    def claim(layer: str, specs: Dict[str, P]):
        for pname, pspec in specs.items():
            out.setdefault((layer, pname), rename(pspec))

    for g in pruning_graph(model, include_output=True):
        tgt = model.layer(g.target)
        specs = _tp_target_specs(tgt, size)
        if not specs:
            continue
        claim(g.target, specs)
        for c in g.consumers:
            cspec = model.layer(c.layer)
            in_w = L.n_units(tgt) * c.fan_out
            claim(c.layer, _tp_consumer_specs(cspec, in_w, size))
    return out


def leaf_paths(tree, prefix=()):
    """``[(path tuple, leaf)]`` of a nested-dict tree (params, or a spec
    tree, whose ``P`` leaves are not descended)."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaf_paths(v, prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _fits(spec, shape, shp) -> bool:
    return all(e is None or shape[d] % int(np.prod(
        [shp[a] for a in _axes(e)])) == 0 for d, e in enumerate(spec))


def tp_sharding(model, params, mesh, axis: str = "model",
                min_size: int = 2**14):
    """Spec tree for ``params``: the pruning-graph TP specs where they
    apply (and still divide after a prune), the FSDP rule elsewhere.
    ``axis`` must be one mesh axis."""
    if isinstance(axis, tuple):
        raise ValueError(
            "tensor parallelism shards over a single mesh axis; tuple "
            f"axes {axis!r} are only meaningful for the FSDP rule "
            "(partition='fsdp')")
    assigned = tp_specs(model, mesh, axis)
    shp = mesh_axes(mesh)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        shape = tuple(tree.shape)
        p = assigned.get(("/".join(prefix[:-1]), prefix[-1]))
        if p is not None and _fits(p, shape, shp):
            return p
        return fsdp_spec(shape, mesh, axis, min_size)

    return walk(params, ())


def piece(spec, mesh, d: int) -> Tuple[int, int]:
    """``(index, count)`` of this rank's piece of dimension ``d`` under
    ``spec`` (model-major over a tuple entry)."""
    shp = mesh_axes(mesh)
    idx, count = 0, 1
    for a in _axes(spec[d] if d < len(spec) else None):
        idx = idx * shp[a] + axis_index(mesh, a)
        count *= shp[a]
    return idx, count


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``spec``, as a
    tensor of its own (the full tensor can be freed)."""
    out = t
    for d in range(len(spec)):
        i, n = piece(spec, mesh, d)
        if n > 1:
            size = t.shape[d] // n
            out = out.narrow(d, i * size, size)
    return out.clone() if out is not t else t


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's piece (JAX ``NamedSharding.shard_shape``);
    ``mesh`` may be ``{axis: size}``."""
    shp = mesh_axes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        out[d] //= int(np.prod([shp[a] for a in _axes(e)]))
    return tuple(out)


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's slice of the global batch ``(x, y, ...)``: rows
    ``[i * b / n, (i + 1) * b / n)`` for its coordinate ``i`` on
    ``axis`` of size ``n``.  A leading dim that does not divide raises
    (callers pad or drop the remainder)."""
    n = mesh_axes(mesh).get(axis, 1)
    i = axis_index(mesh, axis)

    def take(a):
        if a.shape[0] % n:
            raise ValueError(
                f"batch dim {a.shape[0]} not divisible by mesh axis "
                f"{axis}={n}")
        b = a.shape[0] // n
        return a[i * b:(i + 1) * b]

    return tuple(take(a) for a in batch)


def shard_params(tree, mesh, axis: str = "model", min_size: int = 2**14):
    """Place a full params-like tree on the mesh under the FSDP rule:
    ``(local tree, spec tree)``, each leaf this rank's piece.  Arrays
    large enough to shard whose every dim fails the divisibility check
    fall back to replication, with one warning line listing them (the
    analyzer's ``sharding/replicated-fallback``; its severity config
    silences the line with ``"ignore"``)."""
    from torchpruner_tpu_torch.analysis.findings import active_severity

    specs = fsdp_sharding(tree, mesh, axis, min_size)
    fallbacks = _replication_fallbacks(tree, specs, mesh, axis, min_size)
    if fallbacks and active_severity("sharding/replicated-fallback",
                                     "warning") != "ignore":
        from torchpruner_tpu_torch.train.logger import log

        log.warning(
            "[sharding/replicated-fallback] %d array(s) no longer divide "
            "mesh axis %r and fall back to replication: %s",
            len(fallbacks), axis, ", ".join(fallbacks))
    return tree_map(lambda t, s: local_shard(t, s, mesh), tree, specs), specs


def _replication_fallbacks(tree, specs, mesh, axis, min_size: int):
    """Paths of arrays the FSDP rule wanted to shard (big enough, axis
    size > 1) but left replicated because no dim divides."""
    shp = mesh_axes(mesh)
    axes = tuple(a for a in _axes(axis) if a in shp)
    if not axes or int(np.prod([shp[a] for a in axes])) == 1:
        return []
    out = []
    for (path, leaf), (_, sh) in zip(leaf_paths(tree), leaf_paths(specs)):
        shape = tuple(leaf.shape)
        if int(np.prod(shape)) < min_size:
            continue
        if all(a is None for a in sh):
            out.append(f"{'/'.join(path)} {shape}")
    return out
