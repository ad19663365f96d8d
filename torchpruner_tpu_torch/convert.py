"""The weight bridge: a JAX-package param tree, as numpy, to the port's.

The JAX package's params are nested dicts of arrays with ``QTensor``
leaves.  A caller holding both packages turns every array into numpy
(``np.asarray``) and every ``QTensor`` into a plain dict
``{"q", "scale", "in_axes", "bits", "pack_axis"}`` and every
``BlockSparseWeight`` into ``{"w", "in_keep", "out_keep", "block"}``;
:func:`params_from_numpy` builds the port's tree from that, with the
same names and layouts, so the port never sees a JAX array.  The state
tree (BatchNorm's running ``mean`` / ``var``), mask trees
(``core.masking.drop_masks``) and optimizer moments are plain arrays and
convert as params do.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from torchpruner_tpu_torch.ops.blocksparse import BlockSparseWeight
from torchpruner_tpu_torch.ops.quant import QTensor
from torchpruner_tpu_torch.utils.device import resolve_device

_QKEYS = {"q", "scale", "in_axes"}
_BSKEYS = {"w", "in_keep", "out_keep"}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 (no torch view)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree: Any, device=None) -> Any:
    """Port params on ``device`` (``None`` = ``cuda``) from a numpy tree."""
    dev = resolve_device(device)
    return _convert(tree, dev)


def model_from_reference(ref):
    """The port's :class:`SegmentedModel` for a JAX-package model spec
    (e.g. a pruned one): specs are plain dataclasses there too, so they
    map field for field by class name, without importing JAX."""
    from torchpruner_tpu_torch.core import layers as L
    from torchpruner_tpu_torch.core.segment import SegmentedModel

    def spec(s):
        cls = getattr(L, type(s).__name__, None)
        if cls is None:
            raise TypeError(f"the port has no layer {type(s).__name__}")
        if cls is L.Residual:
            return L.Residual(s.name, tuple(spec(c) for c in s.body),
                              tuple(spec(c) for c in s.shortcut))
        fields = {f.name: getattr(s, f.name)
                  for f in dataclasses.fields(s)}
        return cls(**fields)

    return SegmentedModel(tuple(spec(s) for s in ref.layers),
                          tuple(ref.input_shape), ref.input_dtype)


def _convert(tree, dev):
    if isinstance(tree, dict):
        if _QKEYS <= set(tree):
            return QTensor(_tensor(tree["q"], dev),
                           _tensor(tree["scale"], dev).float(),
                           tuple(int(a) for a in tree["in_axes"]),
                           int(tree.get("bits", 8)),
                           int(tree.get("pack_axis", 0)))
        if _BSKEYS <= set(tree):
            in_keep, out_keep = (
                None if tree[k] is None else tuple(int(i) for i in tree[k])
                for k in ("in_keep", "out_keep"))
            return BlockSparseWeight(_tensor(tree["w"], dev), in_keep,
                                     out_keep, int(tree.get("block", 128)))
        return {k: _convert(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, dev) for v in tree)
    return _tensor(tree, dev)
