"""SegmentedModel — an immutable, ordered pipeline of layer specs.

Counterpart of ``torchpruner_tpu/core/segment.py``, reduced to what
serving needs: the spec container and a seeded init.  Params are nested
dicts ``{layer_name: {param_name: tensor}}`` (one level per composite
block), with the JAX package's names and layouts; the numbers of
:func:`init_model` come from a ``torch.Generator`` and are not JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.dtypes import to_dtype


@dataclass(frozen=True)
class SegmentedModel:
    """An ordered pipeline of layer specs with named layers.
    ``input_shape`` excludes the batch dimension; ``input_dtype`` names
    the element type of inputs (``"int32"`` token ids for LMs)."""

    layers: Tuple[L.LayerSpec, ...]
    input_shape: Tuple[int, ...]
    input_dtype: str = "float32"

    def __post_init__(self):
        names = [l.name for l in self.layers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate layer names in {names}")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self.layers)

    def param_shapes(self) -> Dict[str, Any]:
        """``{layer: {param: shape}}`` for the whole model."""
        out: Dict[str, Any] = {}
        shape = tuple(self.input_shape)
        for spec in self.layers:
            p = L.param_shapes(spec, shape)
            if p:
                out[spec.name] = p
            shape = L.out_shape(spec, shape)
        return out

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
        """Params drawn from ``gen``, placed on ``device`` (``None`` =
        ``cuda``; raises without a GPU unless ``device="cpu"``)."""
        device = resolve_device(device)
        params: Dict[str, Any] = {}
        shape = tuple(self.input_shape)
        for spec in self.layers:
            p, shape = L.init_layer(spec, gen, shape, to_dtype(dtype),
                                    device)
            if p:
                params[spec.name] = p
        return params


def init_model(model: SegmentedModel, seed: int = 0, dtype=torch.float32,
               device=None):
    """Seeded ``(params, state)`` on ``device`` (``None`` = ``cuda``;
    raises without a GPU unless ``device="cpu"``); ``state`` is empty for
    the serving layers, kept for the JAX signature.  Drawn from a CPU
    ``torch.Generator`` so the numbers do not depend on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return model.init(gen, dtype=dtype, device=dev), {}
