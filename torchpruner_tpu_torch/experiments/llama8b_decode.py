"""Llama-3-8B served at int4 (or int8) weights — counterpart of
``torchpruner_tpu/experiments/llama8b_decode.py``'s parameter builder.

Params are built DIRECTLY at the quantized representation: each float
leaf is drawn on the device in bf16 from a seeded ``torch.Generator``,
quantized, and dropped, so peak transient memory is one leaf (plus its
f32 quantize copy, ~2.1 GB for the lm_head) on top of the quantized
tree — no 8B float master is ever materialized.  Weights are random;
the decode cost does not depend on their values.
"""

from __future__ import annotations

import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.ops.quant import _QUANT_KEYS, QTensor, \
    quantize_tensor
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.dtypes import to_dtype


def quantized_random_params(model, *, bits: int = 4, seed: int = 0,
                            dtype=torch.bfloat16, device=None):
    """A servable ``(params, state)`` with :class:`QTensor` leaves at every
    site ``quantize_params`` would quantize, built leaf by leaf on
    ``device`` (``None`` = ``cuda``).  Norm scales are ones, biases
    zeros, matmul weights and embeddings ``0.02``-scaled normals."""
    dev = resolve_device(device)
    dtype = to_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def build(specs, shapes):
        out = {}
        for spec in specs:
            name = spec.name
            if name not in shapes:
                continue
            if isinstance(spec, L.COMPOSITE_TYPES):
                out[name] = build(spec.body + spec.shortcut, shapes[name])
                continue
            qkeys = _QUANT_KEYS.get(type(spec).__name__, {})
            entry = {}
            for pname, shp in shapes[name].items():
                if pname == "scale":
                    leaf = torch.ones(shp, dtype=dtype, device=dev)
                elif pname.startswith("b"):
                    leaf = torch.zeros(shp, dtype=dtype, device=dev)
                else:
                    leaf = torch.randn(shp, generator=gen, dtype=dtype,
                                       device=dev) * 0.02
                if pname in qkeys:
                    entry[pname] = quantize_tensor(
                        leaf, in_axes=qkeys[pname], bits=bits)
                    del leaf  # one transient float leaf at a time
                else:
                    entry[pname] = leaf
            out[name] = entry
        return out

    with torch.no_grad():
        params = build(model.layers, model.param_shapes())
    return params, {}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def weight_bytes(params) -> int:
    """Bytes of weight traffic per decode step: every leaf is read once
    per token batch, except the embedding table (gathered, B rows)."""
    total = 0
    for path, leaf in _leaves(params):
        if "emb" in path:
            continue
        if isinstance(leaf, QTensor):
            total += leaf.q.numel() + leaf.scale.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return int(total)
