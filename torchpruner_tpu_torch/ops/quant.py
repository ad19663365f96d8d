"""Weight-only int8/int4 quantization for the serving path.

Counterpart of ``torchpruner_tpu/ops/quant.py``: symmetric
per-output-channel integer weights, with the scale applied to the
matmul OUTPUT (exact, since only input axes contract):

    y = (x @ widen(q)) * scale        # not  x @ (q * scale)

On CUDA, int4 and int8 weights contracted along their leading axis with
bf16 activations go through the hand-written dequant kernel
(``ops/fused_matmul.py``), which reads the integer bytes and widens them
in registers.  Other sites (attention's ``wo``, whose two contracted
axes do not flatten onto the kernel's packed layout) consume
:func:`wval`'s widened copy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from torchpruner_tpu_torch.ops.blocksparse import BlockSparseWeight
from torchpruner_tpu_torch.ops.fixed_order import matmul_rows
from torchpruner_tpu_torch.ops.int4_matmul import pack_int4, unpack_int4

__all__ = ["QTensor", "quantize_tensor", "quantize_params",
           "dequantize_params", "wval", "oscale", "qdot"]


@dataclass
class QTensor:
    """Symmetric per-output-channel integer weight: ``w ≈ q * scale``.

    ``bits=8``: ``q`` has the weight's shape (int8).  ``bits=4``: ``q``
    stores two values per int8 byte, packed pairwise along ``pack_axis``
    (an even-length contracted axis), which therefore has half the
    logical length.  ``scale`` (float32) has the logical rank with the
    contracted ``in_axes`` reduced to size 1."""

    q: torch.Tensor
    scale: torch.Tensor
    in_axes: Tuple[int, ...]
    bits: int = 8
    pack_axis: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        """The LOGICAL weight shape (unpacked)."""
        s = list(self.q.shape)
        if self.bits == 4:
            s[self.pack_axis] *= 2
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:  # the storage dtype
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    def unpacked(self) -> torch.Tensor:
        """The logical int8 payload (identity for bits=8)."""
        if self.bits != 4:
            return self.q
        moved = torch.movedim(self.q, self.pack_axis, 0)
        flat = unpack_int4(moved.reshape(moved.shape[0], -1))
        return torch.movedim(
            flat.reshape((moved.shape[0] * 2,) + tuple(moved.shape[1:])),
            0, self.pack_axis)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Materialized ``q * scale`` (tests / export, not serving)."""
        return self.unpacked().to(dtype) * self.scale.to(dtype)

    def out_scale(self) -> torch.Tensor:
        """The scale with the input axes squeezed out (the output axes'
        shape, for trailing-broadcast onto a matmul result)."""
        keep = [n for a, n in enumerate(self.scale.shape)
                if a not in self.in_axes]
        return self.scale.reshape(keep)


def quantize_tensor(w: torch.Tensor,
                    in_axes: Union[int, Tuple[int, ...]] = 1, *,
                    bits: int = 8) -> QTensor:
    """Symmetric integer weight with one scale per output channel
    (max-abs / ``2**(bits-1) - 1``) over the contracted ``in_axes`` (an
    int means that many LEADING axes); zero channels get scale 1.
    ``bits=4`` packs value pairs along the first even-length contracted
    axis."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if isinstance(in_axes, int):
        in_axes = tuple(range(in_axes))
    in_axes = tuple(in_axes)
    sym = float(2 ** (bits - 1) - 1)
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=in_axes, keepdim=True)
    scale = torch.where(amax > 0, amax / sym, torch.ones_like(amax))
    q = torch.round(wf / scale).to(torch.int8)
    if bits == 8:
        return QTensor(q, scale, in_axes)
    pack_axis = next((a for a in in_axes if w.shape[a] % 2 == 0), None)
    if pack_axis is None:
        raise ValueError(
            f"int4 needs an even-length contracted axis to pack; "
            f"shape {tuple(w.shape)}, in_axes {in_axes}")
    moved = torch.movedim(q, pack_axis, 0)
    packed = pack_int4(moved.reshape(moved.shape[0], -1)).reshape(
        (moved.shape[0] // 2,) + tuple(moved.shape[1:]))
    return QTensor(torch.movedim(packed, 0, pack_axis).contiguous(), scale,
                   in_axes, 4, pack_axis)


def wval(w, dtype: torch.dtype):
    """The tensor a matmul should consume: the integer payload
    (nibble-unpacked for bits=4) widened to ``dtype`` for a
    :class:`QTensor`, the weight itself otherwise."""
    return w.unpacked().to(dtype) if isinstance(w, QTensor) else w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x ·₀ w``: contract ``x``'s trailing axis with ``w``'s LEADING
    axis (the Dense/GatedDense site, and ``...d,dhk->...hk`` for 3-D
    attention weights).  Quantized weights with ``in_axes == (0,)`` and
    bf16 activations go to the dequant kernel when the payload layout
    allows (int4 packed along axis 0; int8 when
    ``fused_matmul.int8_kernel_active``).  A
    :class:`~torchpruner_tpu_torch.ops.blocksparse.BlockSparseWeight`
    goes to its block-sparse product.  The caller applies
    :func:`oscale`."""
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    if isinstance(w, BlockSparseWeight):
        return w.matmul(x)
    if (isinstance(w, QTensor) and w.in_axes == (0,)
            and x.dtype == torch.bfloat16
            and (w.bits == 4 and w.pack_axis == 0
                 or w.bits == 8 and FM.int8_kernel_active(x.device))):
        lead = tuple(x.shape[:-1])
        rest = w.shape[1:]  # logical output axes
        y = FM.dequant_matmul(x.reshape(-1, x.shape[-1]),
                              w.q.reshape(w.q.shape[0], -1), bits=w.bits)
        return y.reshape(lead + tuple(rest)).to(x.dtype)
    wv = wval(w, x.dtype)
    y = matmul_rows(x, wv.reshape(wv.shape[0], -1))
    return y.reshape(tuple(x.shape[:-1]) + tuple(wv.shape[1:]))


def oscale(y: torch.Tensor, w) -> torch.Tensor:
    """Apply ``w``'s output-channel scale to a matmul output whose
    TRAILING axes are ``w``'s output axes; identity for float weights."""
    if not isinstance(w, QTensor):
        return y
    return y * w.out_scale().to(y.dtype)


#: layer-type -> {param key: contracted input axes} (the JAX table,
#: restricted to the layer types the port serves)
_QUANT_KEYS = {
    "Dense": {"w": (0,)},
    "GatedDense": {"wg": (0,), "wu": (0,)},
    "MultiHeadAttention": {"wq": (0,), "wk": (0,), "wv": (0,),
                           "wo": (0, 1)},
    "MoE": {"wg": (1,), "wu": (1,), "wo": (0, 1)},
}


def quantize_params(model, params, *, layers: Optional[Sequence[str]] = None,
                    bits: int = 8):
    """Quantize the matmul weights of ``model``'s Dense / GatedDense /
    attention layers (norms and embeddings stay float).  Returns a NEW
    params tree with :class:`QTensor` leaves.  ``layers`` restricts to
    the named layer paths (``"block1_ffn/gate"`` style)."""
    wanted = set(layers) if layers is not None else None
    matched: set = set()
    out = _quantize_walk(model.layers, params, (), wanted, matched, bits)
    if wanted is not None and wanted - matched:
        raise KeyError(
            f"quantize_params: no quantizable layer matched "
            f"{sorted(wanted - matched)}")
    return out


def _quantize_walk(specs, params, prefix, wanted, matched, bits):
    from torchpruner_tpu_torch.core import layers as L

    out = dict(params)
    for spec in specs:
        name = spec.name
        if isinstance(spec, L.COMPOSITE_TYPES):
            if name in out:
                out[name] = _quantize_walk(
                    spec.body + spec.shortcut, out[name],
                    prefix + (name,), wanted, matched, bits)
            continue
        keys = _QUANT_KEYS.get(type(spec).__name__)
        full = "/".join(prefix + (name,))
        if keys is None or (wanted is not None and full not in wanted) \
                or name not in out:
            continue
        matched.add(full)
        p = dict(out[name])
        for key, in_axes in keys.items():
            if key in p and not isinstance(p[key], QTensor):
                p[key] = quantize_tensor(p[key], in_axes=in_axes, bits=bits)
        out[name] = p
    return out


def dequantize_params(params):
    """Materialize every :class:`QTensor` back to float32."""
    if isinstance(params, QTensor):
        return params.dequantize()
    if isinstance(params, dict):
        return {k: dequantize_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_params(v) for v in params)
    return params
