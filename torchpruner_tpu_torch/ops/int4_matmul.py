"""int4 pack/unpack/quantize helpers.

Counterpart of ``torchpruner_tpu/ops/int4_matmul.py``, with the same byte
layout: values pair along the contracted (input) axis — byte ``k`` of
column ``f`` holds ``w[2k, f]`` in its sign-extended low nibble and
``w[2k+1, f]`` in the high one — so a ``(D//2, F)`` packed matrix unpacks
to ``(D, F)`` with the output (minor) axis untouched.  The kernel that
reads this layout is ``ops/fused_matmul.py`` (the JAX package's
``int4_matmul`` entry point is a thin wrapper over it; the port calls
``dequant_matmul(..., bits=4)`` directly).
"""

from __future__ import annotations

import torch

__all__ = ["pack_int4", "unpack_int4", "quantize_int4"]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] pairwise along axis 0: ``(D, F)`` →
    ``(D//2, F)`` with ``out[k] = (q[2k] & 0xF) | (q[2k+1] << 4)``."""
    if q.shape[0] % 2:
        raise ValueError(f"input axis {q.shape[0]} must be even to pack")
    lo = q[0::2].to(torch.int32) & 0x0F
    hi = (q[1::2].to(torch.int32) & 0x0F) << 4
    # values 0..255 wrap to the same int8 bit pattern as jnp's astype
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4` along ``axis``: ``(D//2, F)`` int8 →
    ``(D, F)`` sign-extended int8 in [-8, 7] (``axis`` = the packed
    axis of a payload of any rank, which doubles).  The shifts stay in
    int8 (the low nibble's left shift wraps, the right shifts are
    arithmetic) and the halves interleave in place of ``axis``, so a
    widened copy moves a fraction of the bytes an int32 detour or a
    transposed copy would."""
    axis = axis % p.ndim
    lo = (p << 4) >> 4  # low nibble, sign-extended
    hi = p >> 4         # high nibble: the arithmetic shift sign-extends
    shape = list(p.shape)
    shape[axis] *= 2
    return torch.stack([lo, hi], dim=axis + 1).reshape(shape)


def quantize_int4(w: torch.Tensor, *, sym_max: int = 7):
    """Symmetric per-output-channel int4: ``(packed, scale)`` with
    ``w ≈ unpack(packed) * scale`` — ``w`` is ``(D, F)``, ``scale`` is
    ``(F,)`` float32.  Zero-channels get scale 1."""
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / sym_max,
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -sym_max, sym_max).to(torch.int8)
    return pack_int4(q), scale
