"""Fused dequant matmul — int8 and packed-int4 weights widened in registers.

Counterpart of ``torchpruner_tpu/ops/fused_matmul.py``.  On CUDA tensors
:func:`dequant_matmul` launches the hand-written Hopper kernel
``csrc/dequant_matmul.cu`` (which replaces the Pallas kernel
``dequant_matmul``/``_kernel``); on CPU tensors it runs
:func:`dequant_matmul_plain`, the same function in plain PyTorch.  There
is no fallback between the two: a CUDA tensor launches the kernel or
raises.

Bound on the H100: weight bytes (see the source note in the ``.cu``).
Every output element is reduced in one fixed order that depends on the
weight's shape only, so a row's result does not depend on how many rows
share the call — what slot-vs-solo bit identity needs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from torchpruner_tpu_torch.ops.fixed_order import matmul_rows
from torchpruner_tpu_torch.ops.int4_matmul import unpack_int4

__all__ = ["dequant_matmul", "dequant_matmul_plain", "int8_kernel_active",
           "INT8_KERNEL"]

#: int8 routing policy for quant.qdot: None = auto (the kernel on CUDA,
#: the plain convert path on the CPU), True/False force
INT8_KERNEL: Optional[bool] = None

#: blocks the grid should hold to stream a weight at full rate: one full
#: wave over the H100's 132 SMs at 4 resident blocks each (64 registers
#: x 256 threads a block)
_TARGET_BLOCKS = 528
_COLS_PER_BLOCK = 128


def int8_kernel_active(device: Optional[torch.device] = None) -> bool:
    if INT8_KERNEL is not None:
        return INT8_KERNEL
    return device is not None and torch.device(device).type == "cuda"


def k_splits(rows: int, F: int) -> int:
    """Grid-level splits of the contracted axis: a function of the
    weight's shape ONLY (never of M), so the reduction order of every
    output element is fixed.  Segments keep >= 16 packed rows a warp."""
    tiles = -(-F // _COLS_PER_BLOCK)
    want = -(-_TARGET_BLOCKS // tiles)
    return max(1, min(want, rows // 128))


def _check(x, q, scale, bits):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"want x (M, D) and q (rows, F); got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}")
    pack = 2 if bits == 4 else 1
    if q.shape[0] * pack != x.shape[1]:
        raise ValueError(
            f"payload rows {q.shape[0]} != D/{pack} = {x.shape[1] // pack}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if scale is not None and scale.shape != (q.shape[1],):
        raise ValueError(f"scale must be ({q.shape[1]},), got "
                         f"{tuple(scale.shape)}")


def dequant_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                         scale: Optional[torch.Tensor] = None, *,
                         bits: int = 8) -> torch.Tensor:
    """The plain version: unpack, then a float32 product of the
    bf16-rounded activations with the widened weight (exact products,
    f32 sums), then the optional per-output-channel scale."""
    _check(x, q, scale, bits)
    wv = unpack_int4(q) if bits == 4 else q
    y = matmul_rows(x.to(torch.bfloat16).float(), wv.float())
    if scale is not None:
        y = y * scale.float()[None, :]
    return y


def dequant_matmul(x: torch.Tensor, q: torch.Tensor,
                   scale: Optional[torch.Tensor] = None, *,
                   bits: int = 8) -> torch.Tensor:
    """``x (M, D) @ dequant(q) (D, F) [* scale (F,)] -> (M, F)`` f32.

    ``q`` is the int8 payload — ``(D, F)`` for ``bits=8``, the
    ``pack_int4`` ``(D//2, F)`` layout for ``bits=4``.  CPU tensors take
    :func:`dequant_matmul_plain`; CUDA tensors launch the kernel."""
    if x.device.type == "cpu" and q.device.type == "cpu":
        return dequant_matmul_plain(x, q, scale, bits=bits)
    if x.device.type != "cuda" or q.device != x.device:
        raise ValueError(f"dequant_matmul: x on {x.device}, q on "
                         f"{q.device}; want both on one CUDA device")
    _check(x, q, scale, bits)
    from torchpruner_tpu_torch.ops import _build

    fn = _build.function("dequant_matmul", "tp_dequant_matmul",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 4:  # the kernel loads bf16 pairs as 32-bit words
        xb = xb.clone()
    qc = q.contiguous()
    M, D = xb.shape
    F = qc.shape[1]
    y = torch.empty((M, F), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    ks = k_splits(qc.shape[0], F)
    part = (torch.empty((ks, M, F), dtype=torch.float32, device=x.device)
            if ks > 1 else y)
    sc = None
    if scale is not None:
        sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    err = fn(xb.data_ptr(), qc.data_ptr(),
             sc.data_ptr() if sc is not None else None, y.data_ptr(),
             part.data_ptr(), M, D, F, bits, ks,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dequant_matmul")
    dequant_matmul.launches += 1
    return y


#: kernel launches made through :func:`dequant_matmul` (CUDA tensors)
dequant_matmul.launches = 0
