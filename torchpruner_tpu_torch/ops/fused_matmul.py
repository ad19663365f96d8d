"""Fused dequant matmul — int8 and packed-int4 weights widened in registers.

Counterpart of ``torchpruner_tpu/ops/fused_matmul.py``.  On CUDA tensors
:func:`dequant_matmul` launches the hand-written Hopper kernel
``csrc/dequant_matmul.cu`` (which replaces the Pallas kernel
``dequant_matmul``/``_kernel``); on CPU tensors it runs
:func:`dequant_matmul_plain`, the same function in plain PyTorch.  There
is no fallback between the two: a CUDA tensor launches the kernel or
raises.

The kernel runs on the tensor cores and reads each weight tile once for
up to 128 rows of x; it is bound by weight bytes at decode and by bytes
and operations about equally at the prefill buckets (see the source note
in the ``.cu``).  :func:`plan` fixes the launch from the weight's shape
alone, so every output element is reduced in one order that does not
depend on M, and a row's result does not depend on how many rows share
the call — what slot-vs-solo bit identity needs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from torchpruner_tpu_torch.ops.fixed_order import matmul_rows
from torchpruner_tpu_torch.ops.int4_matmul import unpack_int4

__all__ = ["dequant_matmul", "dequant_matmul_plain", "int8_kernel_active",
           "INT8_KERNEL", "DequantPlan", "plan"]

#: int8 routing policy for quant.qdot: None = auto (the kernel on CUDA,
#: the plain convert path on the CPU), True/False force
INT8_KERNEL: Optional[bool] = None

#: the kernel's fixed tiles (``csrc/dequant_matmul.cu``): 4 warps of 32
#: output columns, 16 groups of 8 rows of x, 64 contracted rows per ring
#: stage, a ring of 3 stages, at most 16 K segments (one thread-block
#: cluster, Hopper's largest)
STRIP = 128
ROW_TILE = 128
K_STEP = 64
STAGES = 3
MAX_SEGMENTS = 16
#: CTAs the grid should hold at decode to stream a weight: two for each
#: of the H100's 132 SMs (three fit, so such a grid runs in one wave)
_TARGET_CTAS = 264


def int8_kernel_active(device: Optional[torch.device] = None) -> bool:
    if INT8_KERNEL is not None:
        return INT8_KERNEL
    return device is not None and torch.device(device).type == "cuda"


@dataclass(frozen=True)
class DequantPlan:
    """The kernel's launch plan for one weight shape.  ``segments`` and
    ``seg_stages`` fix every output element's reduction order (k16 steps
    ascending inside a segment, segments in ascending order) and are a
    function of ``(D, F, bits)`` alone; the rest are the kernel's fixed
    tiles.  The grid is ``(strips, row_tiles(M), segments)``."""

    D: int
    F: int
    bits: int
    segments: int
    seg_stages: int
    strip: int = STRIP
    row_tile: int = ROW_TILE
    k_step: int = K_STEP
    stages: int = STAGES

    @property
    def strips(self) -> int:
        return -(-self.F // self.strip)

    def row_tiles(self, M: int) -> int:
        return -(-M // self.row_tile)

    def segment_bounds(self) -> List[Tuple[int, int]]:
        """Contracted rows ``[begin, end)`` of D summed by each segment,
        in the order the kernel adds the segments."""
        step = self.seg_stages * self.k_step
        return [(s * step, min(self.D, (s + 1) * step))
                for s in range(self.segments)]

    def args(self, M: int) -> Tuple[int, ...]:
        """The integers ``tp_dequant_matmul`` takes for an M-row call:
        ``(M, D, F, bits, segments, seg_stages, strip, row_tile, k_step,
        stages)``; only M depends on the call."""
        return (M, self.D, self.F, self.bits, self.segments,
                self.seg_stages, self.strip, self.row_tile, self.k_step,
                self.stages)

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA: the ring of x and weight
        slabs, or the segments' f32 partial tile (rows padded by 4
        floats), which reuses it."""
        w_rows = self.k_step // 2 if self.bits == 4 else self.k_step
        ring = self.stages * (self.row_tile * self.k_step * 2
                              + w_rows * self.strip)
        return max(ring, self.row_tile * (self.strip + 4) * 4)


@functools.lru_cache(maxsize=None)
def plan(D: int, F: int, bits: int) -> DequantPlan:
    """The launch plan for a ``(D, F)`` weight of ``bits``: never a
    function of M, so a row's bits do not depend on its batch.  The K
    segments spread a decode-sized call over about two CTAs per SM (at
    most one cluster of 16), each segment at least two ring stages."""
    n_stages = -(-D // K_STEP)
    strips = -(-F // STRIP)
    want = max(1, round(_TARGET_CTAS / strips))
    segments = max(1, min(want, MAX_SEGMENTS, n_stages // 2))
    seg_stages = -(-n_stages // segments)
    segments = -(-n_stages // seg_stages)  # no empty segment
    return DequantPlan(D, F, bits, segments, seg_stages)


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
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                         + [ctypes.c_void_p])
    xb = x.to(torch.bfloat16).contiguous()
    qc = q.contiguous()
    M, D = xb.shape
    F = qc.shape[1]
    y = torch.empty((M, F), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    sc = None
    if scale is not None:
        sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    err = fn(xb.data_ptr(), qc.data_ptr(),
             sc.data_ptr() if sc is not None else None, y.data_ptr(),
             *plan(D, F, bits).args(M),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dequant_matmul")
    dequant_matmul.launches += 1
    return y


#: kernel launches made through :func:`dequant_matmul` (CUDA tensors)
dequant_matmul.launches = 0
