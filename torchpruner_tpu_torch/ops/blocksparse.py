"""Block-sparse matmul — structured sparsity the kernel actually skips.

Counterpart of ``torchpruner_tpu/ops/blocksparse.py``.  Mask-based
pruning (``core/masking.py``) holds dropped units at zero without
changing shapes; a dense product over a half-zero weight still pays for
every block.  Here the weight's kept input-row blocks and kept
output-column blocks are index lists (``in_keep`` / ``out_keep``, from
the same drop indices as ``prune`` / ``drop_masks`` through
:func:`keep_blocks_from_drop`, or from block-granular scoring,
``score_drop_indices(granularity=128)``), and on CUDA three hand-written
Hopper kernels (``csrc/blocksparse_matmul.cu``) replace the Pallas
kernel ``_mm_kernel`` in its three grid layouts:

- :func:`blocksparse_fwd` — ``y = x W`` contracting kept input blocks;
  dropped output columns exactly 0;
- :func:`blocksparse_dx` — ``dx = g Wᵀ`` contracting kept output blocks;
  dropped input columns exactly 0;
- :func:`blocksparse_dw` — ``dW = xᵀ g`` on the kept (in × out) blocks;
  every other block exactly 0.

How a call runs is its launch plan, a function of the shapes alone
(:func:`plan`, the mirror of the library's ``tp_bs_plan``): bf16 on a
block that is a multiple of 64 takes the wgmma body (TMA ring, tiles of
128 rows by 64-192 columns gathered through the keep lists, dW's rows
split over a thread-block cluster and summed in rank order), bf16 on an
odd multiple of 32 the earlier wmma body, f32 the 3xTF32 body (three
TF32 ``mma.sync`` products a product, f32-accurate; a cp.async ring,
dW's rows split over a cluster the same way).

:func:`blocksparse_matmul` wraps them in a ``torch.autograd.Function``
that mirrors the JAX custom VJP.  CPU tensors run
:func:`blocksparse_matmul_plain` (the dense product of the masked
weight) under autograd.  A CUDA tensor launches the kernels or raises:
there is no fallback, so a ``D`` or ``F`` that ``block`` does not divide
raises there (on the CPU it takes the JAX package's contract: no block
lists to honour, the dense product of the caller-masked weight).  An
empty keep list launches nothing on either device: exact zeros, with
exactly zero gradients.

:class:`BlockSparseWeight` wraps a ``(D, F)`` weight with its keep
lists; ``quant.qdot`` and ``core.layers`` dispatch it, so a Dense or
GatedDense site rides the kernels, forward and backward, from the params
tree alone (``masking.blocksparse_params``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BlockSparseWeight", "blocksparse_matmul", "blocksparse_matmul_plain",
    "blocksparse_fwd", "blocksparse_dx", "blocksparse_dw", "kernel_active",
    "keep_blocks_from_drop", "keep_blocks_from_mask", "DEFAULT_BLOCK",
    "BlockSparsePlan", "plan",
]

#: weight-block edge: the JAX package's lane width, and the granularity
#: ``score_drop_indices(granularity=128)`` drops at
DEFAULT_BLOCK = 128
#: the kernels tile a block in 32-wide pieces
BLOCK_MULTIPLE = 32
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def keep_blocks_from_drop(n: int, drop: Sequence[int],
                          block: int = DEFAULT_BLOCK
                          ) -> Optional[Tuple[int, ...]]:
    """Kept-block indices for a width-``n`` axis with ``drop``ped units,
    or None when the pattern is not block-aligned (some block is only
    partially dropped) or the axis doesn't tile."""
    if n % block:
        return None
    dropped = np.zeros(n, bool)
    dropped[np.asarray(list(drop), np.int64)] = True
    per = dropped.reshape(n // block, block)
    full = per.all(axis=1)
    if not np.array_equal(per.any(axis=1), full):
        return None  # partially-dropped block: mask-only semantics
    return tuple(int(i) for i in np.flatnonzero(~full))


def keep_blocks_from_mask(unit_mask, block: int = DEFAULT_BLOCK
                          ) -> Optional[Tuple[int, ...]]:
    """Kept-block indices from a 0/1 keep mask over one axis (None when
    not block-aligned)."""
    m = np.asarray(unit_mask).astype(bool)
    if m.ndim != 1 or m.size % block:
        return None
    per = m.reshape(m.size // block, block)
    kept = per.all(axis=1)
    if not np.array_equal(per.any(axis=1), kept):
        return None
    return tuple(int(i) for i in np.flatnonzero(kept))


def kernel_active(block: int, dtype, device="cuda") -> bool:
    """True when :func:`blocksparse_matmul` launches the CUDA kernels for
    ``block``-edged blocks of ``dtype`` on ``device`` (every row count:
    the kernels mask the ragged edge)."""
    return (torch.device(device).type == "cuda" and dtype in _CODES
            and block > 0 and block % BLOCK_MULTIPLE == 0)


def _unit_mask(n: int, keep: Tuple[int, ...], block: int,
               device) -> torch.Tensor:
    m = torch.zeros(n // block, dtype=torch.bool, device=device)
    if keep:
        m[torch.as_tensor(keep, dtype=torch.long, device=device)] = True
    return m.repeat_interleave(block)


def blocksparse_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                             in_keep: Optional[Sequence[int]] = None,
                             out_keep: Optional[Sequence[int]] = None,
                             block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The plain version: ``x (..., D) @ w (D, F)`` with the rows and
    columns of ``w`` outside the kept blocks masked to zero (None = all
    blocks of that axis), in the operands' promoted dtype.  Autograd of
    it gives the kernels' gradients: dropped input columns of ``dx`` and
    dropped blocks of ``dW`` are exactly 0."""
    D, F = w.shape
    dt = torch.promote_types(x.dtype, w.dtype)
    wm = w.to(dt)
    if in_keep is not None:
        wm = wm * _unit_mask(D, tuple(in_keep), block, w.device)[:, None]
    if out_keep is not None:
        wm = wm * _unit_mask(F, tuple(out_keep), block, w.device)[None, :]
    return x.to(dt) @ wm


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=1024)
def _keep_tensors(in_keep: Tuple[int, ...], out_keep: Tuple[int, ...],
                  n_in: int, n_out: int, device: str):
    """The int32 device arrays of a pattern's keep lists, checked and
    made once per pattern and device: a training step makes dozens of
    calls per pattern, and a host-to-device copy in each would serialize
    it."""
    for keep, n in ((in_keep, n_in), (out_keep, n_out)):
        if not keep or min(keep) < 0 or max(keep) >= n \
                or len(set(keep)) != len(keep):
            raise ValueError(
                f"a keep list must hold distinct block indices in "
                f"[0, {n}) and at least one; got {keep}")
    return (torch.tensor(in_keep, dtype=torch.int32, device=device),
            torch.tensor(out_keep, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=64)
def _all_blocks(n: int) -> Tuple[int, ...]:
    return tuple(range(n))


def _keep_tuple(keep: Optional[Sequence[int]], n: int) -> Tuple[int, ...]:
    """A keep list as a tuple of ints (None = all ``n`` blocks); a tuple
    is taken as it is, since a training step passes the same ones in
    every call."""
    if keep is None:
        return _all_blocks(n)
    return keep if isinstance(keep, tuple) else tuple(int(i) for i in keep)


_MODES = {"fwd": 0, "dx": 1, "dw": 2}
#: body names by ``tp_bs_plan`` code; 0 is the f32 FMA body of sources
#: before the 3xTF32 one, which an A/B may still load
_BODIES = ("fma", "wmma", "wgmma", "tf32x3")
#: the plan's constants, as in ``csrc/blocksparse_matmul.cu``
_BK = _CH = 64
_BM, _SMS, _SMEM_LIMIT, _MAX_STAGES, _MAX_SPLIT = 128, 132, 232448, 8, 8
_MIN_SPLIT_STEPS, _FIXED_COST = 4, 6 * 256
#: the 3xTF32 body: contracted elements of a ring stage, ring stages, and
#: its tiles (rows, columns) in the order the plan tries them
_TK, _TF_STAGES = 32, 3
_TF_TILES = ((128, 128), (128, 64), (128, 32))
_TF_DW_TILES = ((128, 128), (128, 64), (64, 64), (32, 32))


@dataclass(frozen=True)
class BlockSparsePlan:
    """How a kernel call runs (``tp_bs_plan``): the body (``"tf32x3"``
    f32, ``"wmma"`` bf16 on a block that is an odd multiple of 32,
    ``"wgmma"`` bf16 otherwise), its output tile, ring stages, the dW row
    split over a cluster, CTAs, kept output tiles and dynamic
    shared-memory bytes."""

    body: str
    tile_m: int
    tile_n: int
    stages: int
    split: int
    ctas: int
    tiles: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wgmma_smem(bn, stages, n_in, n_out, D, F, block) -> int:
    return (1024 + stages * (_BM + bn) * _BK * 2 + _BM * bn * 2
            + 16 * stages
            + _cdiv(4 * (n_in + n_out), 16) * 16
            + _cdiv(D // block + F // block, 16) * 16)


def tf_pitches(mode: str, bm: int, bn: int) -> Tuple[int, int]:
    """Row pitches, in floats, of the 3xTF32 body's A and B tiles at
    tile (bm, bn): a tile whose rows run along the contraction (fwd / dx
    A, dx B) at 32 + 8 = 8 (mod 32), read two elements a row at a time;
    the others (dW A, fwd / dW B) at their width + 4 = 4 (mod 16), read
    at rows 2t and 2t + 1."""
    m = _MODES[mode]
    return (bm + 4 if m == 2 else _TK + 8), (_TK + 8 if m == 1 else bn + 4)


def tf_stage_floats(mode: str, bm: int, bn: int) -> int:
    """Floats of one ring stage of the 3xTF32 body: A (32 x bm for dW,
    else bm x 32), then B (bn x 32 for dx, else 32 x bn), at
    :func:`tf_pitches`."""
    m = _MODES[mode]
    pa, pb = tf_pitches(mode, bm, bn)
    return (_TK if m == 2 else bm) * pa + (bn if m == 1 else _TK) * pb


def plan(mode: str, R: int, D: int, F: int, block: int, n_in: int,
         n_out: int, dtype=torch.bfloat16) -> BlockSparsePlan:
    """The launch plan of ``mode`` (``"fwd"``, ``"dx"``, ``"dw"``) at
    these shapes: the mirror of the C entry ``tp_bs_plan``, a function of
    its arguments alone.  bf16 on a multiple-of-64 block takes the wgmma
    body: tiles of 128 rows by 64, 128 or 192 columns gathered through
    the keep lists; f32 the 3xTF32 body: tiles of 128 rows by 128, 64 or
    32 columns (dW: 128 x 128, 128 x 64, 64 x 64 or 32 x 32) inside one
    block of each gathered axis.  The tile, and dW's split of R over a
    cluster of 1, 2, 4 or 8 CTAs, minimize rounds of 132 CTAs x (ring
    stages x (tile rows + width) + a fixed cost), what the CTAs read from
    L2.  wgmma: fwd / dx run at most 132 persistent CTAs, dW one cluster
    per kept tile, as many ring stages (at most 8) as 227 KB holds;
    3xTF32: one CTA (dW: one cluster) per output tile, kept or not, 3
    ring stages.  bf16 on an odd multiple of 32 takes the wmma body."""
    m = _MODES[mode]
    if not (R >= 1 and block >= 32 and block % 32 == 0 and D >= 1
            and F >= 1 and D % block == 0 and F % block == 0
            and 1 <= n_in <= D // block and 1 <= n_out <= F // block
            and dtype in _CODES):
        raise ValueError(f"no block-sparse body takes {mode} R {R} D {D} "
                         f"F {F} block {block} kept {n_in} x {n_out} "
                         f"{dtype}")
    out_cols = D if m == 1 else F
    f32 = dtype == torch.float32
    if not f32 and block % 64:
        bm, bn = (32 if m == 2 else 64), 32
        ctas = (D // bm if m == 2 else _cdiv(R, bm)) * (out_cols // bn)
        return BlockSparsePlan("wmma", bm, bn, 1, 1, ctas, ctas, 0)
    rows = n_in * block if m == 2 else R
    cols = (n_in if m == 1 else n_out) * block
    kd = _TK if f32 else _BK
    steps = (n_in * block // kd if m == 0 else
             n_out * block // kd if m == 1 else _cdiv(R, kd))
    if not f32:
        cand = ((_BM, _CH), (_BM, 2 * _CH), (_BM, 3 * _CH))
    else:
        cand = [(bm, bn) for bm, bn in (_TF_DW_TILES if m == 2 else
                                        _TF_TILES)
                if block % bn == 0 and (m != 2 or block % bm == 0)]
    best = None
    for bm, bn in cand:
        tiles = _cdiv(rows, bm) * _cdiv(cols, bn)
        s = 1
        while s <= (_MAX_SPLIT if m == 2 else 1):
            if s > 1 and steps < s * _MIN_SPLIT_STEPS:
                break
            c = _cdiv(tiles * s, _SMS) * (
                _cdiv(steps, s) * (bm + bn) + _FIXED_COST)
            if best is None or c < best[0]:
                best = (c, bm, bn, s, tiles)
            s *= 2
    _, bm, bn, split, tiles = best
    if f32:
        ctas = ((D // bm if m == 2 else _cdiv(R, bm)) * (out_cols // bn)
                * split)
        return BlockSparsePlan("tf32x3", bm, bn, _TF_STAGES, split, ctas,
                               tiles,
                               4 * _TF_STAGES * tf_stage_floats(mode, bm, bn))
    if m == 2:
        ctas = tiles * split
    else:  # the CTAs also write the dropped (64-row, block) units
        ctas = min(_cdiv(R, _CH) * ((F if m == 0 else D) // block) + tiles,
                   _SMS)
    stage = (_BM + bn) * _BK * 2
    fixed = _wgmma_smem(bn, 0, n_in, n_out, D, F, block) + 16 * _MAX_STAGES
    stages = min((_SMEM_LIMIT - fixed) // stage, _MAX_STAGES)
    if stages < 2 or stages * stage < _BM * bn * 4:
        raise ValueError(f"block-sparse {mode}: the keep lists of D {D} / "
                         f"F {F} at block {block} leave no room for a ring")
    return BlockSparsePlan("wgmma", _BM, bn, stages, split, ctas, tiles,
                           _wgmma_smem(bn, stages, n_in, n_out, D, F, block))


def plan_on_card(mode: str, R: int, D: int, F: int, block: int, n_in: int,
                 n_out: int, dtype=torch.bfloat16) -> BlockSparsePlan:
    """The plan as the built library's ``tp_bs_plan`` computes it."""
    from torchpruner_tpu_torch.ops import _build

    fn = _build.function("blocksparse_matmul", "tp_bs_plan",
                         [ctypes.c_int] * 8 + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 8)()
    _build.check(fn(_MODES[mode], R, D, F, block, n_in, n_out,
                    _CODES[dtype], ctypes.addressof(out)), "tp_bs_plan")
    v = list(out)
    return BlockSparsePlan(_BODIES[v[0]], *v[1:])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, a, b, out, in_keep, out_keep, R, D, F, block) -> None:
    from torchpruner_tpu_torch.ops import _build

    if not (a.dtype == b.dtype == out.dtype
            and a.device == b.device == out.device):
        raise ValueError(f"{name}: operands must share dtype and device; "
                         f"got {a.dtype}/{b.dtype} on {a.device}/{b.device}")
    if not kernel_active(block, a.dtype, a.device):
        raise ValueError(
            f"{name}: the block-sparse kernels take float32/bfloat16 CUDA "
            f"tensors and blocks that are multiples of {BLOCK_MULTIPLE}; "
            f"got {a.dtype} block {block} on {a.device}")
    if D % block or F % block:
        raise ValueError(f"{name}: block {block} must divide D {D} and "
                         f"F {F}")
    ii, oo = _keep_tensors(in_keep, out_keep, D // block, F // block,
                           str(a.device))
    fn = _build.function(
        "blocksparse_matmul", name,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
             ii.data_ptr(), oo.data_ptr(),
             len(in_keep), len(out_keep), R, D, F, block, _CODES[a.dtype],
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, name)


def blocksparse_fwd(x: torch.Tensor, w: torch.Tensor,
                    in_keep: Tuple[int, ...], out_keep: Tuple[int, ...],
                    block: int) -> torch.Tensor:
    """Kernel 1: ``y (R, F) = x (R, D) @ w (D, F)`` over kept blocks."""
    x, w = _aligned(x), _aligned(w)
    (R, D), F = x.shape, w.shape[1]
    y = torch.empty((R, F), dtype=x.dtype, device=x.device)
    _launch("tp_bs_fwd", x, w, y, in_keep, out_keep, R, D, F, block)
    blocksparse_fwd.launches += 1
    return y


def blocksparse_dx(g: torch.Tensor, w: torch.Tensor,
                   in_keep: Tuple[int, ...], out_keep: Tuple[int, ...],
                   block: int) -> torch.Tensor:
    """Kernel 2: ``dx (R, D) = g (R, F) @ w (D, F)ᵀ`` over kept blocks."""
    g, w = _aligned(g), _aligned(w)
    (R, F), D = g.shape, w.shape[0]
    dx = torch.empty((R, D), dtype=g.dtype, device=g.device)
    _launch("tp_bs_dx", g, w, dx, in_keep, out_keep, R, D, F, block)
    blocksparse_dx.launches += 1
    return dx


def blocksparse_dw(x: torch.Tensor, g: torch.Tensor,
                   in_keep: Tuple[int, ...], out_keep: Tuple[int, ...],
                   block: int) -> torch.Tensor:
    """Kernel 3: ``dW (D, F) = x (R, D)ᵀ @ g (R, F)`` on kept blocks."""
    x, g = _aligned(x), _aligned(g)
    (R, D), F = x.shape, g.shape[1]
    dw = torch.empty((D, F), dtype=x.dtype, device=x.device)
    _launch("tp_bs_dw", x, g, dw, in_keep, out_keep, R, D, F, block)
    blocksparse_dw.launches += 1
    return dw


#: kernel launches made through each wrapper (CUDA tensors only)
blocksparse_fwd.launches = 0
blocksparse_dx.launches = 0
blocksparse_dw.launches = 0


class _AllDropped(torch.autograd.Function):
    """The product with every block of one axis dropped: exact zeros out,
    exact zeros back to ``x`` and ``w`` (so both stay in the graph, as
    under the JAX package's VJP), and no product computed."""

    @staticmethod
    def forward(ctx, x, w, shape, dtype):
        ctx.save_for_backward(x, w)
        return torch.zeros(shape, dtype=dtype, device=x.device)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return torch.zeros_like(x), torch.zeros_like(w), None, None


class _BlockSparseMatmul(torch.autograd.Function):
    """The custom VJP of the JAX package's ``_bs_mm``: the forward keeps
    (x, w); the backward runs dx and dW on the kept blocks, the incoming
    gradient cast to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, w, in_keep, out_keep, block):
        ctx.save_for_backward(x, w)
        ctx.pattern = (in_keep, out_keep, block)
        return blocksparse_fwd(x, w, in_keep, out_keep, block)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = blocksparse_dx(g, w, *ctx.pattern) \
            if ctx.needs_input_grad[0] else None
        dw = blocksparse_dw(x, g, *ctx.pattern) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None


def blocksparse_matmul(x: torch.Tensor, w: torch.Tensor, *,
                       in_keep: Optional[Sequence[int]] = None,
                       out_keep: Optional[Sequence[int]] = None,
                       block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``x (..., D) @ w (D, F) -> (..., F)`` computing only the kept
    ``block x block`` weight blocks (None = all blocks on that axis: a
    dense blocked product on the same kernels).  Differentiable; dropped
    blocks contribute, and receive, exactly zero.  The result has the
    operands' promoted dtype, ``dx`` has ``x``'s and ``dW`` has ``w``'s.
    CUDA tensors launch the kernels for any row count, and raise when
    ``block`` does not divide ``D`` and ``F``; CPU tensors run
    :func:`blocksparse_matmul_plain`."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"blocksparse_matmul: x {tuple(x.shape)} does not "
                         f"contract with w {tuple(w.shape)}")
    D, F = w.shape
    lead = tuple(x.shape[:-1])
    dt = torch.promote_types(x.dtype, w.dtype)
    if D % block or F % block:
        if x.device.type != "cpu":
            raise ValueError(
                f"blocksparse_matmul: block {block} must divide D {D} and "
                f"F {F} on {x.device}; leave such a weight unwrapped")
        # no block lists to honour: the dense product of the weight,
        # whose dropped entries the caller keeps at zero
        return x.to(dt) @ w.to(dt)
    ik = _keep_tuple(in_keep, D // block)
    ok = _keep_tuple(out_keep, F // block)
    if not ik or not ok or x.numel() == 0:
        # everything dropped on one axis: exactly zero, gradients too
        return _AllDropped.apply(x, w, lead + (F,), dt)
    if x.device.type == "cpu":
        return blocksparse_matmul_plain(x, w, in_keep=ik, out_keep=ok,
                                        block=block)
    if x.device.type != "cuda":
        raise ValueError(f"blocksparse_matmul: unsupported device {x.device}")
    y = _BlockSparseMatmul.apply(x.reshape(-1, D).to(dt), w.to(dt), ik, ok,
                                 int(block))
    return y.reshape(lead + (F,))


@dataclass
class BlockSparseWeight:
    """A ``(D, F)`` matmul weight carrying its block-sparsity pattern.

    ``w`` holds the DENSE buffer with dropped blocks at zero (the tensor
    that masked training updates); ``in_keep`` / ``out_keep`` are the
    kept-block index tuples (None = dense on that axis).  ``quant.qdot``
    and the layer rules send instances through
    :func:`blocksparse_matmul`, so a Dense or GatedDense site picks the
    kernels up from the params tree alone."""

    w: torch.Tensor
    in_keep: Optional[Tuple[int, ...]] = None
    out_keep: Optional[Tuple[int, ...]] = None
    block: int = DEFAULT_BLOCK

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def device(self) -> torch.device:
        return self.w.device

    def dense(self) -> torch.Tensor:
        """The dense (masked) buffer — the reference-path view."""
        return self.w

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        return blocksparse_matmul(
            x, self.w, in_keep=self.in_keep, out_keep=self.out_keep,
            block=self.block)
