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
