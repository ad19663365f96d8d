"""Batch-invariant evaluation of the plain (non-kernel) row operations.

The serve ``--verify`` contract asks for BIT-identical tokens between the
continuous-batching engine and a solo ``generate`` replay.  The two run
the same rows at different batch sizes: slot decode at ``M = n_slots``
against the replay's ``M = 1``, and the engine's bucket-length prefill
against the replay's exact prompt length.  Library matrix products and
reductions choose their algorithm (tiling, split-K, threads per output)
from the whole tensor's shape, so the same row can round differently at
a different ``M``.

The fix: every such operation runs on fixed-size chunks of ``ROWS``
rows (the last chunk zero-padded), so every call has the same shape and
each row's result depends only on that row.  The hand-written kernels
(``fused_matmul``, ``decode_attention``) are batch-invariant by design
and need none of this.
"""

from __future__ import annotations

from typing import Callable

import torch

#: rows per chunk: one chunk covers a decode step of up to 16 slots
ROWS = 16


def per_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             rows: int = ROWS) -> torch.Tensor:
    """``fn`` applied to ``x (..., K)`` flattened to rows, in fixed-size
    chunks of ``rows`` rows.  ``fn`` maps ``(rows, K) -> (rows, ...)``
    row-wise; the result keeps ``x``'s leading axes."""
    per_rows.calls += 1
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    pad = (-m) % rows
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
    y = torch.cat([fn(x2[i:i + rows]) for i in range(0, m + pad, rows)])
    y = y[:m]
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


#: calls of :func:`per_rows` (products and row reductions of the
#: fixed-order path) — the full-sequence path must make none
per_rows.calls = 0


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` with a batch-invariant result per row;
    mixed operand dtypes promote as in ``jnp.matmul``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    w = w.to(dt)
    return per_rows(lambda c: c @ w, x.to(dt))
