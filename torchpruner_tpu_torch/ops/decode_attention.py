"""Decode-shaped attention: one query per row against the static KV cache.

Counterpart of ``torchpruner_tpu/ops/decode_attention.py``.  On CUDA every
single-token step (``s == 1``) launches the hand-written Hopper kernel
``csrc/decode_attention.cu`` (which replaces the Pallas kernel
``_decode_call``/``_decode_kernel``): split-KV in one launch, a CTA per
(row, head, chunk of the cache), the last live CTA of a (row, head)
merging the chunks' partials in chunk order.  On CPU tensors the same
function runs in plain PyTorch (:func:`decode_attention_plain`, the same
partition).  Prefill blocks (``s > 1``) take the masked path
:func:`xla_decode_attention` in plain PyTorch on either device, as the
JAX package computes them outside Pallas.

**Bit-stability contract** (the serve ``--verify`` path), as in the JAX
package: a row's result depends only on its real positions ``0..pos``
and on the chunk partition, which is a function of the cache length
alone (:func:`decode_plan`).  Positions past ``pos`` are never read, so
stale K/V from a slot's previous occupant cannot change a row.  The
masked prefill path partitions the cache into blocks of a FIXED width
(independent of the cache length) and queries into fixed chunks of rows,
so the engine's bucket-length prefill and a solo replay at the exact
prompt length compute every real row identically.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

#: decode block cap / floor: positions per KV block
MAX_DECODE_BLOCK = 128
MIN_DECODE_BLOCK = 8
#: the kernel's largest head dimension
MAX_HEAD_DIM = 256
#: query rows per chunk and KV positions per block of the masked path —
#: fixed widths, independent of the prompt and cache lengths
PREFILL_ROWS = 16
PREFILL_COLS = 64

_NEG_INF = -1e30

Pos = Union[int, torch.Tensor]


def decode_block(T: int) -> Optional[int]:
    """The largest power-of-two divisor of ``T`` in [8, 128] (None when
    below 8) — the JAX package's block rule, a function of T alone."""
    bk = 1
    while T % (bk * 2) == 0 and bk * 2 <= MAX_DECODE_BLOCK:
        bk *= 2
    if bk < MIN_DECODE_BLOCK:
        return None
    return bk


#: the split-KV plan's limits (``csrc/decode_attention.cu``): chunks of a
#: multiple of 64 positions, at most 16 of them a row, at most 4096
#: positions each
MIN_CHUNK = 64
MAX_SPLIT = 16
MAX_CHUNK = 4096
MAX_CACHE_LEN = MAX_SPLIT * MAX_CHUNK


def decode_plan(T: int) -> Tuple[int, int]:
    """``(chunk, n_split)``: how a length-``T`` cache is cut for the
    kernel, a function of T alone (mirror of ``make_plan`` in
    ``csrc/decode_attention.cu``, which the C entry checks): as many
    chunks as 64-position blocks up to :data:`MAX_SPLIT`, each a multiple
    of 64 positions, the last clipped at T.  Chunk ``c`` covers positions
    ``c * chunk .. min((c + 1) * chunk, T) - 1``."""
    if not 0 < T <= MAX_CACHE_LEN:
        raise ValueError(f"decode attention takes cache lengths 1.."
                         f"{MAX_CACHE_LEN}, got {T}")
    want = min(MAX_SPLIT, -(-T // MIN_CHUNK))
    per = -(-T // want)
    chunk = -(-per // MIN_CHUNK) * MIN_CHUNK
    return chunk, -(-T // chunk)


def kernel_active(T: int, Dh: int, dtype, device="cuda") -> bool:
    """True when :func:`decode_attention` launches the CUDA kernel for a
    single-token step at this cache geometry on ``device``."""
    return (torch.device(device).type == "cuda" and Dh <= MAX_HEAD_DIM
            and 0 < T <= MAX_CACHE_LEN)


def _pos_vector(pos: Pos, B: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def xla_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: Pos) -> torch.Tensor:
    """The masked path (every prefill block, ``s >= 1``): query ``i`` of
    row ``b`` attends positions ``<= pos[b] + i``.  ``q`` is
    ``(B, s, H, Dh)``, the cache ``(B, T, H, Dh)``, ``pos`` an int or a
    ``(B,)`` tensor.  f32 online softmax over fixed-width KV blocks;
    returns ``(B, s, H, Dh)`` in the cache dtype."""
    B, s, H, Dh = q.shape
    T = k_cache.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    pos_v = _pos_vector(pos, B, dev).long()
    # blocks a chunk needs: with an int pos the host knows the last
    # attended position; with per-row positions every block is visited
    # (masked blocks add exact zeros, so the result is the same)
    last = None if isinstance(pos, torch.Tensor) and pos.dim() > 0 \
        else int(pos)
    outs = []
    for r0 in range(0, s, PREFILL_ROWS):
        qc = q[:, r0:r0 + PREFILL_ROWS].float()
        n = qc.shape[1]
        if n < PREFILL_ROWS:
            qc = torch.cat([qc, qc.new_zeros(
                (B, PREFILL_ROWS - n, H, Dh))], dim=1)
        qc = qc.permute(0, 2, 1, 3).contiguous()          # (B, H, R, Dh)
        q_pos = pos_v[:, None] + r0 + torch.arange(
            PREFILL_ROWS, device=dev)[None, :]            # (B, R)
        stop = T if last is None else min(T, last + r0 + PREFILL_ROWS)
        m = torch.full((B, H, PREFILL_ROWS), _NEG_INF, device=dev)
        l = torch.zeros((B, H, PREFILL_ROWS), device=dev)
        acc = torch.zeros((B, H, PREFILL_ROWS, Dh), device=dev)
        for t0 in range(0, stop, PREFILL_COLS):
            kc = k_cache[:, t0:t0 + PREFILL_COLS].float()
            vc = v_cache[:, t0:t0 + PREFILL_COLS].float()
            w = kc.shape[1]
            if w < PREFILL_COLS:
                pad = kc.new_zeros((B, PREFILL_COLS - w, H, Dh))
                kc, vc = torch.cat([kc, pad], 1), torch.cat([vc, pad], 1)
            # canonical contiguous operands: every call has one shape
            # and one stride pattern, whatever T is
            kc = kc.permute(0, 2, 3, 1).contiguous()      # (B, H, Dh, C)
            vc = vc.permute(0, 2, 1, 3).contiguous()      # (B, H, C, Dh)
            sc = torch.matmul(qc, kc) * scale
            t = t0 + torch.arange(PREFILL_COLS, device=dev)
            mask = (t[None, None, :] <= q_pos[:, :, None]) \
                & (t < T)[None, None, :]
            sc = torch.where(mask[:, None], sc, _NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vc)
            m = m_new
        ctx = (acc / l[..., None]).permute(0, 2, 1, 3)[:, :n]
        outs.append(ctx.to(v_cache.dtype))
    return torch.cat(outs, dim=1)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: Pos) -> torch.Tensor:
    """The plain version of the decode kernel, on its partition: per row,
    each chunk of :func:`decode_plan` ``(T)`` up to the row's own ``pos``
    (clamped to ``T - 1``) gives an f32 partial (max, sum of weights,
    weighted sum of V rows), and the partials are combined in chunk
    order; nothing past ``pos`` is read.  Returns ``(B, 1, H, Dh)`` in
    the cache dtype."""
    B, _, H, Dh = q.shape
    T = k_cache.shape[1]
    chunk, _ = decode_plan(T)
    scale = 1.0 / math.sqrt(Dh)
    rows = _pos_vector(pos, B, "cpu").tolist()
    out = torch.empty((B, 1, H, Dh), dtype=v_cache.dtype, device=q.device)
    for b, p in enumerate(rows):
        p = min(max(int(p), 0), T - 1)
        qf = q[b, 0].float()                               # (H, Dh)
        parts = []
        for t0 in range(0, p + 1, chunk):
            live = min(chunk, p - t0 + 1)
            kf = k_cache[b, t0:t0 + live].float()          # (live, H, Dh)
            vf = v_cache[b, t0:t0 + live].float()
            sc = (qf[None] * kf).sum(dim=-1).t() * scale   # (H, live)
            m = sc.amax(dim=-1)
            w = torch.exp(sc - m[:, None])
            parts.append((m, w.sum(dim=-1), (w.t()[:, :, None] * vf).sum(0)))
        m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
        l = torch.zeros((H,), device=q.device)
        acc = torch.zeros((H, Dh), device=q.device)
        for pm, pl, pa in parts:
            alpha = torch.exp(pm - m)
            l = l + pl * alpha
            acc = acc + pa * alpha[:, None]
        out[b, 0] = (acc / l[:, None]).to(v_cache.dtype)
    return out


def _dtype_code(t: torch.Tensor) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"decode attention takes float32/bfloat16, got "
                        f"{t.dtype}")
    return codes[t.dtype]


#: the merge's workspace per (device, stream): int32 counters, one per
#: (row, head), which the kernel leaves at 0 after every call, and f32
#: scratch for the chunks' partials; grown, never shrunk, and dropped
#: after a failed launch
_workspaces: dict = {}


def _workspace(device, stream: int, n_bh: int, n_part: int):
    cnt, part = _workspaces.get((device, stream), (None, None))
    if cnt is None or cnt.numel() < n_bh:
        cnt = torch.zeros(n_bh, dtype=torch.int32, device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    _workspaces[(device, stream)] = (cnt, part)
    return cnt, part


def _launch(q, k_cache, v_cache, pos: Pos) -> torch.Tensor:
    from torchpruner_tpu_torch.ops import _build

    B, _, H, Dh = q.shape
    T = k_cache.shape[1]
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"decode kernel supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {Dh}")
    if k_cache.shape != v_cache.shape or k_cache.dtype != v_cache.dtype \
            or k_cache.shape[0] != B or k_cache.shape[2:] != (H, Dh):
        raise ValueError(f"cache {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode kernel needs contiguous K/V caches")
    chunk, n_split = decode_plan(T)
    qc = q.contiguous()
    pv = _pos_vector(pos, B, q.device).contiguous()
    out = torch.empty((B, 1, H, Dh), dtype=v_cache.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cnt, part = _workspace(q.device, stream, B * H,
                           B * H * n_split * (Dh + 2))
    fn = _build.function(
        "decode_attention", "tp_decode_attention",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    try:
        err = fn(qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 pv.data_ptr(), out.data_ptr(), part.data_ptr(),
                 cnt.data_ptr(), B, H, T, Dh, chunk, n_split,
                 1.0 / math.sqrt(Dh), _dtype_code(qc),
                 _dtype_code(k_cache), stream)
        _build.check(err, "decode_attention")
    except BaseException:
        # a launch that failed may have stopped mid-merge with arrival
        # counters set: drop the stream's workspace, so the next call
        # starts from fresh zeroed counters instead of a stale count
        _workspaces.pop((q.device, stream), None)
        raise
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Pos) -> torch.Tensor:
    """Attention of ``q (B, s, H, Dh)`` against ``k_cache/v_cache
    (B, T, H, Dh)`` at per-row positions ``pos`` (a ``(B,)`` int tensor,
    or an int applied to every row).  ``s == 1`` steps launch the CUDA
    kernel on CUDA tensors and run :func:`decode_attention_plain` on CPU
    tensors; ``s > 1`` takes :func:`xla_decode_attention`.  Returns
    ``(B, s, H, Dh)`` in the cache dtype."""
    if q.shape[1] != 1:
        return xla_decode_attention(q, k_cache, v_cache, pos)
    if q.device.type == "cpu" and k_cache.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda" or k_cache.device != q.device:
        raise ValueError(f"decode_attention: q on {q.device}, cache on "
                         f"{k_cache.device}; want one CUDA device")
    out = _launch(q, k_cache, v_cache, pos)
    decode_attention.launches += 1
    return out


#: kernel launches made through :func:`decode_attention` (CUDA tensors)
decode_attention.launches = 0
