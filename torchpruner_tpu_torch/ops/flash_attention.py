"""Flash attention: the full-sequence attention core, forward and backward.

Counterpart of ``torchpruner_tpu/ops/flash_attention.py``.  On CUDA every
self-attention call launches hand-written Hopper kernels
(``csrc/flash_attention.cu``), which replace the Pallas kernels
``_flash_fwd``/``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``:

- :func:`flash_fwd` — the forward, writing the per-row log-sum-exp
  (LSE, ``(B, H, S)`` f32) only when a backward will follow;
- :func:`flash_dq` — dQ, with ``delta = rowsum(dO * O)`` computed in
  the kernel and written out for the next kernel;
- :func:`flash_dkv` — dK and dV.

:func:`flash_attention` wraps them in a ``torch.autograd.Function``,
mirroring the JAX package's custom VJP: a forward that needs no
gradient skips the LSE writes.  q/k/v stay in the JAX layout
``(B, S, H, Dh)``; the kernels read them through their strides, so no
transpose is made.  In bf16 all three run on Hopper's wgmma with their
tiles copied by TMA, or by the kernel's producer threads where a base or
stride breaks TMA's 16-byte rules (:func:`copy_route`); dQ stores its
result by TMA.  In f32 all three run on the tensor cores in 3xTF32
(three TF32 ``mma.sync`` products a product, f32-accurate).  The
kernels' shared memory (:func:`smem_bytes`, :func:`f32_smem_bytes`,
:func:`f32_pitches`) is mirrored here for the tests.  CPU tensors run
:func:`flash_attention_plain` (the ``_xla_attention`` math) under
autograd.  A CUDA tensor whose head dimension or dtype the kernels do
not take raises: there is no fallback.
Cross-attention (K/V longer or shorter than Q) computes plainly on
either device, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

#: the kernels take Dh a multiple of 8 up to 128: the f32 kernels step
#: over it in 8-column mma tiles, the bf16 kernels pad it to 64 or 128
MAX_HEAD_DIM = 128
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30


def kernel_active(Dh: int, dtype, device="cuda") -> bool:
    """True when :func:`flash_attention` launches the CUDA kernels for
    self-attention with head dimension ``Dh`` and ``dtype`` on
    ``device`` (every sequence length: the kernels mask the ragged
    edge)."""
    return (torch.device(device).type == "cuda" and dtype in _CODES
            and 0 < Dh <= MAX_HEAD_DIM and Dh % 8 == 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = False,
                          with_lse: bool = False):
    """The plain version: attention on ``(B, S, H, Dh)`` with the JAX
    package's ``_xla_attention`` math — f32 logits scaled by
    ``1/sqrt(Dh)``, a bottom-right-aligned causal mask (query ``i`` sees
    keys ``j <= i + Sk - Sq``), f32 softmax, weights cast to ``v``'s
    dtype before the value product.  Returns the output in ``v``'s
    dtype, and with ``with_lse`` also the ``(B, H, Sq)`` f32 LSE."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq))
        logits = torch.where(mask, logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthk->bshk", w, v)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


# ---------------------------------------- the bf16 kernels' copies and memory
# Mirrors of ``csrc/flash_attention.cu`` (``tma_ok``, ``*_wgmma_smem``);
# the card tests hold them equal to the library's ``tp_flash_tma_route``
# and ``tp_flash_smem_bytes``.

#: rows of a forward or dQ query tile and of a dK/dV key tile (one CTA
#: each); the forward streams 128-key K and V tiles through a ring of 2
#: stages, dQ 64-key K and V tiles through a ring of 3, dK/dV query tiles
#: of 64 rows through a ring of 3
TILE_ROWS = 128
RING_ROWS = 64
RING_STAGES = {"fwd": 2, "dq": 3, "dkv": 3}


def padded_head_dim(Dh: int) -> int:
    """The head dimension the wgmma kernels compute at: Dh zero-padded to
    one or two 64-column chunks of 128-byte rows."""
    return 64 if Dh <= 64 else 128


def copy_route(*ts: torch.Tensor) -> str:
    """How the bf16 kernels fill their shared memory for these inputs (q,
    k, v for the forward; q, k, v, o, dO for dQ; q, k, v, dO for dK/dV):
    ``"tma"`` when every base
    is 16-byte aligned and the stride of every axis longer than 1 a
    positive multiple of 16 bytes below 2**40, else ``"copy"`` (the
    producer threads' own loads)."""
    for t in ts:
        if t.data_ptr() % 16:
            return "copy"
        for n, st in zip(t.shape[:3], t.stride()[:3]):
            nbytes = st * t.element_size()
            if n > 1 and not (0 < nbytes < 2 ** 40 and nbytes % 16 == 0):
                return "copy"
    return "tma"


def smem_bytes(kernel: str, Dh: int) -> int:
    """Dynamic shared memory of the bf16 ``kernel`` at head dim ``Dh``:
    forward, a 128-row Q tile and a ring of K and V tiles of 128 keys; dQ,
    128-row Q, dO and O tiles and a ring of K and V tiles of 64 keys;
    dK/dV, K and V of 128 keys and a ring of 64-row Q and dO tiles with
    their LSE and delta rows; each plus its 8-byte mbarriers (one for the
    resident tiles, a full and an empty one per ring stage) and 1024
    bytes of alignment."""
    if kernel not in RING_STAGES:
        raise ValueError(f"kernel {kernel!r}: 'fwd', 'dq' or 'dkv'")
    row = padded_head_dim(Dh) * 2          # bytes of a padded bf16 row
    stages = RING_STAGES[kernel]
    extra = 8 * (1 + 2 * stages) + 1024
    if kernel == "fwd":
        return TILE_ROWS * row * (1 + 2 * stages) + extra
    if kernel == "dq":
        return (3 * TILE_ROWS + 2 * stages * RING_ROWS) * row + extra
    return (2 * TILE_ROWS * row
            + stages * (2 * RING_ROWS * row + 2 * RING_ROWS * 4) + extra)


# ------------------------------------- the f32 kernels' tiles and memory
# Mirrors of ``csrc/flash_attention.cu`` (``pitch_qk``, ``*_tf32x3_smem``);
# the card tests hold them equal to the library's ``tp_flash_smem_bytes``
# (kernels 3, 4 and 5).

#: rows of an f32 forward or dQ query tile or dK/dV key tile (a CTA of 4
#: warps, 16 rows each) and of each stage of its cp.async ring
F32_TILE_ROWS = 64


def f32_pitches(Dh: int) -> dict:
    """Row pitches, in floats, of the f32 kernels' tiles, fixed by the
    width w of the kernel copies that run ``Dh`` (64, the copies
    ``*_tf32x3<8, EXACT>``, up to Dh 64, else 128, ``*_tf32x3<16,
    EXACT>``): ``"qk"``, the forward's Q and K, the least >= w that is 8
    (mod 32), read two columns at a time by fragment rows g; ``"v"``, the
    forward's V and every dQ and dK/dV tile, w + 4 (4 mod 8), read a
    column at a time by rows g or by rows 2t and 2t + 1 (dQ's K both
    ways).  Either way a warp's read hits 32 distinct banks, and every
    row starts 16-byte aligned."""
    w = 64 if Dh <= 64 else 128
    return {"qk": w + (8 - w) % 32, "v": w + 4}


def f32_smem_bytes(kernel: str, Dh: int) -> int:
    """Dynamic shared memory of the f32 ``kernel`` at head dim ``Dh``:
    forward, a Q tile and 2 stages of K and V; dQ, Q and dO tiles and
    one stage of K and V up to Dh 64 (three CTAs an SM), else 2 (delta
    is formed from O in global memory); dK/dV, K and V and 2 stages of Q
    and dO with their LSE and delta rows."""
    p, rows = f32_pitches(Dh), F32_TILE_ROWS
    if kernel == "fwd":
        return 4 * rows * (3 * p["qk"] + 2 * p["v"])
    if kernel == "dq":
        return 4 * rows * (2 + 2 * (1 if Dh <= 64 else 2)) * p["v"]
    if kernel == "dkv":
        return 4 * rows * (6 * p["v"] + 4)
    raise ValueError(f"kernel {kernel!r}: 'fwd', 'dq' or 'dkv'")


# ---------------------------------------------------------------- kernels


def _check(*ts: torch.Tensor) -> None:
    q = ts[0]
    B, S, H, Dh = q.shape
    for t in ts:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash attention: tensors must share shape, dtype and "
                f"device; got {tuple(t.shape)} {t.dtype} {t.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}")
    if not kernel_active(Dh, q.dtype, q.device):
        raise ValueError(
            f"flash attention kernels take float32/bfloat16 CUDA tensors "
            f"with head_dim a multiple of 8 up to {MAX_HEAD_DIM}; got "
            f"{q.dtype} head_dim {Dh} on {q.device}")


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its head-dim stride is 1, else a contiguous
    copy (the kernels index the other axes by stride)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _strides(*ts: torch.Tensor):
    arr = (ctypes.c_longlong * (3 * len(ts)))()
    for i, t in enumerate(ts):
        arr[3 * i], arr[3 * i + 1], arr[3 * i + 2] = t.stride()[:3]
    return arr


def _fn(name: str, n_ptr: int):
    from torchpruner_tpu_torch.ops import _build

    return _build.function(
        "flash_attention", name,
        [ctypes.c_void_p] * n_ptr + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _launch(name: str, ptrs, strides, q, causal: bool) -> None:
    from torchpruner_tpu_torch.ops import _build

    B, S, H, Dh = q.shape
    err = _fn(name, len(ptrs))(
        *ptrs, strides, B, H, S, Dh, 1.0 / math.sqrt(Dh), int(causal),
        _CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, with_lse: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 1: ``(out (B, S, H, Dh), lse (B, H, S) f32 or None)``."""
    q, k, v = (_unit_last(t) for t in (q, k, v))
    _check(q, k, v)
    B, S, H, Dh = q.shape
    o = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    _launch("tp_flash_fwd",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if lse is not None else None],
            _strides(q, k, v, o), q, causal)
    flash_fwd.launches += 1
    return o, lse


def flash_dq(q, k, v, o, do, lse, *, causal: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2: ``(dq (B, S, H, Dh), delta (B, H, S) f32)``; ``dq`` is
    allocated contiguous (the bf16 kernel stores it by TMA)."""
    q, k, v, o, do = (_unit_last(t) for t in (q, k, v, o, do))
    _check(q, k, v, o, do)
    B, S, H, Dh = q.shape
    lse = lse.contiguous()
    dq = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("tp_flash_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr()],
            _strides(q, k, v, o, do, dq), q, causal)
    flash_dq.launches += 1
    return dq, delta


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: ``(dk, dv)``, each ``(B, S, H, Dh)``; ``delta`` is the
    one :func:`flash_dq` wrote."""
    q, k, v, do = (_unit_last(t) for t in (q, k, v, do))
    _check(q, k, v, do)
    B, S, H, Dh = q.shape
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    _launch("tp_flash_dkv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            _strides(q, k, v, do, dk, dv), q, causal)
    flash_dkv.launches += 1
    return dk, dv


#: kernel launches made through each wrapper (CUDA tensors only)
flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX package's ``_flash_attention``: the
    forward keeps (q, k, v, out, lse); the backward runs dQ, then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, delta = flash_dq(q, k, v, o, do, lse, causal=ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """Attention on ``(B, S, H, Dh)`` q/k/v (K/V already at H heads).
    CUDA tensors launch the kernels (forward without the LSE when no
    gradient is wanted); CPU tensors run :func:`flash_attention_plain`."""
    if k.shape[1] != q.shape[1] or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_fwd(q, k, v, causal=causal, with_lse=False)[0]
