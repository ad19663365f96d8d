"""Ring attention — sequence (context) parallelism over a process group;
counterpart of ``torchpruner_tpu/parallel/ring.py``.

The sequence dim is sharded over the ``seq`` axis's group: each rank
keeps its local query block while the KV shards rotate around the ring
(:func:`~torchpruner_tpu_torch.parallel.collectives.ppermute`, one hop a
step, K and V in one exchange), and a running online-softmax state
``(max, sumexp, acc)`` merges each arriving chunk (Liu et al., 2023).
Each chunk is streamed in KV blocks of :data:`_BLOCK_K` whose forward is
recomputed in the backward, so the live score memory of a rank is
``(B, H, S_local, block)``.

The core is plain torch with autograd, as the JAX package's is an XLA
einsum differentiated by ``jax.grad`` (it reaches no Pallas kernel): the
scores and the probabilities-times-values products run in f32 on
operands cast to f32.  The JAX program overlaps a chunk's compute with
the next chunk's transfer; this eager port issues them in turn.

``ring_attention`` takes global ``(B, S, H, Dh)`` tensors (the same on
every rank of the group) and returns the global output;
``ring_attention_local`` is the per-shard computation for callers that
already hold their shard (the attention rule under ``SPTrainer``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from torchpruner_tpu_torch.parallel import collectives as C

_NEG_INF = -1e30

#: KV sub-block length for streaming inside one ring chunk
_BLOCK_K = 512


def _block_stats(q, k, v, q_off: int, k_off: int, causal: bool):
    """Online-softmax statistics of local queries against one KV block.
    ``q``: (B, Sq, H, Dh); ``k``/``v``: (B, Sk, H, Dh); offsets are
    global sequence positions (for causal masking across the ring).
    Returns ``m``, ``l``: (B, H, Sq) and ``acc``: (B, H, Sq, Dh), f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(Sq, device=q.device)[:, None]
        kpos = k_off + torch.arange(Sk, device=q.device)[None, :]
        keep = qpos >= kpos
        s = torch.where(keep[None, None], s, _NEG_INF)
        m = s.amax(dim=-1)
        # the mask again, multiplicatively: a fully masked row has l = 0
        # (not Sk), m = _NEG_INF, and merges away to nothing
        p = torch.exp(s - m[..., None]) * keep[None, None]
    else:
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhst,bthk->bhsk", p, v.float())
    return m, l, acc


def _merge_stats(m, l, acc, cm, cl, cacc):
    """Numerically stable merge of two online-softmax partial states."""
    m_new = torch.maximum(m, cm)
    a_old = torch.exp(m - m_new)
    a_new = torch.exp(cm - m_new)
    return (m_new, l * a_old + cl * a_new,
            acc * a_old[..., None] + cacc * a_new[..., None])


def _chunk_stats(q, k, v, q_off: int, k_off: int, causal: bool,
                 block_k: int = _BLOCK_K):
    """Statistics of local queries against one ring chunk, streamed in
    ``block_k``-long KV blocks whose forward the backward recomputes; a
    length the block does not divide halves the block until it does (to
    64), else the chunk is one block."""
    Sk = k.shape[1]
    while block_k > 64 and Sk % block_k:
        block_k //= 2
    if Sk <= block_k or Sk % block_k:
        return _block_stats(q, k, v, q_off, k_off, causal)
    B, Sq, H, Dh = q.shape
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=q.device)
    for j in range(Sk // block_k):
        sl = slice(j * block_k, (j + 1) * block_k)
        cm, cl, cacc = checkpoint(
            _block_stats, q, k[:, sl], v[:, sl], q_off,
            k_off + j * block_k, causal, use_reentrant=False)
        m, l, acc = _merge_stats(m, l, acc, cm, cl, cacc)
    return m, l, acc


def ring_attention_local(q, k, v, *, axis, causal: bool = False):
    """Per-shard ring attention over the process group ``axis`` (the
    JAX package names a mesh axis under ``shard_map``; here it is that
    axis's group).  ``q``/``k``/``v``: this rank's (B, S_local, H, Dh)
    shards (KV already expanded to H heads), shard ``r`` of the sequence
    on group rank ``r``.  Returns the local output shard."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"ring attention is self-attention: K/V shard length "
            f"{k.shape[1]} must equal Q's {q.shape[1]}")
    n = C.group_size(axis)
    idx = 0 if n == 1 else dist.get_rank(axis)
    B, S_loc, H, Dh = q.shape
    m = torch.full((B, H, S_loc), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S_loc, Dh), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (idx - t) % n  # whose KV chunk this rank holds at step t
        cm, cl, cacc = _chunk_stats(q, k_cur, v_cur, idx * S_loc,
                                    src * S_loc, causal)
        m, l, acc = _merge_stats(m, l, acc, cm, cl, cacc)
        if t < n - 1:  # n - 1 hops: the last chunk needs no rotation
            k_cur, v_cur = C.ppermute([k_cur, v_cur], axis)
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, S_loc, H, Dh)


def _check_self_attention(q, k, v, n: int, axis_name: str):
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by mesh "
                         f"axis {axis_name}={n}")
    if k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]:
        raise ValueError(
            f"ring attention is self-attention: K/V length "
            f"{k.shape[1]}/{v.shape[1]} must equal Q's {q.shape[1]}")


def ring_attention(q, k, v, mesh, *, axis: str = "seq",
                   causal: bool = False):
    """Context-parallel attention on global ``(B, S, H, Dh)`` tensors,
    replicated over the group of mesh axis ``axis``: each rank takes its
    sequence shard, runs the ring, and the output shards are gathered
    back (every rank returns the global output; gradients flow to the
    global inputs on every rank)."""
    from torchpruner_tpu_torch.parallel.mesh import mesh_axes

    n = mesh_axes(mesh)[axis]
    _check_self_attention(q, k, v, n, axis)
    group = mesh.get_group(axis)
    local = ring_attention_local(*(C.scatter_dim(t, 1, group)
                                   for t in (q, k, v)),
                                 axis=group, causal=causal)
    return C.gather_dim(local, 1, group)
