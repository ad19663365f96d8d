"""Ulysses-style sequence parallelism — all-to-all head scatter;
counterpart of ``torchpruner_tpu/parallel/ulysses.py`` (after
DeepSpeed-Ulysses, Jacobs et al., 2023).

Ring attention (``parallel/ring.py``) and Ulysses start from the same
layout, the sequence dim sharded over the ``seq`` axis's group, and
exchange differently:

- **Ring**: KV shards rotate (n-1 hops), queries stay put; the head
  count does not constrain the group.
- **Ulysses** (this module): one all-to-all re-shards *seq -> heads*, so
  each rank holds the FULL sequence for ``H/n`` heads and runs the
  single-device attention, the port's flash kernels
  (``ops/flash_attention.py``: the CUDA kernels on the card), then a
  second all-to-all re-shards *heads -> seq*.  It requires
  ``H % n == 0``.

``ulysses_attention`` takes global tensors (the same on every rank of
the group) and returns the global output; ``ulysses_attention_local`` is
the per-shard function.  Gradients flow through both all-to-alls and
the flash kernels' backward.
"""

from __future__ import annotations

from torchpruner_tpu_torch.ops.flash_attention import flash_attention
from torchpruner_tpu_torch.parallel import collectives as C


def ulysses_attention_local(q, k, v, *, axis, causal: bool = False):
    """Per-shard Ulysses attention over the process group ``axis``.
    ``q``/``k``/``v``: this rank's (B, S_local, H, Dh) shards (KV
    already expanded to H heads).  Returns the local output shard.  The
    port's flash kernels run the full sequence on each rank's head
    subset."""
    n = C.group_size(axis)
    H = q.shape[2]
    if H % n:
        raise ValueError(
            f"Ulysses needs heads % seq-axis == 0, got H={H}, seq={n}; "
            f"use ring attention for this head count")
    # seq-sharded -> head-sharded: (B, S/n, H, Dh) -> (B, S, H/n, Dh)
    qh, kh, vh = (C.all_to_all(t, axis, split_dim=2, concat_dim=1)
                  for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal)
    # head-sharded -> seq-sharded: the inverse exchange
    return C.all_to_all(out, axis, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, mesh, *, axis: str = "seq",
                      causal: bool = False):
    """Sequence-parallel attention on global ``(B, S, H, Dh)`` tensors
    via the head-scatter all-to-alls, the full-sequence flash kernels on
    each rank's head subset."""
    from torchpruner_tpu_torch.parallel.mesh import mesh_axes

    n = mesh_axes(mesh)[axis]
    if q.shape[1] % n:
        raise ValueError(
            f"sequence {q.shape[1]} not divisible by mesh axis {axis}={n}")
    if k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]:
        raise ValueError(
            f"self-attention: K/V length {k.shape[1]}/{v.shape[1]} must "
            f"equal Q's {q.shape[1]}")
    if q.shape[2] % n:
        raise ValueError(
            f"Ulysses needs heads % mesh axis == 0, got H={q.shape[2]}, "
            f"{axis}={n}; use ring_attention instead")
    group = mesh.get_group(axis)
    local = ulysses_attention_local(
        *(C.scatter_dim(t, 1, group) for t in (q, k, v)), axis=group,
        causal=causal)
    return C.gather_dim(local, 1, group)


def choose_sp_strategy(n_heads: int, mesh, *, axis: str = "seq") -> str:
    """``"ulysses"`` when the (possibly pruned) head count divides the
    sequence axis (two all-to-alls beat n-1 ring hops), else
    ``"ring"``, which has no head-count constraint."""
    from torchpruner_tpu_torch.parallel.mesh import mesh_axes

    return "ulysses" if n_heads % mesh_axes(mesh)[axis] == 0 else "ring"


def sequence_parallel_attention(q, k, v, mesh, *, axis: str = "seq",
                                causal: bool = False,
                                strategy: str = "auto"):
    """Dispatch between the two strategies on global tensors.
    ``strategy``: ``"ring"`` | ``"ulysses"`` | ``"auto"`` (Ulysses when
    the head count allows it, ring otherwise)."""
    from torchpruner_tpu_torch.parallel.ring import ring_attention

    if strategy == "auto":
        strategy = choose_sp_strategy(q.shape[2], mesh, axis=axis)
    if strategy == "ulysses":
        return ulysses_attention(q, k, v, mesh, axis=axis, causal=causal)
    if strategy == "ring":
        return ring_attention(q, k, v, mesh, axis=axis, causal=causal)
    raise ValueError(f"unknown SP strategy {strategy!r}")
