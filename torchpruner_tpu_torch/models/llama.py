"""Llama-family decoder — counterpart of ``torchpruner_tpu/models/llama.py``.

Pre-norm decoder: token embedding, ``depth`` blocks of
``Residual[RMSNorm, causal GQA attention with RoPE]`` +
``Residual[RMSNorm, SwiGLU, down-proj]`` (``llama_moe``:
``Residual[RMSNorm, MoE]``), final RMSNorm, LM head.  The
same specs, names and defaults as the JAX package, so a param tree
converts one to one (``torchpruner_tpu_torch/convert.py``).
"""

from __future__ import annotations

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel


def llama(
    *,
    vocab_size: int = 128256,
    dim: int = 4096,
    depth: int = 32,
    num_heads: int = 32,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    ffn_dim: int = 14336,
    rope_theta: float = 500000.0,
    seq_len: int = 2048,
) -> SegmentedModel:
    layers: list = [L.Embedding("tok_emb", vocab_size, dim)]
    for i in range(1, depth + 1):
        attn_body = (
            L.RMSNorm("norm"),
            L.MultiHeadAttention(
                "attn", num_heads=num_heads, head_dim=head_dim,
                num_kv_heads=num_kv_heads, out_features=dim,
                causal=True, rope=True, rope_theta=rope_theta,
            ),
        )
        ffn_body = (
            L.RMSNorm("norm"),
            L.GatedDense("gate", ffn_dim, fn="silu"),
            L.Dense("down", dim, use_bias=False),
        )
        layers += [
            L.Residual(f"block{i}_attn", attn_body),
            L.Residual(f"block{i}_ffn", ffn_body),
        ]
    layers += [
        L.RMSNorm("final_norm"),
        L.Dense("lm_head", vocab_size, use_bias=False),
    ]
    return SegmentedModel(tuple(layers), (seq_len,), input_dtype="int32")


def llama_moe(
    *,
    vocab_size: int = 32000,
    dim: int = 4096,
    depth: int = 32,
    num_heads: int = 32,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    ffn_dim: int = 14336,
    n_experts: int = 8,
    top_k: int = 2,
    rope_theta: float = 1e6,
    seq_len: int = 2048,
    dispatch: str = "dense",
    capacity_factor: float = 1.25,
) -> SegmentedModel:
    """Mixtral-style sparse-MoE decoder (the defaults are Mixtral-8x7B:
    46.7 B parameters): each block's FFN is a top-k-routed mixture of
    SwiGLU experts, and the expert is the prunable unit."""
    layers: list = [L.Embedding("tok_emb", vocab_size, dim)]
    for i in range(1, depth + 1):
        layers += [
            L.Residual(f"block{i}_attn", (
                L.RMSNorm("norm"),
                L.MultiHeadAttention(
                    "attn", num_heads=num_heads, head_dim=head_dim,
                    num_kv_heads=num_kv_heads, out_features=dim,
                    causal=True, rope=True, rope_theta=rope_theta),
            )),
            L.Residual(f"block{i}_moe", (
                L.RMSNorm("norm"),
                L.MoE("experts", n_experts, ffn_dim, top_k=top_k,
                      dispatch=dispatch, capacity_factor=capacity_factor),
            )),
        ]
    layers += [
        L.RMSNorm("final_norm"),
        L.Dense("lm_head", vocab_size, use_bias=False),
    ]
    return SegmentedModel(tuple(layers), (seq_len,), input_dtype="int32")


def llama_moe_tiny(
    *,
    vocab_size: int = 256,
    dim: int = 32,
    depth: int = 2,
    num_heads: int = 4,
    num_kv_heads: int = 2,
    ffn_dim: int = 32,
    n_experts: int = 4,
    top_k: int = 2,
    seq_len: int = 16,
    dispatch: str = "dense",
    capacity_factor: float = 1.25,
) -> SegmentedModel:
    """Miniature MoE decoder — tests and CPU smoke runs."""
    return llama_moe(
        vocab_size=vocab_size, dim=dim, depth=depth, num_heads=num_heads,
        num_kv_heads=num_kv_heads, head_dim=dim // num_heads,
        ffn_dim=ffn_dim, n_experts=n_experts, top_k=top_k,
        rope_theta=10000.0, seq_len=seq_len, dispatch=dispatch,
        capacity_factor=capacity_factor)


def llama3_8b(seq_len: int = 2048, depth: int = 32) -> SegmentedModel:
    """Llama-3-8B: 32 blocks, dim 4096, 32 query / 8 KV heads, FFN 14336,
    vocab 128256, RoPE theta 5e5.  ``depth`` cuts the block count only
    (the widths stay full)."""
    return llama(seq_len=seq_len, depth=depth)


def mfu_llama(seq_len: int = 1024) -> SegmentedModel:
    """~200M-param Llama (dim 1024 x depth 8, 32k vocab)."""
    return llama(
        vocab_size=32000, dim=1024, depth=8, num_heads=8, num_kv_heads=8,
        head_dim=128, ffn_dim=4096, seq_len=seq_len,
    )


def llama_tiny(
    *,
    vocab_size: int = 256,
    dim: int = 32,
    depth: int = 2,
    num_heads: int = 4,
    num_kv_heads: int = 2,
    ffn_dim: int = 64,
    seq_len: int = 16,
) -> SegmentedModel:
    """Miniature Llama with the full block structure (GQA + RoPE +
    SwiGLU) — tests and CPU smoke runs."""
    return llama(
        vocab_size=vocab_size, dim=dim, depth=depth, num_heads=num_heads,
        num_kv_heads=num_kv_heads, head_dim=dim // num_heads,
        ffn_dim=ffn_dim, rope_theta=10000.0, seq_len=seq_len,
    )
