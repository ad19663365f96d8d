"""BERT family — counterpart of ``torchpruner_tpu/models/bert.py``, the
"BERT-base Linear-layer pruning on GLUE (Sensitivity criterion)" config.

Post-LN encoder (Devlin et al., 2019): token + learned-position embeddings,
``depth`` blocks of ``Residual[MHA] -> LN -> Residual[fc1, gelu, fc2] -> LN``,
CLS pooler (tanh), classification head.  Single-segment inputs (token-type
embeddings add nothing to pruning behavior and are omitted; the CLS/SEP
convention lives in the tokenizer, so pooling is first-token select).

The Linear-layer pruning target is each block's ``fc1`` (hidden 3072),
pruned with its ``fc2`` consumer inside the residual body — the same group
shape the reference handles for Linear->Linear chains with the NaN trick
(reference tests/test_pruner.py:72-81), here derived statically.
"""

from __future__ import annotations

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel


def bert(
    *,
    vocab_size: int = 30522,
    max_len: int = 512,
    dim: int = 768,
    depth: int = 12,
    num_heads: int = 12,
    mlp_dim: int = 3072,
    n_classes: int = 2,
    dropout: float = 0.1,
    seq_len: int = 128,
) -> SegmentedModel:
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
    layers: list = [
        L.Embedding("tok_emb", vocab_size, dim),
        L.PosEmbed("pos", max_len=max_len),
        L.LayerNorm("emb_ln"),
    ]
    if dropout:
        layers.append(L.Dropout("emb_drop", dropout))
    for i in range(1, depth + 1):
        attn_body = (
            L.MultiHeadAttention(
                "attn", num_heads=num_heads, head_dim=dim // num_heads,
                use_bias=True,
            ),
        ) + ((L.Dropout("drop", dropout),) if dropout else ())
        mlp_body = (
            L.Dense("fc1", mlp_dim),
            L.Activation("gelu", "gelu"),
            L.Dense("fc2", dim),
        ) + ((L.Dropout("drop", dropout),) if dropout else ())
        layers += [
            L.Residual(f"block{i}_attn", attn_body),
            L.LayerNorm(f"block{i}_attn_ln"),
            L.Residual(f"block{i}_mlp", mlp_body),
            L.LayerNorm(f"block{i}_mlp_ln"),
        ]
    layers += [
        L.GlobalPool("cls_pool", "cls"),
        L.Dense("pooler", dim),
        L.Activation("pooler_tanh", "tanh"),
        L.Dense("head", n_classes),
    ]
    return SegmentedModel(tuple(layers), (seq_len,), input_dtype="int32")


def bert_base(n_classes: int = 2, seq_len: int = 128) -> SegmentedModel:
    """BERT-base: 12 blocks, dim 768, 12 heads, FFN 3072 — the GLUE
    Sensitivity-pruning target."""
    return bert(n_classes=n_classes, seq_len=seq_len)


def bert_tiny(
    n_classes: int = 2,
    seq_len: int = 16,
    vocab_size: int = 128,
    dim: int = 32,
    depth: int = 2,
    num_heads: int = 4,
    mlp_dim: int = 64,
) -> SegmentedModel:
    """Miniature BERT with the full block structure — tests / CPU smoke."""
    return bert(
        vocab_size=vocab_size, max_len=seq_len, dim=dim, depth=depth,
        num_heads=num_heads, mlp_dim=mlp_dim, n_classes=n_classes,
        dropout=0.0, seq_len=seq_len,
    )
