"""Vision Transformer family — counterpart of
``torchpruner_tpu/models/vit.py``, the "ViT-B/16 attention-head + MLP
pruning" configuration: self-contained attention-head groups and in-block
MLP hidden-channel groups (fc1 pruned with fc2 as consumer), both derived
by the static pruning graph inside ``Residual`` bodies.

Pre-LN encoder (Dosovitskiy et al., 2021): patchify conv, CLS token +
learned positions, ``depth`` blocks of ``[LN, MHA] + [LN, fc1, gelu,
fc2]`` residuals, final LN, CLS-token head.  Attention runs through
``attention_core(impl="auto")``: the flash kernels on the card.
"""

from __future__ import annotations

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel


def vit(*, image_size: int = 224, patch_size: int = 16, dim: int = 768,
        depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
        n_classes: int = 1000, dropout: float = 0.0, pool: str = "cls"
        ) -> SegmentedModel:
    if image_size % patch_size:
        raise ValueError(f"image_size {image_size} not divisible by "
                         f"patch_size {patch_size}")
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
    n_patches = (image_size // patch_size) ** 2
    seq = n_patches + (1 if pool == "cls" else 0)
    layers: list = [
        L.Conv("patchify", dim, (patch_size, patch_size),
               (patch_size, patch_size), "VALID"),
        L.Reshape("to_tokens", (n_patches, dim)),
    ]
    if pool == "cls":
        layers.append(L.ClsToken("cls"))
    layers.append(L.PosEmbed("pos", max_len=seq))
    if dropout:
        layers.append(L.Dropout("embed_drop", dropout))
    for i in range(1, depth + 1):
        attn_body = (
            L.LayerNorm("ln"),
            L.MultiHeadAttention("attn", num_heads=num_heads,
                                 head_dim=dim // num_heads, use_bias=True),
        )
        mlp_body = (
            L.LayerNorm("ln"),
            L.Dense("fc1", mlp_dim),
            L.Activation("gelu", "gelu"),
        ) + ((L.Dropout("drop", dropout),) if dropout else ()) + (
            L.Dense("fc2", dim),
        )
        layers.append(L.Residual(f"block{i}_attn", attn_body))
        layers.append(L.Residual(f"block{i}_mlp", mlp_body))
    layers += [
        L.LayerNorm("final_ln"),
        L.GlobalPool("pool", "cls" if pool == "cls" else "seq_mean"),
        L.Dense("head", n_classes),
    ]
    return SegmentedModel(tuple(layers), (image_size, image_size, 3))


def vit_b16(n_classes: int = 1000, image_size: int = 224) -> SegmentedModel:
    """ViT-B/16: 12 blocks, dim 768, 12 heads, MLP 3072 — the head + MLP
    pruning target (Shapley, sv_samples 5)."""
    return vit(image_size=image_size, patch_size=16, dim=768, depth=12,
               num_heads=12, mlp_dim=3072, n_classes=n_classes)


def vit_tiny(n_classes: int = 10, image_size: int = 16, patch_size: int = 4,
             dim: int = 32, depth: int = 2, num_heads: int = 4,
             mlp_dim: int = 64) -> SegmentedModel:
    """Miniature ViT with the full block structure — tests / CPU smoke."""
    return vit(image_size=image_size, patch_size=patch_size, dim=dim,
               depth=depth, num_heads=num_heads, mlp_dim=mlp_dim,
               n_classes=n_classes)
