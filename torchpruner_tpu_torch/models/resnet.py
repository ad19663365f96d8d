"""The ResNet family — counterpart of ``torchpruner_tpu/models/resnet.py``:
basic (ResNet-18/20) and bottleneck (ResNet-50) blocks as ``Residual``
specs, a projection shortcut (1x1 conv + BatchNorm) where the stride or
width changes.  Convs feeding the residual sum are width-pinned; a stem
conv feeding a projection block cascades into both of its chains."""

from __future__ import annotations

from typing import Sequence, Tuple

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel


def _projection(width: int, in_width: int, stride: int):
    if stride == 1 and in_width == width:
        return ()
    return (L.Conv("proj", width, (1, 1), (stride, stride), use_bias=False),
            L.BatchNorm("proj_bn"))


def _basic_block(name: str, width: int, in_width: int, stride: int
                 ) -> L.Residual:
    """3x3 -> 3x3 (ResNet-18/20/34)."""
    body = (L.Conv("conv1", width, (3, 3), (stride, stride),
                   use_bias=False),
            L.BatchNorm("bn1"),
            L.Activation("relu1", "relu"),
            L.Conv("conv2", width, (3, 3), use_bias=False),
            L.BatchNorm("bn2"))
    return L.Residual(name, body, _projection(width, in_width, stride))


def _bottleneck(name: str, width: int, in_width: int, stride: int
                ) -> L.Residual:
    """1x1 -> 3x3 (stride) -> 1x1 at 4x width (ResNet-50/101/152)."""
    body = (L.Conv("conv1", width, (1, 1), use_bias=False),
            L.BatchNorm("bn1"),
            L.Activation("relu1", "relu"),
            L.Conv("conv2", width, (3, 3), (stride, stride),
                   use_bias=False),
            L.BatchNorm("bn2"),
            L.Activation("relu2", "relu"),
            L.Conv("conv3", 4 * width, (1, 1), use_bias=False),
            L.BatchNorm("bn3"))
    return L.Residual(name, body, _projection(4 * width, in_width, stride))


def _resnet(stage_blocks: Sequence[int], bottleneck: bool, n_classes: int,
            input_shape: Tuple[int, int, int], stem_width: int = 64,
            deep_stem_pool: bool = True, width_multiplier: float = 1.0
            ) -> SegmentedModel:
    def w(x: int) -> int:
        return max(1, int(x * width_multiplier))

    make = _bottleneck if bottleneck else _basic_block
    if deep_stem_pool:  # ImageNet stem: 7x7/2, then a 3x3/2 SAME max-pool
        layers = [L.Conv("stem", w(stem_width), (7, 7), (2, 2),
                         use_bias=False),
                  L.BatchNorm("stem_bn"),
                  L.Activation("stem_relu", "relu"),
                  L.Pool("stem_pool", "max", (3, 3), (2, 2), "SAME")]
    else:  # CIFAR stem: one 3x3, no pool
        layers = [L.Conv("stem", w(stem_width), (3, 3), use_bias=False),
                  L.BatchNorm("stem_bn"),
                  L.Activation("stem_relu", "relu")]
    in_width = w(stem_width)
    for si, n_blocks in enumerate(stage_blocks):
        width = w(stem_width * 2 ** si)
        for bi in range(n_blocks):
            name = f"stage{si + 1}_block{bi + 1}"
            stride = 2 if si > 0 and bi == 0 else 1
            layers += [make(name, width, in_width, stride),
                       L.Activation(f"{name}_relu", "relu")]
            in_width = width * (4 if bottleneck else 1)
    layers += [L.GlobalPool("avgpool", "avg"), L.Dense("out", n_classes)]
    return SegmentedModel(tuple(layers), input_shape)


def resnet50(n_classes: int = 1000,
             input_shape: Tuple[int, int, int] = (224, 224, 3),
             width_multiplier: float = 1.0) -> SegmentedModel:
    """ResNet-50: [3, 4, 6, 3] bottleneck stages."""
    return _resnet((3, 4, 6, 3), True, n_classes, input_shape,
                   width_multiplier=width_multiplier)


def resnet18(n_classes: int = 1000,
             input_shape: Tuple[int, int, int] = (224, 224, 3),
             width_multiplier: float = 1.0) -> SegmentedModel:
    """ResNet-18: [2, 2, 2, 2] basic-block stages."""
    return _resnet((2, 2, 2, 2), False, n_classes, input_shape,
                   width_multiplier=width_multiplier)


def resnet20_cifar(n_classes: int = 10,
                   input_shape: Tuple[int, int, int] = (32, 32, 3),
                   width_multiplier: float = 1.0) -> SegmentedModel:
    """CIFAR ResNet-20: a 3x3 stem 16 wide, three stages of three basic
    blocks at widths 16 / 32 / 64."""
    return _resnet((3, 3, 3), False, n_classes, input_shape,
                   stem_width=16, deep_stem_pool=False,
                   width_multiplier=width_multiplier)
