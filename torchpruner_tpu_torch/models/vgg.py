"""VGG16-bn for 32x32 inputs — counterpart of
``torchpruner_tpu/models/vgg.py``: 13 Conv-BatchNorm-ReLU layers with 5
max-pools (1x1x512 at the flatten on a 32x32 input), then a classifier
512-512-10 with dropout; 15 prunable layers before the output head."""

from __future__ import annotations

from typing import Tuple, Union

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel

#: VGG16's conv widths, "M" a 2x2 max-pool
VGG16_CFG: Tuple[Union[int, str], ...] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
    512, 512, 512, "M", 512, 512, 512, "M")


def vgg16_bn(n_classes: int = 10,
             input_shape: Tuple[int, int, int] = (32, 32, 3),
             classifier_width: int = 512, dropout: float = 0.5,
             width_multiplier: float = 1.0) -> SegmentedModel:
    """``width_multiplier`` scales every conv width (rounded down; needs
    ``64 * width_multiplier >= 1``)."""
    if width_multiplier <= 0 or 64 * width_multiplier < 1:
        raise ValueError(
            f"width_multiplier {width_multiplier} would produce empty conv "
            "layers (need 64 * width_multiplier >= 1)")
    layers = []
    conv_i = pool_i = 0
    for v in VGG16_CFG:
        if v == "M":
            pool_i += 1
            layers.append(L.Pool(f"pool{pool_i}", "max", (2, 2)))
        else:
            conv_i += 1
            layers += [
                L.Conv(f"conv{conv_i}", int(int(v) * width_multiplier),
                       kernel_size=(3, 3)),
                L.BatchNorm(f"bn{conv_i}"),
                L.Activation(f"relu{conv_i}", "relu")]
    layers += [
        L.Flatten("flatten"),
        L.Dense("fc1", classifier_width),
        L.Activation("relu_fc1", "relu"),
        L.Dropout("drop1", dropout),
        L.Dense("fc2", classifier_width),
        L.Activation("relu_fc2", "relu"),
        L.Dropout("drop2", dropout),
        L.Dense("out", n_classes)]
    return SegmentedModel(tuple(layers), input_shape)


def vgg16_bn_tiny() -> SegmentedModel:
    """x0.125 widths (8 ... 64) and a 64-wide classifier: the VGG recipe
    at smoke scale (``vgg16_digits32_layerwise --smoke``)."""
    return vgg16_bn(width_multiplier=0.125, classifier_width=64)
