"""The Fashion-MNIST convnet family — counterpart of
``torchpruner_tpu/models/convnet.py``: 2 x [Conv-BN-ReLU-MaxPool] ->
Flatten -> Dense-BN-ReLU -> Dense.  ``linearize=True`` swaps the ReLUs
for identity and max-pooling for average pooling."""

from __future__ import annotations

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel


def _convnet(widths, kernel, hidden, input_shape, act="relu", pool="max"
             ) -> SegmentedModel:
    layers = []
    for i, w in enumerate(widths, start=1):
        layers += [L.Conv(f"conv{i}", w, kernel_size=(kernel, kernel),
                          padding="SAME"),
                   L.BatchNorm(f"bn{i}"),
                   L.Activation(f"act{i}", act),
                   L.Pool(f"pool{i}", pool, (2, 2))]
    n = len(widths) + 1
    layers += [L.Flatten("flatten"),
               L.Dense("fc1", hidden),
               L.BatchNorm(f"bn{n}"),
               L.Activation(f"act{n}", act),
               L.Dense("out", 10)]
    return SegmentedModel(tuple(layers), input_shape)


def digits_convnet() -> SegmentedModel:
    """The family at sklearn-digits scale (8x8x1): convs 16 and 32 wide
    (3x3), fc1 128."""
    return _convnet((16, 32), 3, 128, (8, 8, 1))


def fmnist_convnet(linearize: bool = False) -> SegmentedModel:
    """28x28x1: convs 32 and 64 wide (5x5), fc1 4096."""
    return _convnet((32, 64), 5, 4096, (28, 28, 1),
                    act="identity" if linearize else "relu",
                    pool="avg" if linearize else "max")
