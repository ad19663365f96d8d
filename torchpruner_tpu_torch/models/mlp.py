"""Fully-connected model zoo — counterpart of
``torchpruner_tpu/models/mlp.py``: the 784→2024→2024→10 LeakyReLU MNIST
net of "Pruning Untrained Networks" and its CIFAR-10 and digits
variants."""

from __future__ import annotations

from typing import Sequence

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel


def fc_net(input_size: int, hidden: Sequence[int] = (2024, 2024),
           n_classes: int = 10, activation: str = "leaky_relu"
           ) -> SegmentedModel:
    layers = []
    for i, h in enumerate(hidden):
        layers.append(L.Dense(f"fc{i + 1}", h))
        layers.append(L.Activation(f"act{i + 1}", activation))
    layers.append(L.Dense("out", n_classes))
    return SegmentedModel(tuple(layers), (input_size,))


def mnist_fc() -> SegmentedModel:
    """784-2024-2024-10 LeakyReLU on the flattened 28×28 image."""
    return fc_net(784)


def cifar10_fc() -> SegmentedModel:
    """The same architecture on flattened 32×32×3 CIFAR-10 input."""
    return fc_net(32 * 32 * 3)


def digits_fc() -> SegmentedModel:
    """The MNIST-FC architecture on the 8×8 sklearn digits:
    64-512-512-10 LeakyReLU."""
    return fc_net(64, hidden=(512, 512))


def digits_fc_tiny() -> SegmentedModel:
    """64-64-64-10: the MLP recipe at smoke scale
    (``mnist_mlp_shapley --smoke``)."""
    return fc_net(64, hidden=(64, 64))
