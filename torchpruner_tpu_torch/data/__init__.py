"""Datasets of the port (host numpy, copied from the JAX package)."""

from torchpruner_tpu_torch.data.datasets import (  # noqa: F401
    Dataset,
    load_dataset,
)
