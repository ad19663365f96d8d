"""Dtype names shared by the port's entry points and param trees.

The JAX package spells dtypes as ``jnp`` objects; the port takes the same
names as strings at its boundaries (CLI flags, configs) and maps them to
``torch.dtype`` here."""

from __future__ import annotations

from typing import Any

import torch

#: the names the CLI and configs use, mapped to torch dtypes
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
}


def to_dtype(d: Any) -> torch.dtype:
    """A ``torch.dtype`` from a name (``"bfloat16"``) or a dtype."""
    if isinstance(d, torch.dtype):
        return d
    if d not in DTYPES:
        raise ValueError(f"unknown dtype {d!r}; known: {sorted(DTYPES)}")
    return DTYPES[d]
