"""Nested-dict trees of tensors (the port's params, optimizer states):
the few ``jax.tree_util`` operations the port needs."""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the dict/list/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def cast_floats(tree, dtype: torch.dtype):
    """Floating-point tensor leaves cast to ``dtype``; the rest as is."""
    return tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t, tree)


def device_of(tree) -> torch.device:
    """The device of the first tensor leaf of ``tree``."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the tree holds no tensor")
