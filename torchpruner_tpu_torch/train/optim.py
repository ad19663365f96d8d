"""Functional optimizers — the counterpart of the optax pieces the JAX
package's ``experiments/prune_retrain.make_optimizer`` uses: ``sgd``
(with optional momentum), ``adam``, ``adamw``, ``add_decayed_weights``,
``chain`` and the four learning-rate schedules, plus ``scale``, the
resilient runner's LR-backoff stage.

Each is a :class:`GradientTransformation` with optax's contract: ``init
(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, then :func:`apply_updates`.  States are nested dicts whose
moment entries mirror the params tree (``{"mu": params-like, "nu":
params-like, "count": ...}``), so pruning slices them in step with the
params (``core/plan.py``).  The arithmetic follows optax's, operation for
operation, in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import torch

from torchpruner_tpu_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]
LR = Union[float, Schedule]


@dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def _count(params) -> torch.Tensor:
    dev = next((t.device for t in tree_leaves(params)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    return torch.zeros((), dtype=torch.int32, device=dev)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf (updates cast to the param dtype)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply ``txs`` in order; the state is the list of their states."""

    def init(params):
        return [tx.init(params) for tx in txs]

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, new

    return GradientTransformation(init, update)


def trace(decay: float) -> GradientTransformation:
    """Momentum: ``trace = g + decay * trace``; the update is the trace."""

    def init(params):
        return {"trace": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        new = tree_map(lambda g, t: g + decay * t, updates, state["trace"])
        return new, {"trace": new}

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: LR) -> GradientTransformation:
    """``-lr * g``; a schedule is read at the step count (0 first)."""
    if not callable(lr):
        step = -float(lr)

        def init(params):
            return {}

        def update(updates, state, params=None):
            return tree_map(lambda g: step * g, updates), state

        return GradientTransformation(init, update)

    def init_s(params):
        return {"count": _count(params)}

    def update_s(updates, state, params=None):
        step = -float(lr(int(state["count"])))
        return (tree_map(lambda g: torch.tensor(step, dtype=g.dtype,
                                                device=g.device) * g,
                         updates),
                {"count": state["count"] + 1})

    return GradientTransformation(init_s, update_s)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """Adam's moment estimates with bias correction (optax
    ``scale_by_adam``, ``eps_root=0``)."""

    def init(params):
        return {"count": _count(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates,
                      state["mu"])
        nu = tree_map(lambda g, t: (1 - b2) * (g ** 2) + b2 * t, updates,
                      state["nu"])
        count = state["count"] + 1
        cf = count.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=cf.device) ** cf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=cf.device) ** cf
        new = tree_map(lambda m, v: (m / bc1.to(m.dtype))
                       / (torch.sqrt(v / bc2.to(v.dtype)) + eps), mu, nu)
        return new, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """``g + weight_decay * params`` (decoupled decay)."""

    def init(params):
        return {}

    def update(updates, state, params=None):
        return (tree_map(lambda g, p: g + weight_decay * p, updates, params),
                state)

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    """``factor * g`` with an empty state (optax ``scale``).  The
    resilient runner chains it after the config's optimizer as the LR
    backoff: every ``factor`` gives the same state structure, so a
    checkpoint saved before a backoff restores after it."""
    factor = float(factor)

    def init(params):
        return {}

    def update(updates, state, params=None):
        return tree_map(lambda g: factor * g, updates), state

    return GradientTransformation(init, update)


def sgd(lr: LR, momentum=None) -> GradientTransformation:
    """optax ``sgd``: momentum trace (when ``momentum`` is not None),
    then ``-lr``."""
    if momentum is None:
        return chain(scale_by_learning_rate(lr))
    return chain(trace(momentum), scale_by_learning_rate(lr))


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


# ---------------------------------------------------------------- schedules


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Dict[int, float]
                                ) -> Schedule:
    """``init_value`` times every scale whose boundary the count has
    reached."""

    def schedule(count: int) -> float:
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = v * scale
        return v

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value``, then cosine
    decay to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return cosine(count - warmup_steps)

    return schedule
