"""Per-example loss functions — counterpart of
``torchpruner_tpu/utils/losses.py``.

Every loss maps ``(preds, targets) -> (batch,)``; the mean over the batch
gives the training loss.  Loss math runs in f32 whatever the activation
dtype (bf16 logits would otherwise round the softmax and the small
deltas attribution relies on).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.is_floating_point() else x


def mse_loss(preds, targets):
    """Mean-squared error, averaged over non-batch dims -> (batch,)."""
    d = (_f32(preds) - _f32(targets)) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1)


def cross_entropy_loss(logits, labels):
    """Softmax cross-entropy with integer labels -> (batch,)."""
    logp = torch.log_softmax(_f32(logits), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def nll_loss(log_probs, labels):
    """Negative log-likelihood on log-probabilities -> (batch,)."""
    return -_f32(log_probs).gather(-1, labels.long()[:, None])[:, 0]


def lm_cross_entropy_loss(logits, tokens):
    """Next-token cross-entropy for causal LMs -> (batch,): position
    ``t`` predicts token ``t+1``; the per-example value is the mean over
    the S-1 predicted positions."""
    logp = torch.log_softmax(_f32(logits[:, :-1]), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return nll.mean(dim=-1)


def accuracy(logits, labels):
    """Fraction of argmax-correct predictions (scalar)."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def correct_per_example(out, y) -> Tuple[torch.Tensor, int]:
    """``((batch,) correct counts, predictions per example)``: argmax
    over classes for classification (one prediction an example),
    next-token aligned (S-1 predictions an example) for LMs."""
    if out.ndim == y.ndim + 1 and y.ndim >= 2:
        pred = out[:, :-1].argmax(dim=-1)
        return (pred == y[:, 1:]).sum(dim=-1), pred.shape[-1]
    return (out.argmax(dim=-1) == y).long(), 1


def prediction_counts(out, y) -> Tuple[torch.Tensor, int]:
    """``(n_correct, n_predictions)`` over the batch."""
    correct, per = correct_per_example(out, y)
    return correct.sum(), per * y.shape[0]
