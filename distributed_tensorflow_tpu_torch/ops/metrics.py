"""Metrics, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/metrics.py``: the same
registry.  ``bitwise_accuracy`` is ``example.py``'s: the mean of
``round(preds) == round(labels)`` over the 32 output bits, rounding half
to even on both sides (``torch.round``, as ``jnp.round``).  Every metric
returns a 0-d f32 tensor on the inputs' device; nothing reads it back.
"""
from __future__ import annotations

import torch

from .losses import mean_absolute_error  # one definition serves both tables

__all__ = ["bitwise_accuracy", "accuracy", "top_k_accuracy",
           "binary_accuracy", "mean_absolute_error", "precision", "recall",
           "f1_score", "get"]


def bitwise_accuracy(preds, targets):
    match = torch.round(preds.float()) == torch.round(targets.float())
    return torch.mean(match.float())


def accuracy(logits, labels):
    """Argmax accuracy; labels may be int class ids or one-hot (the first
    maximum wins ties, as in ``jnp.argmax``)."""
    if labels.dim() == logits.dim():
        labels = torch.argmax(labels, dim=-1)
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def top_k_accuracy(k: int):
    def metric(logits, labels):
        if labels.dim() == logits.dim():
            labels = torch.argmax(labels, dim=-1)
        # the last k of a stable ascending sort, as jnp.argsort gives
        top = torch.argsort(logits, dim=-1, stable=True)[..., -k:]
        hit = torch.any(top == labels[..., None], dim=-1)
        return torch.mean(hit.float())
    metric.__name__ = f"top_{k}_accuracy"
    return metric


def binary_accuracy(preds, targets, threshold: float = 0.5):
    """Keras binary_accuracy: thresholded sigmoid outputs vs 0/1 targets."""
    hits = (preds.float() > threshold) == (targets.float() > threshold)
    return torch.mean(hits.float())


def _binary_counts(preds, targets, threshold: float):
    p = (preds.float() > threshold).float()
    t = (targets.float() > threshold).float()
    return torch.sum(p * t), torch.sum(p), torch.sum(t)


def precision(preds, targets, threshold: float = 0.5, epsilon: float = 1e-7):
    """Batch precision over thresholded binary outputs."""
    tp, pred_pos, _ = _binary_counts(preds, targets, threshold)
    return tp / torch.clamp(pred_pos, min=epsilon)


def recall(preds, targets, threshold: float = 0.5, epsilon: float = 1e-7):
    tp, _, actual_pos = _binary_counts(preds, targets, threshold)
    return tp / torch.clamp(actual_pos, min=epsilon)


def f1_score(preds, targets, threshold: float = 0.5, epsilon: float = 1e-7):
    tp, pred_pos, actual_pos = _binary_counts(preds, targets, threshold)
    return 2.0 * tp / torch.clamp(pred_pos + actual_pos, min=epsilon)


_REGISTRY = {
    "accuracy": accuracy,
    "categorical_accuracy": accuracy,
    "sparse_categorical_accuracy": accuracy,
    "binary_accuracy": binary_accuracy,
    "bitwise_accuracy": bitwise_accuracy,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "precision": precision,
    "recall": recall,
    "f1": f1_score,
    "f1_score": f1_score,
    "top_5_accuracy": top_k_accuracy(5),
}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown metric {name_or_fn!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
