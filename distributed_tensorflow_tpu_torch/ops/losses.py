"""Losses, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/losses.py``: every loss
of its registry under the same names (``"mse"`` is ``example.py``'s),
``class_weighted`` and ``get``.  Losses reduce in f32 whatever the input
type and return a scalar mean.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mean_squared_error", "binary_cross_entropy",
           "softmax_cross_entropy", "softmax_cross_entropy_with_integer_labels",
           "smoothed_cross_entropy", "mean_absolute_error",
           "mean_absolute_percentage_error", "mean_squared_logarithmic_error",
           "hinge", "squared_hinge", "kullback_leibler_divergence", "poisson",
           "cosine_proximity", "huber", "class_weighted", "get"]


def mean_squared_error(preds, targets):
    return torch.mean(torch.square(preds.float() - targets.float()))


def binary_cross_entropy(preds, targets, epsilon: float = 1e-7):
    """BCE over sigmoid outputs (probabilities), like Keras
    binary_crossentropy."""
    p = torch.clamp(preds.float(), epsilon, 1.0 - epsilon)
    t = targets.float()
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


def softmax_cross_entropy(logits, onehot_targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(onehot_targets * logp, dim=-1))


def softmax_cross_entropy_with_integer_labels(
        logits: torch.Tensor, labels: torch.Tensor,
        where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy with integer labels; optional ``where`` weights or
    mask.  The 1e-9 floor only guards the all-masked case (0 / eps = 0);
    fractional weight sums below 1 divide exactly."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if where is None:
        return nll.mean()
    w = where.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-9)


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds.float() - targets.float()))


def mean_absolute_percentage_error(preds, targets, epsilon: float = 1e-7):
    """Keras MAPE: 100 * mean(|t - p| / max(|t|, eps))."""
    t = targets.float()
    diff = torch.abs(t - preds.float())
    return 100.0 * torch.mean(diff / torch.clamp(torch.abs(t), min=epsilon))


def mean_squared_logarithmic_error(preds, targets):
    """Keras MSLE over non-negative predictions/targets."""
    p = torch.log1p(torch.clamp(preds.float(), min=0.0))
    t = torch.log1p(torch.clamp(targets.float(), min=0.0))
    return torch.mean(torch.square(p - t))


def hinge(preds, targets):
    """Targets in {-1, +1} (Keras hinge convention)."""
    return torch.mean(torch.clamp(1.0 - targets.float() * preds.float(),
                                  min=0.0))


def squared_hinge(preds, targets):
    return torch.mean(torch.square(torch.clamp(
        1.0 - targets.float() * preds.float(), min=0.0)))


def kullback_leibler_divergence(preds, targets, epsilon: float = 1e-7):
    """KL(targets || preds) over probability rows, summed across the last
    axis then averaged (Keras kld)."""
    p = torch.clamp(preds.float(), epsilon, 1.0)
    t = torch.clamp(targets.float(), epsilon, 1.0)
    return torch.mean(torch.sum(t * torch.log(t / p), dim=-1))


def poisson(preds, targets, epsilon: float = 1e-7):
    p = preds.float()
    return torch.mean(p - targets.float() * torch.log(p + epsilon))


def cosine_proximity(preds, targets, epsilon: float = 1e-12):
    """Negative mean cosine similarity along the last axis (Keras 2.0 sign
    convention)."""
    p = preds.float()
    t = targets.float()
    p = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                        min=epsilon)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                        min=epsilon)
    return -torch.mean(torch.sum(p * t, dim=-1))


def huber(delta: float = 1.0):
    """Factory: quadratic within ``delta``, linear outside."""
    d = float(delta)

    def loss(preds, targets):
        err = torch.abs(preds.float() - targets.float())
        quad = torch.clamp(err, max=d)
        return torch.mean(0.5 * torch.square(quad) + d * (err - quad))

    loss.__name__ = f"huber_{d}"
    return loss


def smoothed_cross_entropy(smoothing: float = 0.1):
    """Factory: XE with label smoothing, ``(1-s)·NLL + s·mean(-logp)``."""
    s = float(smoothing)

    def loss(logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
        uniform = -torch.mean(logp, dim=-1)
        return torch.mean((1.0 - s) * nll + s * uniform)

    loss.__name__ = f"smoothed_cross_entropy_{s}"
    return loss


_REGISTRY = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "binary_crossentropy": binary_cross_entropy,
    "categorical_crossentropy": softmax_cross_entropy,
    "sparse_categorical_crossentropy":
        softmax_cross_entropy_with_integer_labels,
    # factories by name use their standard settings; call for custom ones
    "smoothed_cross_entropy": smoothed_cross_entropy(0.1),
    "huber": huber(1.0),
}


def class_weighted(base: str, class_weight):
    """Weighted variant of a classification loss (Keras ``class_weight``:
    per-sample weights looked up from the label's class, weighted-mean
    reduction).  Bases: ``sparse_categorical_crossentropy`` and
    ``binary_crossentropy``; classes absent from the dict weigh 1.0."""
    names = {"sparse_categorical_crossentropy", "binary_crossentropy"}
    if base not in names:
        raise ValueError(f"class_weight supports {sorted(names)}; "
                         f"got loss {base!r}")
    if not class_weight:
        return get(base)            # Keras: empty dict is a no-op
    if any(int(k) < 0 for k in class_weight):
        raise ValueError(f"class_weight keys must be >= 0 class ids; "
                         f"got {sorted(class_weight)}")
    n = max(int(k) for k in class_weight) + 1
    lut = [1.0] * n
    for k, v in class_weight.items():
        lut[int(k)] = float(v)
    lut_arr = torch.tensor(lut, dtype=torch.float32)

    def weight_of(labels):
        """Class id -> weight; ids past the dict's range weigh 1.0."""
        ids = labels.to(torch.int64)
        table = lut_arr.to(labels.device)
        return torch.where(ids < n, table[torch.clamp(ids, 0, n - 1)], 1.0)

    if base == "sparse_categorical_crossentropy":
        def loss(logits, labels):
            return softmax_cross_entropy_with_integer_labels(
                logits, labels, where=weight_of(labels))
    else:
        def loss(preds, targets, epsilon: float = 1e-7):
            p = torch.clamp(preds.float(), epsilon, 1.0 - epsilon)
            t = targets.float()
            bce = -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
            # soft targets round to the nearest class for the lookup
            w = weight_of(t > 0.5)
            return torch.sum(bce * w) / torch.clamp(torch.sum(w), min=1e-9)

    loss.__name__ = f"class_weighted_{base}"
    return loss


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown loss {name_or_fn!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
