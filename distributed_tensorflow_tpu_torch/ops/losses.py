"""Losses, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/losses.py``, the part the
causal-LM training path runs.  Losses reduce in f32 whatever the input
type and return a scalar mean.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy_with_integer_labels"]


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
