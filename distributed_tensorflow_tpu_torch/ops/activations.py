"""Activation functions, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/activations.py``: the same
names, looked up by ``get`` (``Dense(128, activation="relu")``), with the
same definitions.  ``gelu`` is the tanh approximation, which is what
``jax.nn.gelu`` computes by default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["relu", "sigmoid", "hard_sigmoid", "tanh", "gelu", "silu",
           "softmax", "log_softmax", "identity", "get"]

relu = torch.relu
sigmoid = torch.sigmoid
tanh = torch.tanh
silu = F.silu


def gelu(x):
    return F.gelu(x, approximate="tanh")


def softmax(x):
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def identity(x):
    return x


def hard_sigmoid(x):
    """Keras-2 hard_sigmoid: clip(0.2x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_REGISTRY = {
    "relu": relu,
    "sigmoid": sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "tanh": tanh,
    "gelu": gelu,
    "silu": silu,
    "swish": silu,
    "softmax": softmax,
    "log_softmax": log_softmax,
    "linear": identity,
    "identity": identity,
    None: identity,
}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown activation {name_or_fn!r}; "
                         f"known: {sorted(k for k in _REGISTRY if k)}") from None
