"""Model zoo: the baseline-config architectures (BASELINE.md #1-#3), in
PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/zoo.py``: the same
builders, returning ``ops.Stack``s for both API tiers (``make_train_step``
and ``Sequential(stack.layers)``).
"""
from __future__ import annotations

from .. import ops

__all__ = ["xor_mlp", "mnist_mlp", "cifar_cnn"]


def xor_mlp(bits: int = 32) -> ops.Stack:
    """``example.py``'s model: 2*bits -> 128 relu -> drop .3 -> 128 relu
    -> drop .3 -> bits sigmoid."""
    return ops.serial(
        ops.Dense(128, activation="relu"),
        ops.Dropout(0.3),
        ops.Dense(128, activation="relu"),
        ops.Dropout(0.3),
        ops.Dense(bits, activation="sigmoid"),
    )


def mnist_mlp(num_classes: int = 10) -> ops.Stack:
    """BASELINE config #1/#2: 2-layer MLP over flattened 28x28 images."""
    return ops.serial(
        ops.Dense(128, activation="relu"),
        ops.Dropout(0.2),
        ops.Dense(num_classes),
    )


def cifar_cnn(num_classes: int = 10) -> ops.Stack:
    """BASELINE config #3: small conv net for 32x32x3 images (the
    ``outline_keras.py`` model), NHWC."""
    return ops.serial(
        ops.Conv2D(32, 3, activation="relu"),
        ops.Conv2D(32, 3, activation="relu"),
        ops.MaxPool2D(2),
        ops.Conv2D(64, 3, activation="relu"),
        ops.Conv2D(64, 3, activation="relu"),
        ops.MaxPool2D(2),
        ops.Flatten(),
        ops.Dense(256, activation="relu"),
        ops.Dropout(0.5),
        ops.Dense(num_classes),
    )
