"""Host-side image augmentation for the input pipeline.

A numpy copy of ``distributed_tensorflow_tpu/data/augment.py`` (the port
imports nothing of the JAX package): composable per-batch transforms
that plug into ``Dataset(transform=...)``, the same draws from the same
generator as the JAX package's.  Everything is numpy on the host:
augmentation runs on ``prefetch_to_device``'s producer thread, beside the
card's compute, and the step sees dense batches of fixed shapes.

Each transform is ``fn(rng: np.random.Generator, batch: tuple) -> tuple``
acting on the image array (position 0 by convention); ``compose`` chains
them.  All are vectorized over the batch dim.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

__all__ = ["compose", "on_images", "random_flip_lr", "random_crop",
           "normalize", "cutout"]

Transform = Callable[[np.random.Generator, Tuple[np.ndarray, ...]],
                     Tuple[np.ndarray, ...]]


def compose(*transforms: Transform) -> Transform:
    """Apply transforms left to right under one rng stream."""

    def fn(rng, batch):
        for t in transforms:
            batch = t(rng, batch)
        return batch

    return fn


def on_images(image_fn) -> Transform:
    """Lift ``image_fn(rng, images) -> images`` to a batch-tuple transform
    (images are batch position 0)."""

    def fn(rng, batch):
        return (image_fn(rng, batch[0]),) + tuple(batch[1:])

    return fn


def random_flip_lr(prob: float = 0.5) -> Transform:
    """Per-image horizontal flip ([b, h, w, c])."""

    def image_fn(rng, x):
        flip = rng.random(x.shape[0]) < prob
        out = x.copy()
        out[flip] = out[flip, :, ::-1]
        return out

    return on_images(image_fn)


def random_crop(padding: int = 4) -> Transform:
    """Pad reflect by ``padding`` then crop back at a random offset per
    image — the standard CIFAR recipe."""

    def image_fn(rng, x):
        b, h, w, _ = x.shape
        p = padding
        padded = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
        ys = rng.integers(0, 2 * p + 1, b)
        xs = rng.integers(0, 2 * p + 1, b)
        # one fancy-index gather: rows/cols offset per image
        bi = np.arange(b)[:, None, None]
        yi = ys[:, None, None] + np.arange(h)[None, :, None]
        xi = xs[:, None, None] + np.arange(w)[None, None, :]
        return padded[bi, yi, xi]

    return on_images(image_fn)


def normalize(mean: Sequence[float], std: Sequence[float]) -> Transform:
    """Per-channel ``(x - mean) / std`` (f32 out)."""
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)

    def image_fn(rng, x):
        del rng
        return (x.astype(np.float32) - m) / s

    return on_images(image_fn)


def cutout(size: int = 8, prob: float = 1.0) -> Transform:
    """Zero a random ``size`` x ``size`` square per image."""

    def image_fn(rng, x):
        b, h, w, _ = x.shape
        out = x.copy()
        apply = rng.random(b) < prob
        cy = rng.integers(0, h, b)
        cx = rng.integers(0, w, b)
        half = size // 2
        for i in np.flatnonzero(apply):
            # a full size x size patch (clipped only at image borders)
            y0 = max(0, min(cy[i] - half, h - size))
            x0 = max(0, min(cx[i] - half, w - size))
            out[i, y0:y0 + size, x0:x0 + size] = 0
        return out

    return on_images(image_fn)
