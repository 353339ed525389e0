"""Parameter initializers, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/initializers.py``: the same
names and distributions (Keras 2.0.8's defaults: glorot_uniform kernels,
zero biases).  Each initializer is ``init(generator, shape, dtype)`` and
draws from the explicit ``torch.Generator`` it is given, on that
generator's device, where the JAX package splits a PRNG key.  The bits
cannot match ``jax.random``'s; the distributions are the same
(truncated normals cut at two standard deviations, by the inverse CDF).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["zeros", "ones", "constant", "normal", "truncated_normal",
           "uniform", "glorot_uniform", "glorot_normal", "he_normal",
           "he_uniform", "lecun_normal", "orthogonal", "get"]


def _device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def _uniform(generator, shape, low: float, high: float) -> torch.Tensor:
    """f32 draws in [low, high)."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=_device(generator))
    return u * (high - low) + low


def _truncated(generator, shape) -> torch.Tensor:
    """Standard normal draws cut to [-2, 2]: a uniform draw between the
    cut points' CDF values through the inverse CDF."""
    lo = math.erf(-2.0 / math.sqrt(2.0))
    hi = math.erf(2.0 / math.sqrt(2.0))
    u = _uniform(generator, shape, lo, hi)
    return torch.clamp(torch.erfinv(u) * math.sqrt(2.0), -2.0, 2.0)


def zeros(generator, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=_device(generator))


def ones(generator, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=_device(generator))


def constant(value):
    def init(generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=_device(generator))
    return init


def normal(stddev=0.01):
    def init(generator, shape, dtype=torch.float32):
        return (stddev * torch.randn(tuple(shape), generator=generator,
                                     device=_device(generator))).to(dtype)
    return init


def truncated_normal(stddev=0.02):
    def init(generator, shape, dtype=torch.float32):
        return (stddev * _truncated(generator, shape)).to(dtype)
    return init


def uniform(scale=0.05):
    def init(generator, shape, dtype=torch.float32):
        return _uniform(generator, shape, -scale, scale).to(dtype)
    return init


def _fans(shape: Sequence[int]):
    """fan_in/fan_out for dense ([in, out]) and conv ([h, w, in, out])."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _variance_scaling(scale: float, mode: str, distribution: str):
    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        if mode == "fan_in":
            denom = max(1, fan_in)
        elif mode == "fan_out":
            denom = max(1, fan_out)
        else:
            denom = max(1.0, (fan_in + fan_out) / 2.0)
        variance = scale / denom
        if distribution == "uniform":
            limit = math.sqrt(3.0 * variance)
            out = _uniform(generator, shape, -limit, limit)
        elif distribution == "truncated_normal":
            # so that the stddev after the cut is the one asked for
            stddev = math.sqrt(variance) / 0.87962566103423978
            out = stddev * _truncated(generator, shape)
        else:
            out = math.sqrt(variance) * torch.randn(
                tuple(shape), generator=generator, device=_device(generator))
        return out.to(dtype)
    return init


def glorot_uniform():
    return _variance_scaling(1.0, "fan_avg", "uniform")


def glorot_normal():
    return _variance_scaling(1.0, "fan_avg", "truncated_normal")


def he_normal():
    return _variance_scaling(2.0, "fan_in", "truncated_normal")


def he_uniform():
    return _variance_scaling(2.0, "fan_in", "uniform")


def lecun_normal():
    return _variance_scaling(1.0, "fan_in", "truncated_normal")


def orthogonal(scale: float = 1.0):
    """Orthogonal init via QR of a normal matrix: QR of the (max, min)
    rectangle, sign-corrected so that the distribution is uniform over
    orthogonal matrices."""
    def init(generator, shape, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError(f"orthogonal needs >= 2 dims, got {shape}")
        rows = math.prod(shape[:-1])
        cols = shape[-1]
        big, small = max(rows, cols), min(rows, cols)
        a = torch.randn((big, small), generator=generator,
                        device=_device(generator))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.T
        return (scale * q).reshape(tuple(shape)).to(dtype)
    return init


_REGISTRY = {
    "zeros": zeros,
    "ones": ones,
    "glorot_uniform": glorot_uniform(),
    "glorot_normal": glorot_normal(),
    "he_normal": he_normal(),
    "he_uniform": he_uniform(),
    "lecun_normal": lecun_normal(),
    "orthogonal": orthogonal(),
}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown initializer {name_or_fn!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
