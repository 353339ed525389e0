"""Learning-rate schedules (step -> lr), in float32 on the host.

Counterpart of ``distributed_tensorflow_tpu/optim/schedules.py``.  The
port's optimizers keep the step count as a host int (``_lr_at`` in
``optim/optimizers.py`` calls a schedule with it), so a schedule here is a
plain function of that int.  It computes in numpy float32, the type the
JAX schedules trace in, and returns a Python float.
"""
from __future__ import annotations

import numpy as np

__all__ = ["constant", "exponential_decay", "cosine_decay",
           "warmup_cosine_decay", "warmup_linear_decay", "piecewise_constant",
           "polynomial_decay"]

_F = np.float32


def constant(value: float):
    def schedule(count: int) -> float:
        return float(_F(value))
    return schedule


def exponential_decay(init_value: float, decay_steps: int, decay_rate: float,
                      staircase: bool = False):
    def schedule(count: int) -> float:
        p = _F(count) / _F(decay_steps)
        if staircase:
            p = np.floor(p)
        return float(_F(init_value) * np.power(_F(decay_rate), p))
    return schedule


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    def schedule(count: int) -> float:
        frac = np.clip(_F(count) / _F(decay_steps), _F(0), _F(1))
        cos = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * frac))
        return float(_F(init_value) * ((_F(1) - _F(alpha)) * cos
                                       + _F(alpha)))
    return schedule


def _warmup(peak_value: float, warmup_steps: int, t):
    return _F(peak_value) * t / _F(max(warmup_steps, 1))


def warmup_cosine_decay(peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0):
    def schedule(count: int) -> float:
        t = _F(count)
        if t < warmup_steps:
            return float(_warmup(peak_value, warmup_steps, t))
        frac = np.clip((t - _F(warmup_steps))
                       / _F(max(decay_steps - warmup_steps, 1)), _F(0), _F(1))
        return float(_F(end_value) + (_F(peak_value) - _F(end_value))
                     * _F(0.5) * (_F(1) + np.cos(_F(np.pi) * frac)))
    return schedule


def warmup_linear_decay(peak_value: float, warmup_steps: int,
                        total_steps: int):
    """BERT-style: linear warmup then linear decay to zero."""
    def schedule(count: int) -> float:
        t = _F(count)
        if t < warmup_steps:
            return float(_warmup(peak_value, warmup_steps, t))
        frac = np.clip((t - _F(warmup_steps))
                       / _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        return float(_F(peak_value) * (_F(1) - frac))
    return schedule


def polynomial_decay(init_value: float, decay_steps: int,
                     end_value: float = 1e-4, power: float = 1.0,
                     cycle: bool = False):
    """tf.train.polynomial_decay semantics: decay from ``init_value`` to
    ``end_value`` over ``decay_steps`` following ``(1 - t/T)^power``; with
    ``cycle=True`` the horizon T expands to the next multiple of
    ``decay_steps`` past the current step instead of clamping."""
    def schedule(count: int) -> float:
        t = _F(count)
        if cycle:
            horizon = _F(decay_steps) * max(np.ceil(t / _F(decay_steps)),
                                            _F(1))
        else:
            horizon = _F(decay_steps)
            t = min(t, horizon)
        frac = _F(1) - t / horizon
        return float((_F(init_value) - _F(end_value))
                     * np.power(frac, _F(power)) + _F(end_value))
    return schedule


def piecewise_constant(boundaries, values):
    """ResNet-style step schedule: values[i] for step < boundaries[i]."""
    bounds = np.asarray(boundaries, np.float32)
    vals = np.asarray(values, np.float32)

    def schedule(count: int) -> float:
        return float(vals[int(np.sum(_F(count) >= bounds))])
    return schedule
