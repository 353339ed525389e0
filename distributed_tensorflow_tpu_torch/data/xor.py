"""The synthetic 64-bit XOR task: ``example.py``'s data.

Counterpart of ``distributed_tensorflow_tpu/data/xor.py``: the input is 64
random bits, the label the 32-bit XOR of its two halves, f32 in {0, 1}.
``xor_batch`` and ``get_data`` draw from numpy's generator exactly as the
JAX package does, so both packages train on the same arrays for the same
seed.  ``xor_batch_native`` runs the threaded C++ generator of
``csrc/xor.cpp`` (a copy of the JAX package's ``dt_xor_generate``, the
same bytes for the same seed), built on first use by
``ops/kernels/_build.py`` with the system C++ compiler; with no compiler
it raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

__all__ = ["BITS", "get_data", "xor_batch", "xor_batch_native"]

BITS = 32  # the label width; the input is 2 * BITS


def xor_batch(n: int, rng: np.random.Generator
              ) -> Tuple[np.ndarray, np.ndarray]:
    """n samples of (64-bit input, 32-bit XOR label), float32 in {0,1}."""
    x = rng.integers(0, 2, size=(n, 2 * BITS), dtype=np.int8)
    y = np.bitwise_xor(x[:, :BITS], x[:, BITS:])
    return x.astype(np.float32), y.astype(np.float32)


def get_data(n: int = 30000, val_size: int = 1000, seed: int = 0):
    """((x_train, y_train), (x_val, y_val)): ``n`` training and
    ``val_size`` validation samples drawn from one pool of ``n +
    val_size``."""
    rng = np.random.default_rng(seed)
    x, y = xor_batch(n + val_size, rng)
    return (x[:n], y[:n]), (x[n:], y[n:])


_NATIVE: list = []


def _native():
    """The bound ``xor_generate`` of ``csrc/xor.cpp``, built on first use."""
    if not _NATIVE:
        from ..ops.kernels import _build
        _NATIVE.append(_build.bind(
            "xor", "xor_generate",
            [ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32,
             ctypes.c_void_p, ctypes.c_void_p], restype=None))
    return _NATIVE[0]


def xor_batch_native(n: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The same task from the threaded C++ generator: deterministic per
    seed, a different stream than ``xor_batch``'s."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    x = np.empty((n, 2 * BITS), np.float32)
    y = np.empty((n, BITS), np.float32)
    _native()(seed, n, BITS, x.ctypes.data, y.ctypes.data)
    return x, y
