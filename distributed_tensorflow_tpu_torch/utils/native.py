"""The host C++ routines of the port's data path, bound with ctypes.

Counterpart of ``distributed_tensorflow_tpu/utils/native.py``'s
``native_available``, ``bpe_encode`` and ``NativeLoader``.  Where the JAX
package builds one library with ``make -C native``, the port builds each
routine from its own source under ``csrc/`` with the system C++ compiler
(``ops/kernels/_build.py``, into ``build/kernels/``, on first use), as
``summary/crc32c.py`` builds ``csrc/crc32c.cpp``:

  * ``bpe_encode``: ``csrc/bpe.cpp``, the encode loop of
    ``data.text.BPETokenizer``, the same segmentation as its Python loop;
  * ``NativeLoader``: ``csrc/loader.cpp``, the threaded shuffle and row
    gather behind ``data.Dataset(backend="native" | "auto")``, batch for
    batch the JAX package's loader for the same seed (the same
    xoshiro256** stream, ``csrc/xoshiro.h``).

There is no fallback: with no C++ compiler ``native_available()`` is
False and the routines raise, as the CUDA kernels do without ``nvcc``.
The port's crc32c and XOR generator bind their own sources
(``summary/crc32c.py``, ``data/xor.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

__all__ = ["native_available", "bpe_encode", "NativeLoader"]

_SOURCES = ("bpe", "loader")
_i64, _i32, _ptr = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p


def native_available() -> bool:
    """Whether the host routines build (or are built) and load here."""
    from ..ops.kernels import _build
    try:
        for name in _SOURCES:
            _build.load(name)
    except (RuntimeError, OSError):
        return False
    return True


def _fn(lib: str, name: str, argtypes, restype):
    from ..ops.kernels import _build
    return _build.bind(lib, name, argtypes, restype=restype)


def bpe_encode(data: bytes, merge_pairs: np.ndarray,
               base_id: int) -> np.ndarray:
    """The BPE ids of ``data``: ``merge_pairs`` [n_merges, 2] int32 in
    rank order; bytes keep their value and merge ``r`` is id ``base_id +
    r``.  The same segmentation as ``BPETokenizer``'s Python loop."""
    fn = _fn("bpe", "bpe_encode",
             [_ptr, _i64, _ptr, _i64, _i32, _ptr, _i64], _i64)
    arr = np.frombuffer(bytes(data), np.uint8)
    pairs = np.ascontiguousarray(merge_pairs, np.int32).reshape(-1, 2)
    out = np.empty(max(arr.size, 1), np.int32)
    n = fn(arr.ctypes.data if arr.size else None, arr.size,
           pairs.ctypes.data, pairs.shape[0], int(base_id),
           out.ctypes.data, out.size)
    if n < 0:
        raise RuntimeError("bpe_encode: output buffer too small")
    return out[:n].copy()


class NativeLoader:
    """Threaded shuffle + gather batches over one or two host arrays.

    Worker threads gather the upcoming batches of the epoch's permutation
    into a ring of ``queue_depth`` buffers, so ``next()`` copies out a
    batch already gathered.  The stream never ends: after
    ``batches_per_epoch`` batches the next epoch reshuffles (epoch ``e``
    draws its permutation from ``seed * 0x9E3779B97F4A7C15 + e``); a
    partial last batch is dropped.  Rows move as raw bytes, so any
    fixed-width dtype works.  ``next()`` returns ``(x, y)``, or ``(x,)``
    when ``y`` is None."""

    def __init__(self, x: np.ndarray, y: Optional[np.ndarray],
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 num_threads: int = 2, queue_depth: int = 4):
        self._create = _fn("loader", "loader_create",
                           [_ptr, _i64, _ptr, _i64, _i64, _i64,
                            ctypes.c_uint64, _i32, _i32, _i32], _ptr)
        self._next = _fn("loader", "loader_next", [_ptr, _ptr, _ptr], None)
        self._destroy = _fn("loader", "loader_destroy", [_ptr], None)
        per_epoch = _fn("loader", "loader_batches_per_epoch", [_ptr], _i64)
        # the C side reads the arrays in place: keep them alive, contiguous
        self._x = np.ascontiguousarray(x)
        self._y = np.ascontiguousarray(y) if y is not None else None
        if self._y is not None and self._y.shape[0] != self._x.shape[0]:
            raise ValueError("x and y must share the leading dim")
        self.batch_size = int(batch_size)
        n = self._x.shape[0]
        xrow = self._x.nbytes // n if n else 0
        yrow = self._y.nbytes // n if self._y is not None and n else 0
        self._handle = self._create(
            self._x.ctypes.data, xrow,
            self._y.ctypes.data if self._y is not None else None, yrow,
            n, self.batch_size, int(seed) & 0xFFFFFFFFFFFFFFFF,
            int(bool(shuffle)), int(num_threads), int(queue_depth))
        if not self._handle:
            raise ValueError(f"loader_create failed: batch {batch_size} "
                             f"of {n} rows")
        self.batches_per_epoch = int(per_epoch(self._handle))
        self._xshape = (self.batch_size,) + self._x.shape[1:]
        self._yshape = ((self.batch_size,) + self._y.shape[1:]
                        if self._y is not None else None)

    def next(self):
        if not self._handle:
            raise RuntimeError("NativeLoader is closed")
        xb = np.empty(self._xshape, self._x.dtype)
        yb = (np.empty(self._yshape, self._y.dtype)
              if self._yshape is not None else None)
        self._next(self._handle, xb.ctypes.data,
                   yb.ctypes.data if yb is not None else None)
        return (xb, yb) if yb is not None else (xb,)

    def __iter__(self):
        for _ in range(self.batches_per_epoch):
            yield self.next()

    def close(self):
        if getattr(self, "_handle", None):
            self._destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
