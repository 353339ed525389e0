"""CRC32-C (Castagnoli), the checksum of the page wire's frames, of
checkpoint leaves and of event-file records.

``py_crc32c`` is a copy of the table-driven pure-Python path of
``distributed_tensorflow_tpu/summary/crc32c.py`` (the port imports
nothing of the JAX package), a byte at a time: the reference the tests
hold ``crc32c`` against.  ``crc32c`` computes the same checksum through
the slice-by-8 host routine of ``csrc/crc32c.cpp``, built on first use
by ``ops/kernels/_build.py`` with the system C++ compiler (a GPT-2-small
training state is 2 GB, checksummed on every save and verified restore);
with no compiler it raises, as the CUDA kernels do without ``nvcc``.
``masked_crc32c`` is the TFRecord / checkpoint-manifest form, and
``py_masked_crc32c`` the same form over ``py_crc32c``.
"""
from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["crc32c", "masked_crc32c", "py_crc32c", "py_masked_crc32c"]

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def py_crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_NATIVE: list = []


def _native():
    """The bound ``crc32c_update`` of ``csrc/crc32c.cpp``, built on first
    use; raises when there is no C++ compiler."""
    if not _NATIVE:
        from ..ops.kernels import _build
        _NATIVE.append(_build.bind(
            "crc32c", "crc32c_update",
            [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32],
            restype=ctypes.c_uint32))
    return _NATIVE[0]


def _as_bytes(data) -> np.ndarray:
    """A contiguous uint8 view (or copy) of a bytes-like object or array."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def crc32c(data, crc: int = 0) -> int:
    """CRC32-C of ``data`` (bytes, a memoryview or a numpy array, read as
    its bytes) continuing from ``crc``; equal to ``py_crc32c``."""
    buf = _as_bytes(data)
    return int(_native()(buf.ctypes.data, buf.size, crc))


def _mask(crc: int) -> int:
    """The TFRecord masked form: rotate right by 15 and add a constant."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc32c(data) -> int:
    """The masked CRC32-C of ``data`` (the host routine)."""
    return _mask(crc32c(data))


def py_masked_crc32c(data: bytes) -> int:
    """The masked CRC32-C of ``data`` through ``py_crc32c``."""
    return _mask(py_crc32c(data))

