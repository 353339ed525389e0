"""CRC32-C (Castagnoli), the checksum of the page wire's frames.

``py_crc32c`` is a copy of the table-driven pure-Python path of
``distributed_tensorflow_tpu/summary/crc32c.py`` (the port imports
nothing of the JAX package).  It runs at a few MB/s, and a migrated
request's KV pages are tens of MB, so ``crc32c`` computes the same
checksum with numpy for inputs of ``_LANE`` bytes and more.

The vectorised form rests on the CRC register update being linear over
GF(2): with ``R(c, d)`` the register after feeding bytes ``d`` from
register ``c`` (no final XOR), ``R(c, d) = Z_n(c) ^ R(0, d)`` where
``Z_n`` feeds ``n = len(d)`` zero bytes, and ``R(0, a || b) =
Z_len(b)(R(0, a)) ^ R(0, b)``.  The data is front-padded with zeros (which
leave ``R(0, .)`` unchanged) to ``m`` lanes of ``_LANE`` bytes, ``m`` a
power of two; every lane's ``R(0, lane)`` runs at once, one numpy step a
column of 4-byte words (two 64K-entry tables of ``Z_4``), and
neighbouring lanes fold pairwise, ``log2(m)`` levels, each applying ``Z``
of the current lane length, a 32x32 bit matrix, through four byte
tables.
The initial register ``c`` folds into the first four data bytes (XOR of
its little-endian bytes), which feeding them from 0 is equivalent to.
"""
from __future__ import annotations

import numpy as np

__all__ = ["crc32c", "py_crc32c"]

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)
_NP_TABLE = np.asarray(_TABLE, np.uint32)
# bytes a lane; inputs shorter than one lane take the byte loop
_LANE = 256
# tables built on first use: (lo, hi) of ``_word_tables``, and one
# [4, 256] table a fold level of ``_fold_tables``
_WORD_TABLES: list = []
_FOLD_TABLES: list = []
_BASIS = np.uint32(1) << np.arange(32, dtype=np.uint32)


def py_crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _apply(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The bit matrix with columns ``cols`` [32] applied to every entry of
    ``x`` (uint32), one bit at a time."""
    out = np.zeros_like(x)
    for i in range(32):
        out ^= ((x >> np.uint32(i)) & np.uint32(1)) * cols[i]
    return out


def _byte_tables(cols: np.ndarray) -> np.ndarray:
    """[4, 256]: the matrix applied to each byte value at each of a
    register's four byte positions."""
    x = np.arange(256, dtype=np.uint32)
    return np.stack([_apply(cols, x << np.uint32(8 * p)) for p in range(4)])


def _apply_tables(t: np.ndarray, x: np.ndarray) -> np.ndarray:
    b = np.uint32(0xFF)
    return (t[0][x & b] ^ t[1][(x >> np.uint32(8)) & b]
            ^ t[2][(x >> np.uint32(16)) & b] ^ t[3][x >> np.uint32(24)])


def _zeros_matrix(nbytes: int) -> np.ndarray:
    """Columns of ``Z_nbytes`` (feed ``nbytes`` zero bytes), ``nbytes`` a
    power of two: ``Z_1`` squared ``log2(nbytes)`` times."""
    cols = _NP_TABLE[_BASIS & np.uint32(0xFF)] ^ (_BASIS >> np.uint32(8))
    n = 1
    while n < nbytes:
        cols = _apply(cols, cols)
        n *= 2
    return cols


def _word_tables():
    """(lo, hi): ``Z_4`` of every 16-bit value in the low and in the high
    half of a register, built once on first use; a 32-bit word ``w`` fed
    from register ``c`` then gives ``lo[v & 0xFFFF] ^ hi[v >> 16]`` with
    ``v = c ^ w``."""
    if not _WORD_TABLES:
        z4 = _zeros_matrix(4)
        x = np.arange(1 << 16, dtype=np.uint32)
        _WORD_TABLES.extend([_apply(z4, x), _apply(z4, x << np.uint32(16))])
    return _WORD_TABLES


def _fold_tables(level: int) -> np.ndarray:
    """The byte tables of ``Z`` over ``_LANE * 2**level`` bytes, the fold
    of two neighbouring lanes at that level; built once each."""
    while len(_FOLD_TABLES) <= level:
        if not _FOLD_TABLES:
            cols = _zeros_matrix(_LANE)
        else:
            t = _FOLD_TABLES[-1]
            cols = _apply_tables(t, _apply_tables(t, _BASIS))
        _FOLD_TABLES.append(_byte_tables(cols))
    return _FOLD_TABLES[level]


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32-C of ``data`` continuing from ``crc``; equal to
    ``py_crc32c``."""
    n = len(data)
    if n < _LANE:
        return py_crc32c(data, crc)
    lanes = 1 << max(0, (-(-n // _LANE) - 1).bit_length())
    padded = np.zeros(lanes * _LANE, np.uint8)
    padded[-n:] = np.frombuffer(data, np.uint8)
    init = np.frombuffer(np.asarray(crc ^ 0xFFFFFFFF, "<u4").tobytes(),
                         np.uint8)
    padded[-n:-n + 4] ^= init
    words = np.ascontiguousarray(
        padded.view("<u4").reshape(lanes, _LANE // 4).T).astype(np.uint32)
    lo, hi = _word_tables()
    reg = np.zeros(lanes, np.uint32)
    for w in words:
        v = reg ^ w
        reg = lo[v & np.uint32(0xFFFF)] ^ hi[v >> np.uint32(16)]
    level = 0
    while reg.size > 1:
        reg = _apply_tables(_fold_tables(level), reg[0::2]) ^ reg[1::2]
        level += 1
    return int(reg[0]) ^ 0xFFFFFFFF
