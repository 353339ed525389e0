"""The page wire's framing: KV pages as CRC-checked byte frames.

Counterpart of the framing half of
``distributed_tensorflow_tpu/fleet/pagewire.py`` (``PageRecord``,
``frame_chunk``, ``parse_frame`` and the two errors), byte-compatible
with it: the same magic, version, chain-key tags, field order and dtype
names, so a frame written by either implementation parses in the other.
A migrated request's radix-cached KV pages (``Engine.export_wire_pages``)
travel as frames and land in another engine's pool
(``Engine.import_wire_pages``), whose resumed prefill then skips those
windows.

Payload leaves are CPU torch tensors, one ``[L, page_size, ...]`` page
per pool leaf (an int8 pool ships its scale planes as ordinary leaves).
A leaf's dtype goes on the wire as numpy's ``dtype.str`` (``"<f4"``,
``"|i1"``), except bfloat16, which numpy cannot name and which goes by
its name ``"bfloat16"``; the bytes are the tensor's raw little-endian
bytes, so no bfloat16 numpy type is needed on either side.

Not ported: the sender's retry state machine (``PageWire``) and its
loopback link, which need the fault plans and the metrics registry.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..summary.crc32c import crc32c

__all__ = ["PageRecord", "WireError", "WireFrameError", "frame_chunk",
           "parse_frame"]

_MAGIC = b"DTPW"
_VERSION = 1
# chain key type tags: the serve tier keys by blake2b chain hash (bytes),
# the reference's fleet simulator by prefix id (int)
_KEY_BYTES = 0
_KEY_INT = 1

# wire dtype string <-> torch dtype of every leaf a pool can hold (the
# strings numpy's ``dtype.str`` gives, and the reference's name for
# bfloat16)
_WIRE_DTYPES = {"<f4": torch.float32, "<f2": torch.float16,
                "bfloat16": torch.bfloat16, "|i1": torch.int8}
_DTYPE_WIRE = {v: k for k, v in _WIRE_DTYPES.items()}
# same-width integer views that carry a dtype's bytes through numpy
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


class WireError(RuntimeError):
    """Unrecoverable transfer failure; the caller migrates by re-prefill
    instead."""


class WireFrameError(WireError):
    """A frame that failed to parse or to verify (the receiver's NAK)."""


@dataclasses.dataclass
class PageRecord:
    """One shipped page: the ``index``-th full chunk of the migrated
    request's context, its radix chain key, the tokens the chain covers
    through this chunk, and the page (one CPU tensor per pool leaf)."""
    index: int
    chain: Any                           # bytes (serve) | int (sim)
    tokens: int
    payload: Dict[str, torch.Tensor]


def _pack_key(chain: Any) -> Tuple[int, bytes]:
    if isinstance(chain, bytes):
        return _KEY_BYTES, chain
    return _KEY_INT, struct.pack(">q", int(chain))


def _unpack_key(tag: int, raw: bytes) -> Any:
    if tag == _KEY_BYTES:
        return raw
    return struct.unpack(">q", raw)[0]


def _leaf_bytes(leaf: torch.Tensor) -> Tuple[bytes, bytes]:
    """(wire dtype string, raw little-endian bytes) of a CPU tensor."""
    leaf = leaf.detach().contiguous()
    if leaf.device.type != "cpu":
        raise ValueError(f"page leaves must be CPU tensors; got "
                         f"{leaf.device}")
    dt = _DTYPE_WIRE.get(leaf.dtype)
    if dt is None:
        raise ValueError(f"no wire dtype for {leaf.dtype}")
    arr = leaf.view(_BITS.get(leaf.dtype, leaf.dtype)).numpy()
    return dt.encode(), arr.astype(arr.dtype.newbyteorder("<"),
                                   copy=False).tobytes()


def _leaf_tensor(dt: str, shape, raw: bytes) -> torch.Tensor:
    """A CPU tensor from its wire dtype string, shape and raw bytes."""
    dtype = _WIRE_DTYPES.get(dt)
    if dtype is None:
        raise WireFrameError(f"unknown wire dtype {dt!r}")
    carrier = _BITS.get(dtype, dtype)
    np_dt = torch.empty((), dtype=carrier).numpy().dtype.newbyteorder("<")
    arr = np.frombuffer(raw, np_dt).reshape(shape).astype(
        np_dt.newbyteorder("="))
    return torch.from_numpy(arr).view(dtype)


def frame_chunk(seq: int, records: Sequence[PageRecord]) -> bytes:
    """One wire chunk: header, each record's (index, chain key, tokens,
    payload leaves with dtype and shape, in sorted leaf order), and a
    CRC32-C trailer over everything before it."""
    parts = [_MAGIC, struct.pack(">BIH", _VERSION, seq, len(records))]
    for r in records:
        tag, key = _pack_key(r.chain)
        parts.append(struct.pack(">IBB", int(r.index), tag, len(key)))
        parts.append(key)
        parts.append(struct.pack(">IB", int(r.tokens), len(r.payload)))
        for name in sorted(r.payload):
            leaf = r.payload[name]
            dt, raw = _leaf_bytes(leaf)
            parts.append(struct.pack(">B", len(name)))
            parts.append(name.encode())
            parts.append(struct.pack(">B", len(dt)))
            parts.append(dt)
            parts.append(struct.pack(">B", leaf.dim()))
            parts.append(struct.pack(f">{leaf.dim()}I", *leaf.shape))
            parts.append(struct.pack(">Q", len(raw)))
            parts.append(raw)
    body = b"".join(parts)
    return body + struct.pack(">I", crc32c(body))


def parse_frame(frame: bytes) -> Tuple[int, List[PageRecord]]:
    """Decode one chunk frame -> (seq, records), verifying the CRC32-C
    trailer, the magic and the version; raises ``WireFrameError`` on any
    mismatch or truncation."""
    if len(frame) < len(_MAGIC) + 7 + 4:
        raise WireFrameError(f"short frame ({len(frame)} bytes)")
    body, (crc,) = frame[:-4], struct.unpack(">I", frame[-4:])
    if crc32c(body) != crc:
        raise WireFrameError("CRC32C mismatch")
    if body[:4] != _MAGIC:
        raise WireFrameError(f"bad magic {body[:4]!r}")
    ver, seq, n = struct.unpack(">BIH", body[4:11])
    if ver != _VERSION:
        raise WireFrameError(f"wire version {ver} != {_VERSION}")
    off = 11
    out: List[PageRecord] = []
    try:
        for _ in range(n):
            index, tag, klen = struct.unpack(">IBB", body[off:off + 6])
            off += 6
            chain = _unpack_key(tag, body[off:off + klen])
            off += klen
            tokens, nleaves = struct.unpack(">IB", body[off:off + 5])
            off += 5
            payload: Dict[str, torch.Tensor] = {}
            for _ in range(nleaves):
                (ln,) = struct.unpack(">B", body[off:off + 1])
                name = body[off + 1:off + 1 + ln].decode()
                off += 1 + ln
                (ln,) = struct.unpack(">B", body[off:off + 1])
                dt = body[off + 1:off + 1 + ln].decode()
                off += 1 + ln
                (ndim,) = struct.unpack(">B", body[off:off + 1])
                shape = struct.unpack(f">{ndim}I",
                                      body[off + 1:off + 1 + 4 * ndim])
                off += 1 + 4 * ndim
                (nraw,) = struct.unpack(">Q", body[off:off + 8])
                raw = body[off + 8:off + 8 + nraw]
                off += 8 + nraw
                payload[name] = _leaf_tensor(dt, shape, raw)
            out.append(PageRecord(index=index, chain=chain,
                                  tokens=tokens, payload=payload))
    except (struct.error, ValueError) as e:
        raise WireFrameError(f"truncated frame: {e}") from e
    return seq, out
