"""TFRecord container IO: the record framing of event files.

Counterpart of ``distributed_tensorflow_tpu/data/tfrecord.py`` (framing,
``RecordWriter``, ``write_tfrecord``, ``read_tfrecord``); the event writer
(``summary/event_writer.py``) frames its records here.  Checksums come
from the port's ``summary/crc32c.py``.  ``tfrecord_batches`` (a streaming
batcher over record files) is not ported yet.

Framing per record (TFRecord spec):
    uint64 length (LE) | uint32 masked_crc32c(length) |
    bytes  data        | uint32 masked_crc32c(data)
"""
from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator

from ..summary.crc32c import masked_crc32c

__all__ = ["write_tfrecord", "read_tfrecord", "RecordWriter", "write_framed"]


def write_framed(f, payload: bytes) -> None:
    """Write one framed record to an open binary file — the ONE home of the
    TFRecord framing (the TB event writer delegates here too)."""
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(payload)
    f.write(struct.pack("<I", masked_crc32c(payload)))


class RecordWriter:
    """Streaming writer; append ``bytes`` payloads, close (or use as a
    context manager) to flush."""

    def __init__(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        write_framed(self._f, payload)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    """Write all ``records``; returns the count."""
    n = 0
    with RecordWriter(path) as w:
        for r in records:
            w.write(r)
            n += 1
    return n


def read_tfrecord(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield record payloads; ``verify`` checks both crcs per record and
    raises ``IOError`` on corruption (truncated tails always raise)."""
    with open(path, "rb") as f:
        offset = 0
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise IOError(f"{path}: truncated length at offset {offset}")
            len_crc_bytes = f.read(4)
            if len(len_crc_bytes) < 4:
                raise IOError(f"{path}: truncated record at offset {offset}")
            # Validate the length's OWN crc before trusting it for a bulk
            # read — a corrupted length must report as corruption, not as a
            # huge allocation followed by "truncated".
            if verify and struct.unpack("<I", len_crc_bytes)[0] != \
                    masked_crc32c(header):
                raise IOError(
                    f"{path}: length crc mismatch at offset {offset}")
            (length,) = struct.unpack("<Q", header)
            rest = f.read(length + 4)
            if len(rest) < length + 4:
                raise IOError(f"{path}: truncated record at offset {offset}")
            payload = rest[:length]
            (data_crc,) = struct.unpack("<I", rest[length:])
            if verify and data_crc != masked_crc32c(payload):
                raise IOError(
                    f"{path}: data crc mismatch at offset {offset}")
            offset += 8 + 4 + length + 4
            yield payload
