"""TFRecord container IO: the record framing of event files.

Counterpart of ``distributed_tensorflow_tpu/data/tfrecord.py`` (framing,
``RecordWriter``, ``write_tfrecord``, ``read_tfrecord``); the event writer
(``summary/event_writer.py``) frames its records here.  Checksums come
from the port's ``summary/crc32c.py``.  ``tfrecord_batches`` streams
record files into training batches (parse, a reservoir-window shuffle,
per-process sharding, stacking), the JAX package's batches for the same
arguments.

Framing per record (TFRecord spec):
    uint64 length (LE) | uint32 masked_crc32c(length) |
    bytes  data        | uint32 masked_crc32c(data)
"""
from __future__ import annotations

import os
import struct
from typing import Any, Iterable, Iterator, List

from ..summary.crc32c import masked_crc32c

__all__ = ["write_tfrecord", "read_tfrecord", "RecordWriter", "write_framed",
           "tfrecord_batches"]


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


def _stack(examples: List[Any]) -> Any:
    """Examples of one pytree structure (dicts, tuples, lists, numpy
    leaves) -> the same structure with each leaf stacked on a new leading
    dim."""
    import numpy as np
    first = examples[0]
    if isinstance(first, dict):
        return {k: _stack([ex[k] for ex in examples]) for k in first}
    if isinstance(first, (tuple, list)):
        parts = [_stack([ex[i] for ex in examples])
                 for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else type(first)(parts)
    return np.stack(examples)


def tfrecord_batches(paths, parse_fn, batch_size: int,
                     shuffle_buffer: int = 0, seed: int = 0,
                     epoch: int = 0, drop_remainder: bool = True,
                     verify: bool = True,
                     process_index: int = 0, process_count: int = 1):
    """Stream record files into training batches (tf.data's
    ``TFRecordDataset -> map -> shuffle -> batch``), for host feeding
    and ``prefetch_to_device``.

    ``parse_fn(record_bytes)`` returns one example, a pytree of numpy
    arrays (dicts, tuples, lists); a batch is the same pytree with the
    examples stacked on a leading dim.  ``shuffle_buffer > 0``: each
    incoming example swaps with a uniformly random slot of a window of
    that size, drawn from ``np.random.default_rng((seed, epoch))``, and
    the window's remainder is shuffled at the end: pass the epoch number
    on each pass for a per-epoch reshuffle.

    ``process_index`` / ``process_count``: records are read in windows of
    ``process_count`` and each process keeps its slot, so the processes
    see disjoint streams of exactly ``n // process_count`` examples (the
    last partial window is dropped on every process): one process
    drawing an extra batch would enter a collective step alone.
    """
    import numpy as np

    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in "
                         f"[0, {process_count})")

    def examples():
        window: List = []
        for p in paths:
            for rec in read_tfrecord(str(p), verify=verify):
                window.append(rec)
                if len(window) == process_count:
                    yield parse_fn(window[process_index])
                    window.clear()

    def shuffled():
        if shuffle_buffer <= 0:
            yield from examples()
            return
        rng = np.random.default_rng((seed, epoch))
        buf: List = []
        for ex in examples():
            if len(buf) < shuffle_buffer:
                buf.append(ex)
                continue
            j = rng.integers(0, shuffle_buffer)
            out, buf[j] = buf[j], ex
            yield out
        rng.shuffle(buf)
        yield from buf

    batch: List = []
    for ex in shuffled():
        batch.append(ex)
        if len(batch) == batch_size:
            yield _stack(batch)
            batch = []
    if batch and not drop_remainder:
        yield _stack(batch)
