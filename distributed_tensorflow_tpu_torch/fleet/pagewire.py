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

The sender (``PageWire``, counterpart of the reference's) is built around
failure: each frame is CRC-checked by the receiver, a dropped, corrupt or
late frame is re-sent with bounded retries and seeded exponential backoff,
the receiver dedups re-sends by chain key, and an unrecoverable failure
(the link down, retries exhausted) raises ``WireError``, on which the
caller (``fleet.Router``) migrates by re-prefill.  ``InProcessLink`` is
the loopback link of an in-process fleet; the fault plan's wire kinds
(``drop_chunk``, ``corrupt_chunk``, ``stall_wire``, ``kill_host``) act
inside its ``deliver``.  Series: ``dttpu_wire_*``.

On the card the pages of a shipment are read off one replica's pool by a
gather under its pump lock and copied to the host
(``Engine.export_wire_pages``), framed and parsed on the host, and copied
into the destination's pool (``Engine.import_wire_pages``): no kernel of
the port runs on the wire itself.
"""
from __future__ import annotations

import dataclasses
import logging
import struct
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as metrics_lib
from ..resilience import faults as faults_lib
from ..summary.crc32c import crc32c

log = logging.getLogger(__name__)

__all__ = ["InProcessLink", "PageRecord", "PageWire", "WireError",
           "WireFrameError", "frame_chunk", "parse_frame"]

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


class InProcessLink:
    """Loopback wire link of the in-process fleet: ``deliver`` returns the
    frames as the receiver would see them.  ``latency_s`` is paid once a
    call (a flight of frames amortizes it), and the active ``FaultPlan``
    acts on each frame: ``drop_chunk`` vanishes it (None: the sender sees
    a timeout), ``corrupt_chunk`` flips one byte (the receiver's CRC
    NAKs), ``stall_wire`` sleeps the fault's ``seconds`` in line (a late
    flight), ``kill_host`` raises ``ConnectionError`` (unrecoverable).
    A socket-backed link would keep the same ``deliver`` contract."""

    def __init__(self, wire_id: int = 0, latency_s: float = 0.0,
                 sleep=time.sleep):
        self.wire_id = int(wire_id)
        self.latency_s = float(latency_s)
        self.sleep = sleep

    def deliver(self, frames: Sequence[bytes]) -> List[Optional[bytes]]:
        if self.latency_s:
            self.sleep(self.latency_s)
        plan = faults_lib.active()
        out: List[Optional[bytes]] = []
        for frame in frames:
            action = (plan.on_wire_chunk(self.wire_id)
                      if plan is not None else None)
            if action == "drop":
                out.append(None)
            elif action == "corrupt":
                bad = bytearray(frame)
                bad[len(bad) // 2] ^= 0xFF
                out.append(bytes(bad))
            else:
                out.append(bytes(frame))
        return out


class PageWire:
    """The sender's transfer state machine (module docstring).

    ``chunk_pages`` records a frame and ``overlap`` frames a flight shape
    the wire.  ``timeout_s`` is a flight's delivery budget: a flight that
    takes longer is re-sent even if its frames arrived (late is lost to
    the sender; the receiver's chain-key dedup makes the duplicate
    harmless).  Retries back off exponentially with jitter from a
    generator seeded with ``seed``; ``sleep`` is injectable for tests."""

    def __init__(self, *, chunk_pages: int = 2, overlap: int = 1,
                 max_retries: int = 4, timeout_s: float = 0.5,
                 backoff_base_s: float = 0.002,
                 backoff_factor: float = 2.0,
                 backoff_max_s: float = 0.05, jitter: float = 0.5,
                 seed: int = 0, link: Optional[InProcessLink] = None,
                 registry: Optional[metrics_lib.Registry] = None,
                 sleep=time.sleep):
        if chunk_pages < 1:
            raise ValueError(f"chunk_pages must be >= 1; "
                             f"got {chunk_pages}")
        if overlap < 1:
            raise ValueError(f"overlap must be >= 1; got {overlap}")
        self.chunk_pages = int(chunk_pages)
        self.overlap = int(overlap)
        self.max_retries = int(max_retries)
        self.timeout_s = float(timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.sleep = sleep
        self.link = link if link is not None else InProcessLink()
        self._rng = np.random.default_rng(seed)
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self._m_transfers = reg.counter(
            "dttpu_wire_transfers_total",
            "Completed page-wire transfers (pages adopted by the "
            "destination pool).")
        self._m_failures = reg.counter(
            "dttpu_wire_failures_total",
            "Unrecoverable page-wire transfers (link down or chunk "
            "retries exhausted) — each degraded to re-prefill "
            "migration.")
        self._m_chunks = reg.counter(
            "dttpu_wire_chunks_total",
            "Chunk frames sent over the page wire (re-sends "
            "included).")
        self._m_retries = reg.counter(
            "dttpu_wire_chunk_retries_total",
            "Chunk frames re-sent after a drop, CRC NAK, or per-chunk "
            "timeout.")
        self._m_bytes = reg.counter(
            "dttpu_wire_bytes_total",
            "Framed bytes sent over the page wire (re-sends "
            "included).")
        self._m_pages = reg.counter(
            "dttpu_wire_pages_shipped_total",
            "KV pages adopted by destination pools via the wire.")
        self._m_seconds = reg.histogram(
            "dttpu_wire_transfer_seconds",
            "Wall clock of one completed page-wire transfer (device "
            "read to destination splice).")

    def _delay(self, attempt: int) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s
                   * self.backoff_factor ** (attempt - 1))
        return base * (1.0 + self.jitter * float(self._rng.random()))

    def ship(self, records: Sequence[Tuple[int, Any, dict]],
             dest, snap) -> int:
        """Transfer ``records`` (``(chunk_index, chain key, payload)``
        from the source engine's ``export_wire_pages``) to ``dest``
        (anything with ``import_wire_pages(snap, records)``); returns the
        pages the destination adopted (0: nothing usable shipped, and the
        import re-prefills those windows).

        Raises ``WireError`` on an unrecoverable failure; the caller
        treats it as "migrate by re-prefill", never as a failed
        request."""
        if not records:
            return 0
        if not hasattr(dest, "import_wire_pages"):
            return 0                      # no wire surface: degrade
        t0 = time.perf_counter()
        # the tokens a chain covers come from the snapshot's manifest
        # when it has one, else from the chunk index and the page size
        manifest = dict(getattr(snap, "shipped_pages", None) or ())
        pg = int(getattr(snap, "page_size", 0) or 0)
        recs = [PageRecord(index=int(i), chain=c,
                           tokens=int(manifest.get(c, (int(i) + 1) * pg)),
                           payload=dict(p))
                for i, c, p in records]
        frames = [frame_chunk(seq, recs[seq * self.chunk_pages:
                                        (seq + 1) * self.chunk_pages])
                  for seq in range(-(-len(recs) // self.chunk_pages))]
        accepted: Dict[Any, PageRecord] = {}
        try:
            for base in range(0, len(frames), self.overlap):
                self._send_flight(
                    list(enumerate(frames))[base:base + self.overlap],
                    accepted)
        except WireError:
            self._m_failures.inc()
            raise
        # splice the contiguous prefix of chunks 0..n-1: past a gap every
        # window re-prefills anyway
        ordered = sorted(accepted.values(), key=lambda r: r.index)
        take: List[PageRecord] = []
        for j, r in enumerate(ordered):
            if r.index != j:
                break
            take.append(r)
        if not take:
            return 0
        try:
            adopted = int(dest.import_wire_pages(snap, take))
        except Exception as e:
            # a refusing destination (pool exhausted, alien layout) is
            # degradation, not a failed transfer
            log.warning("page-wire splice refused by destination: %r", e)
            self._m_failures.inc()
            return 0
        if adopted:
            self._m_pages.inc(adopted)
            self._m_transfers.inc()
            self._m_seconds.observe(time.perf_counter() - t0)
        return adopted

    def _send_flight(self, flight: List[Tuple[int, bytes]],
                     accepted: Dict[Any, PageRecord]) -> None:
        """Deliver one flight of frames with bounded retry.  A frame is
        settled when it parses and verifies within the flight's timeout;
        drops, NAKs and timeouts re-send only the unsettled frames."""
        pending = list(flight)
        for attempt in range(self.max_retries + 1):
            self._m_chunks.inc(len(pending))
            for _, frame in pending:
                self._m_bytes.inc(len(frame))
            sent = time.perf_counter()
            try:
                outs = self.link.deliver([f for _, f in pending])
            except ConnectionError as e:
                raise WireError(f"page-wire link down: {e}") from e
            late = (time.perf_counter() - sent) > self.timeout_s
            failed: List[Tuple[int, bytes]] = []
            for (seq, frame), out in zip(pending, outs):
                ok = False
                if out is not None:
                    try:
                        _, recs = parse_frame(out)
                    except WireFrameError:
                        recs = None       # the receiver's NAK
                    if recs is not None:
                        # idempotent re-send: a late duplicate is a no-op
                        for r in recs:
                            accepted.setdefault(r.chain, r)
                        ok = not late
                if not ok:
                    failed.append((seq, frame))
            if not failed:
                return
            if attempt >= self.max_retries:
                raise WireError(
                    f"chunk retries exhausted "
                    f"(seqs {[s for s, _ in failed]} after "
                    f"{self.max_retries} retries)")
            self._m_retries.inc(len(failed))
            self.sleep(self._delay(attempt + 1))
            pending = failed
