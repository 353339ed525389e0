"""TensorBoard event files, without TensorFlow.

Counterpart of ``distributed_tensorflow_tpu/summary/event_writer.py``:
``EventFileWriter`` and ``SummaryWriter`` write the same bytes as the JAX
package's for scalars, histograms, text, images (PNG) and audio (WAV):
hand-encoded Event / Summary protobufs, framed TFRecord-style
(``data/tfrecord.py``).  Float steps (the fractional-epoch x-axis) are
written as their floor.  ``add_graph`` writes a model's topology as a
GraphDef (``model_graph_nodes`` of an ``ops.Stack``'s layer list, or
explicit nodes), the reference's ``writer.add_graph(sess.graph)``.
"""
from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Dict, Optional, Union

import numpy as np

__all__ = ["EventFileWriter", "SummaryWriter", "model_graph_nodes"]


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    # proto int64: negatives encode as 64-bit two's complement varints.
    return _varint(num << 3) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _scalar_event(wall_time: float, step: int,
                  scalars: Dict[str, float]) -> bytes:
    values = b"".join(
        _field_bytes(1, _field_bytes(1, tag.encode("utf-8")) +
                     _field_float(2, float(val)))
        for tag, val in scalars.items())
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, values))


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _packed_doubles(num: int, values) -> bytes:
    return _field_bytes(
        num, b"".join(struct.pack("<d", float(v)) for v in values))


def _histogram_proto(values) -> bytes:
    """HistogramProto{min=1,max=2,num=3,sum=4,sum_squares=5,
    bucket_limit=6(packed),bucket=7(packed)} over a flat array.

    Non-finite entries are dropped before bucketing (the moment a tensor
    goes NaN is exactly when you want the histogram logged, not a crash);
    min/max/sum still reflect only the finite values.
    """
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros(1)
    lo, hi = float(v.min()), float(v.max())
    if lo == hi:           # degenerate: one bucket holding everything
        limits = [hi, float(np.nextafter(hi, np.inf))]
        counts = [float(v.size), 0.0]
    else:
        counts_np, edges = np.histogram(v, bins=min(30, max(1, v.size)))
        limits = list(edges[1:])
        counts = [float(c) for c in counts_np]
    return (_field_double(1, lo) + _field_double(2, hi) +
            _field_double(3, float(v.size)) + _field_double(4, float(v.sum()))
            + _field_double(5, float(np.square(v).sum()))
            + _packed_doubles(6, limits) + _packed_doubles(7, counts))


def _png_encode(arr) -> bytes:
    """Minimal PNG writer (8-bit grey/RGB/RGBA, no filtering) — enough for
    TensorBoard image summaries without an image library dependency."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[:, :, None]
    if np.issubdtype(a.dtype, np.integer):
        a = np.clip(a, 0, 255).astype(np.uint8)   # integer pixels are 0-255
    elif a.dtype != np.uint8:
        # float convention follows tf.summary.image: values in [0, 1]
        a = (np.clip(a.astype(np.float64), 0.0, 1.0) * 255).astype(np.uint8)
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data +
                struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _image_event(wall_time: float, step: int, tag: str, image) -> bytes:
    """Summary.Value{tag=1, image=4}; Image{height=1, width=2,
    colorspace=3, encoded_image_string=4} (TF summary.proto)."""
    a = np.asarray(image)
    h, w = a.shape[0], a.shape[1]
    c = 1 if a.ndim == 2 else a.shape[2]
    img = (_field_varint(1, h) + _field_varint(2, w) + _field_varint(3, c) +
           _field_bytes(4, _png_encode(a)))
    value = _field_bytes(1, tag.encode("utf-8")) + _field_bytes(4, img)
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, _field_bytes(1, value)))


def _text_event(wall_time: float, step: int, tag: str, text: str) -> bytes:
    """tf.summary.text parity: Summary.Value{tag=1, metadata=9, tensor=8}
    where the tensor is a DT_STRING TensorProto and the metadata routes the
    value to TensorBoard's text plugin (markdown-rendered).

    Protos: SummaryMetadata{plugin_data=1 PluginData{plugin_name=1}};
    TensorProto{dtype=1 (DT_STRING=7), tensor_shape=2
    TensorShapeProto{dim=2 {size=1}}, string_val=8}.
    """
    payload = text.encode("utf-8")
    tensor = (_field_varint(1, 7)
              + _field_bytes(2, _field_bytes(2, _field_varint(1, 1)))
              + _field_bytes(8, payload))
    metadata = _field_bytes(1, _field_bytes(1, b"text"))
    value = (_field_bytes(1, tag.encode("utf-8")) + _field_bytes(8, tensor)
             + _field_bytes(9, metadata))
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, _field_bytes(1, value)))


def _wav_encode(samples, sample_rate: int) -> bytes:
    """Minimal PCM-16 WAV writer ([frames] or [frames, channels] floats in
    [-1, 1]) — enough for TB audio summaries without an audio library."""
    a = np.asarray(samples, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    pcm = (np.clip(a, -1.0, 1.0) * 32767.0).astype("<i2")
    frames, channels = pcm.shape
    data = pcm.tobytes()
    byte_rate = sample_rate * channels * 2
    header = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
              + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels,
                                      sample_rate, byte_rate,
                                      channels * 2, 16)
              + b"data" + struct.pack("<I", len(data)))
    return header + data


def _audio_event(wall_time: float, step: int, tag: str, audio,
                 sample_rate: int) -> bytes:
    """Summary.Value{tag=1, audio=6}; Audio{sample_rate=1 (float),
    num_channels=2, length_frames=3, encoded_audio_string=4,
    content_type=5} (TF summary.proto)."""
    a = np.asarray(audio)
    frames = a.shape[0]
    channels = 1 if a.ndim == 1 else a.shape[1]
    proto = (_field_float(1, float(sample_rate))
             + _field_varint(2, channels) + _field_varint(3, frames)
             + _field_bytes(4, _wav_encode(a, sample_rate))
             + _field_bytes(5, b"audio/wav"))
    value = _field_bytes(1, tag.encode("utf-8")) + _field_bytes(6, proto)
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, _field_bytes(1, value)))


def _node_def(name: str, op: str, inputs=(), device: str = "") -> bytes:
    """NodeDef{name=1, op=2, input=3 repeated, device=4} (the subset of
    TF's graph.proto that TensorBoard's graph plugin renders)."""
    out = (_field_bytes(1, name.encode("utf-8")) +
           _field_bytes(2, op.encode("utf-8")))
    for inp in inputs:
        out += _field_bytes(3, inp.encode("utf-8"))
    if device:
        out += _field_bytes(4, device.encode("utf-8"))
    return out


def _graph_def(nodes) -> bytes:
    """GraphDef{node=1 repeated, versions=4 VersionDef{producer=1}}.
    ``nodes``: iterable of (name, op, inputs) or (name, op, inputs, device).
    """
    body = b"".join(_field_bytes(1, _node_def(*n)) for n in nodes)
    return body + _field_bytes(4, _field_varint(1, 22))


def _graph_event(wall_time: float, graph_def: bytes) -> bytes:
    # Event.graph_def = field 4 (bytes)
    return _field_double(1, wall_time) + _field_bytes(4, graph_def)


def model_graph_nodes(model):
    """TensorBoard graph nodes of anything with an ordered ``.layers`` list
    (``ops.Stack``): a Placeholder input node feeding the layer chain,
    each node's op the layer's class name, named as the ``Stack`` keys
    its layers ("dense", "dense_1", ...)."""
    layers = getattr(model, "layers", None)
    if layers is None:
        raise TypeError(
            f"model_graph_nodes needs an object with .layers (Stack); got "
            f"{type(model).__name__}")
    nodes = [("input", "Placeholder", ())]
    prev = "input"
    seen: Dict[str, int] = {}
    for layer in layers:
        base = getattr(layer, "name", None) or type(layer).__name__.lower()
        count = seen.get(base, 0)
        seen[base] = count + 1
        name = base if count == 0 else f"{base}_{count}"
        nodes.append((name, type(layer).__name__, (prev,)))
        prev = name
    return nodes


def _histogram_event(wall_time: float, step: int, tag: str, values) -> bytes:
    # Summary.Value: tag=1, simple_value=2, image=4, histo=5 (TF
    # summary.proto oneof) — histograms MUST land in field 5.
    value = (_field_bytes(1, tag.encode("utf-8"))
             + _field_bytes(5, _histogram_proto(values)))
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, _field_bytes(1, value)))


class EventFileWriter:
    """Appends framed Event records to one events file in ``log_dir``."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()), socket.gethostname(), filename_suffix)
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        # imported here: data.tfrecord imports summary.crc32c, so a
        # module-level import would be circular
        from ..data.tfrecord import write_framed
        write_framed(self._file, payload)

    def add_scalars(self, scalars: Dict[str, float],
                    step: Union[int, float],
                    wall_time: Optional[float] = None) -> None:
        self._write_record(_scalar_event(
            wall_time if wall_time is not None else time.time(),
            int(step), {k: float(v) for k, v in scalars.items()}))

    def add_histogram(self, tag: str, values, step: Union[int, float],
                      wall_time: Optional[float] = None) -> None:
        """Histogram summary (e.g. a weight/gradient tensor per N steps)."""
        self._write_record(_histogram_event(
            wall_time if wall_time is not None else time.time(),
            int(step), tag, values))

    def add_image(self, tag: str, image, step: Union[int, float],
                  wall_time: Optional[float] = None) -> None:
        """Image summary: [h, w], [h, w, 1|3|4]; uint8 as-is, floats
        clipped from [0, 1] (tf.summary.image conventions)."""
        self._write_record(_image_event(
            wall_time if wall_time is not None else time.time(),
            int(step), tag, image))

    def add_text(self, tag: str, text: str, step: Union[int, float],
                 wall_time: Optional[float] = None) -> None:
        """Text summary (markdown, TB text plugin) — tf.summary.text
        parity; e.g. run config dumps or sample generations."""
        self._write_record(_text_event(
            wall_time if wall_time is not None else time.time(),
            int(step), tag, text))

    def add_audio(self, tag: str, audio, sample_rate: int,
                  step: Union[int, float],
                  wall_time: Optional[float] = None) -> None:
        """Audio summary (tf.summary.audio parity): float samples in
        [-1, 1], [frames] or [frames, channels]; written as PCM-16 WAV."""
        self._write_record(_audio_event(
            wall_time if wall_time is not None else time.time(),
            int(step), tag, audio, int(sample_rate)))

    def flush(self) -> None:
        self._file.flush()

    def add_graph(self, model_or_nodes,
                  wall_time: Optional[float] = None) -> None:
        """Write a model's topology as a TensorBoard graph event: a
        ``.layers`` model (``ops.Stack``) or an iterable of (name, op,
        inputs[, device]) node tuples."""
        nodes = (model_or_nodes if not hasattr(model_or_nodes, "layers")
                 else model_graph_nodes(model_or_nodes))
        self._write_record(_graph_event(
            wall_time if wall_time is not None else time.time(),
            _graph_def(list(nodes))))

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SummaryWriter:
    """User-facing scalar logger (the ``FileWriter`` analogue);
    ``add_scalar``/``add_scalars`` accept float steps."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = EventFileWriter(log_dir)

    def add_scalar(self, tag: str, value: float,
                   step: Union[int, float]) -> None:
        self._writer.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: Dict[str, float],
                    step: Union[int, float]) -> None:
        self._writer.add_scalars(scalars, step)

    def add_image(self, tag: str, image,
                  step: Union[int, float]) -> None:
        self._writer.add_image(tag, image, step)

    def add_histogram(self, tag: str, values,
                      step: Union[int, float]) -> None:
        self._writer.add_histogram(tag, values, step)

    def add_text(self, tag: str, text: str,
                 step: Union[int, float]) -> None:
        self._writer.add_text(tag, text, step)

    def add_audio(self, tag: str, audio, sample_rate: int,
                  step: Union[int, float]) -> None:
        self._writer.add_audio(tag, audio, sample_rate, step)

    def add_graph(self, model_or_nodes) -> None:
        self._writer.add_graph(model_or_nodes)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
