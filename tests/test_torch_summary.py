"""The port's TensorBoard event files and record framing, held against
the JAX package's ``summary/event_writer.py`` and ``data/tfrecord.py``.

With the wall clock and the host name fixed, the port's
``SummaryWriter`` writes the same bytes (file name included) as the JAX
package's for scalars (int and fractional steps), histograms (spread,
degenerate, with non-finite entries), text, images (grey, RGB, RGBA;
uint8 and float) and audio (mono and stereo).  The records read back
through the port's ``read_tfrecord`` with both checksums verified, and
a flipped byte is reported.
"""
import os
import socket
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import tfrecord as jrec
from distributed_tensorflow_tpu.summary import SummaryWriter as JWriter
from distributed_tensorflow_tpu_torch.data import tfrecord as trec
from distributed_tensorflow_tpu_torch.summary import SummaryWriter

torch.set_num_threads(1)


def _write(cls, log_dir):
    rng = np.random.default_rng(0)
    with cls(str(log_dir)) as w:
        w.add_scalar("loss", 2.5, 1)
        w.add_scalars({"loss": 1.25, "acc": 0.5, "lr": 3e-4}, 2.75)
        w.add_histogram("w", rng.standard_normal(1000), 3)
        w.add_histogram("const", np.full(7, 0.5), 3)
        w.add_histogram("bad", np.array([1.0, np.nan, np.inf, 2.0]), 4)
        w.add_text("config", "lr: **3e-4**, batch 48", 4)
        w.add_image("grey", rng.integers(0, 256, (5, 7)).astype(np.uint8), 5)
        w.add_image("rgb", rng.random((4, 6, 3)), 5)
        w.add_image("rgba", rng.integers(0, 300, (3, 3, 4)), 5)
        w.add_audio("mono", np.sin(np.linspace(0, 20, 400)), 8000, 6)
        w.add_audio("stereo", rng.uniform(-1.2, 1.2, (100, 2)), 16000, 6)
    files = os.listdir(log_dir)
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0]), "rb") as f:
        return files[0], f.read()


def test_event_files_are_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "trainer-0")
    got = _write(SummaryWriter, tmp_path / "port")
    want = _write(JWriter, tmp_path / "jax")
    assert got[0] == want[0] == "events.out.tfevents.1700000000.trainer-0"
    assert got[1] == want[1]
    path = tmp_path / "port" / got[0]
    records = list(trec.read_tfrecord(str(path)))
    assert records == list(jrec.read_tfrecord(str(path)))
    assert len(records) == 12 and b"brain.Event:2" in records[0]


def test_framing_round_trips_and_detects_corruption(tmp_path):
    payloads = [b"", b"x", bytes(range(256)) * 40]
    path = str(tmp_path / "r.tfrecord")
    assert trec.write_tfrecord(path, payloads) == 3
    assert list(trec.read_tfrecord(path)) == payloads
    jpath = str(tmp_path / "j.tfrecord")
    jrec.write_tfrecord(jpath, payloads)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    data = bytearray(open(path, "rb").read())
    data[-10] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="data crc mismatch"):
        list(trec.read_tfrecord(path))
    assert len(list(trec.read_tfrecord(path, verify=False))) == 3
    open(path, "wb").write(bytes(data[:-3]))
    with pytest.raises(IOError, match="truncated"):
        list(trec.read_tfrecord(path))
