"""The port's host C++ data routines held against the JAX package's.

- ``utils.native.bpe_encode`` (``csrc/bpe.cpp``) gives the ids of the
  Python merge loop and of the JAX package's ``utils.native.bpe_encode``.
- ``utils.native.NativeLoader`` (``csrc/loader.cpp``) gives the JAX
  package's ``NativeLoader`` batches, batch for batch, for the same seed
  (the same xoshiro stream): shuffled over several epochs, in order
  without shuffle, with and without labels, and under many threads and a
  shallow ring over many epochs; every epoch covers each row once and
  the next epoch reshuffles.
- ``data.Dataset(backend=...)``: "native" and "auto" equal the JAX
  package's batches over two epochs; "auto" takes the numpy route where
  the shape does not fit the loader; the refusals.
- ``data.tfrecord_batches`` equals the JAX package's on files the test
  writes (no shuffle, a shuffle buffer of 8, 2 processes, the remainder
  kept), and ``py_masked_crc32c`` equals the JAX package's.

All comparisons are exact.  Skipped only where the JAX package's native
library cannot build, as ``tests/test_native.py`` skips.
"""
import struct

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import pipeline as jpipe
from distributed_tensorflow_tpu.data import tfrecord as jrec
from distributed_tensorflow_tpu.summary.crc32c import \
    py_masked_crc32c as jpy_masked_crc32c
from distributed_tensorflow_tpu.utils import native as jnative
from distributed_tensorflow_tpu_torch.data import (Dataset, tfrecord_batches,
                                                   write_tfrecord)
from distributed_tensorflow_tpu_torch.data.text import BPETokenizer
from distributed_tensorflow_tpu_torch.summary.crc32c import (
    masked_crc32c, py_masked_crc32c)
from distributed_tensorflow_tpu_torch.utils import native

torch.set_num_threads(1)

TEXT = ("the quick brown fox jumps over the lazy dog. " * 8
        + "café — 中文 \U0001f600 naïve ünïcödé 12345 ")


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.native_available():
        pytest.skip("the JAX package's native library cannot build here")
    assert native.native_available()


def _tokenizer():
    return BPETokenizer.train([TEXT], 330)


@pytest.mark.parametrize("text", ["", "a", TEXT, TEXT[::-1] * 3,
                                  "\x00\xff" * 17 + "the the the"])
def test_bpe_encode_equals_the_loop_and_the_jax_native(jax_native, text):
    tok = _tokenizer()
    raw = text.encode("utf-8")
    got = native.bpe_encode(raw, tok._merge_array, tok._base)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tok.encode(text, backend="python"))
    np.testing.assert_array_equal(
        got, jnative.bpe_encode(raw, tok._merge_array, tok._base))
    no_merges = native.bpe_encode(raw, np.zeros((0, 2), np.int32), 259)
    np.testing.assert_array_equal(no_merges, np.frombuffer(raw, np.uint8))


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 2)).astype(np.float32),
            np.arange(n, dtype=np.int32))


def _batches(loader, k):
    return [loader.next() for _ in range(k)]


@pytest.mark.parametrize("shuffle,labels", [(True, True), (False, True),
                                            (True, False)])
def test_loader_equals_the_jax_loader_batch_for_batch(jax_native, shuffle,
                                                      labels):
    x, y = _arrays(203)
    y = y if labels else None
    kw = dict(batch_size=16, seed=11, shuffle=shuffle, num_threads=3,
              queue_depth=5)
    got = native.NativeLoader(x, y, **kw)
    want = jnative.NativeLoader(x, y, **kw)
    assert got.batches_per_epoch == want.batches_per_epoch == 12
    try:
        for g, w in zip(_batches(got, 12 * 3 + 5), _batches(want, 12 * 3 + 5)):
            assert len(g) == len(w) == (2 if labels else 1)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    finally:
        got.close()
        want.close()


def test_loader_epochs_cover_every_row_and_reshuffle(jax_native):
    x, y = _arrays(96)
    loader = native.NativeLoader(x, y, 8, seed=3)
    try:
        epochs = [np.concatenate([b[1] for b in loader]) for _ in range(3)]
    finally:
        loader.close()
    for order in epochs:
        assert sorted(order.tolist()) == list(range(96))
    assert not np.array_equal(epochs[0], epochs[1])
    ordered = native.NativeLoader(x, y, 8, shuffle=False)
    try:
        np.testing.assert_array_equal(
            np.concatenate([b[1] for b in ordered]), np.arange(96))
        np.testing.assert_array_equal(ordered.next()[0], x[:8])
    finally:
        ordered.close()


def test_loader_stress_many_threads_and_epochs(jax_native):
    x, y = _arrays(61, seed=2)
    kw = dict(batch_size=4, seed=123456789, num_threads=8, queue_depth=2)
    got = native.NativeLoader(x, y, **kw)
    want = jnative.NativeLoader(x, y, **kw)
    try:
        for _ in range(40 * 15):
            for a, b in zip(got.next(), want.next()):
                np.testing.assert_array_equal(a, b)
    finally:
        got.close()
        want.close()
    got.close()                       # closing twice is harmless
    with pytest.raises(RuntimeError, match="closed"):
        got.next()
    with pytest.raises(ValueError, match="loader_create"):
        native.NativeLoader(x, y, 62)


@pytest.mark.parametrize("backend,arrays,kw", [
    ("native", 2, dict(batch_size=12, seed=4)),
    ("native", 1, dict(batch_size=5, seed=9, shuffle=False)),
    ("auto", 2, dict(batch_size=12, seed=4)),
    ("auto", 3, dict(batch_size=12, seed=4)),
    ("auto", 2, dict(batch_size=12, seed=4, drop_remainder=False)),
    ("auto", 1, dict(batch_size=120, seed=4, drop_remainder=False)),
])
def test_dataset_backends_equal_the_jax_dataset(jax_native, backend, arrays,
                                                kw):
    x, y = _arrays(100, seed=5)
    data = [x, y, y * 2][:arrays]
    got = list(Dataset(data, backend=backend, **kw).epochs(2))
    want = list(jpipe.Dataset(data, backend=backend, **kw).epochs(2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    fits = arrays < 3 and kw.get("drop_remainder", True) and \
        kw["batch_size"] <= 100
    numpy_route = list(Dataset(data, backend="numpy", **kw).epochs(2))
    same = all(all(np.array_equal(a, b) for a, b in zip(g, w))
               for g, w in zip(got, numpy_route))
    assert same == (not fits or not kw.get("shuffle", True))


def test_dataset_native_refusals(jax_native, monkeypatch):
    x, y = _arrays(20)
    with pytest.raises(ValueError, match="unknown backend"):
        Dataset([x], 4, backend="torch")
    for data, kw in (([x, y, y], {}), ([x], dict(drop_remainder=False)),
                     ([x], dict(batch_size=21))):
        kw.setdefault("batch_size", 4)
        with pytest.raises(ValueError, match="backend='native'"):
            Dataset(data, backend="native", **kw)
    monkeypatch.setattr(native, "native_available", lambda: False)
    for backend in ("native", "auto"):
        with pytest.raises(RuntimeError, match="cannot be built"):
            Dataset([x, y], 4, backend=backend)
    # the numpy route needs no library, and "auto" takes it for shapes
    # the loader does not fit
    assert len(list(Dataset([x, y, y], 4, backend="auto"))) == 5
    assert len(list(Dataset([x], 4, backend="numpy"))) == 5


def _write_records(tmp_path, n_files=3, per_file=13):
    paths = []
    for f in range(n_files):
        recs = [struct.pack("<if", f * 100 + i, f + i / 8.0) + bytes([i])
                for i in range(per_file)]
        paths.append(str(tmp_path / f"part-{f}.tfrecord"))
        write_tfrecord(paths[-1], recs)
    return paths


def _parse_dict(rec):
    i, v = struct.unpack("<if", rec[:8])
    return {"id": np.int32(i), "pair": np.array([v, -v], np.float32),
            "tail": (np.uint8(rec[8]), np.array([rec[8]] * 2, np.int64))}


def _parse_tuple(rec):
    i, v = struct.unpack("<if", rec[:8])
    return (np.array([i, i + 1], np.int32), [np.float32(v)])


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=5, shuffle_buffer=8, seed=3, epoch=2),
    dict(batch_size=3, process_index=0, process_count=2),
    dict(batch_size=3, process_index=1, process_count=2, shuffle_buffer=8),
    dict(batch_size=7, drop_remainder=False, shuffle_buffer=8, epoch=1),
])
@pytest.mark.parametrize("parse", [_parse_dict, _parse_tuple])
def test_tfrecord_batches_equal_the_jax_batches(tmp_path, kw, parse):
    paths = _write_records(tmp_path)
    got = list(tfrecord_batches(paths, parse, **kw))
    want = list(jrec.tfrecord_batches(paths, parse, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g) is type(w)
        gl, wl = _leaves(g), _leaves(w)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="process_index"):
        next(tfrecord_batches(paths, parse, 2, process_index=2,
                              process_count=2))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_tfrecord_batches_shard_disjoint_equal_streams(tmp_path):
    paths = _write_records(tmp_path, n_files=2, per_file=11)
    ids = [np.concatenate([b["id"] for b in tfrecord_batches(
        paths, _parse_dict, 1, process_index=r, process_count=3)])
        for r in range(3)]
    assert [len(s) for s in ids] == [22 // 3] * 3
    assert len(set(np.concatenate(ids).tolist())) == 21


@pytest.mark.parametrize("data", [b"", b"a", b"123456789",
                                  bytes(range(256)) * 3])
def test_py_masked_crc32c_equals_the_jax_package(data):
    want = jpy_masked_crc32c(data)
    assert py_masked_crc32c(data) == want
    assert masked_crc32c(data) == want
