"""The port's image datasets and augmentation, byte-equal to the JAX
package's.

- ``synthetic_image_classes`` at MNIST's and CIFAR-10's shapes (a few
  hundred rows) and ``mnist(None, flatten=...)`` at its full 60,000 +
  10,000 rows: arrays byte-equal, same dtypes; ``cifar10(None)`` asks the
  same synthetic set (its arguments recorded from both packages).
- The readers on files the test writes: MNIST as the four IDX files
  (plain and ``.gz``) and as ``mnist.npz``, an incomplete IDX set (the
  warning and the synthetic fallback), CIFAR-10 as
  ``cifar-10-batches-py/`` pickles and as ``cifar10.npz``: byte-equal, and
  ``provenance`` says ``real`` or ``synthetic`` as the JAX package does.
- ``compose``, ``on_images``, ``random_flip_lr``, ``random_crop``,
  ``normalize`` and ``cutout`` on one batch from one generator seed:
  byte-equal outputs; and through ``Dataset(transform=...)`` two epochs
  of batches byte-equal to the JAX package's ``Dataset``.
"""
import gzip
import pickle
import struct

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import augment as jaug
from distributed_tensorflow_tpu.data import datasets as jds
from distributed_tensorflow_tpu.data import pipeline as jpipe
from distributed_tensorflow_tpu_torch.data import augment as taug
from distributed_tensorflow_tpu_torch.data import datasets as tds
from distributed_tensorflow_tpu_torch.data import pipeline as tpipe

torch.set_num_threads(1)


def _equal(got, want):
    """Nested tuples of arrays, byte-equal with equal dtypes."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape,seed", [((28, 28, 1), 0), ((32, 32, 3), 3),
                                        ((8,), 1)])
def test_synthetic_image_classes_equal(shape, seed):
    _equal(tds.synthetic_image_classes(shape, 10, 300, 50, seed=seed),
           jds.synthetic_image_classes(shape, 10, 300, 50, seed=seed))


@pytest.mark.parametrize("flatten", [False, True])
def test_mnist_synthetic_fallback_equal(flatten):
    got = tds.mnist(None, flatten=flatten, seed=2)
    _equal(got, jds.mnist(None, flatten=flatten, seed=2))
    assert got[0][0].shape == ((60000, 784) if flatten
                               else (60000, 28, 28, 1))
    assert tds.provenance("mnist") == jds.provenance("mnist") == "synthetic"


def test_cifar10_synthetic_fallback_asks_the_same_set(monkeypatch):
    calls = []
    for lib in (tds, jds):
        monkeypatch.setattr(lib, "synthetic_image_classes",
                            lambda *a, **kw: calls.append((a, kw)))
        lib.cifar10(None, seed=5)
    assert calls[0] == calls[1] == (((32, 32, 3),), dict(
        num_classes=10, train_n=50000, test_n=10000, seed=5))
    assert tds.provenance("cifar10") == jds.provenance("cifar10")
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.provenance("svhn", "/nowhere")


def _idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def _mnist_arrays(rng, n=20, m=6):
    return (rng.integers(0, 256, (n, 28, 28)), rng.integers(0, 10, n),
            rng.integers(0, 256, (m, 28, 28)), rng.integers(0, 10, m))


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_files_equal(tmp_path, gz):
    rng = np.random.default_rng(0)
    names = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    for name, arr in zip(names, _mnist_arrays(rng)):
        _idx(str(tmp_path / name), arr, gz)
    d = str(tmp_path)
    got = tds.mnist(d, flatten=True)
    _equal(got, jds.mnist(d, flatten=True))
    assert got[0][0].shape == (20, 784)
    assert tds.provenance("mnist", d) == jds.provenance("mnist", d) == "real"


def test_mnist_npz_and_incomplete_idx(tmp_path):
    rng = np.random.default_rng(1)
    xt, yt, xe, ye = _mnist_arrays(rng)
    np.savez(tmp_path / "mnist.npz", x_train=xt.astype(np.uint8),
             y_train=yt, x_test=xe.astype(np.uint8), y_test=ye)
    d = str(tmp_path)
    _equal(tds.mnist(d), jds.mnist(d))
    inc = tmp_path / "inc"
    inc.mkdir()
    _idx(str(inc / "train-images-idx3-ubyte"), xt)
    assert tds.provenance("mnist", str(inc)) == \
        jds.provenance("mnist", str(inc)) == "synthetic"
    with pytest.warns(UserWarning, match="missing other IDX files"):
        got = tds.mnist(str(inc), seed=1)
    assert got[0][0].shape == (60000, 28, 28, 1)


def test_cifar10_pickles_and_npz_equal(tmp_path):
    rng = np.random.default_rng(2)
    batches = tmp_path / "pk" / "cifar-10-batches-py"
    batches.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(batches / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072)).astype(
                np.uint8), b"labels": list(rng.integers(0, 10, 4))}, f)
    d = str(tmp_path / "pk")
    got = tds.cifar10(d)
    _equal(got, jds.cifar10(d))
    assert got[0][0].shape == (20, 32, 32, 3)
    assert tds.provenance("cifar10", d) == "real"
    np.savez(tmp_path / "cifar10.npz",
             x_train=rng.integers(0, 256, (5, 32, 32, 3)).astype(np.uint8),
             y_train=rng.integers(0, 10, 5),
             x_test=rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8),
             y_test=rng.integers(0, 10, 3))
    d = str(tmp_path)
    _equal(tds.cifar10(d), jds.cifar10(d))
    assert tds.provenance("cifar10", d) == jds.provenance("cifar10", d)


def _pipelines(lib):
    return {
        "crop_flip": lib.compose(lib.random_crop(4), lib.random_flip_lr()),
        "flip_p": lib.random_flip_lr(0.3),
        "crop_2": lib.random_crop(2),
        "normalize": lib.normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3]),
        "cutout": lib.cutout(8, prob=0.7),
        "on_images": lib.on_images(lambda rng, x: x * rng.random()),
        "all": lib.compose(lib.random_crop(4), lib.random_flip_lr(),
                           lib.cutout(6),
                           lib.normalize([0.5] * 3, [0.25] * 3)),
    }


@pytest.mark.parametrize("name", sorted(_pipelines(taug)))
def test_augment_equal(name):
    x = np.random.default_rng(0).random((16, 32, 32, 3)).astype(np.float32)
    y = np.arange(16, dtype=np.int32)
    got = _pipelines(taug)[name](np.random.default_rng(7), (x, y))
    want = _pipelines(jaug)[name](np.random.default_rng(7), (x, y))
    _equal(tuple(got), tuple(want))
    assert not np.shares_memory(got[0], x)


def test_augmented_dataset_batches_equal():
    (x, y), _ = tds.synthetic_image_classes((32, 32, 3), 10, 100, 1, seed=0)
    kw = dict(batch_size=32, seed=4)
    t = tpipe.Dataset([x, y], transform=_pipelines(taug)["crop_flip"], **kw)
    j = jpipe.Dataset([x, y], transform=_pipelines(jaug)["crop_flip"],
                      backend="numpy", **kw)
    for _ in range(2):
        got, want = list(t), list(j)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _equal(tuple(g), tuple(w))
