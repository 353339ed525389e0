"""Datasets: MNIST / CIFAR-10 loaders and synthetic stand-ins, and
synthetic token streams.

A numpy copy of ``distributed_tensorflow_tpu/data/datasets.py`` (the port
imports nothing of the JAX package); same seed, same arrays.

Two-tier path resolution: if standard dataset files exist under
``data_dir`` they are loaded; otherwise a procedural synthetic stand-in
with the same shapes and dtypes is generated.  The synthetic sets are
class-conditional (one smoothed random prototype per class + noise), so
they are learnable: convergence checks and examples/s behave like the
real task on a machine with no dataset and no network.
``provenance`` says which of the two a loader returns.

Supported on-disk formats in ``data_dir``:
  * MNIST: the four classic IDX files (``train-images-idx3-ubyte`` etc.,
    optionally ``.gz``), or ``mnist.npz`` (Keras layout).
  * CIFAR-10: ``cifar-10-batches-py/`` pickled batches, or ``cifar10.npz``.

For causal-LM training: ``synthetic_lm_corpus`` (a fixed random Markov
chain, 80% deterministic continuation) and ``lm_sequences`` (rows of
``seq_len + 1`` ids).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["mnist", "cifar10", "synthetic_image_classes", "provenance",
           "synthetic_lm_corpus", "lm_sequences"]

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def synthetic_image_classes(shape, num_classes: int, train_n: int, test_n: int,
                            seed: int = 0, noise: float = 0.35) -> Arrays:
    """Class-prototype images + gaussian noise, normalized to [0, 1]."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.0, 1.0, size=(num_classes,) + tuple(shape))
    # Smooth the prototypes a little so conv models have spatial structure.
    if len(shape) >= 2:
        for _ in range(2):
            protos = 0.5 * protos + 0.25 * (np.roll(protos, 1, axis=1) +
                                            np.roll(protos, -1, axis=1))

    def make(n, split_seed):
        r = np.random.default_rng((seed, split_seed))
        y = r.integers(0, num_classes, size=n)
        x = protos[y] + noise * r.standard_normal((n,) + tuple(shape))
        return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)

    return make(train_n, 1), make(test_n, 2)




def synthetic_lm_corpus(vocab_size: int = 256, length: int = 1_000_000,
                        seed: int = 0, order: int = 2) -> np.ndarray:
    """Deterministic synthetic token stream with learnable structure.

    A fixed random Markov chain over the last ``order`` tokens (1 or 2 —
    higher values are clamped to 2): 80% of positions follow the chain's
    deterministic continuation, 20% are noise.  Same seed → same corpus, no
    downloads; a causal LM that learns it drops well below the uniform
    log(vocab) loss, so training scripts have a real convergence signal.
    The context table is hashed into at most 2^16 buckets, so memory stays
    bounded for any vocab size.  Returns int32 [length].
    """
    rng = np.random.default_rng(seed)
    order = 1 if order <= 1 else 2
    h_mod = vocab_size if order == 1 else min(vocab_size * vocab_size,
                                              1 << 16)
    table = rng.integers(0, vocab_size, size=h_mod).tolist()
    noise = rng.random(length).tolist()
    # plain-int list arithmetic: ~10x faster than per-element numpy scalars
    out = [int(t) for t in rng.integers(0, vocab_size, order)]
    for i in range(order, length):
        ctx = (out[-1] % h_mod if order == 1
               else (out[-1] * 31 + out[-2]) % h_mod)
        if noise[i] < 0.8:           # 80% deterministic continuation
            out.append(table[ctx])
        else:
            out.append(int(noise[i] * 1e9) % vocab_size)
    return np.asarray(out, np.int32)


def lm_sequences(corpus: np.ndarray, seq_len: int) -> np.ndarray:
    """Chop a token stream into [n, seq_len+1] rows (inputs ++ next-token
    target at each position via shift-by-one).  A corpus shorter than
    ``seq_len + 1`` yields an empty [0, seq_len+1] array."""
    n = (len(corpus) - 1) // seq_len
    if n <= 0:
        return np.zeros((0, seq_len + 1), np.int32)
    x = corpus[:n * seq_len + 1]
    rows = np.stack([x[i * seq_len:(i + 1) * seq_len + 1] for i in range(n)])
    return rows.astype(np.int32)


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find(data_dir: str, names) -> Optional[str]:
    for name in names:
        for cand in (name, name + ".gz"):
            path = os.path.join(data_dir, cand)
            if os.path.exists(path):
                return path
    return None


_MNIST_IDX_NAMES = (["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
                    ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
                    ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
                    ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])


def provenance(dataset: str, data_dir: Optional[str] = None) -> str:
    """``"real"`` when the on-disk files ``mnist()``/``cifar10()`` would
    load exist under ``data_dir``, else ``"synthetic"`` (the procedural
    class-prototype stand-ins).  Benchmarks label their JSON output with
    this so a throughput/accuracy number can never silently pass off the
    synthetic task as the real dataset."""
    if not data_dir:
        return "synthetic"
    if dataset == "mnist":
        if _find(data_dir, ["mnist.npz"]):
            return "real"
        return ("real" if all(_find(data_dir, names)
                              for names in _MNIST_IDX_NAMES) else "synthetic")
    if dataset == "cifar10":
        if (_find(data_dir, ["cifar10.npz"]) or
                os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py"))):
            return "real"
        return "synthetic"
    raise ValueError(f"unknown dataset {dataset!r}; choices: mnist, cifar10")


def mnist(data_dir: Optional[str] = None, flatten: bool = False,
          seed: int = 0) -> Arrays:
    """(x_train, y_train), (x_test, y_test); images float32 [0,1] 28x28x1."""
    loaded = None
    if data_dir:
        npz = _find(data_dir, ["mnist.npz"])
        xi = _find(data_dir, _MNIST_IDX_NAMES[0])
        if npz:
            with np.load(npz) as z:
                loaded = ((z["x_train"], z["y_train"]),
                          (z["x_test"], z["y_test"]))
        elif xi:
            rest = [_find(data_dir, names) for names in _MNIST_IDX_NAMES[1:]]
            if all(rest):
                yt_p, xe_p, ye_p = rest
                loaded = ((_read_idx(xi), _read_idx(yt_p)),
                          (_read_idx(xe_p), _read_idx(ye_p)))
            else:
                import warnings
                warnings.warn(
                    f"mnist: {data_dir} has train images but is missing "
                    "other IDX files; falling back to the synthetic set")
    if loaded is not None:
        (xt, yt), (xe, ye) = loaded
        def norm(x):
            x = x.astype(np.float32) / 255.0
            return x.reshape(x.shape[0], 28, 28, 1)
        train = (norm(xt), yt.astype(np.int32))
        test = (norm(xe), ye.astype(np.int32))
    else:
        train, test = synthetic_image_classes(
            (28, 28, 1), num_classes=10, train_n=60000, test_n=10000,
            seed=seed)
    if flatten:
        train = (train[0].reshape(train[0].shape[0], -1), train[1])
        test = (test[0].reshape(test[0].shape[0], -1), test[1])
    return train, test


def cifar10(data_dir: Optional[str] = None, seed: int = 0) -> Arrays:
    """(x_train, y_train), (x_test, y_test); images float32 [0,1] 32x32x3."""
    if data_dir:
        npz = _find(data_dir, ["cifar10.npz"])
        batches = os.path.join(data_dir, "cifar-10-batches-py")
        if npz:
            with np.load(npz) as z:
                return ((z["x_train"].astype(np.float32) / 255.0,
                         z["y_train"].astype(np.int32)),
                        (z["x_test"].astype(np.float32) / 255.0,
                         z["y_test"].astype(np.int32)))
        if os.path.isdir(batches):
            def load_batch(name):
                with open(os.path.join(batches, name), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                return x, np.asarray(d[b"labels"])
            xs, ys = zip(*[load_batch(f"data_batch_{i}") for i in range(1, 6)])
            xt, yt = np.concatenate(xs), np.concatenate(ys)
            xe, ye = load_batch("test_batch")
            return ((xt.astype(np.float32) / 255.0, yt.astype(np.int32)),
                    (xe.astype(np.float32) / 255.0, ye.astype(np.int32)))
    return synthetic_image_classes((32, 32, 3), num_classes=10,
                                   train_n=50000, test_n=10000, seed=seed)
