"""Host-side input pipeline: shuffled minibatches over in-memory arrays.

Counterpart of ``distributed_tensorflow_tpu/data/pipeline.py``
``Dataset`` with its ``"numpy"`` backend: the documented ``(seed, epoch)``
numpy shuffle stream, so the port and the JAX package see the same
batches in the same order.  Each epoch reshuffles; ``process_count > 1``
keeps this process's contiguous shard.  The native C++ loader backend
(``"auto"``, ``"native"``) and ``prefetch_to_device`` are not ported:
batches are numpy arrays, which the caller moves to the card
(``torch.from_numpy(b).to(device)``).
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

__all__ = ["Dataset"]


class Dataset:
    """In-memory dataset of aligned arrays with shuffled minibatch
    iteration; ``transform(rng, batch) -> batch`` runs on each batch with
    a ``(seed, epoch, 1)`` generator."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, backend: str = "numpy",
                 transform=None):
        if backend != "numpy":
            raise ValueError(f"backend {backend!r}: the port has only the "
                             "'numpy' backend")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the leading dim")
        if process_count > 1:
            shard = n // process_count
            lo = process_index * shard
            arrays = [a[lo:lo + shard] for a in arrays]
            n = shard
        self.arrays = list(arrays)
        self.n = n
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        self.epoch = 0
        self.transform = transform

    @property
    def batches_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __len__(self) -> int:
        return self.batches_per_epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(
                self.n)
        else:
            order = np.arange(self.n)
        t_rng = np.random.default_rng((self.seed, self.epoch, 1))
        self.epoch += 1
        stop = (self.n - self.batch_size + 1 if self.drop_remainder
                else self.n)
        for lo in range(0, stop, self.batch_size):
            idx = order[lo:lo + self.batch_size]
            batch = tuple(a[idx] for a in self.arrays)
            yield batch if self.transform is None \
                else self.transform(t_rng, batch)

    def epochs(self, num_epochs: int) -> Iterator[Tuple[np.ndarray, ...]]:
        for _ in range(num_epochs):
            yield from self
