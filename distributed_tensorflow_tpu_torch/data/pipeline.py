"""Input pipeline: shuffled minibatches over in-memory arrays, and their
prefetch to the card.

Counterpart of ``distributed_tensorflow_tpu/data/pipeline.py``:

  * ``Dataset``: with its ``"numpy"`` backend (the default), the
    documented ``(seed, epoch)`` numpy shuffle stream, so the port and the
    JAX package see the same batches in the same order.  ``"native"``
    runs one ``utils.native.NativeLoader`` (threaded gather in host C++,
    ``csrc/loader.cpp``) an epoch, seeded ``seed * 1_000_003 + epoch``:
    the JAX package's native batches, batch for batch.  ``"auto"`` takes
    the native route where the shape fits it (one or two arrays, full
    batches, ``n >= batch_size``) and the numpy route elsewhere, as the
    JAX package does; where the shape fits but the loader cannot be
    built, the port raises instead of taking the numpy route (its shuffle
    stream differs).  Each epoch reshuffles; ``process_count > 1`` keeps
    this process's contiguous shard.
  * ``prefetch_to_device``: a background thread stages upcoming batches
    on the device while the current step computes.  On a card it copies
    each batch from pinned host memory on a side stream and records an
    event after the copy; the consumer's (compute) stream waits for that
    event before the batch is handed over, and each tensor is marked as
    used on that stream (``record_stream``), so the caching allocator
    does not reuse its memory before the compute stream is done with
    it.  As in the JAX package, the active fault plan sees each batch in
    the producer (``on_batch``: ``poison_batch``, ``kill_prefetch``,
    whose error the consumer re-raises), and the consumer's blocking
    wait for the next batch is goodput's ``data_stall``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs import goodput as goodput_lib
from ..resilience import faults as faults_lib

__all__ = ["Dataset", "prefetch_to_device"]


class Dataset:
    """In-memory dataset of aligned arrays with shuffled minibatch
    iteration; ``transform(rng, batch) -> batch`` runs on each batch with
    a ``(seed, epoch, 1)`` generator."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, backend: str = "numpy",
                 transform=None):
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
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
        self.backend = backend
        if backend == "native" and not self._native_fits():
            raise ValueError(
                "backend='native' takes one or two arrays in full batches "
                f"(drop_remainder=True, n >= batch_size); got "
                f"{len(self.arrays)} arrays, n={n}, batch_size="
                f"{self.batch_size}, drop_remainder={drop_remainder}")
        if backend != "numpy" and self._native_fits():
            from ..utils import native
            if not native.native_available():
                raise RuntimeError(
                    f"backend={backend!r}: the native loader "
                    "(csrc/loader.cpp) cannot be built here; "
                    "backend='numpy' is the portable route")
        self.transform = transform

    def _native_fits(self) -> bool:
        """Whether the native loader takes this dataset's shape."""
        return (len(self.arrays) in (1, 2) and self.drop_remainder
                and self.n >= self.batch_size)

    @property
    def batches_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __len__(self) -> int:
        return self.batches_per_epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        if self.backend != "numpy" and self._native_fits():
            yield from self._iter_native()
            return
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

    def _iter_native(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """One epoch through a fresh ``NativeLoader`` seeded with the
        epoch folded in, so each epoch reshuffles and an epoch left early
        leaves nothing behind."""
        from ..utils import native
        x = self.arrays[0]
        y = self.arrays[1] if len(self.arrays) == 2 else None
        seed = (self.seed * 1_000_003 + self.epoch) & 0xFFFFFFFFFFFFFFFF
        t_rng = np.random.default_rng((self.seed, self.epoch, 1))
        self.epoch += 1
        loader = native.NativeLoader(x, y, self.batch_size, seed=seed,
                                     shuffle=self.shuffle)
        try:
            for _ in range(loader.batches_per_epoch):
                batch = loader.next()
                yield batch if self.transform is None \
                    else self.transform(t_rng, batch)
        finally:
            loader.close()

    def epochs(self, num_epochs: int) -> Iterator[Tuple[np.ndarray, ...]]:
        for _ in range(num_epochs):
            yield from self


def _tensors(item, fn):
    """``fn`` of every array of a batch (an array, or a tuple, list or
    dict of them), in the batch's structure."""
    if isinstance(item, dict):
        return {k: _tensors(v, fn) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_tensors(v, fn) for v in item)
    return fn(item)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Iterator:
    """Stage the batches of ``iterator`` (numpy arrays or tensors, alone or
    in tuples, lists or dicts) on ``device`` from a background thread;
    yields them as tensors in the same structure.

    At most ``size`` staged batches exist at a time: the producer takes a
    ticket before it copies a batch and the consumer returns it when it
    asks for the next one.  On a card the copy runs on a side stream from
    pinned memory, and the batch is handed to the consumer's current
    stream through an event (``wait_event``) and ``record_stream``; see
    the module docstring.  The consumer may abandon the generator at any
    point (``break``, ``.close()``, garbage collection): the producer is
    woken and ends.  An error in the producer is raised on the consumer's
    side."""
    device = torch.device(device)
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(device)
    handoff: queue.Queue = queue.Queue()
    tickets = threading.Semaphore(size)
    stop = threading.Event()
    done = object()
    err: list = []

    def stage(a):
        t = torch.as_tensor(a)
        if not cuda:
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def producer():
        try:
            for item in iterator:
                plan = faults_lib.active()
                if plan is not None:
                    # may poison this batch or kill this producer (the
                    # raise lands in err and the consumer re-raises it)
                    item = plan.on_batch(item)
                tickets.acquire()
                # checked after acquire: an abandoning consumer releases
                # a ticket once to unblock exactly this wait
                if stop.is_set():
                    return
                if not cuda:
                    handoff.put((_tensors(item, stage), None))
                    continue
                with torch.cuda.device(device), torch.cuda.stream(side):
                    staged = _tensors(item, stage)
                    ready = torch.cuda.Event()
                    ready.record(side)
                handoff.put((staged, ready))
        except Exception as e:  # raised on the consumer's side
            err.append(e)
        finally:
            handoff.put(done)

    thread = threading.Thread(target=producer, daemon=True,
                              name="dttpu-torch-prefetch")
    thread.start()
    try:
        while True:
            # the consumer's blocking wait IS the input starvation; closed
            # before the yield, so the caller's step never lands here
            with goodput_lib.account("data_stall"):
                got = handoff.get()
            if got is done:
                if err:
                    raise err[0]
                return
            staged, ready = got
            if ready is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                _tensors(staged, lambda t: t.record_stream(compute))
            yield staged
            tickets.release()
    finally:
        stop.set()
        tickets.release()
        thread.join(timeout=5.0)
