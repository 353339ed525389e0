"""Fixed-capacity LoRA adapter table: per-request adapters off one base.

Counterpart of ``distributed_tensorflow_tpu/serve/adapters.py``.  The
host-side manager of the stacked adapter table the serving entries read
(``GPT.init_lora_table``: ``[capacity + 1, L, ...]`` f32 leaves on the
model's device); row 0 is the zero adapter, so an ``adapter_id=None``
request adds an exact zero and its tokens equal an adapter-free
engine's.

Lifecycle::

    table = AdapterTable(model, capacity=4, rank=8)
    table.register("customer-a", adapter)  # host copy (GPT.init_lora layout)
    row = table.acquire("customer-a")      # copied into a device row, pinned
    ...                                    # decode under row
    table.release("customer-a")            # unpinned, stays resident

``acquire`` runs on the scheduler's pump at prefill begin: a resident
adapter is a dict hit; another is copied into a free row, or into the
least-recently-used UNPINNED row (an eviction).  When every row is
pinned it raises ``AdapterTableFull`` and the scheduler leaves the
request queued until a retirement unpins one.

Hot update: ``register`` of a RESIDENT id (any thread) builds a new
table with that row replaced and rebinds ``arrays`` (copy on write): a
tick in flight keeps reading the table it started with, so no request
decodes one tick with half of each version.  ``acquire`` writes its row
in place, which is safe because it runs on the pump, between device
calls, into a row no in-flight request holds.

Prefix namespaces: a request's K/V depend on its adapter, so the page
pool's radix tree keeps one namespace per adapter version
(``namespace``: a digest of the adapter's weights, ``b""`` for no
adapter).  Pages prefilled under one adapter are never matched by a
request under another, or under a hot-updated version of the same id;
two engines holding the same weights agree on the namespace, so shipped
pages still match across engines.

Metrics (``registry=``, default the process registry): the JAX package's
``dttpu_adapter_loads_total`` (row copies), ``dttpu_adapter_evictions_total``
and the ``dttpu_adapter_resident`` gauge.  ``evictions`` counts this
table's own evictions (the registry's counter sums every table's).
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional

import torch

from ..obs import metrics as metrics_lib

__all__ = ["AdapterTable", "AdapterTableFull"]


class AdapterTableFull(RuntimeError):
    """``acquire`` found no free or evictable row: every row is pinned
    by an in-flight request.  Transient: retry after a retirement."""


class AdapterTable:
    """Host-side manager of one device-resident stacked adapter table.

    ``capacity`` counts loadable adapters (the table has ``capacity + 1``
    rows).  ``arrays`` is the table the serving entries read; a hot
    update rebinds it, so a caller reads it once per device call."""

    def __init__(self, model, capacity: int, rank: int,
                 registry: Optional[metrics_lib.Registry] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.model = model
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.arrays = model.init_lora_table(capacity + 1, rank)
        # register() runs on controller threads while acquire()/release()
        # run on the pump: one lock keeps the maps and the table coherent
        self._lock = threading.Lock()
        self._store: Dict[str, dict] = {}     # id -> host (CPU) adapter
        self._digest: Dict[str, bytes] = {}   # id -> weights digest
        self._rows: Dict[str, int] = {}       # id -> resident row
        self._refs: Dict[str, int] = {}       # id -> in-flight pins
        self._used: Dict[str, int] = {}       # id -> LRU clock tick
        self._clock = 0
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self._loads = reg.counter(
            "dttpu_adapter_loads_total",
            "LoRA adapters spliced into a device table row.")
        self._evictions = reg.counter(
            "dttpu_adapter_evictions_total",
            "LoRA adapters evicted from the table (LRU, unpinned only).")
        self._resident = reg.gauge(
            "dttpu_adapter_resident",
            "LoRA adapters currently resident in the device table.")
        self.evictions = 0

    # ------------------------------------------------------------ intake

    def register(self, adapter_id: str, adapter) -> None:
        """Make ``adapter_id`` loadable (a host copy; the device copy
        happens at ``acquire``).  Re-registering a RESIDENT id replaces
        its row in a new table (the hot-update path)."""
        if not adapter_id:
            raise ValueError("adapter_id must be a non-empty string")
        self._check_shapes(adapter)
        host = {name: {ab: t.detach().to("cpu", torch.float32).clone()
                       for ab, t in leaves.items()}
                for name, leaves in adapter.items()}
        h = hashlib.blake2b(digest_size=8)
        for name in sorted(host):
            for ab in ("a", "b"):
                h.update(host[name][ab].contiguous().numpy().tobytes())
        with self._lock:
            self._store[adapter_id] = host
            self._digest[adapter_id] = h.digest()
            row = self._rows.get(adapter_id)
            if row is not None:
                fresh = {name: {ab: buf.clone() for ab, buf in leaves.items()}
                         for name, leaves in self.arrays.items()}
                self.arrays = self.model.lora_insert_row(fresh, row, host)
                self._loads.inc()

    def _check_shapes(self, adapter) -> None:
        want = self.model.lora_shapes(self.rank)
        L = self.model.config.num_layers
        if set(adapter) != set(want):
            raise ValueError(f"adapter targets {sorted(adapter)}, "
                             f"expected {sorted(want)}")
        for name, (a_shape, b_shape) in want.items():
            got_a = tuple(adapter[name]["a"].shape)
            got_b = tuple(adapter[name]["b"].shape)
            if got_a != (L,) + a_shape or got_b != (L,) + b_shape:
                raise ValueError(
                    f"adapter[{name!r}] shapes {got_a}/{got_b} do not "
                    f"match rank-{self.rank} layout "
                    f"{(L,) + a_shape}/{(L,) + b_shape}")

    def namespace(self, adapter_id: Optional[str]) -> bytes:
        """The prefix namespace of ``adapter_id``'s registered weights
        (``b""`` for None); ``KeyError`` for an unknown id."""
        if adapter_id is None:
            return b""
        with self._lock:
            return self._digest[adapter_id]

    def known(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._store

    @property
    def resident_ids(self):
        with self._lock:
            return tuple(self._rows)

    # ----------------------------------------------------------- pinning

    def acquire(self, adapter_id: Optional[str]) -> int:
        """Pin ``adapter_id`` and return its table row (0 for None).
        Copies a non-resident adapter into a free row, evicting the
        least-recently-used unpinned resident when the table is full;
        raises ``AdapterTableFull`` when every row is pinned."""
        if adapter_id is None:
            return 0
        with self._lock:
            if adapter_id not in self._store:
                raise KeyError(f"unknown adapter_id {adapter_id!r}; "
                               f"register() it first")
            self._clock += 1
            self._used[adapter_id] = self._clock
            row = self._rows.get(adapter_id)
            if row is None:
                row = self._free_row()
                self.model.lora_insert_row(self.arrays, row,
                                           self._store[adapter_id])
                self._rows[adapter_id] = row
                self._loads.inc()
                self._resident.set(len(self._rows))
            self._refs[adapter_id] = self._refs.get(adapter_id, 0) + 1
            return row

    def release(self, adapter_id: Optional[str]) -> None:
        """Unpin one ``acquire`` (the adapter stays resident for reuse
        until a later load evicts it)."""
        if adapter_id is None:
            return
        with self._lock:
            n = self._refs.get(adapter_id, 0)
            if n <= 1:
                self._refs.pop(adapter_id, None)
            else:
                self._refs[adapter_id] = n - 1

    def pinned(self) -> int:
        """Pins held by in-flight requests, over all adapters."""
        with self._lock:
            return sum(self._refs.values())

    def _free_row(self) -> int:
        used = set(self._rows.values())
        for row in range(1, self.capacity + 1):
            if row not in used:
                return row
        victims = [aid for aid in self._rows
                   if self._refs.get(aid, 0) == 0]
        if not victims:
            raise AdapterTableFull(
                f"all {self.capacity} adapter rows are pinned by "
                "in-flight requests")
        victim = min(victims, key=lambda aid: self._used.get(aid, 0))
        row = self._rows.pop(victim)
        self.evictions += 1
        self._evictions.inc()
        self._resident.set(len(self._rows))
        # no scrub: the caller overwrites the whole row next
        return row
