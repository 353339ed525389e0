"""Slot scheduler: admission, chunked prefill, decode ticks, retirement.

Counterpart of ``distributed_tensorflow_tpu/serve/scheduler.py``, with
its two storage layouts behind one state machine (``paged=``, default
True).  Paged: the K/V live in a page pool (``serve/pages.py``) mapped
to slot columns through per-slot page tables; shared prompt prefixes map
the same read-only radix-cached pages and skip their prefill windows.
``paged=False``: the contiguous stripe layout (``serve/slots.py``), one
``[max_len]`` stripe a slot; each request prefills into a batch-1
contiguous cache (spares pooled, at most ``num_slots``) that admission
splices into its slot; no page pool and no radix cache, so
``EngineStats``' page fields read 0.

Request lifecycle::

    QUEUED --admission--> PREFILLING --last window--> ACTIVE --> FINISHED
                (free slot)   (chunked)    (first token)  (EOS/budget)

Admission: ``submit`` checks the queue depth (``QueueFullError``) and the
tenancy policy's quotas, and enqueues, as one decision under ``_lock``;
a tenancy policy's fair queue (``fleet/tenancy.py``) replaces the FIFO.
A request past its deadline retires ``deadline_exceeded`` at the next
tick, wherever it is.  With an adapter table (``serve/adapters.py``)
each request pins its LoRA adapter's row at prefill begin, before its
pages; a full table requeues it with nothing held.

Migration: any in-flight request exports as a host-only
``RequestSnapshot`` (``export``/``export_all``) and resumes on another
engine (``import_snapshot``): prefill runs over its context, ``prompt +
generated``, and decode continues where the source stopped.  On a paged
engine the export hands the request's final full pages to the radix
tree, and the page wire (``export_chain_pages``/``import_wire_pages``)
carries them to another pool, whose re-prefill then skips them.

All device work goes through three methods, the JAX package's three
jitted programs of each layout run eagerly:

* ``_win_mid``: a mid-prefill window, straight into the request's pages
  (``decode_window_paged``) or into its prefill cache
  (``decode_window``);
* ``_last_admit``: the last window, the first-token sample and the
  slot's arming (contiguous: the splice of the prefill cache into the
  slot, ``slots.insert_slot``);
* ``_tick``: ``tick_steps`` decode steps, a Python loop over
  ``pages.decode_paged_step`` or ``slots.decode_slots_step``, sampling
  on the device and freezing rows as they finish
  (``ops.decoding.finish_step``); tokens reach the host once per tick.

The JAX programs donate the cache buffers; here the K/V are updated in
place and the slot-state tensors are rebound.

Exactness contract: every operation is row-independent, so one request's
tokens do not depend on which other requests share its tick, and a
prefix-cache hit decodes the same tokens as a cold cache.

Thread-safety: ``submit``/``cancel``/``stats`` may run on any thread
while another pumps ``step()``.  ``_pump_lock`` serialises ticks, and
device state is touched only under it; ``_lock`` guards host bookkeeping
in short sections that never span device work or a callback.  A
cross-thread ``cancel`` of an active row marks it stale and the pump
freezes it at the next tick.

Instrumentation, at the JAX scheduler's sites: a duck-typed ``metrics``
sink (the engine's ``ServeMetrics``) hears of every submission,
admission, delivery and retirement, and of the load after each tick;
request tracing (``obs.reqtrace``: a ``trace_id`` carried across
migration, the ``queued``/``prefill``/``decode`` stages, the
``prefill_window``/``admitted``/``first_token`` marks, export and import,
retirement, and a forensic dump at a deadline's expiry); the critical
path (``obs.critpath``: per-request phases accrued at the same seams,
finalized once at retirement, carried across migration); and the active
fault plan, at the top of the pump (``on_engine_tick(chaos_tag)``:
``stall_tick``, ``wedge_replica``) and at token delivery
(``on_decode(rid)``: ``fail_decode``, which fails that request only).
With no tracer, ledger or plan active each site is one attribute check.

Pump heartbeat: every tick is bracketed by ``ticks_started`` /
``ticks_completed`` and ``perf_counter`` stamps in ``EngineStats``,
written under ``_lock``, so ``fleet.Watchdog`` tells a wedged pump (a
tick started and not completed) or a stalled one (the last tick too long)
from an idle one without touching the pump thread.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import critpath as critpath_lib
from ..obs import reqtrace
from ..ops import decoding as dec
from ..resilience import faults as faults_lib
from . import pages as pages_lib
from . import slots as slots_lib
from .adapters import AdapterTableFull

__all__ = ["EngineStats", "QueueFullError", "Request", "RequestSnapshot",
           "SlotScheduler"]


class QueueFullError(RuntimeError):
    """``submit``/``import_snapshot`` rejected: the queue is at
    ``max_queue_depth``.  Backpressure: retry after requests retire."""


@dataclasses.dataclass
class Request:
    """One in-flight generation request (host-side bookkeeping).
    ``status``: ``"pending"`` while in flight, then ``"ok"`` |
    ``"deadline_exceeded"`` | ``"failed"`` | ``"cancelled"`` |
    ``"migrated"`` (exported as a ``RequestSnapshot``).  ``deadline`` is
    an absolute ``perf_counter`` instant, checked once a tick.
    ``tenant`` attributes the request for quotas and fair share;
    ``adapter_id`` names its LoRA adapter, pinned at table row
    ``adapter_row`` from prefill begin to retirement.

    Migration: ``context`` is what prefill runs over, the prompt plus
    the tokens generated on a source engine (the prompt for a fresh
    submit); ``resumed`` counts those pre-seeded tokens; ``token_cost``
    is what tenancy charged at admission (the remaining budget).

    Observability: ``trace_id`` is the request's trace lane (None with
    tracing off); ``phases`` the live critical-path accrual (None with no
    ledger active at intake: every accrual site then reduces to one
    attribute check) and ``critpath`` the finished breakdown;
    ``e2e_base`` carries wall time spent on earlier engines;
    ``_cp_wait``/``_cp_t0`` are the open wait phase's stopwatch
    (``queue_wait`` until the admission that starts prefill,
    ``backpressure_requeue`` after an admission bounce)."""
    rid: int
    prompt: np.ndarray                       # [plen] int32
    max_new_tokens: int
    on_token: Optional[Callable[[List[int]], None]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    deadline: Optional[float] = None
    tenant: str = "default"
    adapter_id: Optional[str] = None
    adapter_row: Optional[int] = None
    status: str = "pending"
    error: Optional[BaseException] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # terminal transitions are claim-once (cancel vs pump)
    _retired: bool = dataclasses.field(default=False, repr=False)
    # paged engines: page holdings, granted at prefill begin, released
    # at retirement
    _lease: Optional[pages_lib.PageLease] = dataclasses.field(
        default=None, repr=False)
    context: Optional[np.ndarray] = dataclasses.field(default=None,
                                                      repr=False)
    resumed: int = 0
    token_cost: int = 0
    # the page pool's prefix namespace (its adapter's weights digest,
    # b"" without one), fixed when the adapter is pinned
    prefix_ns: bytes = dataclasses.field(default=b"", repr=False)
    trace_id: Optional[str] = None
    phases: Optional[Dict[str, float]] = dataclasses.field(
        default=None, repr=False)
    critpath: Optional[Dict[str, float]] = dataclasses.field(
        default=None, repr=False)
    e2e_base: float = 0.0
    _cp_wait: Optional[str] = dataclasses.field(default="queue_wait",
                                                repr=False)
    _cp_t0: float = dataclasses.field(default=0.0, repr=False)

    @property
    def remaining_budget(self) -> int:
        """Tokens this engine still owes (``max_new_tokens`` for a fresh
        submit, the unserved tail for an import)."""
        return self.max_new_tokens - self.resumed

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


@dataclasses.dataclass
class RequestSnapshot:
    """A portable host-side snapshot of one in-flight request: the unit
    of live migration (the JAX package's ``RequestSnapshot``, field for
    field).

    It holds no device state: the destination rebuilds the KV cache by
    prefilling ``prompt + generated``, then decodes on.  ``generated``
    pre-seeds the new request's tokens, so the destination's callbacks
    fire only beyond ``stream_offset`` (exactly-once delivery).
    ``max_new_tokens`` stays the original total budget across hops;
    ``deadline_remaining_s`` is relative, so it survives a host change;
    ``sampling`` is the source's sampling config, and an engine with
    another refuses the import.  ``clean`` is False for an export that
    did not wait for the pump.  ``shipped_pages`` is the page wire's
    manifest: ``(chain hash, tokens covered)`` of every full chunk the
    export handed to the source's radix tree, with that pool's
    ``page_size``; a hint only, correctness never depends on it.
    ``trace_id`` continues the request's trace lane on the importer;
    ``critpath`` carries the source's phase accrual, its elapsed wall
    and the export instant (the importer books the gap to
    ``migration``)."""
    rid: int
    prompt: np.ndarray                       # [plen] int32, the original
    generated: List[int]                     # tokens delivered so far
    max_new_tokens: int                      # original total budget
    stream_offset: int                       # == len(generated)
    tenant: str = "default"
    adapter_id: Optional[str] = None
    deadline_remaining_s: Optional[float] = None
    sampling: Optional[dict] = None          # source sampling config
    clean: bool = True                       # pump-quiesced export
    trace_id: Optional[str] = None
    critpath: Optional[dict] = None
    shipped_pages: Optional[Tuple[Tuple[bytes, int], ...]] = None
    page_size: int = 0                       # source pool's page size

    @property
    def context(self) -> np.ndarray:
        """``prompt + generated``: what the destination prefills."""
        prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if not self.generated:
            return prompt
        return np.concatenate([prompt,
                               np.asarray(self.generated, np.int32)])


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Snapshot of one engine's load, its per-tenant in-flight counts
    (queued + prefilling + active requests, and the sum of their charged
    token budgets) and its page-pool counters (all 0 on a contiguous
    engine)."""
    queued: int
    prefilling: int
    active: int
    num_slots: int
    inflight_per_tenant: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    tokens_inflight_per_tenant: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    pages_total: int = 0
    pages_free: int = 0
    pages_per_request: float = 0.0
    prefix_lookups_total: int = 0
    prefix_hits_total: int = 0
    prefix_tokens_reused_total: int = 0
    prefix_evictions_total: int = 0
    cow_splits_total: int = 0
    prefill_windows_skipped_total: int = 0
    page_size: int = 0
    # the pool's bounded hot-chain digest (chain hash -> cached tokens)
    prefix_fingerprint: Dict[bytes, int] = dataclasses.field(
        default_factory=dict)
    # pump heartbeat (fleet/watchdog.py): tick counters and perf_counter
    # stamps bracketing the most recent tick; started > completed with a
    # stale start stamp is a wedged pump, a completed tick longer than the
    # watchdog's deadline a stalled one
    ticks_started: int = 0
    ticks_completed: int = 0
    last_tick_start_s: float = 0.0           # perf_counter at tick entry
    last_tick_end_s: float = 0.0             # perf_counter at tick exit
    last_tick_duration_s: float = 0.0

    @property
    def inflight(self) -> int:
        return self.queued + self.prefilling + self.active

    @property
    def free_slots(self) -> int:
        return self.num_slots - self.active

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prefix lookups that mapped at least one page."""
        if not self.prefix_lookups_total:
            return 0.0
        return self.prefix_hits_total / self.prefix_lookups_total


class _NullMetrics:
    """Duck-typed metrics sink; the engine supplies a real one."""

    def submitted(self, req):
        pass

    def admitted(self, req):
        pass

    def emitted(self, req, n):
        pass

    def finished(self, req):
        pass

    def aborted(self, req, status):
        pass

    def depth(self, stats):
        pass


class SlotScheduler:
    """Drive a slot cache for a port ``GPT`` (on its device).

    Synchronous: callers pump ``step()`` (one tick: a window for every
    in-flight prefill, then one ``tick_steps`` decode run) or
    ``drain()``.  ``paged`` (default True) picks the page pool; False the
    contiguous stripes.  Paged only: ``page_size`` defaults to
    ``auto_page_size(max_len, 16)``; ``num_pages`` to ``num_slots`` full
    slots plus the trash page; ``prefix_cache=False`` turns off the radix
    tree (and with it the export handoff and the page wire).
    ``generator`` feeds the sampled path (``temperature > 0``).

    Admission: ``queue`` replaces the FIFO (any object with append/
    popleft/remove/__len__/__iter__/__contains__, optionally requeue and
    release: ``fleet.tenancy.DeficitFairQueue``); ``max_queue_depth``
    bounds the queue; ``tenancy`` (``TenantPolicy``) checks quotas.
    ``adapters``: an ``AdapterTable`` for per-request LoRA adapters; None
    keeps every forward adapter-free.  ``metrics``: the sink of the
    scheduler's events (``serve.engine.ServeMetrics``; None: nothing).
    ``chaos_tag``: this engine's identity for the engine-targeted fault
    kinds (0 for a standalone engine).
    """

    def __init__(self, model, *, num_slots: int = 8,
                 max_len: Optional[int] = None, prefill_chunk: int = 32,
                 tick_steps: int = 4, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 queue=None, adapters=None, metrics=None,
                 max_queue_depth: Optional[int] = None, tenancy=None,
                 paged: bool = True, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = True):
        c = model.config
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1; got {num_slots}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1; got {prefill_chunk}")
        if tick_steps < 1:
            raise ValueError(f"tick_steps must be >= 1; got {tick_steps}")
        max_len = max_len or c.max_position
        if max_len > c.max_position:
            raise ValueError(f"max_len {max_len} exceeds max_position "
                             f"{c.max_position}")
        self.paged = bool(paged)
        if self.paged:
            page_size = int(page_size) if page_size else \
                pages_lib.auto_page_size(max_len, 16)
            if page_size < 1 or max_len % page_size:
                raise ValueError(f"page_size must divide max_len "
                                 f"{max_len}; got {page_size}")
            pps = max_len // page_size
            if num_pages is None:
                num_pages = max(num_slots * pps + 1, pps + 2)
        else:
            page_size = num_pages = 0
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.tick_steps = tick_steps
        self.temperature = float(temperature)
        self.top_k, self.top_p = top_k, top_p
        self.eos_id = eos_id
        self.pad_id = dec.resolve_pad(eos_id, pad_id)
        self._pad = self.pad_id if self.pad_id is not None else 0
        # the sampling config under the JAX package's keys, stamped on
        # exported snapshots so that an engine with another refuses them
        self._sampling = dict(temperature=self.temperature, top_k=top_k,
                              top_p=top_p, eos_id=eos_id)
        self.generator = generator
        self.adapters = adapters
        self.metrics = metrics if metrics is not None else _NullMetrics()
        self.chaos_tag = 0
        # pump heartbeat, read by stats() under _lock
        self._ticks_started = 0
        self._ticks_completed = 0
        self._tick_start_t = 0.0
        self._tick_end_t = 0.0
        self._last_tick_s = 0.0
        self.max_queue_depth = max_queue_depth
        self.tenancy = tenancy
        self.page_size = page_size
        self.num_pages = int(num_pages)
        self.pages: Optional[pages_lib.PagePool] = None
        self._page_tab: Optional[np.ndarray] = None
        if self.paged:
            self.pages = pages_lib.PagePool(self.num_pages, page_size, pps,
                                            prefix_cache=prefix_cache)
            self._page_tab = np.zeros((num_slots, pps), np.int32)
        self._windows_skipped = 0
        self._next_rid = 0
        self._lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._stale_rows: set = set()
        self._orphans: List[list] = []
        self._queue = queue if queue is not None else collections.deque()
        self._slots: List[Optional[Request]] = [None] * num_slots
        # in-flight prefills: [req, windows [n, 1, W], windows done,
        # payload]; the payload is the page lease (paged) or the
        # request's batch-1 prefill cache (contiguous)
        self._prefills: List[list] = []
        # contiguous: spare batch-1 prefill caches, reused across requests
        # (a stale column is masked by the slot's validity window)
        self._pf_pool: List[dict] = []
        # per-tenant in-flight requests and charged token budgets: what
        # quotas check and stats() reports
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_tokens: Dict[str, int] = {}

        # -- device state -------------------------------------------------
        dev = self.device
        self._cache = (pages_lib.init_paged_cache(model, num_slots,
                                                  self.num_pages, page_size)
                       if self.paged
                       else slots_lib.init_slot_cache(model, num_slots,
                                                      max_len))
        self._tokens = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=dev)
        self._finished = torch.ones((num_slots,), dtype=torch.bool,
                                    device=dev)          # empty = finished
        self._remaining = torch.zeros((num_slots,), dtype=torch.int32,
                                      device=dev)
        # each slot's adapter table row (0, the zero adapter, when empty),
        # set at admission
        self._adapter_rows = (torch.zeros((num_slots,), dtype=torch.int32,
                                          device=dev)
                              if adapters is not None else None)

    # ------------------------------------------- the three device programs

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return dec.sample_logits(logits, self.temperature, self.top_k,
                                 self.top_p, generator=self.generator)

    def _page_row(self, lease: pages_lib.PageLease) -> torch.Tensor:
        return torch.from_numpy(lease.row).to(self.device)

    def _adapter_args(self, req: Optional[Request] = None) -> dict:
        """The adapter keyword arguments of one device call: none without
        a table; else the table as it is now (a hot update rebinds it, so
        it is read once a call) and the rows, one request's (a prefill
        window) or every slot's (a tick)."""
        if self.adapters is None:
            return {}
        if req is None:
            rows = self._adapter_rows
        else:
            rows = torch.tensor([req.adapter_row], dtype=torch.int32,
                                device=self.device)
        return {"adapters": self.adapters.arrays, "adapter_rows": rows}

    def _win_mid(self, window: np.ndarray, payload, pos: int, ad: dict):
        """Mid prefill window: paged, straight into the request's pages at
        ``pos``; contiguous, into its prefill cache (whose own ``pos``
        is that column).  Returns the payload to carry on."""
        ids = torch.from_numpy(window).to(self.device)
        if self.paged:
            self.model.decode_window_paged(
                self._cache["kv"], ids, self._page_row(payload), pos,
                head="none", **ad)
            return payload
        return self.model.decode_window(payload, ids, head="none", **ad)[1]

    def _last_admit(self, window: np.ndarray, payload, pos: int,
                    last_idx: int, slot: int, length: int,
                    budget: int, ad: dict) -> torch.Tensor:
        """Last prefill window + first-token sample + slot arming.  Paged:
        no splice, the context's K/V already live in the request's pages
        and admission points the slot's column state at them (the
        page-table row is host state, handed to the next tick).
        Contiguous: the prefill cache's row is spliced into the slot.
        Returns the first token as a 1-element device tensor."""
        ids = torch.from_numpy(window).to(self.device)
        if self.paged:
            logits, _ = self.model.decode_window_paged(
                self._cache["kv"], ids, self._page_row(payload), pos,
                head=last_idx, **ad)
        else:
            logits, payload = self.model.decode_window(payload, ids,
                                                       head=last_idx, **ad)
        tok = self._sample(logits)                       # [1]
        self._tokens[slot] = tok[0]
        done0 = torch.full_like(self._finished[slot], budget <= 1)
        if self.eos_id is not None:
            done0 = done0 | (tok[0] == self.eos_id)
        self._finished[slot] = done0
        # the first token was already emitted from the prefill logits
        self._remaining[slot] = budget - 1
        if self.paged:
            self._cache["start_col"][slot] = 0
            self._cache["write_col"][slot] = length
            self._cache["positions"][slot] = length
        else:
            slots_lib.insert_slot(self._cache, slot,
                                  slots_lib.strip_pos(payload), length)
        return tok

    def _tick(self, page_tab: Optional[torch.Tensor], ad: dict):
        """``tick_steps`` decode steps (``page_tab``: the paged layout's
        table snapshot, None when contiguous; ``ad``: the adapter table
        and rows, read once for the whole tick); returns (emitted [K, S],
        live [K, S]) on the device."""
        cache, tokens = self._cache, self._tokens
        finished, remaining = self._finished, self._remaining
        emitted, lives = [], []
        for _ in range(self.tick_steps):
            live = ~finished
            if self.paged:
                logits, cache = pages_lib.decode_paged_step(
                    self.model, cache, page_tab, tokens, live, **ad)
            else:
                logits, cache = slots_lib.decode_slots_step(
                    self.model, cache, tokens, live, **ad)
            nxt = self._sample(logits)
            if self.eos_id is not None:
                nxt, finished = dec.finish_step(nxt, finished, self.eos_id,
                                                self._pad)
            remaining = remaining - live.to(torch.int32)
            emitted.append(torch.where(live, nxt, self._pad))
            lives.append(live)
            finished = finished | (remaining <= 0)
            tokens = torch.where(live, nxt, tokens)
        self._cache, self._tokens = cache, tokens
        self._finished, self._remaining = finished, remaining
        return torch.stack(emitted), torch.stack(lives)

    # ------------------------------------------------------------- intake

    def _check_fits(self, what: str, clen: int, budget: int) -> None:
        padded = -(-clen // self.prefill_chunk) * self.prefill_chunk
        if clen + budget > self.max_len or padded > self.max_len:
            raise ValueError(
                f"{what} ({clen}, chunk-padded {padded}) + budget "
                f"({budget}) exceeds max_len {self.max_len}")

    def _check_adapter(self, adapter_id: Optional[str]) -> None:
        if adapter_id is None:
            return
        if self.adapters is None:
            raise ValueError("adapter_id requires an engine built with an "
                             "adapter table (adapter_capacity > 0)")
        if not self.adapters.known(adapter_id):
            raise KeyError(f"unknown adapter_id {adapter_id!r}; "
                           "load_adapter() it first")

    def _admit_locked(self, tenant: str, cost: int) -> None:
        """Queue depth, then quota (the caller holds ``_lock``, so that
        the checks and the enqueue after them are one decision)."""
        if self.max_queue_depth is not None \
                and len(self._queue) >= self.max_queue_depth:
            raise QueueFullError(
                f"queue at max_queue_depth={self.max_queue_depth}; "
                "retry after in-flight requests retire")
        if self.tenancy is not None:
            self.tenancy.check_admission(
                tenant, cost,
                inflight=self._tenant_inflight.get(tenant, 0),
                tokens_inflight=self._tenant_tokens.get(tenant, 0))

    def submit(self, prompt, max_new_tokens: int,
               on_token: Optional[Callable[[List[int]], None]] = None,
               deadline_s: Optional[float] = None,
               tenant: str = "default",
               adapter_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> Request:
        """Queue one request.  ``prompt``: [plen] int token ids.  The
        prompt + ``max_new_tokens`` must fit ``max_len``, and so must the
        chunk-padded prompt.  ``deadline_s``: wall-clock budget from now
        (retired ``deadline_exceeded`` at the first tick past it);
        ``tenant``: for quotas and fair share; ``adapter_id``: a
        registered LoRA adapter (unknown ids fail here); ``trace_id``:
        the request's trace lane (opened here)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0; got {deadline_s}")
        self._check_adapter(adapter_id)
        self._check_fits("prompt", prompt.size, max_new_tokens)
        now = time.perf_counter()
        tenant = str(tenant)
        cp_phases = critpath_lib.new_phases()   # outside the state lock
        with self._lock:
            self._admit_locked(tenant, int(max_new_tokens))
            req = Request(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens),
                          on_token=on_token, submit_time=now,
                          deadline=(None if deadline_s is None
                                    else now + deadline_s),
                          tenant=tenant, adapter_id=adapter_id,
                          context=prompt, token_cost=int(max_new_tokens),
                          trace_id=trace_id)
            req.phases = cp_phases
            req._cp_t0 = now
            self._next_rid += 1
            self._enqueue_locked(req)
        if req.trace_id:
            reqtrace.submitted(req.trace_id, rid=req.rid,
                               tenant=req.tenant, plen=int(prompt.size),
                               max_new_tokens=int(max_new_tokens))
        self.metrics.submitted(req)
        self._report_depth()
        return req

    def _enqueue_locked(self, req: Request) -> None:
        """Enqueue and count the request against its tenant (the caller
        holds ``_lock``); shared by ``submit`` and ``import_snapshot``."""
        self._queue.append(req)
        t = req.tenant
        self._tenant_inflight[t] = self._tenant_inflight.get(t, 0) + 1
        self._tenant_tokens[t] = self._tenant_tokens.get(t, 0) \
            + req.token_cost

    def _requeue(self, req: Request) -> None:
        """Put a popped but unstartable request back at the FRONT (a fair
        queue refunds its deficit charge); the caller holds ``_lock``."""
        if hasattr(self._queue, "requeue"):
            self._queue.requeue(req)
        else:
            self._queue.appendleft(req)

    # ---------------------------------------------------------- the tick

    @property
    def busy(self) -> bool:
        with self._lock:
            return bool(self._queue) or bool(self._prefills) \
                or any(r is not None for r in self._slots)

    @property
    def queued(self) -> int:
        """Requests accepted but not yet prefilling (the engine's
        ``max_queue_depth`` admission-control signal)."""
        with self._lock:
            return len(self._queue)

    def stats(self) -> EngineStats:
        with self._lock:
            base = dict(queued=len(self._queue),
                        prefilling=len(self._prefills),
                        active=sum(r is not None for r in self._slots),
                        num_slots=self.num_slots,
                        inflight_per_tenant=dict(self._tenant_inflight),
                        tokens_inflight_per_tenant=dict(self._tenant_tokens),
                        prefill_windows_skipped_total=self._windows_skipped,
                        ticks_started=self._ticks_started,
                        ticks_completed=self._ticks_completed,
                        last_tick_start_s=self._tick_start_t,
                        last_tick_end_s=self._tick_end_t,
                        last_tick_duration_s=self._last_tick_s)
        if self.paged:
            p = self.pages.stats()
            for key in ("pages_total", "pages_free", "pages_per_request",
                        "prefix_lookups_total", "prefix_hits_total",
                        "prefix_tokens_reused_total",
                        "prefix_evictions_total", "cow_splits_total",
                        "page_size", "prefix_fingerprint"):
                base[key] = p[key]
        return EngineStats(**base)

    def tenant_inflight(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_inflight.get(tenant, 0)

    def tenant_tokens_inflight(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_tokens.get(tenant, 0)

    def step(self) -> bool:
        """One tick: retire expired deadlines, start prefills for free
        slots, advance every in-flight prefill by one window, then one
        decode run over the slots.  Returns False when fully idle.

        Each tick is bracketed by the pump heartbeat (``stats()``), the
        signal ``fleet.Watchdog`` reads.  The end stamp is taken on the
        host after ``_step_locked`` returns; the card has reached it too
        when the tick read tokens back, because the tick's last read, the
        decode run's copy of the emitted tokens to the host
        (``_decode_tick``), waits for every kernel queued before it on
        the stream.  A tick of mid-prefill windows only reads nothing, so
        its windows finish on the card inside the next tick that does,
        and their time is counted there."""
        with self._pump_lock:
            start = time.perf_counter()
            with self._lock:
                self._ticks_started += 1
                self._tick_start_t = start
            plan = faults_lib.active()
            if plan is not None:
                # stall_tick sleeps and wedge_replica blocks here, inside
                # the pump lock and the heartbeat, as a pathological tick
                # would
                plan.on_engine_tick(self.chaos_tag)
            try:
                return self._step_locked()
            finally:
                end = time.perf_counter()
                with self._lock:
                    self._ticks_completed += 1
                    self._tick_end_t = end
                    self._last_tick_s = end - start

    def _step_locked(self) -> bool:
        did = False
        outbox: List[tuple] = []     # tick-ordered deliveries/finishes
        self._harvest_orphans()
        self._freeze_stale_rows()
        self._expire_deadlines()
        while True:
            with self._lock:
                req = None
                free = sum(r is None for r in self._slots)
                if self._queue and len(self._prefills) < free:
                    req = self._queue.popleft()
            if req is None:
                break
            try:
                st = self._begin_prefill(req)
            except (AdapterTableFull, pages_lib.PagePoolExhausted):
                # every adapter row or page is pinned by an in-flight
                # request: requeue (a retirement frees pins and pages, so
                # this always drains) and stop admitting this tick; the
                # wait goes on as backpressure, not queue order
                if req.phases is not None:
                    self._cp_close_wait(req, time.perf_counter(),
                                        reopen="backpressure_requeue")
                with self._lock:
                    self._requeue(req)
                break
            if req.phases is not None:
                self._cp_close_wait(req, time.perf_counter())
            if req.trace_id:
                reqtrace.stage(req.trace_id, "prefill")
            with self._lock:
                self._prefills.append(st)
        with self._lock:
            pending = list(self._prefills)
        # critpath: with a ledger active, time each prefill window and the
        # decode run; prefill_s totals this tick's window cost and
        # win_by_req keys each request's own share (a request prefilled
        # this tick was not decoding while the windows ran, so it is
        # exempt from interference)
        cp_on = critpath_lib.active() is not None
        prefill_s = 0.0
        win_by_req: Dict[int, float] = {}
        if pending:
            did = True
            for st in pending:
                if cp_on:
                    w0 = time.perf_counter()
                    self._advance_prefill(st, outbox)
                    dt = time.perf_counter() - w0
                    prefill_s += dt
                    win_by_req[id(st[0])] = \
                        win_by_req.get(id(st[0]), 0.0) + dt
                    if st[0].phases is not None:
                        st[0].phases["prefill_compute"] += dt
                else:
                    self._advance_prefill(st, outbox)
        with self._lock:
            active = any(r is not None for r in self._slots)
        if active:
            did = True
            self._decode_tick(outbox, prefill_s if cp_on else None,
                              win_by_req)
        self._flush(outbox)
        if did:
            self._report_depth()
        return did

    def _cp_close_wait(self, req: Request, now: float,
                       reopen: Optional[str] = None) -> None:
        """Close the request's open wait phase at ``now``; ``reopen``
        restarts the stopwatch under another phase (an admission
        bounce).  Pump-only: the stopwatch has a single writer."""
        if req._cp_wait is not None:
            req.phases[req._cp_wait] += max(0.0, now - req._cp_t0)
        req._cp_wait = reopen
        req._cp_t0 = now

    def drain(self) -> None:
        """Pump until every queued/in-flight request has finished."""
        while self.busy:
            self.step()

    def _harvest_orphans(self) -> None:
        """Recycle the payloads of prefills cancelled cross-thread: release
        the page lease, or pool the contiguous prefill cache (only the
        pump recycles, so no window is still writing it)."""
        with self._lock:
            orphans, self._orphans = self._orphans, []
            if not self.paged:
                for st in orphans:
                    self._pool_prefill_cache(st[3])
        if self.paged:
            for st in orphans:
                self.pages.release(st[3])

    def _pool_prefill_cache(self, cache) -> None:
        """Return a batch-1 prefill cache to the spare pool (the caller
        holds ``_lock``), at most ``num_slots`` of them: concurrent
        prefills never outnumber the free slots."""
        if len(self._pf_pool) < self.num_slots:
            self._pf_pool.append(slots_lib.strip_pos(cache))

    def _freeze_stale_rows(self) -> None:
        """Freeze rows cancelled cross-thread since the last tick (paged:
        and map their page-table rows to the trash page)."""
        with self._lock:
            stale = sorted(self._stale_rows)
            self._stale_rows.clear()
            if self.paged:
                for r in stale:
                    self._page_tab[r] = 0
        if stale:
            self._finished[torch.tensor(stale, device=self.device)] = True

    def _expire_deadlines(self) -> None:
        """Retire every request past its deadline, wherever it is: queued,
        mid-prefill (its lease released at retirement, or its cache
        pooled) or active (its row frozen, its page-table row on the trash
        page).  Runs once a tick, on the pump."""
        now = time.perf_counter()

        def expired(req):
            return req is not None and req.deadline is not None \
                and now > req.deadline and not req.done.is_set()

        aborts: List[Request] = []
        rows: List[int] = []
        with self._lock:
            for req in [r for r in self._queue if expired(r)]:
                self._queue.remove(req)
                aborts.append(req)
            still = []
            for st in self._prefills:
                if expired(st[0]):
                    if not self.paged:
                        self._pool_prefill_cache(st[3])
                    aborts.append(st[0])
                else:
                    still.append(st)
            self._prefills = still
            for r, req in enumerate(self._slots):
                if expired(req):
                    self._slots[r] = None
                    if self.paged:
                        self._page_tab[r] = 0
                    rows.append(r)
                    aborts.append(req)
        if rows:
            self._finished[torch.tensor(rows, device=self.device)] = True
        for req in aborts:
            self._abort(req, "deadline_exceeded")
            if req.trace_id:
                # the victim's span tree while the evidence is warm, with
                # the phase budget its deadline was spent on
                extra = ({"critpath": req.critpath}
                         if req.critpath is not None else {})
                reqtrace.forensic_dump(req.trace_id, "deadline_expired",
                                       rid=req.rid, tenant=req.tenant,
                                       **extra)
        if aborts:
            self._report_depth()

    # ---------------------------------------------------------- prefill

    def _begin_prefill(self, req: Request) -> list:
        """Pin the request's adapter, then cut its context into
        right-padded windows and take its payload.  Paged: lease the
        request's pages (mapping any cached prefix chain read-only,
        private pages for the rest of context + remaining budget); only
        the unmatched tail is windowed.  Contiguous: a spare (or new)
        batch-1 prefill cache at ``pos`` 0.  Any failure after the pin
        releases the lease and the pin before it propagates."""
        w = self.prefill_chunk
        ctx = req.context if req.context is not None else req.prompt
        clen = ctx.size
        if self.adapters is not None:
            # before any storage: AdapterTableFull leaves nothing to undo
            req.adapter_row = self.adapters.acquire(req.adapter_id)
            req.prefix_ns = self.adapters.namespace(req.adapter_id)
        try:
            if not self.paged:
                n_win = -(-clen // w)
                padded = np.zeros((n_win * w,), np.int32)
                padded[:clen] = ctx
                with self._lock:
                    kv = self._pf_pool.pop() if self._pf_pool else None
                if kv is None:
                    kv = slots_lib.strip_pos(self.model.init_cache(
                        1, self.max_len))
                return [req, padded.reshape(n_win, 1, w), 0,
                        dict(kv, pos=0)]
            lease = self.pages.begin(ctx, clen + req.remaining_budget - 1,
                                     namespace=req.prefix_ns)
            req._lease = lease
            remaining = ctx[lease.skip:]
            n_win = -(-remaining.size // w)
            padded = np.zeros((n_win * w,), np.int32)
            padded[:remaining.size] = remaining
            with self._lock:
                # window dispatches avoided by the prefix hit
                self._windows_skipped += -(-clen // w) - n_win
            return [req, padded.reshape(n_win, 1, w), 0, lease]
        except BaseException:
            if req._lease is not None:
                self.pages.release(req._lease)
                req._lease = None
            if req.adapter_row is not None and self.adapters is not None:
                self.adapters.release(req.adapter_id)
                req.adapter_row = None
            raise

    def _advance_prefill(self, st: list, outbox: List[tuple]) -> None:
        """One window for one in-flight prefill; admits the request into
        a slot on its last window (window i runs at ``pos = skip + i*W``,
        so a paged prefix hit never dispatches the shared windows)."""
        req, windows, i, payload = st
        with self._lock:
            if st not in self._prefills:
                return       # cancelled cross-thread: harvest recycles it
        ad = self._adapter_args(req)
        skip = payload.skip if self.paged else 0
        if i < len(windows) - 1:
            payload = self._win_mid(windows[i], payload,
                                    skip + i * self.prefill_chunk, ad)
            with self._lock:
                st[2], st[3] = i + 1, payload
            if req.trace_id:
                reqtrace.mark(req.trace_id, "prefill_window", window=int(i))
            return
        ctx = req.context if req.context is not None else req.prompt
        clen = ctx.size
        last_idx = clen - skip - 1 - (len(windows) - 1) * self.prefill_chunk
        with self._lock:
            if st not in self._prefills or req.done.is_set():
                return
            self._prefills.remove(st)
            slot = self._slots.index(None)
            # reserve before arming so the free-slot count stays right
            self._slots[slot] = req
            self._stale_rows.discard(slot)
        if self._adapter_rows is not None:
            self._adapter_rows[slot] = req.adapter_row
        tok = self._last_admit(
            windows[-1], payload,
            skip + (len(windows) - 1) * self.prefill_chunk, last_idx, slot,
            clen, req.remaining_budget, ad)
        first = int(tok[0])          # host fetch: the TTFT barrier
        req.first_token_time = time.perf_counter()
        if self.paged:
            # the context's full pages are final now: publish them so the
            # NEXT request with this prefix skips their windows
            self.pages.register(payload, ctx)
        with self._lock:
            if self.paged:
                self._page_tab[slot] = payload.row
            else:
                self._pool_prefill_cache(payload)   # spliced: reusable
            cancelled = req.done.is_set()
            if cancelled and self._slots[slot] is req:
                self._slots[slot] = None
                if self.paged:
                    self._page_tab[slot] = 0
        if cancelled:
            self._finished[slot] = True
            return
        self.metrics.admitted(req)
        if req.trace_id:
            reqtrace.mark(req.trace_id, "prefill_window",
                          window=len(windows) - 1)
            reqtrace.mark(req.trace_id, "admitted", slot=int(slot))
            reqtrace.mark(req.trace_id, "first_token",
                          ttft_s=req.first_token_time - req.submit_time)
            reqtrace.stage(req.trace_id, "decode")
        if req.remaining_budget <= 1 or (self.eos_id is not None
                                         and first == self.eos_id):
            self._drop_slot(slot, req)
            outbox.append(("deliver", req, [first], None))
            outbox.append(("finish", req))
        else:
            outbox.append(("deliver", req, [first], slot))

    # ----------------------------------------------------------- decode

    def _drop_slot(self, r: int, req: Request) -> None:
        """Free slot ``r`` if ``req`` still holds it; paged, also map its
        page table to the trash page, so the frozen row's writes can never
        touch a reallocated page."""
        with self._lock:
            if self._slots[r] is req:
                self._slots[r] = None
                if self.paged:
                    self._page_tab[r] = 0

    def _decode_tick(self, outbox: List[tuple],
                     prefill_s: Optional[float] = None,
                     win_by_req: Optional[Dict[int, float]] = None
                     ) -> None:
        """One ``tick_steps`` decode run.  ``prefill_s`` (a critpath
        ledger active) is this tick's total prefill-window wall time:
        every slot already decoding when those windows ran is charged all
        of it as ``prefill_interference``, while requests in
        ``win_by_req`` (prefilled this tick) are exempt;
        ``decode_compute`` is the run's wall to the host read, the same
        for every live slot."""
        with self._lock:
            slots = list(self._slots)
            # page-table snapshot: host mutations between ticks never
            # tear a run mid-read
            tab = (torch.from_numpy(self._page_tab.copy()).to(self.device)
                   if self.paged else None)
        t0 = time.perf_counter() if prefill_s is not None else 0.0
        em, live = self._tick(tab, self._adapter_args())
        k, s = em.shape
        host = torch.cat([em.reshape(-1), live.reshape(-1).to(torch.int32),
                          self._finished.to(torch.int32)]).cpu().numpy()
        decode_s = (time.perf_counter() - t0      # the host read included
                    if prefill_s is not None else 0.0)
        em = host[:k * s].reshape(k, s)
        mask = host[k * s:2 * k * s].reshape(k, s).astype(bool)
        fin = host[2 * k * s:].astype(bool)
        for r, req in enumerate(slots):
            if req is None:
                continue
            with self._lock:
                if self._slots[r] is not req:
                    continue         # cancelled mid-run: drop tokens
            if prefill_s is not None and req.phases is not None:
                req.phases["decode_compute"] += decode_s
                if id(req) not in (win_by_req or {}):
                    req.phases["prefill_interference"] += prefill_s
            toks = em[:, r][mask[:, r]]
            if toks.size:
                outbox.append(("deliver", req, [int(t) for t in toks], r))
            if fin[r]:
                self._drop_slot(r, req)
                outbox.append(("finish", req))

    def _flush(self, outbox: List[tuple]) -> None:
        """Deliver tokens and terminal transitions in tick order.  A
        raising ``on_token`` fails only its own request: its row
        freezes, every other stream is untouched."""
        poisoned: set = set()
        for ev in outbox:
            kind, req = ev[0], ev[1]
            if id(req) in poisoned or req.done.is_set():
                continue
            if kind == "deliver":
                toks, row = ev[2], ev[3]
                try:
                    self._deliver(req, toks)
                except Exception as e:
                    poisoned.add(id(req))
                    if row is not None:
                        self._drop_slot(row, req)
                        self._finished[row] = True
                    self._abort(req, "failed", error=e)
            else:
                self._finish(req)

    def _deliver(self, req: Request, toks: List[int]) -> None:
        plan = faults_lib.active()
        if plan is not None:
            plan.on_decode(req.rid)  # may fail THIS request only
        req.tokens.extend(toks)
        self.metrics.emitted(req, len(toks))
        if req.on_token is not None:
            req.on_token(toks)

    # ------------------------------------------------------ retirement

    def cancel(self, req: Request, status: str = "cancelled") -> bool:
        """Abort one request wherever it is; False if already finished.
        Device work is left to the pump: an active row is marked stale,
        a prefill's lease or cache is recycled at the next tick."""
        if req.done.is_set():
            return False
        with self._lock:
            if req in self._queue:
                self._queue.remove(req)
            for st in list(self._prefills):
                if st[0] is req:
                    self._prefills.remove(st)
                    self._orphans.append(st)
            for r, other in enumerate(self._slots):
                if other is req:
                    self._slots[r] = None
                    self._stale_rows.add(r)
        self._abort(req, status)
        self._report_depth()
        return True

    def _retire(self, req: Request) -> bool:
        """Claim-once terminal bookkeeping: the tenant's counts come down,
        a fair queue hears of it, and the adapter pin and the page lease
        are released (shared prefix pages stay cached).  False when the
        request was already retired."""
        with self._lock:
            if req._retired:
                return False
            req._retired = True
            t = req.tenant
            n = self._tenant_inflight.get(t, 0) - 1
            if n > 0:
                self._tenant_inflight[t] = n
            else:
                self._tenant_inflight.pop(t, None)
            k = self._tenant_tokens.get(t, 0) - req.token_cost
            if k > 0:
                self._tenant_tokens[t] = k
            else:
                self._tenant_tokens.pop(t, None)
            release = getattr(self._queue, "release", None)
            if release is not None:
                release(req)
        if req.adapter_row is not None and self.adapters is not None:
            self.adapters.release(req.adapter_id)
            req.adapter_row = None
        if req._lease is not None:
            self.pages.release(req._lease)
        return True

    def _finalize_critpath(self, req: Request) -> None:
        """Close the request's phase accrual into its finished breakdown
        and fold it into the active ledger (once: inside the claim-once
        retirement, ``finish_time`` stamped).  A ``migrated`` request
        carries its accrual on the snapshot instead."""
        if req.phases is None or req.status == "migrated":
            return
        now = req.finish_time
        if req._cp_wait is not None:
            req.phases[req._cp_wait] += max(0.0, now - req._cp_t0)
            req._cp_wait = None
        e2e = req.e2e_base + max(0.0, now - req.submit_time)
        req.critpath = critpath_lib.finalize(req.phases, e2e)
        critpath_lib.observe(req.tenant, req.critpath,
                             trace_id=req.trace_id)

    def _finish(self, req: Request) -> None:
        if not self._retire(req):
            return
        req.status = "ok"
        req.finish_time = time.perf_counter()
        self._finalize_critpath(req)
        if req.trace_id:
            extra = ({"critpath": req.critpath}
                     if req.critpath is not None else {})
            reqtrace.retired(req.trace_id, "ok", tokens=len(req.tokens),
                             **extra)
        self.metrics.finished(req)
        req.done.set()

    def _abort(self, req: Request, status: str,
               error: Optional[BaseException] = None) -> None:
        if not self._retire(req):
            return
        req.status = status
        req.error = error
        req.finish_time = time.perf_counter()
        self._finalize_critpath(req)
        if req.trace_id:
            # "migrated" is a no-op there: exported() owns the hop
            extra = ({"critpath": req.critpath}
                     if req.critpath is not None else {})
            reqtrace.retired(req.trace_id, status,
                             tokens=len(req.tokens), **extra)
        self.metrics.aborted(req, status)
        req.done.set()

    def _report_depth(self) -> None:
        self.metrics.depth(self.stats())

    # -------------------------------------------- migration (snapshots)

    def find(self, rid: int) -> Optional[Request]:
        """The in-flight request with id ``rid`` (queued, prefilling or
        active), or None."""
        with self._lock:
            for req in self._inflight_locked():
                if req.rid == rid:
                    return req
        return None

    def _inflight_locked(self) -> List[Request]:
        return ([r for r in self._queue] + [st[0] for st in self._prefills]
                + [r for r in self._slots if r is not None])

    def inflight_trace_ids(self) -> List[str]:
        """Trace ids of every in-flight request (queued, prefilling,
        active)."""
        with self._lock:
            reqs = self._inflight_locked()
        return [r.trace_id for r in reqs if r.trace_id]

    def inflight_critpath(self) -> Dict[str, dict]:
        """Live critical-path breakdowns keyed by trace_id: each
        in-flight request's accrual so far, finalized against now with
        its open wait phase included."""
        with self._lock:
            reqs = self._inflight_locked()
        now = time.perf_counter()
        out: Dict[str, dict] = {}
        for req in reqs:
            if req.phases is None or not req.trace_id:
                continue
            ph = dict(req.phases)
            if req._cp_wait is not None:
                ph[req._cp_wait] = ph.get(req._cp_wait, 0.0) \
                    + max(0.0, now - req._cp_t0)
            e2e = req.e2e_base + max(0.0, now - req.submit_time)
            out[req.trace_id] = critpath_lib.finalize(ph, e2e)
        return out

    def _acquire_pump(self, timeout_s: Optional[float]) -> bool:
        if timeout_s is None:
            return self._pump_lock.acquire()
        return self._pump_lock.acquire(timeout=timeout_s)

    def export(self, req: Request,
               timeout_s: Optional[float] = None) -> RequestSnapshot:
        """Export one in-flight request as a ``RequestSnapshot`` and
        retire it here with status ``migrated``.  Waits for the running
        tick (so the snapshot and the callback stream agree); with
        ``timeout_s`` it waits at most that long and then exports anyway,
        stamped ``clean=False``.  Raises ``RuntimeError`` for a request
        already terminal."""
        clean = self._acquire_pump(timeout_s)
        try:
            return self._export(req, clean)
        finally:
            if clean:
                self._pump_lock.release()

    def export_all(self, timeout_s: Optional[float] = None
                   ) -> List[RequestSnapshot]:
        """Export every in-flight request (in rid order), leaving the
        scheduler empty."""
        clean = self._acquire_pump(timeout_s)
        try:
            with self._lock:
                reqs = self._inflight_locked()
            snaps = []
            for req in sorted(reqs, key=lambda r: r.rid):
                try:
                    snaps.append(self._export(req, clean))
                except RuntimeError:
                    continue          # finished while we were exporting
            return snaps
        finally:
            if clean:
                self._pump_lock.release()

    def _export(self, req: Request, clean: bool) -> RequestSnapshot:
        """Capture and retire (the caller handled the pump lock)."""
        if req.done.is_set():
            raise RuntimeError(
                f"request {req.rid} already terminal ({req.status!r}); "
                "nothing to export")
        ctx = req.context if req.context is not None else req.prompt
        with self._lock:
            windows_done = next((st[2] for st in self._prefills
                                 if st[0] is req), None)
            active = any(r is req for r in self._slots)
        generated = list(req.tokens)
        now = time.perf_counter()
        snap = RequestSnapshot(
            rid=req.rid, prompt=req.prompt.copy(), generated=generated,
            max_new_tokens=req.max_new_tokens,
            stream_offset=len(generated), tenant=req.tenant,
            adapter_id=req.adapter_id,
            deadline_remaining_s=(None if req.deadline is None
                                  else max(0.0, req.deadline - now)),
            sampling=dict(self._sampling), clean=clean)
        if req.phases is not None:
            # critpath carry: a copy with the open wait phase closed now;
            # the importer books the export-to-import gap to migration
            ph = dict(req.phases)
            if req._cp_wait is not None:
                ph[req._cp_wait] = ph.get(req._cp_wait, 0.0) \
                    + max(0.0, now - req._cp_t0)
            snap.critpath = {
                "phases": ph,
                "elapsed_s": req.e2e_base + max(0.0, now - req.submit_time),
                "exported_at": now}
        # lease handoff: publish the request's FINAL full pages before the
        # retirement below releases them.  Final: for an active row the
        # context and all but the newest generated token (whose K/V is
        # written when it is next fed); for a prefill its finished
        # windows.  The manifest lists those chains for the page wire.
        lease = req._lease
        if self.paged and lease is not None and not lease.released:
            fresh = generated[req.resumed:]
            if active:
                written = ctx.size + max(0, len(fresh) - 1)
                full = (np.concatenate([ctx, np.asarray(fresh, np.int32)])
                        if fresh else ctx)
            else:
                written = lease.skip + (windows_done or 0) \
                    * self.prefill_chunk
                full = ctx
            published = full[:written]
            self.pages.handoff(lease, published)
            keys = pages_lib.prompt_chain_keys(published, self.page_size,
                                               lease.namespace)
            if keys and self.pages.prefix_cache:
                snap.shipped_pages = keys
                snap.page_size = self.page_size
        if not self.cancel(req, status="migrated"):
            raise RuntimeError(f"request {req.rid} finished during export")
        if req.trace_id:
            # the lane goes on at the importer: close this engine's stage
            # and start the migration's flow arrow
            snap.trace_id = req.trace_id
            reqtrace.exported(req.trace_id, rid=req.rid,
                              generated=len(generated), clean=bool(clean))
        return snap

    def export_chain_pages(self, context: np.ndarray,
                           timeout_s: Optional[float] = None,
                           namespace: bytes = b"") -> list:
        """The page wire's sender capture: the radix pages covering
        ``context``'s full chunks in prefix ``namespace``, read off the device as ``[(chunk_index,
        chain_hash, {leaf: CPU tensor [L, page_size, ...]})]`` (int8
        scale planes are leaves like any other).  The gather is issued
        under the pump lock, so no later tick's write or eviction can
        reach the pages before it; the copy to the host waits outside the
        lock.  Returns [] on a contiguous engine, with the prefix cache
        off, with nothing cached, or when the pump stays busy past
        ``timeout_s``: shipping fewer pages costs prefill windows, never
        correctness."""
        if not self.paged or not self.pages.prefix_cache:
            return []
        if not self._acquire_pump(timeout_s):
            return []
        try:
            entries = self.pages.chain_pages(
                np.asarray(context, np.int32).reshape(-1), namespace)
            if not entries:
                return []
            idx = torch.tensor([page for _, page, _ in entries],
                               dtype=torch.long, device=self.device)
            view = {k: v.index_select(1, idx)
                    for k, v in self._cache["kv"].items()}
        finally:
            self._pump_lock.release()
        view = {k: v.cpu() for k, v in view.items()}
        return [(chunk, chain, {k: v[:, j].contiguous()
                                for k, v in view.items()})
                for j, (chunk, _, chain) in enumerate(entries)]

    def import_wire_pages(self, context: np.ndarray, records,
                          timeout_s: Optional[float] = None,
                          namespace: bytes = b"") -> int:
        """The page wire's receiver splice: adopt shipped pages for
        ``context``'s leading full chunks, in prefix ``namespace``, through the lease every request
        uses: ``begin`` the shipped prefix (chunks already cached here
        are matched, so a re-delivery is idempotent), copy each missing
        chunk's payload into its leased page, and ``handoff`` to publish
        the chain; the next ``import_snapshot`` then skips those windows.
        ``records``: ``PageRecord``-like (``index``, ``chain``,
        ``payload``).  Every record's leaves, shapes and dtypes are
        checked against the pool before the first copy.  Returns the
        chunks now cached for the context: 0 on a contiguous engine, with
        the prefix cache off, for an alien layout or chain, an exhausted
        pool, or a pump busy past ``timeout_s``."""
        if not self.paged or not self.pages.prefix_cache or not records:
            return 0
        pg = self.page_size
        ctx = np.asarray(context, np.int32).reshape(-1)
        expected = pages_lib.prompt_chain_keys(ctx, pg, namespace)
        if not self._acquire_pump(timeout_s):
            return 0
        lease = None
        try:
            kv = self._cache["kv"]
            want = {k: ((v.shape[0],) + tuple(v.shape[2:]), v.dtype)
                    for k, v in kv.items()}
            take = []
            for j, rec in enumerate(sorted(records, key=lambda r: r.index)):
                if rec.index != j or j >= len(expected) \
                        or rec.chain != expected[j][0]:
                    break                # gap or foreign chain: stop
                if set(rec.payload) != set(want):
                    return 0             # alien pool layout
                if any(tuple(rec.payload[k].shape) != want[k][0]
                       or rec.payload[k].dtype != want[k][1] for k in want):
                    return 0             # page size or dtype mismatch
                take.append(rec)
            if not take:
                return 0
            ship = ctx[:len(take) * pg]
            try:
                lease = self.pages.begin(ship, ship.size, namespace)
            except pages_lib.PagePoolExhausted:
                return 0                 # no room: re-prefill instead
            # chunks below lease.skip are cached here already
            for j in range(lease.skip // pg, len(take)):
                page = int(lease.row[j])
                for k, buf in kv.items():
                    buf[:, page].copy_(take[j].payload[k])
            self.pages.handoff(lease, ship)
        except BaseException:
            if lease is not None:
                self.pages.release(lease)
            raise
        finally:
            self._pump_lock.release()
        return len(take)

    def import_snapshot(self, snap: RequestSnapshot,
                        on_token: Optional[Callable[[List[int]], None]]
                        = None) -> Request:
        """Admit an exported request and resume it where it stopped: the
        new request prefills ``prompt + generated`` (a radix hit, or
        shipped pages, skip windows), samples the next token from the
        last window and decodes on.  Its tokens are pre-seeded with
        ``generated``, so ``on_token`` fires only for new ones.  The same
        admission as ``submit`` (queue depth, quotas), charged at the
        remaining budget.  Raises ``ValueError`` for a snapshot this
        engine cannot resume faithfully: another sampling config, a spent
        budget, a context too long, an adapter without a table;
        ``KeyError`` for an adapter this engine does not know."""
        prompt = np.asarray(snap.prompt, np.int32).reshape(-1)
        generated = [int(t) for t in snap.generated]
        if snap.sampling is not None and snap.sampling != self._sampling:
            raise ValueError(
                f"sampling config mismatch: snapshot {snap.sampling} vs "
                f"engine {self._sampling}: resuming here would change the "
                "request's distribution")
        remaining = int(snap.max_new_tokens) - len(generated)
        if remaining < 1:
            raise ValueError(
                f"snapshot {snap.rid} has no remaining budget "
                f"({len(generated)}/{snap.max_new_tokens} generated)")
        ctx = (np.concatenate([prompt, np.asarray(generated, np.int32)])
               if generated else prompt)
        if ctx.size < 1:
            raise ValueError("empty snapshot context")
        self._check_adapter(snap.adapter_id)
        self._check_fits("snapshot context", ctx.size, remaining)
        now = time.perf_counter()
        tenant = str(snap.tenant)
        # critpath resume (outside the state lock): a snapshot carrying
        # accrual continues it whatever the local ledger state; the
        # export-to-import gap is the migration phase (0 for a foreign
        # clock's instant)
        carry = snap.critpath
        cp_base = 0.0
        if carry is not None:
            src = carry.get("phases") or {}
            cp_phases = {p: float(src.get(p, 0.0))
                         for p in critpath_lib.PHASES[:-1]}
            gap = max(0.0, now - float(carry.get("exported_at", now)))
            cp_phases["migration"] += gap
            cp_base = float(carry.get("elapsed_s", 0.0)) + gap
        else:
            cp_phases = critpath_lib.new_phases()
        with self._lock:
            self._admit_locked(tenant, remaining)
            req = Request(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(snap.max_new_tokens),
                          on_token=on_token, submit_time=now,
                          deadline=(None if snap.deadline_remaining_s is None
                                    else now + snap.deadline_remaining_s),
                          tenant=tenant, adapter_id=snap.adapter_id,
                          context=ctx, resumed=len(generated),
                          token_cost=remaining, trace_id=snap.trace_id)
            req.tokens = list(generated)
            req.phases = cp_phases
            req.e2e_base = cp_base
            req._cp_t0 = now
            self._next_rid += 1
            self._enqueue_locked(req)
        if req.trace_id:
            # the lane is open already: finish the flow arrow and queue
            # again on the same id
            reqtrace.imported(req.trace_id, rid=req.rid,
                              resumed=req.resumed)
        self.metrics.submitted(req)
        self._report_depth()
        return req
