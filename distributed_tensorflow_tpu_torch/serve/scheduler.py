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

Not ported yet: adapters/LoRA, tenancy, deadlines,
critical-path and request tracing, fault plans, export/import and the
page wire.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops import decoding as dec
from . import pages as pages_lib
from . import slots as slots_lib

__all__ = ["EngineStats", "Request", "SlotScheduler"]


@dataclasses.dataclass
class Request:
    """One in-flight generation request (host-side bookkeeping).
    ``status``: ``"pending"`` while in flight, then ``"ok"`` |
    ``"failed"`` | ``"cancelled"``."""
    rid: int
    prompt: np.ndarray                       # [plen] int32
    max_new_tokens: int
    on_token: Optional[Callable[[List[int]], None]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
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

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Snapshot of one engine's load and page-pool counters (all 0 on a
    contiguous engine)."""
    queued: int
    prefilling: int
    active: int
    num_slots: int
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

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prefix lookups that mapped at least one page."""
        if not self.prefix_lookups_total:
            return 0.0
        return self.prefix_hits_total / self.prefix_lookups_total


class SlotScheduler:
    """Drive a slot cache for a port ``GPT`` (on its device).

    Synchronous: callers pump ``step()`` (one tick: a window for every
    in-flight prefill, then one ``tick_steps`` decode run) or
    ``drain()``.  ``paged`` (default True) picks the page pool; False the
    contiguous stripes.  Paged only: ``page_size`` defaults to
    ``auto_page_size(max_len, 16)``; ``num_pages`` to ``num_slots`` full
    slots plus the trash page.  ``generator`` feeds the sampled path
    (``temperature > 0``).
    """

    def __init__(self, model, *, num_slots: int = 8,
                 max_len: Optional[int] = None, prefill_chunk: int = 32,
                 tick_steps: int = 4, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 paged: bool = True, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None):
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
        self.generator = generator
        self.page_size = page_size
        self.num_pages = int(num_pages)
        self.pages: Optional[pages_lib.PagePool] = None
        self._page_tab: Optional[np.ndarray] = None
        if self.paged:
            self.pages = pages_lib.PagePool(self.num_pages, page_size, pps)
            self._page_tab = np.zeros((num_slots, pps), np.int32)
        self._windows_skipped = 0
        self._next_rid = 0
        self._lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._stale_rows: set = set()
        self._orphans: List[list] = []
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[Request]] = [None] * num_slots
        # in-flight prefills: [req, windows [n, 1, W], next index,
        # payload]; the payload is the page lease (paged) or the
        # request's batch-1 prefill cache (contiguous)
        self._prefills: List[list] = []
        # contiguous: spare batch-1 prefill caches, reused across requests
        # (a stale column is masked by the slot's validity window)
        self._pf_pool: List[dict] = []

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

    # ------------------------------------------- the three device programs

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return dec.sample_logits(logits, self.temperature, self.top_k,
                                 self.top_p, generator=self.generator)

    def _page_row(self, lease: pages_lib.PageLease) -> torch.Tensor:
        return torch.from_numpy(lease.row).to(self.device)

    def _win_mid(self, window: np.ndarray, payload, pos: int):
        """Mid prefill window: paged, straight into the request's pages at
        ``pos``; contiguous, into its prefill cache (whose own ``pos``
        is that column).  Returns the payload to carry on."""
        ids = torch.from_numpy(window).to(self.device)
        if self.paged:
            self.model.decode_window_paged(
                self._cache["kv"], ids, self._page_row(payload), pos,
                head="none")
            return payload
        return self.model.decode_window(payload, ids, head="none")[1]

    def _last_admit(self, window: np.ndarray, payload, pos: int,
                    last_idx: int, slot: int, length: int,
                    budget: int) -> torch.Tensor:
        """Last prefill window + first-token sample + slot arming.  Paged:
        no splice, the prompt's K/V already live in the request's pages
        and admission points the slot's column state at them (the
        page-table row is host state, handed to the next tick).
        Contiguous: the prefill cache's row is spliced into the slot.
        Returns the first token as a 1-element device tensor."""
        ids = torch.from_numpy(window).to(self.device)
        if self.paged:
            logits, _ = self.model.decode_window_paged(
                self._cache["kv"], ids, self._page_row(payload), pos,
                head=last_idx)
        else:
            logits, payload = self.model.decode_window(payload, ids,
                                                       head=last_idx)
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

    def _tick(self, page_tab: Optional[torch.Tensor]):
        """``tick_steps`` decode steps (``page_tab``: the paged layout's
        table snapshot, None when contiguous); returns (emitted [K, S],
        live [K, S]) on the device."""
        cache, tokens = self._cache, self._tokens
        finished, remaining = self._finished, self._remaining
        emitted, lives = [], []
        for _ in range(self.tick_steps):
            live = ~finished
            if self.paged:
                logits, cache = pages_lib.decode_paged_step(
                    self.model, cache, page_tab, tokens, live)
            else:
                logits, cache = slots_lib.decode_slots_step(
                    self.model, cache, tokens, live)
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

    def submit(self, prompt, max_new_tokens: int,
               on_token: Optional[Callable[[List[int]], None]] = None
               ) -> Request:
        """Queue one request.  ``prompt``: [plen] int token ids.  The
        prompt + ``max_new_tokens`` must fit ``max_len``, and so must the
        chunk-padded prompt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = prompt.size
        if plen < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}")
        padded = -(-plen // self.prefill_chunk) * self.prefill_chunk
        if plen + max_new_tokens > self.max_len or padded > self.max_len:
            raise ValueError(
                f"prompt ({plen}, chunk-padded {padded}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}")
        with self._lock:
            req = Request(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens),
                          on_token=on_token,
                          submit_time=time.perf_counter())
            self._next_rid += 1
            self._queue.append(req)
        return req

    # ---------------------------------------------------------- the tick

    @property
    def busy(self) -> bool:
        with self._lock:
            return bool(self._queue) or bool(self._prefills) \
                or any(r is not None for r in self._slots)

    def stats(self) -> EngineStats:
        with self._lock:
            base = dict(queued=len(self._queue),
                        prefilling=len(self._prefills),
                        active=sum(r is not None for r in self._slots),
                        num_slots=self.num_slots,
                        prefill_windows_skipped_total=self._windows_skipped)
        if self.paged:
            p = self.pages.stats()
            for key in ("pages_total", "pages_free", "pages_per_request",
                        "prefix_lookups_total", "prefix_hits_total",
                        "prefix_tokens_reused_total",
                        "prefix_evictions_total", "cow_splits_total",
                        "page_size"):
                base[key] = p[key]
        return EngineStats(**base)

    def step(self) -> bool:
        """One tick: start prefills for free slots, advance every
        in-flight prefill by one window, then one decode run over the
        slots.  Returns False when fully idle."""
        with self._pump_lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        did = False
        outbox: List[tuple] = []     # tick-ordered deliveries/finishes
        self._harvest_orphans()
        self._freeze_stale_rows()
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
            except pages_lib.PagePoolExhausted:
                # every page is pinned by an in-flight request: requeue
                # (a retirement frees pages, so this always drains)
                with self._lock:
                    self._queue.appendleft(req)
                break
            with self._lock:
                self._prefills.append(st)
        with self._lock:
            pending = list(self._prefills)
        if pending:
            did = True
            for st in pending:
                self._advance_prefill(st, outbox)
        with self._lock:
            active = any(r is not None for r in self._slots)
        if active:
            did = True
            self._decode_tick(outbox)
        self._flush(outbox)
        return did

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

    # ---------------------------------------------------------- prefill

    def _begin_prefill(self, req: Request) -> list:
        """Cut the prompt into right-padded windows and take its payload.
        Paged: lease the request's pages (mapping any cached prefix chain
        read-only, private pages for the rest of prompt + budget); only
        the unmatched tail is windowed.  Contiguous: a spare (or new)
        batch-1 prefill cache at ``pos`` 0."""
        w = self.prefill_chunk
        plen = req.prompt.size
        if not self.paged:
            n_win = -(-plen // w)
            padded = np.zeros((n_win * w,), np.int32)
            padded[:plen] = req.prompt
            with self._lock:
                kv = self._pf_pool.pop() if self._pf_pool else None
            if kv is None:
                kv = slots_lib.strip_pos(self.model.init_cache(
                    1, self.max_len))
            return [req, padded.reshape(n_win, 1, w), 0, dict(kv, pos=0)]
        lease = self.pages.begin(req.prompt, plen + req.max_new_tokens - 1)
        req._lease = lease
        remaining = req.prompt[lease.skip:]
        n_win = -(-remaining.size // w)
        padded = np.zeros((n_win * w,), np.int32)
        padded[:remaining.size] = remaining
        with self._lock:
            # window dispatches avoided by the prefix hit
            self._windows_skipped += -(-plen // w) - n_win
        return [req, padded.reshape(n_win, 1, w), 0, lease]

    def _advance_prefill(self, st: list, outbox: List[tuple]) -> None:
        """One window for one in-flight prefill; admits the request into
        a slot on its last window (window i runs at ``pos = skip + i*W``,
        so a paged prefix hit never dispatches the shared windows)."""
        req, windows, i, payload = st
        with self._lock:
            if st not in self._prefills:
                return       # cancelled cross-thread: harvest recycles it
        skip = payload.skip if self.paged else 0
        if i < len(windows) - 1:
            payload = self._win_mid(windows[i], payload,
                                    skip + i * self.prefill_chunk)
            with self._lock:
                st[2], st[3] = i + 1, payload
            return
        plen = req.prompt.size
        last_idx = plen - skip - 1 - (len(windows) - 1) * self.prefill_chunk
        with self._lock:
            if st not in self._prefills or req.done.is_set():
                return
            self._prefills.remove(st)
            slot = self._slots.index(None)
            # reserve before arming so the free-slot count stays right
            self._slots[slot] = req
            self._stale_rows.discard(slot)
        tok = self._last_admit(
            windows[-1], payload,
            skip + (len(windows) - 1) * self.prefill_chunk, last_idx, slot,
            plen, req.max_new_tokens)
        first = int(tok[0])          # host fetch: the TTFT barrier
        req.first_token_time = time.perf_counter()
        if self.paged:
            # the prompt's full pages are final now: publish them so the
            # NEXT request with this prefix skips their windows
            self.pages.register(payload, req.prompt)
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
        if req.max_new_tokens <= 1 or (self.eos_id is not None
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

    def _decode_tick(self, outbox: List[tuple]) -> None:
        with self._lock:
            slots = list(self._slots)
            # page-table snapshot: host mutations between ticks never
            # tear a run mid-read
            tab = (torch.from_numpy(self._page_tab.copy()).to(self.device)
                   if self.paged else None)
        em, live = self._tick(tab)
        k, s = em.shape
        host = torch.cat([em.reshape(-1), live.reshape(-1).to(torch.int32),
                          self._finished.to(torch.int32)]).cpu().numpy()
        em = host[:k * s].reshape(k, s)
        mask = host[k * s:2 * k * s].reshape(k, s).astype(bool)
        fin = host[2 * k * s:].astype(bool)
        for r, req in enumerate(slots):
            if req is None:
                continue
            with self._lock:
                if self._slots[r] is not req:
                    continue         # cancelled mid-run: drop tokens
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
                    req.tokens.extend(toks)
                    if req.on_token is not None:
                        req.on_token(toks)
                except Exception as e:
                    poisoned.add(id(req))
                    if row is not None:
                        self._drop_slot(row, req)
                        self._finished[row] = True
                    self._abort(req, "failed", error=e)
            else:
                self._finish(req)

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
        return True

    def _retire(self, req: Request) -> bool:
        """Claim-once terminal bookkeeping; releases a paged request's
        lease (shared prefix pages stay cached)."""
        with self._lock:
            if req._retired:
                return False
            req._retired = True
        if req._lease is not None:
            self.pages.release(req._lease)
        return True

    def _finish(self, req: Request) -> None:
        if not self._retire(req):
            return
        req.status = "ok"
        req.finish_time = time.perf_counter()
        req.done.set()

    def _abort(self, req: Request, status: str,
               error: Optional[BaseException] = None) -> None:
        if not self._retire(req):
            return
        req.status = status
        req.error = error
        req.finish_time = time.perf_counter()
        req.done.set()
