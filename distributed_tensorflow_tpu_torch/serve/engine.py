"""Engine façade: submit() -> handle, streaming callbacks, obs metrics.

Counterpart of ``distributed_tensorflow_tpu/serve/engine.py``;
``paged=False`` serves from contiguous per-slot stripes instead of the
page pool::

    from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_small

    model = GPT(gpt_small(dtype=torch.bfloat16))        # on the card
    eng = Engine(model, num_slots=8, max_len=1024, prefill_chunk=32)
    h = eng.submit(prompt_ids, max_new_tokens=64,
                   on_token=lambda toks: print(toks))
    eng.drain()                     # or pump eng.step() yourself
    h.tokens                        # the generated ids (incl. EOS)

Per-request LoRA adapters, admission and live migration::

    eng = Engine(model, adapter_capacity=4, adapter_rank=16,
                 max_queue_depth=64, tenancy=TenantPolicy(quotas))
    eng.load_adapter("tuned", adapter)            # GPT.init_lora layout
    h = eng.submit(ids, 64, adapter_id="tuned", tenant="a", deadline_s=2.0)
    snaps = eng.export_inflight()                 # or drain(timeout_s=...)
    h2 = other.import_request(snaps[0])           # resumes where it stopped

The engine is synchronous: the caller pumps ``step()``/``drain()``.  It
runs on the card unless built with ``device="cpu"``, and raises when
asked for a card that is not there.

Metrics (``registry=``, default the process registry
``obs.metrics.REGISTRY``; the JAX package's series, docs/
OBSERVABILITY.md): ``dttpu_serve_queue_depth`` / ``_active_slots`` /
``_pages_free`` / ``_pages_per_request`` / ``_page_size`` gauges,
``dttpu_serve_ttft_seconds`` and ``_request_decode_seconds`` histograms,
``dttpu_serve_tokens_total`` / ``_requests_total`` / ``_rejected_total``
/ ``_deadline_expired_total`` / ``_failed_total`` /
``_prefix_hits_total`` / ``_prefix_evictions_total`` counters, the
per-tenant series and ``dttpu_serve_stream_resume_offset``.  Request
tracing: ``submit`` mints a ``trace_id`` when a tracer is active (or
takes the caller's), and the scheduler emits the request's lane
(``obs.reqtrace``); with a ``CritpathLedger`` active each handle ends
with its ``critpath``.  ``chaos_tag`` names the engine to the fault
plan's engine-targeted kinds; an injected ``fail_decode`` fails its
request only.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Union

import torch

from ..models.gpt import resolve_device
from ..obs import metrics as metrics_lib
from ..obs import reqtrace
from .adapters import AdapterTable
from .scheduler import (EngineStats, QueueFullError, Request,
                        RequestSnapshot, SlotScheduler)

__all__ = ["DrainResult", "Engine", "EngineStats", "QueueFullError",
           "RequestHandle", "RequestSnapshot", "ServeMetrics"]


class ServeMetrics:
    """obs wiring for the scheduler's duck-typed metrics sink: the JAX
    package's series, names and buckets."""

    # TTFT is queue-position dependent; sub-ms to minutes, so a wide grid
    _TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, registry: Optional[metrics_lib.Registry] = None):
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self.registry = reg
        self.queue_depth = reg.gauge(
            "dttpu_serve_queue_depth",
            "Requests queued, not yet prefilling.")
        self.active_slots = reg.gauge(
            "dttpu_serve_active_slots",
            "Slots holding an in-flight request.")
        self.ttft = reg.histogram(
            "dttpu_serve_ttft_seconds",
            "Submit to first generated token on the host.",
            buckets=self._TTFT_BUCKETS)
        self.request_decode = reg.histogram(
            "dttpu_serve_request_decode_seconds",
            "First to last generated token, per request.")
        self.tokens = reg.counter(
            "dttpu_serve_tokens_total",
            "Generated tokens delivered to callers.")
        self.requests = reg.counter(
            "dttpu_serve_requests_total",
            "Requests submitted to the engine.")
        self.rejected = reg.counter(
            "dttpu_serve_rejected_total",
            "Requests rejected at submit (queue at max_queue_depth).")
        self.deadline_expired = reg.counter(
            "dttpu_serve_deadline_expired_total",
            "Requests retired past their deadline_s budget.")
        self.failed = reg.counter(
            "dttpu_serve_failed_total",
            "Requests failed individually (callback/decode error) "
            "without killing the scheduler.")
        # live migration (docs/RESILIENCE.md): where imported requests'
        # streams resume — the offset IS the decode work the snapshot
        # salvaged, so the distribution doubles as a preserved-work view
        self.stream_resume = reg.histogram(
            "dttpu_serve_stream_resume_offset",
            "Stream offset (tokens already delivered on the source "
            "engine) at which an imported request resumed.",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0))
        # paged-KV series (serve/pages.py; flat zero on a contiguous
        # engine) — rendered from the same Engine.stats() snapshot as
        # the gauges above, so there is exactly ONE bookkeeping source
        self.pages_free = reg.gauge(
            "dttpu_serve_pages_free",
            "KV-cache pool pages on the free list.")
        self.pages_per_request = reg.gauge(
            "dttpu_serve_pages_per_request",
            "Average pages held per in-flight request "
            "(shared prefix pages count once per holder).")
        self.prefix_hits = reg.counter(
            "dttpu_serve_prefix_hits_total",
            "Requests that mapped radix-cached prefix pages and "
            "skipped their prefill windows.")
        self.prefix_evictions = reg.counter(
            "dttpu_serve_prefix_evictions_total",
            "Radix-cached prefix pages reclaimed by LRU eviction "
            "under allocation pressure.")
        # prefix-affinity federation (with the fleet slice): the pool's
        # hot-chain fingerprint rendered as labeled gauges so a
        # cross-host router can score prefix affinity from SCRAPED
        # stats — ``chain`` is the radix chain hash (hex; bounded by
        # ``pages.FINGERPRINT_K``, so cardinality is a config knob, not
        # traffic-dependent), the value is cached tokens.  Page size
        # rides along: remote scorers must chunk prompts identically.
        self.page_size_gauge = reg.gauge(
            "dttpu_serve_page_size",
            "KV page-pool page size in tokens (0 on a contiguous "
            "engine).")
        self._chain_gauges: dict = {}
        # counters render by delta against the stats() snapshot (the
        # exposition forbids decreasing counters; stats are monotonic)
        self._last_prefix_hits = 0
        self._last_prefix_evictions = 0
        # per-tenant series, created lazily at first sight of a tenant
        # (cardinality = the tenant set, which admission policy bounds)
        self._tenant_tokens: dict = {}
        self._tenant_inflight: dict = {}
        self._tenant_rejected: dict = {}

    def tenant_rejected(self, tenant: str):
        c = self._tenant_rejected.get(tenant)
        if c is None:
            c = self._tenant_rejected[tenant] = self.registry.counter(
                "dttpu_tenant_rejected_total",
                "Requests rejected by per-tenant quota at admission.",
                labels={"tenant": tenant})
        return c

    def _tenant_gauge(self, tenant: str):
        g = self._tenant_inflight.get(tenant)
        if g is None:
            g = self._tenant_inflight[tenant] = self.registry.gauge(
                "dttpu_tenant_inflight",
                "In-flight requests (queued+prefilling+active), "
                "by tenant.", labels={"tenant": tenant})
        return g

    # -- scheduler hooks --------------------------------------------------

    def submitted(self, req: Request) -> None:
        self.requests.inc()

    def admitted(self, req: Request) -> None:
        if req.ttft_s is not None:
            self.ttft.observe(req.ttft_s)

    def emitted(self, req: Request, n: int) -> None:
        self.tokens.inc(n)
        c = self._tenant_tokens.get(req.tenant)
        if c is None:
            c = self._tenant_tokens[req.tenant] = self.registry.counter(
                "dttpu_tenant_tokens_total",
                "Generated tokens delivered, by tenant.",
                labels={"tenant": req.tenant})
        c.inc(n)

    def finished(self, req: Request) -> None:
        if req.ttft_s is None:
            return
        if req.first_token_time is not None and req.finish_time is not None:
            self.request_decode.observe(
                req.finish_time - req.first_token_time)

    def aborted(self, req: Request, status: str) -> None:
        if status == "deadline_exceeded":
            self.deadline_expired.inc()
        elif status == "failed":
            self.failed.inc()

    def depth(self, stats: EngineStats) -> None:
        """Render the gauges from the scheduler's ``stats()`` snapshot —
        the one bookkeeping source (no separate counters here; the
        paged-KV counters advance by snapshot delta)."""
        self.queue_depth.set(stats.queued)
        self.active_slots.set(stats.active)
        self.pages_free.set(stats.pages_free)
        self.pages_per_request.set(stats.pages_per_request)
        d = stats.prefix_hits_total - self._last_prefix_hits
        if d > 0:
            self.prefix_hits.inc(d)
            self._last_prefix_hits = stats.prefix_hits_total
        d = stats.prefix_evictions_total - self._last_prefix_evictions
        if d > 0:
            self.prefix_evictions.inc(d)
            self._last_prefix_evictions = stats.prefix_evictions_total
        for tenant, n in stats.inflight_per_tenant.items():
            self._tenant_gauge(tenant).set(n)
        for tenant, g in self._tenant_inflight.items():
            if tenant not in stats.inflight_per_tenant:
                g.set(0)
        self.page_size_gauge.set(stats.page_size)
        for chain, tokens in stats.prefix_fingerprint.items():
            key = chain.hex()
            g = self._chain_gauges.get(key)
            if g is None:
                g = self._chain_gauges[key] = self.registry.gauge(
                    "dttpu_serve_prefix_chain_tokens",
                    "Radix-cached tokens under this chain hash — the "
                    "pool's hot-chain fingerprint, federated for "
                    "cross-host prefix-affinity routing.",
                    labels={"chain": key})
            g.set(tokens)
        live = {c.hex() for c in stats.prefix_fingerprint}
        for key, g in self._chain_gauges.items():
            if key not in live:
                g.set(0)             # evicted chain: renders 0, and the
                #                      federation layer drops 0-chains


class RequestHandle:
    """Caller-facing view of one request."""

    def __init__(self, req: Request, engine: "Engine"):
        self._req = req
        self._engine = engine

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def tokens(self) -> List[int]:
        """Generated ids so far (includes the EOS token when one fired)."""
        return list(self._req.tokens)

    @property
    def done(self) -> bool:
        return self._req.done.is_set()

    @property
    def tenant(self) -> str:
        return self._req.tenant

    @property
    def adapter_id(self) -> Optional[str]:
        return self._req.adapter_id

    @property
    def status(self) -> str:
        """``pending`` while in flight; then ``ok`` |
        ``deadline_exceeded`` | ``failed`` | ``cancelled`` | ``migrated``
        (exported as a ``RequestSnapshot``); a non-ok handle keeps the
        tokens delivered before it ended."""
        return self._req.status

    @property
    def error(self) -> Optional[BaseException]:
        return self._req.error

    @property
    def ttft_s(self) -> Optional[float]:
        return self._req.ttft_s

    @property
    def decode_s(self) -> Optional[float]:
        if self._req.first_token_time is None \
                or self._req.finish_time is None:
            return None
        return self._req.finish_time - self._req.first_token_time

    @property
    def critpath(self) -> Optional[Dict[str, float]]:
        """The finished critical-path breakdown (``obs.critpath``):
        exclusive phase seconds summing to ``e2e_s``, plus
        ``interference_share``.  None while in flight, or when no ledger
        was active at submit."""
        cp = self._req.critpath
        return dict(cp) if cp is not None else None

    @property
    def trace_id(self) -> Optional[str]:
        return self._req.trace_id

    def result(self) -> List[int]:
        """Pump the engine until this request finishes; return its
        tokens.  (Synchronous engine: waiting IS driving.)"""
        while not self.done:
            if not self._engine.step():
                break
        return self.tokens


class DrainResult:
    """Outcome of ``Engine.drain``: truthy iff every request finished in
    place.  A drain that ran out of time exports the stragglers instead
    of leaving them pending: ``exported`` holds their snapshots, for
    ``import_request`` here or on another engine."""

    __slots__ = ("completed", "exported")

    def __init__(self, completed: bool, exported=()):
        self.completed = bool(completed)
        self.exported: List[RequestSnapshot] = list(exported)

    def __bool__(self) -> bool:
        return self.completed

    def __repr__(self) -> str:
        return (f"DrainResult(completed={self.completed}, "
                f"exported={len(self.exported)})")


class Engine:
    """Continuous-batching serving engine over a paged (default) or
    contiguous KV cache.

    ``model`` is a port ``GPT`` on ``device`` (default ``"cuda"``).
    Keyword arguments go to ``SlotScheduler`` (num_slots, max_len,
    prefill_chunk, tick_steps, temperature/top_k/top_p, eos_id/pad_id,
    generator, paged, page_size/num_pages, prefix_cache); also:

      registry: the ``obs.metrics.Registry`` the engine's
        ``ServeMetrics`` record into (default: the process registry
        ``obs.metrics.REGISTRY``, served by any ``Telemetry`` endpoint
        already running).
      default_max_new_tokens: the ``submit()`` budget when none is given.
      max_queue_depth: ``submit``/``import_request`` raise
        ``QueueFullError`` when this many requests already wait for
        prefill (None: no bound).
      default_deadline_s: the ``submit()`` deadline when none is given
        (None: none).
      tenancy: a ``fleet.TenantPolicy``: its quotas are checked at
        ``submit`` (``QuotaExceededError``) and its deficit fair queue
        replaces the FIFO.
      adapter_capacity / adapter_rank: > 0 builds an ``AdapterTable`` of
        that many rank-``adapter_rank`` LoRA adapters:
        ``load_adapter()``, then ``submit(adapter_id=...)``; requests
        without one ride the zero row and decode as an adapter-free
        engine does.  0 (default): no table and no adapter work.
    """

    def __init__(self, model, *, device: Union[str, torch.device] = "cuda",
                 registry: Optional[metrics_lib.Registry] = None,
                 default_max_new_tokens: int = 64,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 tenancy=None, adapter_capacity: int = 0,
                 adapter_rank: int = 8, **scheduler_kwargs):
        device = resolve_device(device)
        if model.device.type != device.type or (
                device.index is not None and model.device != device):
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {device}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1; got {max_queue_depth}")
        self.device = model.device
        self.metrics = ServeMetrics(registry)
        self.default_max_new_tokens = default_max_new_tokens
        self.default_deadline_s = default_deadline_s
        self.tenancy = tenancy
        self.adapters = (AdapterTable(model, adapter_capacity, adapter_rank,
                                      registry=self.metrics.registry)
                         if adapter_capacity else None)
        self.scheduler = SlotScheduler(
            model, queue=tenancy.make_queue() if tenancy is not None
            else None, adapters=self.adapters, metrics=self.metrics,
            max_queue_depth=max_queue_depth, tenancy=tenancy,
            **scheduler_kwargs)

    def stats(self) -> EngineStats:
        return self.scheduler.stats()

    @property
    def chaos_tag(self) -> int:
        """Identity for the engine-targeted fault kinds (stall_tick,
        wedge_replica); a fleet router stamps its replica id here."""
        return self.scheduler.chaos_tag

    @chaos_tag.setter
    def chaos_tag(self, tag: int) -> None:
        self.scheduler.chaos_tag = int(tag)

    def load_adapter(self, adapter_id: str, adapter) -> None:
        """Register a LoRA adapter (``GPT.init_lora`` layout) for
        ``submit(adapter_id=...)``: a host copy now, the device copy at
        its first use; re-loading a resident id replaces it for every
        later device call (the hot update)."""
        if self.adapters is None:
            raise ValueError("engine built without adapters "
                             "(adapter_capacity=0)")
        self.adapters.register(adapter_id, adapter)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[List[int]], None]] = None,
               deadline_s: Optional[float] = None,
               tenant: str = "default",
               adapter_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> RequestHandle:
        """Queue one prompt ([plen] ids, any length) -> handle;
        ``on_token`` streams each delivered token batch.  Raises
        ``QueueFullError`` at ``max_queue_depth`` (counted in
        ``dttpu_serve_rejected_total``) and the tenancy policy's
        ``QuotaExceededError`` over a quota (``dttpu_tenant_rejected_total``);
        ``adapter_id`` selects a loaded adapter (``KeyError`` for an
        unknown one).  ``trace_id`` carries a caller's trace id; when None
        and a tracer is active one is minted here, the engine being the
        front door."""
        if trace_id is None:
            trace_id = reqtrace.mint()
        try:
            req = self.scheduler.submit(
                prompt, max_new_tokens or self.default_max_new_tokens,
                on_token=on_token,
                deadline_s=(deadline_s if deadline_s is not None
                            else self.default_deadline_s),
                tenant=tenant, adapter_id=adapter_id, trace_id=trace_id)
        except QueueFullError:
            self.metrics.rejected.inc()
            raise
        except (ValueError, KeyError):
            raise                    # validation, not admission policy
        except Exception:
            if self.tenancy is not None:
                self.metrics.tenant_rejected(str(tenant)).inc()
            raise
        return RequestHandle(req, self)

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def inflight_trace_ids(self) -> List[str]:
        """Trace ids of every in-flight request (``obs.reqtrace``)."""
        return self.scheduler.inflight_trace_ids()

    def inflight_critpath(self) -> Dict[str, dict]:
        """Live critical-path breakdowns keyed by trace_id
        (``obs.critpath``)."""
        return self.scheduler.inflight_critpath()

    def step(self) -> bool:
        """One scheduler tick; False when fully idle."""
        return self.scheduler.step()

    def drain(self, timeout_s: Optional[float] = None) -> DrainResult:
        """Run until every submitted request has finished -> a truthy
        ``DrainResult``.  With ``timeout_s``, the requests still in
        flight when it runs out are exported (their handles end
        ``migrated``, the engine is left idle) and the falsy result
        carries their snapshots."""
        if timeout_s is None:
            self.scheduler.drain()
            return DrainResult(True)
        deadline = time.perf_counter() + timeout_s
        while self.scheduler.busy:
            if time.perf_counter() >= deadline:
                snaps = self.scheduler.export_all()
                return DrainResult(not snaps, snaps)
            self.scheduler.step()
        return DrainResult(True)

    def cancel(self, handle: RequestHandle) -> bool:
        """Abort one request (status ``cancelled``); False if it already
        finished."""
        return self.scheduler.cancel(handle._req)

    # ------------------------------------------------- live migration

    def export_request(self, handle: Union[RequestHandle, int],
                       timeout_s: Optional[float] = None
                       ) -> RequestSnapshot:
        """Export one in-flight request (a handle or its rid) as a
        ``RequestSnapshot`` and retire it here ``migrated``; another
        engine's ``import_request`` resumes it.  ``timeout_s`` bounds the
        wait for the running tick (the export is then ``clean=False``).
        Raises ``KeyError`` for an unknown rid, ``RuntimeError`` for a
        request already terminal."""
        if isinstance(handle, RequestHandle):
            req = handle._req
        else:
            req = self.scheduler.find(int(handle))
            if req is None:
                raise KeyError(f"no in-flight request with rid {handle}")
        return self.scheduler.export(req, timeout_s=timeout_s)

    def export_inflight(self, timeout_s: Optional[float] = None
                        ) -> List[RequestSnapshot]:
        """Export every in-flight request (rid order), leaving the engine
        idle."""
        return self.scheduler.export_all(timeout_s=timeout_s)

    def export_wire_pages(self, snap: RequestSnapshot,
                          timeout_s: Optional[float] = None) -> list:
        """The KV pages behind ``snap``'s shipped-pages manifest, read off
        this engine's card: ``[(chunk_index, chain_hash, payload)]``, the
        payload a CPU tensor per pool leaf, ready for
        ``fleet.pagewire.frame_chunk``.  Call after ``export_request``,
        whose handoff published the pages (a page evicted since simply
        does not ship).  [] without a manifest, on a contiguous engine,
        for an adapter this engine no longer holds, or with the pump
        busy past ``timeout_s``."""
        manifest = snap.shipped_pages
        ns = self.prefix_namespace(snap.adapter_id)
        if not manifest or ns is None:
            return []
        return self.scheduler.export_chain_pages(
            snap.context[:int(manifest[-1][1])], timeout_s=timeout_s,
            namespace=ns)

    def import_wire_pages(self, snap: RequestSnapshot, records,
                          timeout_s: Optional[float] = 5.0) -> int:
        """Splice shipped pages (``PageRecord``s) for ``snap`` into this
        engine's pool BEFORE ``import_request``, so that the resumed
        prefill matches them and skips their windows.  Returns the chunks
        adopted; 0 (re-prefill) for another page size, an alien layout or
        chain, an adapter not loaded here (load it first: its pages are
        matched under its weights' digest), a full pool or a pump busy
        past ``timeout_s``."""
        ns = self.prefix_namespace(snap.adapter_id)
        if ns is None or not snap.page_size \
                or snap.page_size != self.scheduler.page_size:
            return 0
        return self.scheduler.import_wire_pages(snap.context, records,
                                                timeout_s=timeout_s,
                                                namespace=ns)

    def prefix_namespace(self, adapter_id: Optional[str]
                         ) -> Optional[bytes]:
        """The radix namespace a request under ``adapter_id`` is cached
        in here (``b""`` without one; the page wire and the router's
        affinity score key chains by it); None when this engine does not
        hold that adapter, so that no page of it can be matched."""
        if adapter_id is None:
            return b""
        if self.adapters is None or not self.adapters.known(adapter_id):
            return None
        return self.adapters.namespace(adapter_id)

    def import_request(self, snap: RequestSnapshot,
                       on_token: Optional[Callable[[List[int]], None]]
                       = None) -> RequestHandle:
        """Resume an exported request here -> handle.  Admission as in
        ``submit``, charged at the remaining budget; ``on_token`` streams
        only tokens beyond the snapshot's ``stream_offset``; the handle's
        ``tokens`` are the full sequence."""
        try:
            req = self.scheduler.import_snapshot(snap, on_token=on_token)
        except QueueFullError:
            self.metrics.rejected.inc()
            raise
        except (ValueError, KeyError):
            raise                    # validation, not admission policy
        except Exception:
            if self.tenancy is not None:
                self.metrics.tenant_rejected(str(snap.tenant)).inc()
            raise
        self.metrics.stream_resume.observe(float(snap.stream_offset))
        return RequestHandle(req, self)

    def generate_batch(self, prompts,
                       max_new_tokens: Optional[int] = None
                       ) -> List[List[int]]:
        """Submit a list of prompts, drain, return each request's tokens
        in submission order.  If a submit raises, the handles already
        submitted are cancelled before the error propagates."""
        handles = []
        try:
            for p in prompts:
                handles.append(self.submit(p, max_new_tokens))
        except BaseException:
            for h in handles:
                self.scheduler.cancel(h._req)
            raise
        self.drain()
        return [h.tokens for h in handles]
