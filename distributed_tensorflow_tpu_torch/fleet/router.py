"""Fleet router: spread requests over N ``Engine`` replicas, survive losses.

Counterpart of ``distributed_tensorflow_tpu/fleet/router.py``: the same
policy, bookkeeping and series, over the port's engines.

* **Prefix-affinity placement**: each submit reads every live replica's
  ``Engine.stats()`` (a host-side read) and orders the candidates by
  ``inflight - affinity_weight * expected_pages_reused(...)``, ties by
  raw inflight, then replica id.  With no fingerprint anywhere this is
  exactly the least-loaded order, so a replayed trace reproduces
  ``router.placements``; ``affinity_weight=0`` turns affinity off.
* **Retry within the deadline**: a submit rejected by one replica (queue
  full, tenant quota) tries the others in score order; a request whose
  replica dies, drains or is quarantined MIGRATES (``RequestSnapshot``
  export, import on a survivor with its progress), and every
  ``on_token`` the router attaches is an offset-deduplicating shim, so
  the caller's stream is exactly-once across any number of hops.
* **Rolling restarts**: ``drain_replica`` (migrating by default),
  ``remove_replica``, ``add_replica``, ``resume_replica``.
* **Quarantine**: ``quarantine_replica`` (the ``Watchdog``'s action)
  takes a stuck-but-alive replica out of rotation, exports its requests
  past a wedged pump (``clean=False``) and keeps the engine in
  ``router.quarantined``.
* **Chaos**: ``kill_replica`` and ``correlated_kill`` raise at this
  router's pump of a replica (``plan.on_replica_step``).
* **Page wire**: with ``page_wire=`` a migration ships the victim's
  radix pages to the destination, whose import then skips those prefill
  windows; a wire failure degrades to re-prefill.

Adapter namespaces.  The port's radix tree keeps one root per adapter
namespace (``serve/pages.py``), so an adapter request is scored under
the namespace the candidate reports for its adapter
(``Engine.prefix_namespace``): a replica that does not hold the adapter
scores 0, and pages cached for another adapter, or for none, are never
credited.  The reference scores every prompt in the default namespace;
adapter-free placement is the reference's exactly.

One card.  The replicas of an in-process fleet run in one process, on
the card's default stream, and may share one model; each has its own page
pool.  A wedged pump is a blocked host thread, not a blocked stream: the
other replicas' kernels keep running while it is held.  A replica taken
out by ``remove_replica``, ``quarantine_replica`` or a pump failure keeps
its page pool and adapter table on the card until the caller drops the
engine the router hands back (``remove_replica``'s return value, the
entry of ``router.quarantined``).

The router is synchronous like the engine: the caller pumps ``step()``
(one tick of every live replica and the retry sweep) or ``drain()``.

Thread-safety: ``submit``/``cancel``/``stats`` and replica management may
run on any thread while another pumps.  One lock guards the replica
table, the in-flight list and the placement log; engines are pumped
outside it.  The lock order is router -> engine, never reversed: a
sweep's import into a replica, and the page wire's splice into its pool
(``import_wire_pages``, which waits at most 5 s for that replica's pump
lock and then ships nothing), run under the router lock, so a wedged
destination costs a re-prefill, not the fleet.

Metrics (``registry=``): the ``dttpu_router_replicas`` gauge,
``dttpu_router_requests_total`` / ``_retries_total`` /
``_replica_down_total`` / ``_rejected_total`` / ``dttpu_migrations_total``
/ ``dttpu_router_affinity_hits_total`` / ``_wire_migrations_total`` /
``_wire_degraded_total`` counters, the ``dttpu_router_affinity_score``
gauge and ``dttpu_router_placed_total{replica=...}``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import (Callable, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

from ..obs import metrics as metrics_lib
from ..obs import reqtrace
from ..resilience import faults as faults_lib
from ..serve import pages as pages_lib
from ..serve.engine import (Engine, QueueFullError, RequestHandle,
                            RequestSnapshot)
from .pagewire import WireError
from .tenancy import QuotaExceededError

log = logging.getLogger(__name__)

__all__ = ["EngineProtocol", "FleetHandle", "NoReplicaError", "Router",
           "expected_pages_reused", "request_chain_keys"]


def request_chain_keys(prompt, page_size: int, namespace: bytes = b""):
    """``(fingerprint key, tokens covered)`` pairs of a request's prompt,
    the request side of the affinity score:

    * a token sequence: the chain hashes of its full ``page_size`` chunks
      under ``namespace`` (``serve.pages.prompt_chain_keys``);
    * a simulator prompt tuple ``(plen, prefix_id, prefix_len, ...)``:
      the prefix id itself, covering the full chunks of ``prefix_len``;
    * anything else (a bare int, None): no keys, affinity 0.
    """
    if type(prompt) is tuple:
        prefix_id, prefix_len = prompt[1], prompt[2]
        covered = int(prefix_len) - int(prefix_len) % int(page_size)
        if prefix_id and covered > 0:
            return ((int(prefix_id), covered),)
        return ()
    if prompt is None or isinstance(prompt, (int, float)):
        return ()
    return pages_lib.prompt_chain_keys(prompt, page_size, namespace)


def expected_pages_reused(prompt, stats, manifest=None,
                          namespace: bytes = b"") -> int:
    """How many whole KV pages of ``prompt``'s prefix the replica behind
    ``stats`` (``prefix_fingerprint`` + ``page_size``) would serve from
    its radix cache: the deepest fingerprint match, capped by what is
    cached.  0 without a fingerprint (contiguous engine, cold pool),
    which is what makes the blind fallback exact.

    ``manifest`` (a ``RequestSnapshot.shipped_pages``) replaces the
    prompt's keys: a migrating request scores by the chains its export
    handed off, prompt and generated tokens, already keyed in its
    namespace.  ``namespace`` keys a fresh request's prompt (its
    adapter's namespace on that replica)."""
    fp = getattr(stats, "prefix_fingerprint", None)
    pg = int(getattr(stats, "page_size", 0) or 0)
    if not fp or pg < 1:
        return 0
    keys = manifest if manifest else request_chain_keys(prompt, pg,
                                                        namespace)
    best = 0
    for key, tokens in keys:
        cached = fp.get(key, 0)
        got = tokens if tokens < cached else cached
        if got > best:
            best = got
    return best // pg


# submit errors that mean "THIS replica won't take it now": safe to retry
# on another.  Anything else (validation, unknown adapter) is wrong
# everywhere and reaches the caller.
_REJECTIONS = (QueueFullError, QuotaExceededError)


class NoReplicaError(RuntimeError):
    """No live replica can take this request (all dead or draining)."""


@runtime_checkable
class EngineProtocol(Protocol):
    """What the router requires of a replica.  ``add_replica`` checks it
    with ``isinstance`` (member presence, not signatures), so a bogus
    replica fails at registration instead of at its first pump."""

    def submit(self, prompt, max_new_tokens=None, on_token=None,
               **kwargs): ...

    def stats(self): ...

    def step(self) -> bool: ...

    def drain(self, timeout_s=None) -> bool: ...

    def cancel(self, handle) -> bool: ...

    def export_request(self, handle, timeout_s=None): ...

    def import_request(self, snapshot, on_token=None): ...

    def load_adapter(self, adapter_id, adapter) -> None: ...

    @property
    def busy(self) -> bool: ...


class FleetHandle:
    """Caller-facing view of one fleet request across retries.

    Mirrors ``RequestHandle`` (tokens / done / status / error / ttft_s)
    and survives replica failures: after a migration or failover it
    tracks the new attempt.  ``replica_id`` is the current (or final)
    placement; ``attempts`` counts placements; ``migrations`` counts
    snapshot moves and ``tokens_preserved`` the decode work they kept."""

    def __init__(self, rid: int, spec: dict,
                 deadline: Optional[float], retries_left: int,
                 router: "Router"):
        self.rid = rid
        self.spec = spec
        self.deadline = deadline            # absolute perf_counter or None
        self.retries_left = retries_left
        self.attempts = 0
        self.migrations = 0
        self.tokens_preserved = 0
        self.replica_id: Optional[int] = None
        self._router = router
        self._handle: Optional[RequestHandle] = None
        self._snapshot: Optional[RequestSnapshot] = None
        # host copies of the radix pages an orphan's export handed off,
        # shipped to whichever survivor imports it (fleet/pagewire.py)
        self._wire_records: Optional[list] = None
        self._streamed = 0                  # tokens forwarded to the user
        self._ttft: Optional[float] = None  # pinned at first placement
        self._status = "pending"
        self.error: Optional[BaseException] = None

    @property
    def tokens(self) -> List[int]:
        if self._handle is not None:
            return self._handle.tokens
        if self._snapshot is not None:      # orphaned mid-migration
            return list(self._snapshot.generated)
        return []

    @property
    def status(self) -> str:
        return self._status

    @property
    def done(self) -> bool:
        return self._status != "pending"

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token of the first placement that produced a
        token; a migration does not reset it."""
        if self._ttft is not None:
            return self._ttft
        return self._handle.ttft_s if self._handle is not None else None

    @property
    def tenant(self) -> str:
        return self.spec["tenant"]

    @property
    def critpath(self) -> Optional[dict]:
        """The finished critical-path breakdown of the placement that
        retired the request (the accrual rides the snapshot, so it spans
        every hop); None while in flight or with no ledger active."""
        return self._handle.critpath if self._handle is not None else None

    def _attempt_stream(self, base: int):
        """An ``on_token`` shim for one placement: forwards only tokens
        the user has not seen, so delivery is exactly-once across
        migrations and raw resubmits.  ``base`` is the stream position
        where this attempt starts emitting (a snapshot's
        ``stream_offset``; 0 for a fresh submit).  A raising user
        callback propagates before ``_streamed`` advances, so a retried
        attempt re-delivers exactly the tokens the user never took."""
        user = self.spec["on_token"]
        pos = [base]

        def shim(toks: List[int]) -> None:
            start = pos[0]
            pos[0] = start + len(toks)
            fresh = toks[max(0, self._streamed - start):]
            if not fresh:
                return
            if user is not None:
                user(fresh)
            self._streamed = max(self._streamed, pos[0])

        return shim

    def result(self) -> List[int]:
        """Pump the fleet until this request finishes; return its
        tokens."""
        while not self.done:
            if not self._router.step():
                break
        return self.tokens

    def _finalize(self, status: str,
                  error: Optional[BaseException] = None) -> None:
        self._status = status
        self.error = error


class Router:
    """Spread ``submit()`` traffic over N ``Engine`` replicas.

    Args:
      replicas: engines to start with (``add_replica`` adds more; each
        gets the next integer replica id).
      registry: obs registry of the router's series (default: the
        process registry).
      max_retries: placements a request may consume after its first
        (rejection probing at submit does not count).
      export_timeout_s: how long a failure-path export waits for a dead
        or quarantined replica's pump before exporting anyway
        (``clean=False``).
      affinity_weight: inflight units one expected reused KV page is
        worth in the placement score; 0 turns affinity off.
      page_wire: a ``fleet.PageWire``: migrations ship the victim's radix
        pages to the destination instead of re-prefilling them; an
        unrecoverable wire failure degrades to re-prefill
        (``dttpu_router_wire_degraded_total``).
    """

    def __init__(self, replicas=(), *,
                 registry: Optional[metrics_lib.Registry] = None,
                 max_retries: int = 2,
                 export_timeout_s: float = 1.0,
                 affinity_weight: float = 1.0,
                 page_wire=None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0; got {max_retries}")
        if affinity_weight < 0:
            raise ValueError(
                f"affinity_weight must be >= 0; got {affinity_weight}")
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self.registry = reg
        self.max_retries = int(max_retries)
        self.export_timeout_s = float(export_timeout_s)
        self.affinity_weight = float(affinity_weight)
        self.page_wire = page_wire
        # guards the replica table, the draining set, the in-flight list
        # and the placement log; never held while pumping a tick
        self._lock = threading.Lock()
        self._replicas: Dict[int, Engine] = {}
        self._draining: set = set()
        # replicas pulled for being unhealthy: {replica_id: (engine,
        # reason)}, detached and kept for inspection
        self.quarantined: Dict[int, Tuple[Engine, str]] = {}
        self._next_replica = 0
        self._next_rid = 0
        self._inflight: List[FleetHandle] = []
        self.placements: List[tuple] = []      # (fleet rid, replica id)
        self._m_replicas = reg.gauge(
            "dttpu_router_replicas", "Live engine replicas behind the "
            "router (draining replicas still count until empty).")
        self._m_requests = reg.counter(
            "dttpu_router_requests_total",
            "Requests accepted by the router.")
        self._m_retries = reg.counter(
            "dttpu_router_retries_total",
            "Failover resubmissions (replica death or failed handle).")
        self._m_down = reg.counter(
            "dttpu_router_replica_down_total",
            "Replicas removed after a pump failure.")
        self._m_rejected = reg.counter(
            "dttpu_router_rejected_total",
            "Submits rejected by EVERY live replica (fleet-wide "
            "backpressure surfaced to the caller).")
        self._m_migrations = reg.counter(
            "dttpu_migrations_total",
            "In-flight requests moved live (RequestSnapshot export -> "
            "import on a survivor) across failover, drain, removal, or "
            "quarantine.")
        self._m_affinity_hits = reg.counter(
            "dttpu_router_affinity_hits_total",
            "Placements that landed on a replica already holding part "
            "of the request's prefix (expected_pages_reused > 0).")
        self._m_affinity_score = reg.gauge(
            "dttpu_router_affinity_score",
            "Expected KV pages reused by the most recent placement "
            "(0 = blind landing).")
        self._m_wire_migrations = reg.counter(
            "dttpu_router_wire_migrations_total",
            "Migrations whose KV pages were shipped over the page "
            "wire and adopted by the destination pool (the skipped "
            "re-prefill windows show up in the destination's "
            "EngineStats.prefill_windows_skipped_total).")
        self._m_wire_degraded = reg.counter(
            "dttpu_router_wire_degraded_total",
            "Migrations that fell back to re-prefill after an "
            "unrecoverable page-wire failure (link down, chunk "
            "retries exhausted).")
        self._m_placed: Dict[int, metrics_lib.Counter] = {}
        for engine in replicas:
            self.add_replica(engine)

    # -------------------------------------------------------- replicas

    def add_replica(self, engine: Engine) -> int:
        if not isinstance(engine, EngineProtocol):
            missing = [m for m in ("submit", "stats", "step", "drain",
                                   "cancel", "export_request",
                                   "import_request", "load_adapter",
                                   "busy")
                       if not hasattr(engine, m)]
            raise TypeError(
                f"replica {type(engine).__name__} does not implement "
                f"the router's EngineProtocol (missing: {missing})")
        with self._lock:
            rid = self._next_replica
            self._next_replica += 1
            self._replicas[rid] = engine
            # the engine-targeted fault kinds (stall_tick, wedge_replica)
            # address this replica by its fleet id
            engine.chaos_tag = rid
            self._m_placed[rid] = self.registry.counter(
                "dttpu_router_placed_total",
                "Requests placed, by replica.",
                labels={"replica": str(rid)})
            self._m_replicas.set(len(self._replicas))
        return rid

    @property
    def replica_ids(self):
        with self._lock:
            return tuple(self._replicas)

    def replica(self, replica_id: int) -> Engine:
        with self._lock:
            return self._replicas[replica_id]

    def stats(self) -> Dict[int, object]:
        """{replica_id: EngineStats} for every live replica (load, page
        pool, radix cache and pump heartbeat in one snapshot each)."""
        with self._lock:
            live = list(self._replicas.items())
        return {rid: eng.stats() for rid, eng in live}

    def pages_free(self) -> int:
        """Fleet-wide free KV pages (0 when every replica is
        contiguous)."""
        return sum(s.pages_free for s in self.stats().values())

    def load_adapter(self, adapter_id: str, adapter) -> None:
        """Register a LoRA adapter on EVERY live replica (each holds its
        own table on the card), so placement stays adapter-agnostic."""
        with self._lock:
            live = list(self._replicas.values())
        for eng in live:
            eng.load_adapter(adapter_id, adapter)

    # ---------------------------------------------------------- intake

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[List[int]], None]] = None,
               deadline_s: Optional[float] = None,
               tenant: str = "default",
               adapter_id: Optional[str] = None) -> FleetHandle:
        """Place one request on the best-scoring live replica -> handle.
        A rejecting replica (queue full, tenant quota) is skipped for the
        next; if EVERY live replica rejects, the last rejection
        propagates.  ``deadline_s`` is a fleet deadline: retries submit
        with the remaining budget."""
        deadline = (None if deadline_s is None
                    else time.perf_counter() + deadline_s)
        # the trace id is minted at the fleet's front door, so every
        # attempt and hop shares one lane (None with tracing off)
        trace_id = reqtrace.mint()
        with self._lock:
            fh = FleetHandle(
                rid=self._next_rid,
                spec=dict(prompt=prompt, max_new_tokens=max_new_tokens,
                          on_token=on_token, tenant=tenant,
                          adapter_id=adapter_id, trace_id=trace_id),
                deadline=deadline, retries_left=self.max_retries,
                router=self)
            self._next_rid += 1
            self._place(fh, raise_rejection=True)
            self._m_requests.inc()
            self._inflight.append(fh)
        return fh

    def _affinity(self, fh: FleetHandle, eng, stats) -> int:
        """``fh``'s expected reused pages on one candidate.  A migrating
        request scores by its manifest; a fresh one by its prompt under
        the namespace the candidate keeps its adapter's chains in (None,
        an adapter it does not hold: 0)."""
        prompt = fh.spec["prompt"]
        manifest = getattr(fh._snapshot, "shipped_pages", None)
        adapter_id = fh.spec["adapter_id"]
        namespace = b""
        if adapter_id is not None and not manifest:
            lookup = getattr(eng, "prefix_namespace", None)
            namespace = lookup(adapter_id) if lookup is not None else None
            if namespace is None:
                return 0
        return expected_pages_reused(prompt, stats, manifest=manifest,
                                     namespace=namespace)

    def _candidates(self, fh: Optional[FleetHandle] = None
                    ) -> Tuple[List[int], Dict[int, int]]:
        """Live, non-draining replica ids in placement order, and each
        one's affinity score (all 0 with scoring off or no request).
        With no fingerprint anywhere the order is exactly (inflight, id).
        Called with the router lock held."""
        ids = [rid for rid in self._replicas
               if rid not in self._draining]
        stats = {rid: self._replicas[rid].stats() for rid in ids}
        if fh is None or not self.affinity_weight:
            ids.sort(key=lambda rid: (stats[rid].inflight, rid))
            return ids, {rid: 0 for rid in ids}
        aff = {rid: self._affinity(fh, self._replicas[rid], stats[rid])
               for rid in ids}
        ids.sort(key=lambda rid: (
            stats[rid].inflight - self.affinity_weight * aff[rid],
            stats[rid].inflight, rid))
        return ids, aff

    def _place(self, fh: FleetHandle, raise_rejection: bool) -> bool:
        """Place ``fh`` on the first candidate, in score order, that takes
        it: a snapshot-carrying handle is imported (progress intact), a
        fresh one submitted.  True on placement; False when every
        candidate rejected (or none exists) and ``raise_rejection`` is
        off.  Fresh submits, rejection probing and every re-placement
        pass through here, so the affinity score covers every path onto
        a replica.  Called with the router lock held (lock order router
        -> engine)."""
        remaining = None
        if fh.deadline is not None:
            remaining = fh.deadline - time.perf_counter()
            if remaining <= 0:
                fh._finalize("deadline_exceeded")
                return False
        candidates, affinity = self._candidates(fh)
        if not candidates:
            err = NoReplicaError("no live replica available")
            if raise_rejection:
                raise err
            fh._finalize("failed", error=fh.error or err)
            return False
        snap = fh._snapshot
        if snap is not None and fh.deadline is not None:
            # the fleet deadline stays authoritative across the
            # export -> import gap
            snap.deadline_remaining_s = remaining
        last: Optional[BaseException] = None
        for rid in candidates:
            eng = self._replicas[rid]
            try:
                if snap is not None:
                    # ship the exported radix pages into THIS candidate's
                    # pool first, so that the import skips their windows;
                    # every wire failure ends in a plain re-prefill
                    self._ship_wire_pages(fh, eng, snap)
                    h = eng.import_request(
                        snap,
                        on_token=fh._attempt_stream(snap.stream_offset))
                else:
                    h = eng.submit(
                        fh.spec["prompt"], fh.spec["max_new_tokens"],
                        on_token=fh._attempt_stream(0),
                        deadline_s=remaining,
                        tenant=fh.spec["tenant"],
                        adapter_id=fh.spec["adapter_id"],
                        trace_id=fh.spec.get("trace_id"))
            except _REJECTIONS as e:
                last = e
                continue
            except Exception as e:
                # not backpressure: this request cannot be placed
                # anywhere (validation); surface it instead of spinning
                if raise_rejection:
                    raise
                fh._finalize("failed", error=e)
                return False
            if snap is not None:
                # consumed: a later failover re-exports from the new
                # replica, which owns the freshest progress
                fh._snapshot = None
                fh._wire_records = None
                fh.migrations += 1
                fh.tokens_preserved += len(snap.generated)
                self._m_migrations.inc()
            fh._handle = h
            fh.replica_id = rid
            fh.attempts += 1
            self.placements.append((fh.rid, rid))
            self._m_placed[rid].inc()
            score = affinity.get(rid, 0)
            if score > 0:
                self._m_affinity_hits.inc()
            self._m_affinity_score.set(score)
            return True
        if raise_rejection:
            self._m_rejected.inc()
            raise last
        return False                    # stays pending; retried next step

    def _ship_wire_pages(self, fh: FleetHandle, eng: Engine,
                         snap: RequestSnapshot) -> None:
        """Ship an orphan's captured pages into candidate ``eng`` before
        its import: pages adopted (the import skips their windows), the
        destination refused (0 adopted; the records stay for the next
        candidate), or the wire failed (``WireError``: the records are
        dropped and this migration re-prefills)."""
        if self.page_wire is None or not fh._wire_records:
            return
        try:
            adopted = self.page_wire.ship(fh._wire_records, eng, snap)
        except WireError as e:
            log.warning("page wire failed for fleet rid %d — "
                        "degrading to re-prefill migration: %s",
                        fh.rid, e)
            fh._wire_records = None
            self._m_wire_degraded.inc()
            return
        if adopted:
            self._m_wire_migrations.inc()

    # ----------------------------------------------------------- drive

    @property
    def busy(self) -> bool:
        with self._lock:
            live = list(self._replicas.values())
            pending = any(not fh.done for fh in self._inflight)
        return pending or any(eng.busy for eng in live)

    def step(self) -> bool:
        """One fleet tick: pump every live replica in id order (a replica
        whose pump RAISES is declared dead and its requests re-placed),
        then sweep the handles: finalize finished ones, re-place failed
        or orphaned ones with deadline and retry budget left.  Engines
        are pumped without the router lock."""
        did = False
        plan = faults_lib.active()
        with self._lock:
            live = list(self._replicas.items())
        for rid, eng in live:
            try:
                if plan is not None:
                    plan.on_replica_step(rid)
                did = eng.step() or did
            except Exception as e:
                self._replica_down(rid, e)
                did = True
        with self._lock:
            did = self._sweep() or did
        return did

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Pump until every request is terminal; with ``timeout_s``, stop
        at the budget and return False."""
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        while self.busy:
            if deadline is not None and time.perf_counter() >= deadline:
                return False
            self.step()
        return True

    def cancel(self, fh: FleetHandle) -> bool:
        """Abort one fleet request; False if already terminal."""
        with self._lock:
            if fh.done:
                return False
            handle, eng = fh._handle, self._replicas.get(fh.replica_id)
            fh._finalize("cancelled")
        if handle is not None and eng is not None:
            eng.cancel(handle)
        return True

    # ----------------------------------------------- rolling restarts

    def drain_replica(self, replica_id: int,
                      timeout_s: Optional[float] = None,
                      migrate: bool = True) -> bool:
        """Stop routing new traffic to ``replica_id`` and empty it: with
        ``migrate=True`` its requests are exported and re-placed on the
        survivors in one round; ``migrate=False`` (or no survivor) pumps
        the fleet until it empties.  False on timeout (the replica stays
        draining: call again, ``remove_replica`` or
        ``resume_replica``)."""
        with self._lock:
            if replica_id not in self._replicas:
                raise KeyError(f"unknown replica {replica_id}")
            self._draining.add(replica_id)
            eng = self._replicas[replica_id]
            if migrate and not any(
                    r != replica_id and r not in self._draining
                    for r in self._replicas):
                migrate = False     # no survivor: wait-drain instead
            victims = (self._victims_locked(replica_id) if migrate
                       else [])
        if migrate:
            # a draining replica's pump is healthy: each export just
            # waits out the running tick
            self._export_and_orphan(victims, eng, timeout_s=None)
            with self._lock:
                self._sweep()       # re-place on survivors now
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        while True:
            with self._lock:
                waiting = any(fh.replica_id == replica_id
                              for fh in self._inflight if not fh.done)
            if not (eng.busy or waiting):
                break
            if deadline is not None and time.perf_counter() >= deadline:
                return False
            if not self.step():
                break
        return not eng.busy

    def resume_replica(self, replica_id: int) -> None:
        """Put a draining replica back into rotation."""
        with self._lock:
            if replica_id not in self._replicas:
                raise KeyError(f"unknown replica {replica_id}")
            self._draining.discard(replica_id)

    def remove_replica(self, replica_id: int) -> Engine:
        """Take ``replica_id`` out of the fleet; its requests migrate to
        the survivors (deadline and retry budget permitting).  Returns
        the detached engine, whose pool stays on the card until it is
        dropped (or ``add_replica``'d back)."""
        with self._lock:
            eng = self._replicas.pop(replica_id)
            self._draining.discard(replica_id)
            self._m_replicas.set(len(self._replicas))
            victims = self._victims_locked(replica_id)
        self._export_and_orphan(victims, eng,
                                timeout_s=self.export_timeout_s)
        with self._lock:
            self._sweep()
        return eng

    def quarantine_replica(self, replica_id: int,
                           reason: str = "unhealthy",
                           export_timeout_s: Optional[float] = None
                           ) -> Engine:
        """Pull a stuck-but-alive replica out of rotation (the
        ``Watchdog``'s action): the engine moves to
        ``router.quarantined`` with ``reason``, its requests are exported
        (past a wedged pump after ``export_timeout_s``, default the
        router's) and migrate.  Returns the detached engine."""
        with self._lock:
            if replica_id not in self._replicas:
                raise KeyError(f"unknown replica {replica_id}")
            eng = self._replicas.pop(replica_id)
            self._draining.discard(replica_id)
            self.quarantined[replica_id] = (eng, str(reason))
            self._m_replicas.set(len(self._replicas))
            victims = self._victims_locked(replica_id)
        timeout = (self.export_timeout_s if export_timeout_s is None
                   else export_timeout_s)
        self._export_and_orphan(victims, eng, timeout_s=timeout)
        with self._lock:
            self._sweep()
        return eng

    # ------------------------------------------------------- internals

    def _victims_locked(self, replica_id: int
                        ) -> List[Tuple[FleetHandle,
                                        Optional[RequestHandle]]]:
        """(handle, engine handle) pairs still pending on a replica
        (router lock held)."""
        return [(fh, fh._handle) for fh in self._inflight
                if fh.replica_id == replica_id and not fh.done]

    def _export_and_orphan(self, victims, eng: Engine,
                           timeout_s: Optional[float],
                           error: Optional[BaseException] = None) -> None:
        """Export each victim from ``eng`` and orphan its fleet handle
        with the snapshot (the sweep imports it on a survivor).  A failed
        export (finished meanwhile, engine too far gone) falls back to
        cancel + raw resubmit, which the stream shim keeps exactly-once.
        Called WITHOUT the router lock."""
        for fh, h in victims:
            snap: Optional[RequestSnapshot] = None
            recs: Optional[list] = None
            if h is not None:
                if h.done:
                    continue            # the sweep finalizes it
                try:
                    snap = eng.export_request(h, timeout_s=timeout_s)
                except Exception:
                    snap = None
                if snap is None:
                    if h.done:
                        continue        # finished during the export
                    eng.cancel(h)       # stop the doomed attempt
                elif self.page_wire is not None \
                        and getattr(snap, "shipped_pages", None):
                    # host copies of the pages the export handed off,
                    # while the source is reachable; a source too far
                    # gone ships nothing (re-prefill)
                    try:
                        recs = eng.export_wire_pages(
                            snap, timeout_s=timeout_s) or None
                    except Exception:
                        recs = None
            with self._lock:
                if fh.done:
                    continue
                if fh._ttft is None and h is not None:
                    fh._ttft = h.ttft_s
                fh._snapshot = snap
                fh._wire_records = recs
                if error is not None:
                    fh.error = error
                fh._handle = None       # orphaned: the sweep re-places
                fh.replica_id = None
                self._m_retries.inc()

    def _replica_down(self, replica_id: int, error: BaseException) -> None:
        with self._lock:
            eng = self._replicas.pop(replica_id, None)
            self._draining.discard(replica_id)
            self._m_down.inc()
            self._m_replicas.set(len(self._replicas))
            victims = self._victims_locked(replica_id)
        if eng is not None:
            # the pump raised but the engine's host state is intact, so
            # in-flight progress is still exportable: the kill loses a
            # replica, not its decode work
            self._export_and_orphan(victims, eng,
                                    timeout_s=self.export_timeout_s,
                                    error=error)

    def _sweep(self) -> bool:
        """Called with the router lock held."""
        did = False
        still: List[FleetHandle] = []
        for fh in self._inflight:
            if fh.done:
                continue
            h = fh._handle
            if h is None:               # orphaned (death/removal/retry)
                did = True
                self._place(fh, raise_rejection=False)
            elif h.done:
                did = True
                if h.status == "failed" and fh.retries_left > 0 \
                        and self._deadline_ok(fh):
                    fh.retries_left -= 1
                    fh._handle = None
                    fh.replica_id = None
                    self._m_retries.inc()
                    self._place(fh, raise_rejection=False)
                elif h.status == "failed":
                    fh._finalize("failed", error=h.error)
                else:                   # ok | deadline_exceeded | cancelled
                    fh._finalize(h.status, error=h.error)
            if not fh.done:
                still.append(fh)
        self._inflight = still
        return did

    @staticmethod
    def _deadline_ok(fh: FleetHandle) -> bool:
        return fh.deadline is None or time.perf_counter() < fh.deadline
