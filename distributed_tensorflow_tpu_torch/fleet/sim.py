"""Virtual-time fleet simulator: the port's own ``Router``, synthetic engines.

Counterpart of ``distributed_tensorflow_tpu/fleet/sim.py``: the same
engine model, event loop and report, over the port's router, watchdog,
autoscaler, tenancy, fault plan and request tracing.  Every fleet policy
(least-loaded prefix-affine placement, fair-share admission, snapshot
migration, watchdog quarantine, autoscaling) is host logic, so a trace of
any size replays through the unmodified ``fleet.Router`` at virtual-time
speed; no device is touched.  A real engine on the card prices the
virtual ticks (``CostModel.calibrate``).

* ``SimEngine`` implements the surface the router consumes
  (``fleet.router.EngineProtocol``, and ``export_inflight``,
  ``export_wire_pages``, ``import_wire_pages``, ``inflight_trace_ids``,
  ``wedge``) with the serve scheduler's tick shape: admit into free
  slots, one prefill window a prompt a tick, ``tick_steps`` tokens a
  decoding slot a tick, the last window fused with the first token.  A
  tick advances the engine's VIRTUAL clock by a ``CostModel`` price.
* ``CostModel`` prices one prefill window and one decode tick in
  seconds: ``analytic`` (2 * P FLOPs a token, one parameter read a pass),
  ``from_costs`` (two ``Cost`` records on a ``HardwarePoint``), or
  ``calibrate`` (an effective FLOP/s and a dispatch overhead solved from
  two measured wall times).  ``from_targets`` raises: it prices the
  reference scheduler's traced executables, and the port has no graph
  tier.
* ``FleetSim`` is the discrete-event loop: it advances a shared
  ``SimClock``, flushes trace arrivals into ``Router.submit`` with their
  true arrival times (so queueing delay counts from arrival even when
  submits are batched), arms ``correlated_kill`` on the active fault plan
  as the trace's schedule comes due, reads the ``Watchdog`` through
  ``check(now=vt)``, and lets an ``Autoscaler`` add and drain replicas.
  ``Router.step()`` is the one pump: an engine ticks only when the shared
  clock has caught up with its own, over several ticks in one pump.

Modelling simplifications (the reference's): a slot decodes from the tick
after its last window, and every first token lands at its tick's end
(the serve scheduler decodes a slot in the tick that arms it and reads
each first token as its window ends); a decode tick costs the
fixed-batch price however many slots are live; shared-prefix reuse is a
per-engine seen-set over whole chunks, keyed by the trace's prefix id in
one namespace (no eviction; ``prefix_namespace`` answers ``b""`` for
every adapter, so the router scores an adapter request as the reference
does); token values are not simulated (streams carry zeros; offsets,
dedup and counts are exact).

Determinism: every decision derives from the seeded trace, the seeded
fault plan and the cost model; two runs of one configuration give equal
event logs, placements and reports, and equal to the reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from array import array
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as metrics_lib
from ..obs import reqtrace
from ..resilience import faults as faults_lib
from ..serve.scheduler import QueueFullError, RequestSnapshot
from . import watchdog as watchdog_lib
from .autoscaler import SLO, Autoscaler
from .router import NoReplicaError, Router
from .tenancy import TenantPolicy
from .workload import Trace

__all__ = ["Cost", "CostModel", "FleetSim", "HardwarePoint", "SimClock",
           "SimEngine", "SimMetrics"]

_EPS = 1e-12


# ------------------------------------------------------------ cost model


@dataclasses.dataclass(frozen=True)
class Cost:
    """Static cost of one call: FLOPs, bytes moved and the peak of live
    bytes (the port's copy of the reference's ``analysis.graph.Cost``)."""
    flops: float
    bytes: float
    peak_bytes: float

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs a byte), the roofline abscissa."""
        return self.flops / self.bytes if self.bytes else 0.0

    def time_s(self, peak_flops: float, peak_bw: float,
               overhead_s: float = 0.0) -> float:
        """Roofline duration of one call on a hardware point: the
        overhead plus the slower of the compute and memory legs."""
        compute = self.flops / peak_flops if peak_flops > 0 else 0.0
        memory = self.bytes / peak_bw if peak_bw > 0 else 0.0
        return overhead_s + max(compute, memory)


class HardwarePoint:
    """One roofline operating point: FLOP/s, memory bandwidth, and a host
    overhead a dispatch.  The default peaks are the H100 SXM's data sheet
    (989 TFLOP/s bf16 dense, 3.35 TB/s); ``overhead_s`` is a modelling
    default, not a measurement.  ``CostModel.calibrate`` replaces the
    point with a measured one."""
    __slots__ = ("peak_flops", "peak_bw", "overhead_s")

    def __init__(self, peak_flops: float = 989e12,
                 peak_bw: float = 3.35e12, overhead_s: float = 50e-6):
        self.peak_flops = float(peak_flops)
        self.peak_bw = float(peak_bw)
        self.overhead_s = float(overhead_s)


class CostModel:
    """Virtual seconds for the two serve-tier tick phases.

    A tick costs ``overhead_s`` + ``decode_tick_s`` (when any slot is
    decoding; the fixed-batch price) + ``prefill_window_s`` for each
    prefilling request (one window each a tick)."""
    __slots__ = ("prefill_window_s", "decode_tick_s", "overhead_s",
                 "provenance")

    def __init__(self, prefill_window_s: float, decode_tick_s: float,
                 overhead_s: float = 50e-6,
                 provenance: str = "explicit"):
        if not prefill_window_s > 0 or not decode_tick_s > 0:
            raise ValueError("phase costs must be positive")
        if overhead_s < 0:
            raise ValueError("overhead_s must be >= 0")
        self.prefill_window_s = float(prefill_window_s)
        self.decode_tick_s = float(decode_tick_s)
        self.overhead_s = float(overhead_s)
        self.provenance = provenance

    def __repr__(self):
        return (f"CostModel(window={self.prefill_window_s:.3e}s, "
                f"tick={self.decode_tick_s:.3e}s, "
                f"overhead={self.overhead_s:.3e}s, {self.provenance})")

    @classmethod
    def from_costs(cls, window: Cost, tick: Cost,
                   hw: Optional[HardwarePoint] = None,
                   provenance: str = "graph") -> "CostModel":
        """Price two ``Cost`` records on a roofline point."""
        hw = hw or HardwarePoint()
        return cls(window.time_s(hw.peak_flops, hw.peak_bw),
                   tick.time_s(hw.peak_flops, hw.peak_bw),
                   overhead_s=hw.overhead_s, provenance=provenance)

    @classmethod
    def from_targets(cls, targets, hw: Optional[HardwarePoint] = None
                     ) -> "CostModel":
        """Not available in the port: the reference traces its
        scheduler's executables (``graph_targets()``) into ``Cost``
        records, and the port has no graph tier.  Use ``analytic``, or
        ``calibrate`` from two times measured on the card."""
        raise NotImplementedError(
            "CostModel.from_targets needs the reference's graph tier; "
            "use CostModel.analytic or CostModel.calibrate")

    @classmethod
    def analytic(cls, *, n_params: float, prefill_chunk: int,
                 num_slots: int, tick_steps: int,
                 hw: Optional[HardwarePoint] = None,
                 dtype_bytes: int = 4) -> "CostModel":
        """Closed-form transformer price: 2 * P FLOPs a token, one read
        of the parameters a pass."""
        hw = hw or HardwarePoint()
        window = Cost(flops=2.0 * n_params * prefill_chunk,
                      bytes=n_params * dtype_bytes, peak_bytes=0.0)
        tick = Cost(flops=2.0 * n_params * num_slots * tick_steps,
                    bytes=n_params * dtype_bytes * tick_steps,
                    peak_bytes=0.0)
        return cls.from_costs(window, tick, hw, provenance="analytic")

    @classmethod
    def calibrate(cls, window: Cost, tick: Cost,
                  measured_window_s: float, measured_tick_s: float
                  ) -> "CostModel":
        """Two-point calibration: solve ``t0 + flops / F_eff = T`` from
        the measured wall times of a prefill window and a decode tick,
        then price both through that line.  The fit is REJECTED, and the
        measured times used as they are, when it cannot explain them:
        degenerate inputs (equal times, inverted order) or an implied
        negative host overhead, which is what two calls of nearly equal
        FLOPs but different dispatch counts give (a clamped ``t0`` there
        would inflate both prices)."""
        df = tick.flops - window.flops
        dt = measured_tick_s - measured_window_s
        if df > 0 and dt > 0:
            f_eff = df / dt
            t0 = measured_window_s - window.flops / f_eff
            if t0 >= 0:
                return cls(t0 + window.flops / f_eff,
                           t0 + tick.flops / f_eff,
                           overhead_s=0.0, provenance="calibrated")
        return cls(measured_window_s, measured_tick_s, overhead_s=0.0,
                   provenance="measured")


# ------------------------------------------------------------ sim engine


class SimClock:
    """The fleet's shared virtual clock (owned by ``FleetSim``)."""
    __slots__ = ("now",)

    def __init__(self, now: float = 0.0):
        self.now = float(now)


class _SimStats:
    """Mutable, engine-owned stats snapshot with the attribute surface
    the router/watchdog/autoscaler read from ``EngineStats``.  One
    object per engine, updated in place — ``stats()`` at fleet-sim call
    rates cannot afford a frozen dataclass per call."""
    __slots__ = ("queued", "prefilling", "active", "num_slots",
                 "inflight", "inflight_per_tenant",
                 "tokens_inflight_per_tenant", "pages_total",
                 "pages_free", "pages_per_request",
                 "prefix_lookups_total", "prefix_hits_total",
                 "prefix_tokens_reused_total", "ticks_started",
                 "ticks_completed", "last_tick_start_s",
                 "last_tick_end_s", "last_tick_duration_s",
                 "page_size", "prefix_fingerprint")

    def __init__(self, num_slots: int):
        self.queued = 0
        self.prefilling = 0
        self.active = 0
        self.num_slots = num_slots
        self.inflight = 0
        self.inflight_per_tenant: Dict[str, int] = {}
        self.tokens_inflight_per_tenant: Dict[str, int] = {}
        self.pages_total = 0
        self.pages_free = 0
        self.pages_per_request = 0.0
        self.prefix_lookups_total = 0
        self.prefix_hits_total = 0
        self.prefix_tokens_reused_total = 0
        # prefix-affinity mirror of the real pool's fingerprint
        # (serve/pages.py): {prefix_id: cached tokens}, keyed by the
        # trace's prefix id — the same keys request_chain_keys yields
        # for a sim prompt tuple, so the router scores sim and real
        # fleets through one code path
        self.page_size = 0
        self.prefix_fingerprint: Dict[int, int] = {}
        self.ticks_started = 0
        self.ticks_completed = 0
        self.last_tick_start_s = 0.0
        self.last_tick_end_s = 0.0
        self.last_tick_duration_s = 0.0

    @property
    def free_slots(self) -> int:
        return self.num_slots - self.prefilling - self.active


class _SimRequest:
    """One in-flight simulated request; doubles as its own engine
    handle (``tokens/done/status/error/ttft_s`` — what ``FleetHandle``
    reads)."""
    __slots__ = ("rid", "prompt_ref", "plen", "context", "budget",
                 "max_new_tokens", "tenant", "adapter_id", "prefix_id",
                 "prefix_len", "on_token", "arrival_vt", "first_vt",
                 "span_base", "span_start_vt", "emitted",
                 "windows_left", "status", "error", "deadline_vt",
                 "trace_id", "enqueue_vt", "cp_queue", "cp_prefill",
                 "cp_decode", "cp_interf", "cp_migr")

    def __init__(self):
        self.error: Optional[BaseException] = None
        self.first_vt: Optional[float] = None
        self.span_start_vt: Optional[float] = None
        self.status = "pending"
        self.trace_id: Optional[str] = None
        # critical-path accrual on virtual time, mirroring the serve
        # scheduler's obs.critpath phase vocabulary (queue wait is
        # measured from ENGINE enqueue, not true arrival, so a migrated
        # request never double-counts its pre-migration span)
        self.cp_queue = 0.0
        self.cp_prefill = 0.0
        self.cp_decode = 0.0
        self.cp_interf = 0.0
        self.cp_migr = 0.0

    @property
    def done(self) -> bool:
        return self.status != "pending"

    @property
    def tokens(self) -> List[int]:
        # token VALUES are not simulated; counts/offsets are exact
        return [0] * self.emitted

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_vt is None:
            return None
        return self.first_vt - self.arrival_vt

    @property
    def critpath(self) -> Dict[str, float]:
        """The serve handle's breakdown surface (``FleetHandle.critpath``
        reads this), in the obs.critpath phase vocabulary.  Backpressure
        requeue cannot happen in the sim (queue caps reject at submit),
        so that phase is structurally zero here."""
        return {"queue_wait": self.cp_queue,
                "prefill_compute": self.cp_prefill,
                "prefill_interference": self.cp_interf,
                "decode_compute": self.cp_decode,
                "migration": self.cp_migr,
                "backpressure_requeue": 0.0}


class SimEngine:
    """A virtual-time replica conforming to ``EngineProtocol``.

    Prompts may be plain ints/sequences (length = token count) or the
    fleet-sim tuple ``(plen, prefix_id, prefix_len, arrival_vt)`` —
    carrying the TRUE arrival time through ``Router.submit`` and
    ``RequestSnapshot.prompt`` keeps queueing delay and TTFT honest
    across batched submits and migrations."""

    def __init__(self, cost_model: CostModel, *, num_slots: int = 8,
                 prefill_chunk: int = 32, tick_steps: int = 8,
                 policy: Optional[TenantPolicy] = None,
                 clock: Optional[SimClock] = None,
                 metrics: Optional["SimMetrics"] = None,
                 max_queue_depth: Optional[int] = None,
                 default_max_new_tokens: int = 16,
                 trace_sample: int = 64):
        self.cost = cost_model
        self.num_slots = int(num_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.tick_steps = int(tick_steps)
        self.policy = policy
        self.clock = clock
        self.metrics = metrics
        self.max_queue_depth = max_queue_depth
        self.default_max_new_tokens = int(default_max_new_tokens)
        # request tracing on VIRTUAL time: a million-request sim cannot
        # afford a lane per request, so only 1-in-``trace_sample``
        # router-minted trace ids are kept (<=1 keeps all); a migrated
        # request's sampling verdict rides its snapshot, lane intact
        self.trace_sample = int(trace_sample)
        self._trace_seen = 0
        self.vt = clock.now if clock is not None else 0.0
        # how far past clock.now one step() may pre-run: the fleet
        # loop sets this to its round quantum so a busy engine
        # simulates the whole upcoming window tick-exactly instead of
        # one tick per round (admission is quantised anyway)
        self.lookahead_s = 0.0
        self.chaos_tag = 0
        self._queue = (policy.make_queue() if policy is not None
                       else collections.deque())
        self._prefilling: List[_SimRequest] = []
        self._active: List[_SimRequest] = []
        self._stats = _SimStats(self.num_slots)
        # the sim's "page" is its prefill chunk: reuse is granted in
        # whole chunks, so that is the granularity the router's
        # affinity scorer must divide by
        self._stats.page_size = self.prefill_chunk
        self._prefix_seen: set = set()
        self._adapters: set = set()
        self._next_rid = 0
        self._wedged_until: Optional[float] = None
        # shared zero-token payloads, one per emission size (stream
        # shims only slice them)
        self._zeros = [[0] * k for k in range(self.tick_steps + 1)]

    # ------------------------------------------------------ intake

    def _parse_prompt(self, prompt) -> Tuple[int, int, int, float]:
        if type(prompt) is tuple:
            return prompt
        now = self.clock.now if self.clock is not None else self.vt
        if isinstance(prompt, (int, np.integer)):
            return int(prompt), 0, 0, now
        return len(prompt), 0, 0, now

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               tenant: str = "default",
               adapter_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> _SimRequest:
        plen, prefix_id, prefix_len, arrival = self._parse_prompt(prompt)
        budget = (self.default_max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1; got {budget}")
        st = self._stats
        if self.max_queue_depth is not None \
                and st.queued >= self.max_queue_depth:
            raise QueueFullError(
                f"sim queue full ({st.queued}/{self.max_queue_depth})")
        if self.policy is not None:
            self.policy.check_admission(
                tenant, budget,
                inflight=st.inflight_per_tenant.get(tenant, 0),
                tokens_inflight=st.tokens_inflight_per_tenant.get(
                    tenant, 0))
        r = _SimRequest()
        r.rid = self._next_rid
        self._next_rid += 1
        r.prompt_ref = prompt
        r.plen = plen
        r.context = plen
        r.budget = budget
        r.max_new_tokens = budget        # DeficitFairQueue's cost field
        r.tenant = tenant
        r.adapter_id = adapter_id
        r.prefix_id = prefix_id
        r.prefix_len = prefix_len
        r.on_token = on_token
        r.arrival_vt = arrival
        r.span_base = 0
        r.emitted = 0
        r.windows_left = 0
        now = self.clock.now if self.clock is not None else self.vt
        r.enqueue_vt = now
        r.deadline_vt = None if deadline_s is None else now + deadline_s
        if trace_id is not None:
            self._trace_seen += 1
            if self.trace_sample <= 1 \
                    or self._trace_seen % self.trace_sample == 1:
                r.trace_id = trace_id
        self._queue.append(r)
        st.queued += 1
        st.inflight += 1
        t = st.inflight_per_tenant
        t[tenant] = t.get(tenant, 0) + 1
        t = st.tokens_inflight_per_tenant
        t[tenant] = t.get(tenant, 0) + budget
        if r.trace_id:
            reqtrace.submitted(r.trace_id, ts_us=now * 1e6, rid=r.rid,
                               tenant=tenant, plen=plen,
                               max_new_tokens=budget)
        return r

    def import_request(self, snap: RequestSnapshot,
                       on_token: Optional[Callable] = None
                       ) -> _SimRequest:
        """Re-admit a migrated request: its full context (prompt +
        generated-so-far) is re-prefilled, then decode resumes at the
        remaining budget — the serve-tier import semantics."""
        resumed = int(snap.stream_offset)
        r = self.submit(snap.prompt, snap.max_new_tokens,
                        on_token=on_token, tenant=snap.tenant,
                        adapter_id=snap.adapter_id,
                        deadline_s=snap.deadline_remaining_s)
        r.emitted = resumed
        r.span_base = resumed
        r.context = r.plen + resumed
        if resumed > 0:
            # the caller saw the stream start on the source replica
            r.first_vt = r.arrival_vt
        carry = getattr(snap, "critpath", None)
        if carry:
            # resume the source replica's phase accrual; the export ->
            # import gap is charged to the migration phase on virtual
            # time, exactly like the serve scheduler's carry
            src = carry.get("phases") or {}
            r.cp_queue = float(src.get("queue_wait", 0.0))
            r.cp_prefill = float(src.get("prefill_compute", 0.0))
            r.cp_interf = float(src.get("prefill_interference", 0.0))
            r.cp_decode = float(src.get("decode_compute", 0.0))
            r.cp_migr = float(src.get("migration", 0.0))
            r.cp_migr += max(0.0, r.enqueue_vt
                             - float(carry.get("exported_at",
                                               r.enqueue_vt)))
        if snap.trace_id is not None:
            # the source's sampling verdict rides the snapshot — the
            # lane continues here, not a fresh submitted()
            r.trace_id = snap.trace_id
            now = self.clock.now if self.clock is not None else self.vt
            reqtrace.imported(r.trace_id, ts_us=now * 1e6, rid=r.rid,
                              resumed=resumed)
        return r

    def export_request(self, handle: _SimRequest,
                       timeout_s: Optional[float] = None
                       ) -> RequestSnapshot:
        r = handle
        if r.status != "pending":
            raise RuntimeError(f"request {r.rid} is terminal "
                               f"({r.status}); nothing to export")
        now = self.clock.now if self.clock is not None else self.vt
        if r in self._queue:
            # close the open queue wait at export so the carried
            # breakdown stays monotone across hops
            r.cp_queue += max(0.0, now - r.enqueue_vt)
        self._forget(r)
        r.status = "exported"
        if r.trace_id:
            reqtrace.exported(r.trace_id, ts_us=now * 1e6, rid=r.rid,
                              generated=r.emitted,
                              clean=self._wedged_until is None)
        snap = RequestSnapshot(
            rid=r.rid, prompt=r.prompt_ref,
            generated=[0] * r.emitted, max_new_tokens=r.budget,
            stream_offset=r.emitted, tenant=r.tenant,
            adapter_id=r.adapter_id, deadline_remaining_s=None,
            sampling=None, clean=self._wedged_until is None,
            trace_id=r.trace_id,
            critpath={"phases": r.critpath,
                      "elapsed_s": max(0.0, now - r.arrival_vt),
                      "exported_at": now})
        # page-wire manifest mirror (serve: the chains the export
        # handed off; sim: the cached prefix id + its covered tokens).
        # Only when this engine actually holds the prefix — a request
        # exported before admission shipped nothing.
        if r.prefix_id and r.prefix_id in self._prefix_seen:
            covered = r.prefix_len - r.prefix_len % self.prefill_chunk
            if covered > 0:
                snap.shipped_pages = ((r.prefix_id, covered),)
                snap.page_size = self.prefill_chunk
        return snap

    def export_inflight(self, timeout_s: Optional[float] = None
                        ) -> List[RequestSnapshot]:
        pending = (list(self._queue) + list(self._prefilling)
                   + list(self._active))
        return [self.export_request(r, timeout_s=timeout_s)
                for r in pending]

    def export_wire_pages(self, snap: RequestSnapshot,
                          timeout_s: Optional[float] = None) -> list:
        """Page-wire capture mirror (serve: host copies of device
        pages; sim: payload-free records — a shipped "page" is a
        fingerprint entry, keyed by prefix id instead of chain hash)."""
        manifest = getattr(snap, "shipped_pages", None)
        if not manifest:
            return []
        return [(j, key, {}) for j, (key, _tok) in enumerate(manifest)]

    def import_wire_pages(self, snap: RequestSnapshot, records,
                          timeout_s: Optional[float] = None) -> int:
        """Page-wire splice mirror: adopting a shipped record marks its
        prefix id cached here, so the subsequent ``import_request``'s
        admission radix-hits and its re-prefill pays only the
        uncovered windows — the sim twin of the serve pool's
        pre-warm.  Returns prefill chunks adopted."""
        chunk = self.prefill_chunk
        if int(getattr(snap, "page_size", 0) or 0) != chunk \
                or not records:
            return 0                 # chunking differs: keys are alien
        st = self._stats
        adopted = 0
        for rec in records:
            covered = int(rec.tokens)
            if covered < chunk or not rec.chain:
                continue
            self._prefix_seen.add(rec.chain)
            if covered > st.prefix_fingerprint.get(rec.chain, 0):
                st.prefix_fingerprint[rec.chain] = covered
            adopted += covered // chunk
        return adopted

    def cancel(self, handle: _SimRequest) -> bool:
        if handle.status != "pending":
            return False
        self._forget(handle)
        handle.status = "cancelled"
        if handle.trace_id:
            now = self.clock.now if self.clock is not None else self.vt
            reqtrace.retired(handle.trace_id, "cancelled",
                             ts_us=now * 1e6, tokens=handle.emitted)
        if self.metrics is not None:
            self.metrics.cancelled += 1
        return True

    def _forget(self, r: _SimRequest) -> None:
        """Remove a pending request from whichever stage holds it and
        settle the counters (export/cancel path)."""
        st = self._stats
        if r in self._active:
            self._active.remove(r)
            st.active -= 1
        elif r in self._prefilling:
            self._prefilling.remove(r)
            st.prefilling -= 1
        else:
            self._queue.remove(r)
            st.queued -= 1
        st.inflight -= 1
        t = st.inflight_per_tenant
        t[r.tenant] = t.get(r.tenant, 1) - 1
        t = st.tokens_inflight_per_tenant
        t[r.tenant] = t.get(r.tenant, r.budget) - r.budget

    def load_adapter(self, adapter_id: str, adapter: Any = None) -> None:
        self._adapters.add(adapter_id)

    def prefix_namespace(self, adapter_id: Optional[str]) -> bytes:
        """The radix namespace the router scores a request in.  The
        sim's prefix cache is one seen-set keyed by prefix id, whatever
        the adapter, so every request shares the default namespace."""
        return b""

    def inflight_trace_ids(self) -> List[str]:
        """Trace ids of every in-flight (sampled) request — the same
        pre-quarantine forensics surface the real engine exposes."""
        pending = (list(self._queue) + list(self._prefilling)
                   + list(self._active))
        return [r.trace_id for r in pending if r.trace_id]

    def stats(self) -> _SimStats:
        return self._stats

    # ------------------------------------------------------- pump

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._prefilling or self._active
                    or self._wedged_until is not None)

    def wedge(self, until_vt: float) -> None:
        """Model a stuck pump: a tick starts and never completes until
        ``until_vt`` — the stuck-but-alive heartbeat shape the real
        ``Watchdog`` quarantines (virtual ``now`` in, same verdict
        logic)."""
        st = self._stats
        st.ticks_started += 1
        st.last_tick_start_s = max(
            self.vt, self.clock.now if self.clock is not None else self.vt)
        self._wedged_until = float(until_vt)

    def step(self) -> bool:
        clock = self.clock
        if self._wedged_until is not None:
            now = clock.now if clock is not None else self._wedged_until
            if now + _EPS < self._wedged_until:
                return False
            st = self._stats
            end = self._wedged_until
            self._wedged_until = None
            st.ticks_completed += 1
            st.last_tick_end_s = end
            st.last_tick_duration_s = end - st.last_tick_start_s
            self.vt = max(self.vt, end)
        if clock is None:
            if not (self._queue or self._prefilling or self._active):
                return False
            self._tick_once()
            return True
        did = False
        horizon = clock.now + self.lookahead_s + _EPS
        # catch up: the router only intervenes between the loop's rounds
        # (submits, faults, scaling), so consecutive ticks commute
        while (self._queue or self._prefilling or self._active) \
                and self.vt <= horizon:
            self._tick_once()
            did = True
        return did

    def _tick_once(self) -> None:
        st = self._stats
        cm = self.cost
        clock = self.clock
        t0 = self.vt
        if clock is not None and clock.now > t0:
            t0 = clock.now
        dur = cm.overhead_s
        active = self._active
        prefilling = self._prefilling
        queue = self._queue
        chunk = self.prefill_chunk
        if active:
            dur += cm.decode_tick_s
        # admit from the (fair-share) queue into free slots
        free = self.num_slots - len(active) - len(prefilling)
        while free > 0 and len(queue):
            r = queue.popleft()
            free -= 1
            r.cp_queue += max(0.0, t0 - r.enqueue_vt)
            reused = 0
            if r.prefix_id:
                st.prefix_lookups_total += 1
                if r.prefix_id in self._prefix_seen:
                    st.prefix_hits_total += 1
                    reused = min(r.prefix_len - (r.prefix_len % chunk),
                                 r.context - 1)
                    st.prefix_tokens_reused_total += reused
                else:
                    self._prefix_seen.add(r.prefix_id)
                    # fingerprint mirror (serve/pages.py): the sim's
                    # cache never evicts (_prefix_seen's documented
                    # simplification), so the fingerprint only grows
                    st.prefix_fingerprint[r.prefix_id] = (
                        r.prefix_len - r.prefix_len % chunk)
            need = r.context - reused
            r.windows_left = (need + chunk - 1) // chunk if need > 0 else 1
            prefilling.append(r)
            st.queued -= 1
            st.prefilling += 1
            if r.trace_id:
                reqtrace.stage(r.trace_id, "prefill", ts_us=t0 * 1e6,
                               windows=r.windows_left)
        prefill_wall = len(prefilling) * cm.prefill_window_s
        dur += prefill_wall
        t1 = t0 + dur
        self.vt = t1
        metrics = self.metrics
        # decode: every slot active at tick start emits up to
        # tick_steps tokens at tick end
        if active:
            tick_steps = self.tick_steps
            zeros = self._zeros
            decode_s = cm.decode_tick_s
            still: List[_SimRequest] = []
            for r in active:
                # head-of-line attribution, same charging rule as the
                # serve scheduler: a slot already decoding at tick
                # start experiences the whole prefill wall as stretch;
                # requests admitted THIS tick sit in `prefilling`, so
                # they are structurally exempt
                r.cp_decode += decode_s
                r.cp_interf += prefill_wall
                k = r.budget - r.emitted
                if k > tick_steps:
                    k = tick_steps
                r.emitted += k
                cb = r.on_token
                if cb is not None:
                    cb(zeros[k])
                if r.emitted >= r.budget:
                    self._retire(r, t1, "ok")
                elif r.deadline_vt is not None and t1 > r.deadline_vt:
                    self._retire(r, t1, "deadline_exceeded")
                else:
                    still.append(r)
            self._active = active = still
            st.active = len(still)
        # prefill: one window each; the last window is fused with the
        # first emitted token (the serve scheduler's admit executable)
        if prefilling:
            still_p: List[_SimRequest] = []
            for r in prefilling:
                r.cp_prefill += cm.prefill_window_s
                r.windows_left -= 1
                if r.windows_left > 0:
                    still_p.append(r)
                    continue
                r.emitted += 1
                r.span_start_vt = t1
                if r.trace_id:
                    reqtrace.mark(r.trace_id, "first_token",
                                  ts_us=t1 * 1e6,
                                  ttft_s=t1 - r.arrival_vt)
                    reqtrace.stage(r.trace_id, "decode", ts_us=t1 * 1e6)
                if r.first_vt is None:
                    r.first_vt = t1
                    if metrics is not None:
                        metrics.record_ttft(t1 - r.arrival_vt, r.tenant)
                cb = r.on_token
                if cb is not None:
                    cb(self._zeros[1])
                if r.emitted >= r.budget:
                    self._retire(r, t1, "ok", in_prefill=True)
                elif r.deadline_vt is not None and t1 > r.deadline_vt:
                    self._retire(r, t1, "deadline_exceeded",
                                 in_prefill=True)
                else:
                    active.append(r)
                    st.active += 1
                    st.prefilling -= 1
            self._prefilling = still_p
        st.ticks_started += 1
        st.ticks_completed += 1
        st.last_tick_start_s = t0
        st.last_tick_end_s = t1
        st.last_tick_duration_s = dur

    def _retire(self, r: _SimRequest, now_vt: float, status: str,
                in_prefill: bool = False) -> None:
        st = self._stats
        if in_prefill:
            st.prefilling -= 1
        # active-list membership is settled by the caller's rebuild
        st.inflight -= 1
        t = st.inflight_per_tenant
        t[r.tenant] = t.get(r.tenant, 1) - 1
        t = st.tokens_inflight_per_tenant
        t[r.tenant] = t.get(r.tenant, r.budget) - r.budget
        r.status = status
        if r.trace_id:
            reqtrace.retired(r.trace_id, status, ts_us=now_vt * 1e6,
                             tokens=r.emitted)
        release = getattr(self._queue, "release", None)
        if release is not None:
            release(r)
        if self.metrics is not None:
            self.metrics.record_retire(r, now_vt, status)

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Standalone pump-to-empty (protocol surface; ``FleetSim``
        drains through the router instead)."""
        steps = 0
        limit = None if timeout_s is None else max(
            1, int(timeout_s * 1e6))
        while self._queue or self._prefilling or self._active:
            self._tick_once()
            steps += 1
            if limit is not None and steps >= limit:
                return False
        return True


# --------------------------------------------------------- SLO metrics


class SimMetrics:
    """Streaming SLO collector shared by every SimEngine of a run.

    TTFT is recorded once per request at its first emitted token
    (measured from TRUE arrival, surviving migration via the prompt
    tuple); the inter-token metric is the per-request mean gap (TPOT)
    over its final decode span, recorded at retirement.  Attainment
    counters update incrementally so the autoscaler's sliding window
    needs no array scans."""

    def __init__(self, slo: Optional[SLO] = None):
        self.slo = slo
        self.ttft = array("d")
        self.tpot = array("d")
        # per-request interference share (cp_interf / e2e) at
        # retirement — the fleet-wide head-of-line distribution
        self.interference = array("d")
        self.completed = 0
        self.deadline_exceeded = 0
        self.cancelled = 0
        self.tokens_out = 0
        self.ttft_ok = 0
        self.itl_ok = 0
        self.itl_n = 0
        self.per_tenant: Dict[str, int] = {}
        self.autoscaler: Optional[Autoscaler] = None
        # optional obs.federate.FederatedMetrics: per-tenant latency
        # samples and SLO verdicts stream into its dttpu_slo_* gauges
        self.federation: Optional[Any] = None

    @property
    def finished(self) -> int:
        return self.completed + self.deadline_exceeded

    def record_ttft(self, v: float, tenant: str = "default") -> None:
        self.ttft.append(v)
        ok = self.slo is None or v <= self.slo.ttft_s
        if ok:
            self.ttft_ok += 1
        a = self.autoscaler
        if a is not None:
            a.record(ttft_ok=ok)
        f = self.federation
        if f is not None:
            f.ingest(tenant, ttft_s=v, ttft_ok=ok)

    def record_retire(self, r: _SimRequest, now_vt: float,
                      status: str) -> None:
        # interference is recorded for EVERY retirement (deadline
        # blow-ups are exactly the requests most likely to have been
        # stretched behind other tenants' prefills)
        e2e = now_vt - r.arrival_vt
        if e2e > 0:
            self.interference.append(r.cp_interf / e2e)
        if status != "ok":
            self.deadline_exceeded += 1
            return
        self.completed += 1
        span = r.emitted - r.span_base
        self.tokens_out += span
        t = self.per_tenant
        t[r.tenant] = t.get(r.tenant, 0) + 1
        if span > 1 and r.span_start_vt is not None:
            tpot = (now_vt - r.span_start_vt) / (span - 1)
        else:
            tpot = 0.0
        self.tpot.append(tpot)
        self.itl_n += 1
        ok = True
        if self.slo is not None:
            ok = tpot <= self.slo.itl_s
        if ok:
            self.itl_ok += 1
        a = self.autoscaler
        if a is not None:
            a.record(itl_ok=ok)
        f = self.federation
        if f is not None:
            f.ingest(r.tenant, tpot_s=tpot, itl_ok=ok)

    # ------------------------------------------------------- report

    def _pct(self, arr: array, q: float) -> float:
        if not len(arr):
            return 0.0
        return float(np.percentile(np.frombuffer(arr, dtype=np.float64),
                                   q))

    def report(self) -> Dict[str, Any]:
        n_ttft = len(self.ttft)
        att_ttft = self.ttft_ok / n_ttft if n_ttft else 1.0
        att_itl = self.itl_ok / self.itl_n if self.itl_n else 1.0
        return {
            "completed": self.completed,
            "deadline_exceeded": self.deadline_exceeded,
            "cancelled": self.cancelled,
            "tokens_generated": self.tokens_out,
            "ttft_p50_ms": round(self._pct(self.ttft, 50) * 1e3, 4),
            "ttft_p95_ms": round(self._pct(self.ttft, 95) * 1e3, 4),
            "ttft_p99_ms": round(self._pct(self.ttft, 99) * 1e3, 4),
            "itl_p99_ms": round(self._pct(self.tpot, 99) * 1e3, 4),
            "attainment_ttft": round(att_ttft, 6),
            "attainment_itl": round(att_itl, 6),
            "slo_attainment": round(min(att_ttft, att_itl), 6),
            "interference_share_p50": round(
                self._pct(self.interference, 50), 6),
            "interference_share_p95": round(
                self._pct(self.interference, 95), 6),
        }


# ------------------------------------------------------- the event loop


class FleetSim:
    """Discrete-event loop: a seeded :class:`workload.Trace` through
    the real :class:`fleet.Router` on virtual time (module docstring).

    ``autoscaler=`` takes a kwargs dict for :class:`Autoscaler` (built
    against this run's router/factory/SLO); ``watchdog=`` a kwargs dict
    for the real :class:`fleet.Watchdog` (checked on virtual time).
    ``inflight_cap`` bounds the router-side backlog: arrivals past the
    cap wait in the loop with their TRUE arrival time intact, so the
    queueing delay still lands in TTFT while ``Router._sweep`` stays
    affordable at millions of requests.

    The loop advances in ``quantum_s`` virtual-second rounds — the
    router pumps once per round while each engine ticks internally to
    exact sub-quantum times, so retire/TTFT timestamps are tick-exact
    and only ADMISSION is quantised: a request can sit in the loop up
    to one quantum past its true arrival, adding at most ``quantum_s``
    of apparent queueing to its TTFT.  Shrink ``quantum_s`` when that
    bias matters more than wall-clock speed."""

    def __init__(self, trace: Trace, cost_model: CostModel, *,
                 replicas: int = 2, slo: Optional[SLO] = None,
                 engine: Optional[Dict[str, Any]] = None,
                 policy: Optional[TenantPolicy] = None,
                 autoscaler: Optional[Dict[str, Any]] = None,
                 watchdog: Optional[Dict[str, Any]] = None,
                 registry: Optional[metrics_lib.Registry] = None,
                 quantum_s: float = 0.05,
                 inflight_cap_per_replica: Optional[int] = None,
                 seed: int = 0,
                 affinity_weight: float = 1.0):
        self.trace = trace
        self.cost_model = cost_model
        self.slo = slo or SLO()
        self.engine_kwargs = dict(engine or {})
        self.policy = policy
        self.registry = (registry if registry is not None
                         else metrics_lib.Registry())
        self.quantum_s = float(quantum_s)
        self.clock = SimClock(0.0)
        self.metrics = SimMetrics(self.slo)
        self.router = Router(registry=self.registry,
                             affinity_weight=affinity_weight)
        self.event_log: List[tuple] = []
        self._rng = np.random.default_rng(seed)
        self._engines: List[SimEngine] = []
        slots = int(self.engine_kwargs.get("num_slots", 8))
        cap = (inflight_cap_per_replica if inflight_cap_per_replica
               is not None else 8 * slots)
        self.inflight_cap_per_replica = int(cap)
        for _ in range(int(replicas)):
            self.router.add_replica(self.make_engine())
        self.autoscaler: Optional[Autoscaler] = None
        if autoscaler is not None:
            self.autoscaler = Autoscaler(
                self.router, self.make_engine, self.slo,
                registry=self.registry, **autoscaler)
            self.metrics.autoscaler = self.autoscaler
        self.watchdog = None
        self._wd_interval = math.inf
        if watchdog is not None:
            kw = dict(watchdog)
            self._wd_interval = kw.pop(
                "check_interval_s", kw.get("tick_deadline_s", 5.0) / 2)
            self.watchdog = watchdog_lib.Watchdog(
                self.router, registry=self.registry, **kw)
        self.replica_seconds = 0.0

    def make_engine(self) -> SimEngine:
        eng = SimEngine(self.cost_model, policy=self.policy,
                        clock=self.clock, metrics=self.metrics,
                        **self.engine_kwargs)
        eng.vt = self.clock.now
        eng.lookahead_s = self.quantum_s
        self._engines.append(eng)
        return eng

    # ------------------------------------------------------------- run

    def run(self, max_rounds: Optional[int] = None) -> Dict[str, Any]:
        trace = self.trace
        clock = self.clock
        router = self.router
        metrics = self.metrics
        auto = self.autoscaler
        n = len(trace)
        arrivals = trace.arrival_s.tolist()
        plens = trace.plen.tolist()
        budgets = trace.new_tokens.tolist()
        prefix_ids = trace.prefix_id.tolist()
        prefix_lens = trace.prefix_len.tolist()
        names = [name for name, _ in trace.tenants]
        tenant_of = [names[t] for t in trace.tenant.tolist()]
        ad_label = {-1: None}
        adapter_of = [ad_label.setdefault(a, f"ad{a}")
                      for a in trace.adapter.tolist()]
        events = list(trace.events)
        submit = router.submit
        plan = faults_lib.FaultPlan([], seed=trace.seed,
                                    registry=self.registry)
        next_eval = (auto.eval_interval_s if auto is not None
                     else math.inf)
        next_wd = self._wd_interval
        quantum = self.quantum_s
        kills = quarantines = 0
        i = 0
        rounds = 0
        lost = 0
        log = self.event_log
        cap_per = self.inflight_cap_per_replica
        with faults_lib.activated(plan):
            while True:
                inflight = i - metrics.finished - metrics.cancelled \
                    - lost
                if i >= n and inflight <= 0:
                    break
                rounds += 1
                if max_rounds is not None and rounds > max_rounds:
                    log.append(("aborted", round(clock.now, 9), rounds))
                    break
                rids = router.replica_ids
                if not rids and auto is None:
                    # dead fleet with nothing to heal it: everything
                    # still outstanding is lost
                    lost += (n - i) + inflight
                    log.append(("dead_fleet", round(clock.now, 9),
                                n - i, inflight))
                    break
                cap_total = cap_per * max(1, len(rids))
                # --- next interesting virtual instant: one quantum
                # ahead, clipped by due events and the policy cadences.
                # Engines tick internally to exact sub-quantum times,
                # so arrivals/wedge releases only need quantum-level
                # granularity (admission quantisation, class docstring).
                t_next = clock.now + quantum
                if events and events[0].at_s < t_next:
                    t_next = events[0].at_s
                if next_eval < t_next:
                    t_next = next_eval
                if next_wd < t_next:
                    t_next = next_wd
                if t_next > clock.now:
                    live = len(rids)
                    dt = t_next - clock.now
                    self.replica_seconds += dt * live
                    if auto is not None:
                        auto.charge(dt, live)
                    clock.now = t_next
                now = clock.now
                # --- flush due arrivals (true arrival time rides the
                # prompt tuple), up to the backlog cap
                while i < n and rids and arrivals[i] <= now \
                        and inflight < cap_total:
                    try:
                        submit((plens[i], prefix_ids[i], prefix_lens[i],
                                arrivals[i]),
                               budgets[i], tenant=tenant_of[i],
                               adapter_id=adapter_of[i])
                    except NoReplicaError:
                        if auto is not None:
                            # defer: the autoscaler heals the fleet at
                            # its next evaluation; arrival time rides
                            # the prompt tuple so TTFT stays honest.
                            break
                        lost += 1
                        log.append(("rejected", round(now, 9), i))
                        i += 1
                        continue
                    i += 1
                    inflight += 1
                # --- due fleet events -> the shared fault vocabulary
                while events and events[0].at_s <= now:
                    ev = events.pop(0)
                    if ev.kind == "correlated_kill":
                        plan.add(faults_lib.Fault(
                            kind="correlated_kill",
                            at=plan.global_pump_index, k=ev.k,
                            window=ev.window))
                        kills += 1
                        log.append(("correlated_kill",
                                    round(now, 9), ev.k, ev.window))
                    elif ev.kind == "wedge_replica":
                        live_rids = router.replica_ids
                        if live_rids:
                            victim = int(self._rng.choice(
                                sorted(live_rids)))
                            router.replica(victim).wedge(
                                now + ev.seconds)
                            log.append(("wedge", round(now, 9), victim))
                # --- autoscaler / watchdog on virtual time
                if auto is not None and now + _EPS >= next_eval:
                    action = auto.evaluate(now)
                    next_eval = now + auto.eval_interval_s
                    if action is not None:
                        log.append((action[0], round(now, 9),
                                    action[1]))
                if self.watchdog is not None and now + _EPS >= next_wd:
                    pulled = self.watchdog.check(now=now)
                    next_wd = now + self._wd_interval
                    for rid, reason in (pulled or ()):
                        quarantines += 1
                        log.append(("quarantine", round(now, 9),
                                    rid, reason))
                # --- the one real pump
                router.step()
                inflight = i - metrics.finished - metrics.cancelled \
                    - lost
                if i >= n and inflight > 0 and not router.busy:
                    # requests that went fleet-terminal without retiring
                    # on an engine (failed past the retry budget)
                    lost += inflight
                    log.append(("lost", round(now, 9), inflight))
        rep = metrics.report()
        rep.update({
            "simulated_requests": i,
            "virtual_time_s": round(clock.now, 6),
            "driver_rounds": rounds,
            "replicas_final": len(router.replica_ids),
            "replica_seconds": round(self.replica_seconds, 6),
            "migrations": int(self.registry.get(
                "dttpu_migrations_total").value),
            "correlated_kills_armed": kills,
            "quarantines": quarantines,
            "lost": lost,
            "events": len(log),
        })
        # fleet-wide radix reuse, summed over EVERY engine this run
        # created (including replicas the autoscaler later retired)
        lookups = sum(e._stats.prefix_lookups_total
                      for e in self._engines)
        hits = sum(e._stats.prefix_hits_total for e in self._engines)
        rep["fleet_prefix_lookups"] = lookups
        rep["fleet_prefix_hit_rate"] = round(
            hits / lookups if lookups else 0.0, 6)
        if self.replica_seconds > 0:
            rep["attainment_per_kilo_replica_second"] = round(
                rep["slo_attainment"]
                / (self.replica_seconds / 1e3), 6)
        if auto is not None:
            rep["scale_outs"] = auto.scale_outs
            rep["scale_ins"] = auto.scale_ins
        return rep
