"""Per-request critical-path ledger: where each request's latency went.

Counterpart of ``distributed_tensorflow_tpu/obs/critpath.py``, the port's
own copy.  The goodput invariant (exclusive buckets summing to wall by
construction) applied *per request*: every retired request's end-to-end
wall time decomposes into exclusive phases

* ``queue_wait`` — submit until the admission that started its prefill,
* ``prefill_compute`` — its own prefill windows' wall time,
* ``prefill_interference`` — time this request's decode ticks were
  stretched by *other* requests' prefill windows sharing the tick (each
  co-scheduled decode slot is charged the tick's other-requests' window
  cost in full — every slot experiences the stretch in parallel),
* ``decode_compute`` — its decode ticks' wall time,
* ``migration`` — export-to-import gap when the request moved engines,
* ``backpressure_requeue`` — re-queued wait after an admission bounce
  (adapter table / page pool exhaustion),
* derived ``other`` — the unattributed remainder (host glue, stream
  flush), never accrued directly, so the split stays honest.

The scheduler accrues into a plain per-request dict at its transition
seams (the same places reqtrace hooks) and calls :func:`finalize` +
:func:`observe` exactly once at retirement.  The finished breakdown
rides the request handle, the reqtrace retirement mark, and — through
this ledger — per-tenant phase histograms, a bounded worst-K slow
request reservoir, ``dttpu_critpath_seconds_total{phase,tenant}`` /
``dttpu_critpath_interference_ratio`` on /metrics, a ``/statusz`` top-K
table, and a Chrome-trace counter lane.

Same activation contract as ``obs.goodput``: with no active ledger,
:func:`new_phases` returns ``None`` and the scheduler's accrual sites
reduce to one attribute check.  Pure stdlib.
"""
from __future__ import annotations

import contextlib
import heapq
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import trace as trace_lib

__all__ = ["PHASES", "CritpathLedger", "new_phases", "finalize",
           "activate", "deactivate", "active", "activated", "observe"]

# The attribution vocabulary.  "other" is derived (e2e minus the
# measured phases), never accrued directly — untracked host time shows
# up there instead of silently inflating a named phase.
PHASES = ("queue_wait", "prefill_compute", "prefill_interference",
          "decode_compute", "migration", "backpressure_requeue", "other")

_MEASURED = PHASES[:-1]

# log-spaced per-phase histogram edges (seconds): serve latencies span
# sub-ms decode ticks to multi-second queue waits
HIST_EDGES_S = (0.0001, 0.001, 0.01, 0.1, 1.0, 10.0, 100.0)


def new_phases() -> Optional[Dict[str, float]]:
    """A zeroed accrual dict for one request — or ``None`` when no
    ledger is active (the scheduler's disabled fast path: accrual sites
    gate on the request's ``phases is None``)."""
    if _ACTIVE is None:
        return None
    return {p: 0.0 for p in _MEASURED}


def finalize(phases: Dict[str, float], e2e_s: float) -> Dict[str, float]:
    """Close one request's accrual dict into the finished breakdown:
    a COPY with the derived ``other`` remainder, the measured ``e2e_s``,
    and ``interference_share``.  Phases sum to ``e2e_s`` by construction
    (every accrued interval is disjoint and inside [submit, finish], so
    the remainder is nonnegative up to clock granularity — the property
    test's tolerance)."""
    out = {p: float(phases.get(p, 0.0)) for p in _MEASURED}
    e2e = max(float(e2e_s), 0.0)
    out["other"] = max(0.0, e2e - sum(out.values()))
    out["e2e_s"] = e2e
    out["interference_share"] = (
        out["prefill_interference"] / e2e if e2e > 0.0 else 0.0)
    return out


def _pct(ordered: List[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending list (stdlib —
    no numpy in obs/)."""
    n = len(ordered)
    if n == 0:
        return 0.0
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


class CritpathLedger:
    """Aggregates finished per-request breakdowns.

    Args:
      registry: an ``obs.metrics.Registry`` to export
        ``dttpu_critpath_seconds_total{phase,tenant}`` counters and the
        ``dttpu_critpath_interference_ratio`` gauge into (``None`` =
        in-process report only).
      worst_k: slow-request exemplars kept (min-heap on e2e — full
        breakdown + trace_id, the Perfetto lookup key).
      reservoir: bounded per-request interference-share sample count;
        past the cap, sample ``i`` overwrites slot ``i % cap``
        (deterministic — no randomness, so seeded runs reproduce).
      trace_counters: mirror cumulative phase totals onto the active
        tracer as a Chrome ``"C"`` counter lane.
    """

    def __init__(self, registry=None, worst_k: int = 8,
                 reservoir: int = 4096, trace_counters: bool = True,
                 clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.worst_k = int(worst_k)
        self._reservoir_cap = max(1, int(reservoir))
        self._count = 0
        self._totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._e2e_total = 0.0
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._tenant_counts: Dict[str, int] = {}
        # per-(tenant, phase) log-bucket histogram: len(edges)+1 counts
        self._hist: Dict[str, Dict[str, List[int]]] = {}
        self._worst: List[Tuple[float, int, Dict[str, Any]]] = []
        self._shares: List[float] = []
        self.trace_counters = trace_counters
        self._registry = registry
        self._counters: Dict[Tuple[str, str], Any] = {}
        self._ratio_gauge = None
        if registry is not None:
            self._ratio_gauge = registry.gauge(
                "dttpu_critpath_interference_ratio",
                "Cumulative prefill_interference seconds over cumulative "
                "request e2e seconds — the fleet-wide head-of-line "
                "blocking fraction (docs/OBSERVABILITY.md Critical "
                "path).")

    # ------------------------------------------------------------ observe

    def _counter(self, phase: str, tenant: str):
        """Lazy ``{phase,tenant}`` counter (serve tenants are an open
        set, same pattern as ServeMetrics' tenant counters).  Caller
        holds ``_lock``."""
        key = (phase, tenant)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = self._registry.counter(
                "dttpu_critpath_seconds_total",
                "Wall-clock seconds attributed to each critical-path "
                "phase, per tenant (exclusive; 'other' is report-only, "
                "as with goodput).",
                labels={"phase": phase, "tenant": tenant})
        return c

    def observe(self, tenant: Optional[str],
                breakdown: Dict[str, float],
                trace_id: Optional[str] = None,
                ts_us: Optional[int] = None) -> None:
        """Fold one :func:`finalize`\\ d breakdown into the aggregates.
        Called once per retired request (the scheduler's claim-once
        retirement path); thread-safe."""
        tenant = tenant or "default"
        e2e = float(breakdown.get("e2e_s", 0.0))
        share = float(breakdown.get("interference_share", 0.0))
        with self._lock:
            self._count += 1
            seq = self._count
            per = self._tenants.setdefault(
                tenant, {p: 0.0 for p in PHASES})
            hist = self._hist.setdefault(
                tenant, {p: [0] * (len(HIST_EDGES_S) + 1)
                         for p in _MEASURED})
            for p in PHASES:
                v = float(breakdown.get(p, 0.0))
                self._totals[p] += v
                per[p] += v
                if p != "other":
                    b = 0
                    while b < len(HIST_EDGES_S) and v > HIST_EDGES_S[b]:
                        b += 1
                    hist[p][b] += 1
                    if self._registry is not None and v > 0.0:
                        self._counter(p, tenant).inc(v)
            self._tenant_counts[tenant] = \
                self._tenant_counts.get(tenant, 0) + 1
            self._e2e_total += e2e
            entry = dict(breakdown)
            entry["tenant"] = tenant
            if trace_id is not None:
                entry["trace_id"] = trace_id
            heapq.heappush(self._worst, (e2e, seq, entry))
            if len(self._worst) > self.worst_k:
                heapq.heappop(self._worst)
            if len(self._shares) < self._reservoir_cap:
                self._shares.append(share)
            else:
                self._shares[seq % self._reservoir_cap] = share
            interf_total = self._totals["prefill_interference"]
            e2e_total = self._e2e_total
            lane = dict(self._totals) if self.trace_counters else None
        if self._ratio_gauge is not None:
            self._ratio_gauge.set(
                interf_total / e2e_total if e2e_total > 0.0 else 0.0)
        if lane is not None:
            tracer = trace_lib.active_tracer()
            if tracer is not None and tracer.enabled:
                tracer.add_event({
                    "name": "critpath_seconds", "ph": "C",
                    "ts": trace_lib.now_us() if ts_us is None else ts_us,
                    "cat": "critpath", "args": lane})

    # ------------------------------------------------------------ report

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative phase totals + request count (cheap, lock-bounded)."""
        with self._lock:
            return {"requests": self._count,
                    "phase_seconds": dict(self._totals),
                    "e2e_seconds": self._e2e_total}

    def interference_shares(self) -> List[float]:
        """A copy of the bounded per-request interference-share samples."""
        with self._lock:
            return list(self._shares)

    def worst(self) -> List[Dict[str, Any]]:
        """The worst-K exemplars, slowest first (full breakdown each)."""
        with self._lock:
            ranked = sorted(self._worst, key=lambda t: (-t[0], t[1]))
        return [dict(entry) for _, _, entry in ranked]

    def report(self) -> Dict[str, Any]:
        """The per-run critpath document bench rows and the CI artifact
        embed: request count, the fleet phase split, the per-tenant
        phase table (totals + log-bucket histograms), the
        interference-share distribution, and the worst-K exemplars."""
        with self._lock:
            count = self._count
            totals = dict(self._totals)
            e2e_total = self._e2e_total
            per_tenant = {
                t: {"requests": self._tenant_counts.get(t, 0),
                    "phase_seconds": {p: round(v, 6)
                                      for p, v in per.items()},
                    "phase_hist": {p: list(h)
                                   for p, h in self._hist[t].items()}}
                for t, per in sorted(self._tenants.items())}
            shares = sorted(self._shares)
        worst = self.worst()
        return {
            "requests": count,
            "phase_seconds": {p: round(totals[p], 6) for p in PHASES},
            "e2e_seconds": round(e2e_total, 6),
            "interference_ratio": round(
                totals["prefill_interference"] / e2e_total, 6)
            if e2e_total > 0.0 else 0.0,
            "interference_share_p50": round(_pct(shares, 50.0), 6),
            "interference_share_p95": round(_pct(shares, 95.0), 6),
            "hist_edges_s": list(HIST_EDGES_S),
            "per_tenant": per_tenant,
            "worst": worst,
        }

    def statusz(self) -> Dict[str, Any]:
        """The compact ``/statusz`` section: headline ratio + the top-K
        slow-request table (one row per exemplar, phases rounded)."""
        snap = self.snapshot()
        e2e = snap["e2e_seconds"]
        rows = [{
            "trace_id": e.get("trace_id"),
            "tenant": e.get("tenant"),
            "e2e_s": round(e.get("e2e_s", 0.0), 4),
            "interference_share": round(
                e.get("interference_share", 0.0), 4),
            "phases_s": {p: round(e.get(p, 0.0), 4) for p in PHASES},
        } for e in self.worst()]
        return {"requests": snap["requests"],
                "interference_ratio": round(
                    snap["phase_seconds"]["prefill_interference"] / e2e,
                    6) if e2e > 0.0 else 0.0,
                "slowest": rows}


# ---------------------------------------------------------------------------
# Active ledger: the process-wide sink the scheduler accrues into.  Same
# contract as goodput's active accountant — the scheduler cannot thread
# a handle through Request objects that migrate between engines.

_ACTIVE: Optional[CritpathLedger] = None
_ACTIVE_LOCK = threading.Lock()


def activate(led: CritpathLedger) -> CritpathLedger:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = led
    return led


def deactivate(led: Optional[CritpathLedger] = None) -> None:
    """Clear the active ledger (only if it is ``led``, when given)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if led is None or _ACTIVE is led:
            _ACTIVE = None


def active() -> Optional[CritpathLedger]:
    return _ACTIVE


def observe(tenant: Optional[str], breakdown: Dict[str, float],
            trace_id: Optional[str] = None,
            ts_us: Optional[int] = None) -> None:
    """Module-level observe: routes to the active ledger, no-op when
    nothing is active.  The scheduler still attaches the breakdown to
    the request handle either way — aggregation is what's optional."""
    led = _ACTIVE
    if led is not None:
        led.observe(tenant, breakdown, trace_id=trace_id, ts_us=ts_us)


@contextlib.contextmanager
def activated(led: CritpathLedger):
    """Scoped activation (tests, bench): restores the previous ledger."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, led
    try:
        yield led
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev
