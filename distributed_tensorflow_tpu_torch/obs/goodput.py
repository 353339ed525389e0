"""Goodput accounting: where every second of a supervised run went.

Counterpart of ``distributed_tensorflow_tpu/obs/goodput.py``, the port's
own copy.  ``GoodputAccountant`` attributes run time into named buckets
at the sites the port hooks (the session's step and checkpoint saves,
the verified restore, the supervisor's rebuild and backoff sleep, the
prefetch handoff) and renders the split three ways:

* ``dttpu_goodput_seconds_total{bucket=...}`` counters on the metrics
  registry (scrape ``rate()`` for a live goodput fraction),
* a Chrome-trace **counter lane** (``ph: "C"``) on the active tracer,
* a per-run :meth:`report` — wall seconds, per-bucket seconds,
  ``goodput_pct = step / wall``.

**Exclusive time.**  Buckets nest (a checkpoint restore happens *inside*
fault recovery) and naive interval sums would double-count.  Accounting
is a per-thread stack: entering a nested bucket pauses the enclosing
frame's accrual, so each wall-clock second lands in exactly one bucket
and the measured buckets plus the derived ``other`` remainder sum to
wall by construction.  The port has no jit, so its ``compile`` bucket
stays 0.

Pure stdlib, same contract as ``obs.trace``: a module-level *active
accountant* (``activate``/``deactivate``/``account``) serves code that
cannot thread a handle through its API (the prefetch generator); with
nothing active, ``account()`` returns a cached no-op context manager —
one module-global ``None`` check on the hot path.  An active frame costs
two ``perf_counter`` reads and one lock acquire.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional

from . import trace as trace_lib

__all__ = ["BUCKETS", "GoodputAccountant", "activate", "deactivate",
           "active", "activated", "account"]

# The attribution vocabulary.  "other" is derived (wall minus the
# measured buckets), never accrued directly — it is where untracked time
# (hook bodies, host-side glue, Python overhead) shows up, which keeps
# the split honest instead of silently inflating a named bucket.
BUCKETS = ("step", "compile", "checkpoint_save", "checkpoint_restore",
           "restart_backoff", "data_stall", "fault_recovery", "other")

_MEASURED = tuple(b for b in BUCKETS if b != "other")


class GoodputAccountant:
    """Attributes wall-clock into exclusive named buckets.

    Args:
      registry: an ``obs.metrics.Registry`` to export
        ``dttpu_goodput_seconds_total{bucket=}`` counters into
        (``None`` = in-process report only).
      trace_counters: mirror every accrual onto the *active* tracer as a
        Chrome ``"C"`` counter event (no-op when no tracer is active).
      clock: injectable monotonic clock (tests).
    """

    def __init__(self, registry=None, trace_counters: bool = True,
                 clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {b: 0.0 for b in _MEASURED}
        self._tls = threading.local()
        self._started_at: Optional[float] = None
        self._stopped_at: Optional[float] = None
        self.trace_counters = trace_counters
        self._counters = None
        if registry is not None:
            self._counters = {
                b: registry.counter(
                    "dttpu_goodput_seconds_total",
                    "Wall-clock seconds attributed to each goodput "
                    "bucket (exclusive; see docs/OBSERVABILITY.md "
                    "Goodput section).", labels={"bucket": b})
                for b in _MEASURED}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "GoodputAccountant":
        """Stamp the wall-clock origin (idempotent)."""
        if self._started_at is None:
            self._started_at = self._clock()
        return self

    def stop(self) -> "GoodputAccountant":
        """Stamp the wall-clock end; frames still open keep accruing into
        their buckets but the report's wall stops here."""
        if self._stopped_at is None:
            self._stopped_at = self._clock()
        return self

    def __enter__(self) -> "GoodputAccountant":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------------ accrual

    def _stack(self):
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _accrue(self, bucket: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        with self._lock:
            self._totals[bucket] += seconds
            if self.trace_counters:
                lane = dict(self._totals)
            else:
                lane = None
        if self._counters is not None:
            self._counters[bucket].inc(seconds)
        if lane is not None:
            tracer = trace_lib.active_tracer()
            if tracer is not None and tracer.enabled:
                tracer.add_event({"name": "goodput_seconds", "ph": "C",
                                  "ts": trace_lib.now_us(),
                                  "cat": "goodput", "args": lane})

    def account(self, bucket: str):
        """Context manager attributing its body's wall time to ``bucket``
        (exclusively: an enclosing frame is paused for the duration)."""
        if bucket not in _MEASURED:
            raise ValueError(f"unknown goodput bucket {bucket!r}; "
                             f"choices: {_MEASURED}")
        return _Frame(self, bucket)

    def accrue(self, bucket: str, seconds: float) -> None:
        """Attribute an already-measured duration (no pause semantics —
        for durations measured outside any frame)."""
        if bucket not in _MEASURED:
            raise ValueError(f"unknown goodput bucket {bucket!r}; "
                             f"choices: {_MEASURED}")
        self._accrue(bucket, float(seconds))

    # ------------------------------------------------------------ report

    def wall_seconds(self) -> float:
        if self._started_at is None:
            return 0.0
        end = self._stopped_at if self._stopped_at is not None \
            else self._clock()
        return max(0.0, end - self._started_at)

    def snapshot(self) -> Dict[str, float]:
        """Per-bucket seconds including the derived ``other`` remainder.
        Open frames' in-flight time is NOT included (it accrues on frame
        exit) — call between frames, or after :meth:`stop`."""
        with self._lock:
            out = dict(self._totals)
        wall = self.wall_seconds()
        attributed = sum(out.values())
        out["other"] = max(0.0, wall - attributed)
        return out

    def report(self) -> Dict[str, Any]:
        """The per-run goodput document bench rows embed: wall seconds,
        the bucket split, ``goodput_pct`` (= step/wall), and
        ``coverage_pct`` (measured buckets / wall — how much of the run
        the instrumentation saw; the chaos acceptance asserts the split
        sums to wall within 1%, which holds by construction because
        ``other`` is the remainder)."""
        buckets = self.snapshot()
        wall = self.wall_seconds()
        attributed = sum(v for b, v in buckets.items() if b != "other")
        return {
            "wall_s": round(wall, 6),
            "buckets_s": {b: round(buckets[b], 6) for b in BUCKETS},
            "goodput_pct": round(100.0 * buckets["step"] / wall, 3)
            if wall > 0 else 0.0,
            "coverage_pct": round(100.0 * min(attributed, wall) / wall, 3)
            if wall > 0 else 0.0,
        }


class _Frame:
    """One accounting frame: pauses the enclosing frame on entry, accrues
    its own exclusive time on exit, resumes the parent."""

    __slots__ = ("_acct", "_bucket", "_t0")

    def __init__(self, acct: GoodputAccountant, bucket: str):
        self._acct = acct
        self._bucket = bucket
        self._t0 = 0.0

    def __enter__(self) -> "_Frame":
        acct = self._acct
        now = acct._clock()
        stack = acct._stack()
        if stack:
            parent = stack[-1]
            acct._accrue(parent._bucket, now - parent._t0)
        stack.append(self)
        self._t0 = now
        return self

    def __exit__(self, *exc) -> bool:
        acct = self._acct
        now = acct._clock()
        stack = acct._stack()
        acct._accrue(self._bucket, now - self._t0)
        # tolerate misnested exits (a generator frame GC'd out of order):
        # drop everything above this frame rather than corrupt the stack
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if stack:
            stack[-1]._t0 = now          # resume the parent's accrual
        return False


class _NullFrame:
    """Cached no-op for the inactive fast path (mirrors trace._NullSpan)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_FRAME = _NullFrame()

# ---------------------------------------------------------------------------
# Active accountant: the process-wide sink for code without a handle
# (data/pipeline.py's prefetch wait).

_ACTIVE: Optional[GoodputAccountant] = None
_ACTIVE_LOCK = threading.Lock()


def activate(acct: GoodputAccountant) -> GoodputAccountant:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = acct
    return acct


def deactivate(acct: Optional[GoodputAccountant] = None) -> None:
    """Clear the active accountant (only if it is ``acct``, when given)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if acct is None or _ACTIVE is acct:
            _ACTIVE = None


def active() -> Optional[GoodputAccountant]:
    return _ACTIVE


def account(bucket: str):
    """Module-level frame: routes to the active accountant, cached no-op
    when nothing is active (one global read on the disabled path)."""
    a = _ACTIVE
    if a is None:
        return _NULL_FRAME
    return a.account(bucket)


@contextlib.contextmanager
def activated(acct: GoodputAccountant):
    """Scoped activation (tests, bench): starts/stops the accountant and
    restores the previously active one."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, acct
    acct.start()
    try:
        yield acct
    finally:
        acct.stop()
        with _ACTIVE_LOCK:
            _ACTIVE = prev
