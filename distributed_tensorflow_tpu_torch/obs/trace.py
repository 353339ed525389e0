"""Host-timeline tracing: a Chrome-trace-event / Perfetto JSON recorder.

Counterpart of ``distributed_tensorflow_tpu/obs/trace.py``, the port's own
copy.  It records *host-side* spans — ``span("data_load")``,
``span("dispatch")``, ``span("checkpoint")`` — and instant events
(session lifecycle marks, faults, forensics) into the Chrome trace-event
JSON format, so one step of a training run opens in ``chrome://tracing``
or https://ui.perfetto.dev as a timeline.

Pure stdlib: spans time the HOST, which is the honest thing to time under
asynchronous CUDA launches (a span around a step measures its issue; the
card's completion is wherever the caller reads a value).  Recording a
span is two ``perf_counter_ns`` reads and a ``list.append`` under a lock;
a disabled tracer's ``span()`` returns a cached no-op context manager.

Multi-process: every process writes its own file, but events carry the
process index as the Chrome ``pid`` (plus a ``process_name`` metadata
record naming the host and OS pid), so the per-host files load together
in Perfetto as one timeline with one row group per host.

Module-level *active tracer*: ``activate(tracer)`` makes a tracer the
process-wide sink for code that cannot thread a handle through its API
(request tracing, fault instants, checkpoint quarantines).
``instant(...)``/``span(...)`` module functions route to it and no-op
when nothing is active.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "activate", "activated", "deactivate",
           "active_tracer", "span", "instant", "now_us"]

# perf_counter_ns is monotonic but has an arbitrary epoch; anchor it once
# so ts values are comparable across tracers in one process.
_EPOCH_NS = time.perf_counter_ns()


class _NullSpan:
    """Cached no-op context manager for the disabled-tracer fast path."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def now_us() -> float:
    """Microseconds on the tracer clock (monotonic, process-anchored) —
    for callers recording retroactive spans via ``Tracer.add_span``."""
    return (time.perf_counter_ns() - _EPOCH_NS) / 1e3


class Tracer:
    """Collects Chrome trace events in memory; ``save()`` writes JSON.

    Args:
      enabled: a disabled tracer's record methods are no-ops (cheap to
        leave wired in).
      pid: the Chrome "process" lane — conventionally the multi-host
        process index so per-host files merge into one timeline.
      host: human label for the process lane ("host0"); defaults to
        ``host{pid}``.
    """

    def __init__(self, enabled: bool = True, pid: int = 0,
                 host: Optional[str] = None):
        self.enabled = enabled
        self.pid = int(pid)
        self.host = host or f"host{self.pid}"
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self.instant_counts: Dict[str, int] = {}
        self._add_metadata()

    # ------------------------------------------------------------ record

    def _add_metadata(self) -> None:
        # ph "M" metadata records name the process lane; the OS pid rides
        # along so a merged multi-host timeline still identifies processes.
        self._events.append({
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": f"{self.host} (os pid {os.getpid()})"}})

    _now_us = staticmethod(now_us)

    def span(self, name: str, **args: Any):
        """Context manager recording a complete ("X") event around its body."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def add_span(self, name: str, start_us: float, end_us: float,
                 **args: Any) -> None:
        """Record an already-measured span (retroactive; TraceHook uses it
        for the inter-step host gap)."""
        if not self.enabled:
            return
        event = {"name": name, "ph": "X", "ts": start_us,
                 "dur": max(0.0, end_us - start_us), "pid": self.pid,
                 "tid": threading.get_ident() & 0xFFFFFFFF, "cat": "host"}
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def add_event(self, event: Dict[str, Any]) -> None:
        """Record a raw Chrome trace event (async ``b``/``n``/``e``
        lifecycle phases, flow ``s``/``f`` arrows — shapes the typed
        helpers above don't cover; ``obs.reqtrace`` is the producer).
        The caller supplies ``ts``/``ph``/``cat``/``id``; ``pid`` and
        ``tid`` default to this tracer's lane and the calling thread."""
        if not self.enabled:
            return
        event.setdefault("pid", self.pid)
        event.setdefault("tid", threading.get_ident() & 0xFFFFFFFF)
        with self._lock:
            self._events.append(event)

    def instant(self, name: str, **args: Any) -> None:
        """Record an instant ("i") event — compiles, retraces, marks."""
        if not self.enabled:
            return
        event = {"name": name, "ph": "i", "s": "p", "ts": self._now_us(),
                 "pid": self.pid,
                 "tid": threading.get_ident() & 0xFFFFFFFF, "cat": "host"}
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)
            self.instant_counts[name] = self.instant_counts.get(name, 0) + 1

    # ------------------------------------------------------------ output

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_dict(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)
        return path


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: Tracer, name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = Tracer._now_us()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.add_span(self._name, self._t0, Tracer._now_us(),
                              **self._args)
        return False


# ---------------------------------------------------------------------------
# Active tracer: the process-wide sink for code without a handle.

_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()


def activate(tracer: Tracer) -> Tracer:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = tracer
    return tracer


def deactivate(tracer: Optional[Tracer] = None) -> None:
    """Clear the active tracer (only if it is ``tracer``, when given)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if tracer is None or _ACTIVE is tracer:
            _ACTIVE = None


def active_tracer() -> Optional[Tracer]:
    return _ACTIVE


def instant(name: str, **args: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, **args)


def span(name: str, **args: Any):
    t = _ACTIVE
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


@contextlib.contextmanager
def activated(tracer: Tracer):
    """Scoped activation (tests, bench): restores the previous tracer."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, tracer
    try:
        yield tracer
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev
