"""Request-scoped tracing: one async lane per request.

Counterpart of ``distributed_tensorflow_tpu/obs/reqtrace.py``, the port's
own copy.  ``obs.trace`` records *host* timelines — what each process
did, when.  This module records *request* timelines: a request that
queues on one engine, migrates, and finishes on another is one story,
and it renders as ONE lane in Perfetto:

* a **trace id** is minted once, at the front door (``Engine.submit``),
  and carried on ``Request`` and — across live migration —
  ``RequestSnapshot``;
* the scheduler emits **lifecycle stages** as Chrome-trace async events
  (``ph: "b"/"n"/"e"``, ``cat: "request"``, ``id: <trace id>``):
  ``request`` (the whole lane) wrapping ``queued`` → ``prefill`` →
  ``decode`` stage spans, with ``admitted`` / ``prefill_window`` /
  ``first_token`` instants riding the lane (``"n"``);
* export → import is linked by **flow arrows** (``ph: "s"``/``"f"``,
  ``cat: "migration"``, same id);
* every completed request's span record lands in a **bounded ring**,
  and ``forensic_dump`` — called by the scheduler on deadline expiry —
  snapshots the victim's span tree while the evidence is still warm.

Emission routes through the module-level active tracer
(``obs.trace.activate``); with no tracer active, ``mint`` returns
``None`` and every carrier skips the calls entirely — the tracing-off
path costs one attribute check per request, not per event.  All state
lives behind one module lock.

Timestamps default to the host tracer clock (``trace.now_us``) but every
function takes ``ts_us=`` for callers on a virtual clock.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Any, Dict, List, Optional

from . import trace as trace_lib

__all__ = ["mint", "enabled", "configure", "reset",
           "submitted", "stage", "mark", "exported", "imported",
           "retired", "tree", "lookup", "live_ids", "completed",
           "forensic_dump", "forensics_log",
           "CAT", "FLOW_CAT"]

CAT = "request"          # async-lane category: one track per trace id
FLOW_CAT = "migration"   # flow-arrow category: export -> import edges

_lock = threading.Lock()
_seq = 0
_enabled = True
_live: Dict[str, Dict[str, Any]] = {}
_ring: "collections.deque[Dict[str, Any]]" = collections.deque(maxlen=256)
_forensics: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=64)


def configure(enabled: Optional[bool] = None,
              ring: Optional[int] = None,
              forensics: Optional[int] = None) -> None:
    """Adjust the module switches: ``enabled`` gates minting (an
    instrumentation-off run turns it off), ``ring``/``forensics`` resize the
    bounded completed-trace and dump buffers (existing entries kept,
    newest-first, up to the new capacity)."""
    global _enabled, _ring, _forensics
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if ring is not None:
            _ring = collections.deque(_ring, maxlen=int(ring))
        if forensics is not None:
            _forensics = collections.deque(_forensics,
                                           maxlen=int(forensics))


def reset() -> None:
    """Drop all live records, the ring, the forensics log, and re-enable
    minting (test isolation)."""
    global _enabled, _seq
    with _lock:
        _enabled = True
        _seq = 0
        _live.clear()
        _ring.clear()
        _forensics.clear()


def enabled() -> bool:
    """True when minting is on AND a tracer is active — the condition
    under which carriers get trace ids at the front door."""
    return _enabled and trace_lib.active_tracer() is not None


def mint(prefix: str = "req") -> Optional[str]:
    """A fresh trace id, or None when tracing is off.  Ids embed the OS
    pid so two hosts' mints never collide in a merged trace."""
    global _seq
    if not enabled():
        return None
    with _lock:
        _seq += 1
        return f"{prefix}-{os.getpid():x}-{_seq:06x}"


# ------------------------------------------------------------------ emit

def _record(trace_id: str) -> Dict[str, Any]:
    rec = _live.get(trace_id)
    if rec is None:
        rec = {"trace_id": trace_id, "events": [], "open": [],
               "hops": 0, "status": None}
        _live[trace_id] = rec
    return rec


def _emit(trace_id: str, ph: str, name: str, cat: str,
          ts_us: Optional[float], args: Dict[str, Any]) -> None:
    ev: Dict[str, Any] = {
        "name": name, "ph": ph, "cat": cat, "id": trace_id,
        "ts": trace_lib.now_us() if ts_us is None else float(ts_us)}
    if ph == "s":
        # flow starts may outlive the emitting scope; bind at enclosing
        ev["bp"] = "e"
    if args:
        ev["args"] = args
    rec = _record(trace_id)
    rec["events"].append(ev)
    t = trace_lib.active_tracer()
    if t is not None:
        t.add_event(dict(ev))


def _close_open_stage(trace_id: str, ts_us: Optional[float]) -> None:
    rec = _record(trace_id)
    if rec["open"]:
        _emit(trace_id, "e", rec["open"].pop(), CAT, ts_us, {})


# ------------------------------------------------------- lifecycle spans

def submitted(trace_id: str, ts_us: Optional[float] = None,
              **args: Any) -> None:
    """Open the request lane (async ``b`` for ``request``) and its first
    stage, ``queued``.  Call once, where the request enters a scheduler
    for the first time; a migrated arrival goes through ``imported``."""
    with _lock:
        rec = _record(trace_id)
        _emit(trace_id, "b", "request", CAT, ts_us, args)
        _emit(trace_id, "b", "queued", CAT, ts_us, {})
        rec["open"].append("queued")


def stage(trace_id: str, name: str, ts_us: Optional[float] = None,
          **args: Any) -> None:
    """Close the currently open stage span and open ``name`` — the
    scheduler's queued→prefill→decode progression."""
    with _lock:
        _close_open_stage(trace_id, ts_us)
        _emit(trace_id, "b", name, CAT, ts_us, args)
        _record(trace_id)["open"].append(name)


def mark(trace_id: str, name: str, ts_us: Optional[float] = None,
         **args: Any) -> None:
    """An instant riding the request lane (async ``n``): ``admitted``,
    ``prefill_window``, ``first_token``."""
    with _lock:
        _emit(trace_id, "n", name, CAT, ts_us, args)


def exported(trace_id: str, ts_us: Optional[float] = None,
             **args: Any) -> None:
    """The request leaves this replica as a snapshot: close the open
    stage, mark the hop, and start a flow arrow (``s``) the importing
    side will finish."""
    with _lock:
        _close_open_stage(trace_id, ts_us)
        _emit(trace_id, "n", "exported", CAT, ts_us, args)
        _emit(trace_id, "s", "migrate", FLOW_CAT, ts_us, {})


def imported(trace_id: str, ts_us: Optional[float] = None,
             **args: Any) -> None:
    """The snapshot lands on a destination replica: finish the flow
    arrow (``f``), mark the hop, and re-open ``queued`` — the SAME
    async id, so Perfetto renders one contiguous lane."""
    with _lock:
        rec = _record(trace_id)
        rec["hops"] += 1
        _emit(trace_id, "f", "migrate", FLOW_CAT, ts_us, {})
        _emit(trace_id, "n", "imported", CAT, ts_us, args)
        _emit(trace_id, "b", "queued", CAT, ts_us, {})
        rec["open"].append("queued")


def retired(trace_id: str, status: str, ts_us: Optional[float] = None,
            **args: Any) -> None:
    """Terminal: close any open stage, end the request lane (``e``)
    with the retirement status, and move the record into the completed
    ring.  A ``migrated`` retirement is NOT terminal for the lane — the
    importing replica continues it — so only the stage closes."""
    with _lock:
        if status == "migrated":
            # exported() already closed the stage and started the flow
            return
        _close_open_stage(trace_id, ts_us)
        all_args = dict(args)
        all_args["status"] = status
        _emit(trace_id, "e", "request", CAT, ts_us, all_args)
        rec = _live.pop(trace_id, None)
        if rec is not None:
            rec["status"] = status
            _ring.append(rec)


# ------------------------------------------------------------ forensics

def lookup(trace_id: str) -> Optional[Dict[str, Any]]:
    """The raw span record for a live or ring-resident trace."""
    with _lock:
        rec = _live.get(trace_id)
        if rec is None:
            for r in reversed(_ring):
                if r["trace_id"] == trace_id:
                    rec = r
                    break
        return None if rec is None else {
            "trace_id": rec["trace_id"], "events": list(rec["events"]),
            "hops": rec["hops"], "status": rec["status"]}


def live_ids() -> List[str]:
    with _lock:
        return list(_live)


def completed() -> List[Dict[str, Any]]:
    """Snapshot of the bounded completed-trace ring, oldest first."""
    with _lock:
        return [{"trace_id": r["trace_id"], "events": list(r["events"]),
                 "hops": r["hops"], "status": r["status"]}
                for r in _ring]


def tree(trace_id: str) -> Optional[Dict[str, Any]]:
    """Fold a trace's async events into a nested span tree:
    ``{"trace_id", "status", "hops", "spans": [...]}`` where each span
    is ``{"name", "start_us", "end_us", "args", "marks", "children"}``.
    Spans still open (a live victim) carry ``end_us: None``."""
    rec = lookup(trace_id)
    if rec is None:
        return None
    roots: List[Dict[str, Any]] = []
    stack: List[Dict[str, Any]] = []
    for ev in rec["events"]:
        if ev.get("cat") != CAT:
            continue
        if ev["ph"] == "b":
            node = {"name": ev["name"], "start_us": ev["ts"],
                    "end_us": None, "args": ev.get("args", {}),
                    "marks": [], "children": []}
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
        elif ev["ph"] == "e":
            for i in range(len(stack) - 1, -1, -1):
                if stack[i]["name"] == ev["name"]:
                    stack[i]["end_us"] = ev["ts"]
                    if ev.get("args"):
                        stack[i]["args"].update(ev["args"])
                    del stack[i:]
                    break
        elif ev["ph"] == "n":
            target = stack[-1] if stack else None
            entry = {"name": ev["name"], "ts_us": ev["ts"],
                     "args": ev.get("args", {})}
            if target is None:
                roots.append(dict(entry, marks=[], children=[],
                                  start_us=ev["ts"], end_us=ev["ts"]))
            else:
                target["marks"].append(entry)
    return {"trace_id": trace_id, "status": rec["status"],
            "hops": rec["hops"], "spans": roots}


def forensic_dump(trace_id: str, reason: str,
                  **context: Any) -> Optional[Dict[str, Any]]:
    """Snapshot a victim's span tree into the forensics log (bounded)
    and onto the host timeline as a ``forensics`` instant.  Returns the
    tree, or None for an unknown id.  Caller: the scheduler at deadline
    expiry, and the fleet watchdog at a quarantine."""
    t = tree(trace_id)
    if t is None:
        return None
    entry = dict(t, reason=reason, context=context)
    with _lock:
        _forensics.append(entry)
    tracer = trace_lib.active_tracer()
    if tracer is not None:
        tracer.instant("forensics", trace_id=trace_id, reason=reason,
                       **context)
    return entry


def forensics_log() -> List[Dict[str, Any]]:
    with _lock:
        return list(_forensics)
