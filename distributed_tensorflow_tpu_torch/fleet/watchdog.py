"""Fleet watchdog: detect wedged or stalled replicas and quarantine them.

Counterpart of ``distributed_tensorflow_tpu/fleet/watchdog.py``.  A
replica can fail without dying: a pump thread blocked in a CUDA call,
a tick that takes seconds.  The router's failure path (a pump that
raises) never sees these.  ``Watchdog`` applies a tick-deadline policy to
the pump heartbeat of every replica's ``Engine.stats()``
(``ticks_started``/``ticks_completed`` and the stamps of the latest tick,
kept by the scheduler under its state lock, so reading them never waits
for the possibly stuck pump).  A replica is unhealthy when it is

* **wedged**: a tick is in progress (started > completed) and started
  more than ``tick_deadline_s`` ago; or
* **stalled**: its last completed tick took longer than
  ``tick_deadline_s`` (seen after the fact, so the policy is testable on
  one thread).

On a verdict the watchdog counts ``dttpu_watchdog_unhealthy_total``,
writes a forensic dump for each of the replica's requests (its trace ids
and critical paths so far, the goodput split, the page wire's posture),
and calls ``Router.quarantine_replica``: the replica leaves rotation,
its requests are exported (past a wedged pump, ``clean=False``) and
migrate to the survivors.

On the card the heartbeat is host time: a tick ends where its token read
waited for the card (``SlotScheduler.step``), so a stall counts the
device time the tick queued.  A wedged pump is a blocked host thread;
the other replicas' kernels keep running on the stream meanwhile.

The watchdog owns no thread: call ``check()`` from a loop you have, or
hand ``watch(stop_event)`` to a thread you own::

    wd = fleet.Watchdog(router, tick_deadline_s=2.0)
    stop = threading.Event()
    t = threading.Thread(target=wd.watch, args=(stop,),
                         name="dttpu-watchdog", daemon=True)
    t.start()
    ...
    stop.set(); t.join()
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from ..obs import goodput as goodput_lib
from ..obs import metrics as metrics_lib
from ..obs import reqtrace
from .router import Router

__all__ = ["Watchdog"]


class Watchdog:
    """Tick-deadline health policy over a ``Router``'s replicas.

    Args:
      router: the fleet to watch.
      tick_deadline_s: a pump tick in progress for longer, or completed
        after longer, than this is pathological.  Set it well above the
        fleet's honest worst tick (a first tick that builds the kernels
        included, or warm the engines first).
      export_timeout_s: how long the quarantine's export waits for the
        unhealthy replica's pump lock before exporting past it.
      registry: obs registry of ``dttpu_watchdog_unhealthy_total``.
    """

    def __init__(self, router: Router, *, tick_deadline_s: float = 5.0,
                 export_timeout_s: float = 0.25,
                 registry: Optional[metrics_lib.Registry] = None):
        if tick_deadline_s <= 0:
            raise ValueError(
                f"tick_deadline_s must be > 0; got {tick_deadline_s}")
        self.router = router
        self.tick_deadline_s = float(tick_deadline_s)
        self.export_timeout_s = float(export_timeout_s)
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self.unhealthy_total = reg.counter(
            "dttpu_watchdog_unhealthy_total",
            "Replicas declared unhealthy by the watchdog's "
            "tick-deadline policy and quarantined.")
        self._lock = threading.Lock()      # guards the audit log
        self.log: List[Tuple[int, str]] = []   # (replica_id, reason)

    def verdict(self, stats, now: Optional[float] = None
                ) -> Optional[str]:
        """The policy on one ``EngineStats``: a reason when the replica
        is unhealthy, else None."""
        now = time.perf_counter() if now is None else now
        d = self.tick_deadline_s
        if stats.ticks_started > stats.ticks_completed:
            age = now - stats.last_tick_start_s
            if age > d:
                return (f"wedged: tick #{stats.ticks_started} in "
                        f"progress for {age:.3f}s (deadline {d:g}s)")
        elif stats.ticks_completed and stats.last_tick_duration_s > d:
            return (f"stalled: tick #{stats.ticks_completed} took "
                    f"{stats.last_tick_duration_s:.3f}s (deadline "
                    f"{d:g}s)")
        return None

    def check(self, now: Optional[float] = None
              ) -> List[Tuple[int, str]]:
        """One sweep: read every replica's heartbeat, quarantine the
        unhealthy ones (their requests migrate), return this sweep's
        ``[(replica_id, reason)]``."""
        hits: List[Tuple[int, str]] = []
        for rid, stats in self.router.stats().items():
            reason = self.verdict(stats, now)
            if reason is None:
                continue
            # the victims' trace ids and critical paths BEFORE the
            # quarantine exports them away
            try:
                eng = self.router.replica(rid)
            except KeyError:
                continue        # raced another check or an operator
            victims = getattr(eng, "inflight_trace_ids", lambda: [])()
            snaps = getattr(eng, "inflight_critpath", lambda: {})()
            try:
                self.router.quarantine_replica(
                    rid, reason=reason,
                    export_timeout_s=self.export_timeout_s)
            except KeyError:
                continue        # raced another check or an operator
            self.unhealthy_total.inc()
            # the process goodput split at quarantine time: where the
            # wall clock went (a fat data_stall against a real hang)
            acct = goodput_lib.active()
            extra = ({"goodput_s": {k: round(v, 6) for k, v in
                                    acct.snapshot().items()}}
                     if acct is not None else {})
            # the page wire's posture: how many of this fleet's
            # migrations shipped pages and how many re-prefilled
            wire_m = getattr(self.router, "_m_wire_migrations", None)
            wire_d = getattr(self.router, "_m_wire_degraded", None)
            if wire_m is not None and wire_d is not None \
                    and self.router.page_wire is not None:
                extra = dict(extra, page_wire={
                    "shipped_total": wire_m.value,
                    "degraded_total": wire_d.value})
            for trace_id in victims:
                cp = snaps.get(trace_id)
                per = dict(extra, critpath=cp) if cp is not None \
                    else extra
                reqtrace.forensic_dump(trace_id, "watchdog_quarantine",
                                       replica=rid, verdict=reason,
                                       **per)
            with self._lock:
                self.log.append((rid, reason))
            hits.append((rid, reason))
        return hits

    def watch(self, stop: threading.Event,
              interval_s: float = 0.5) -> None:
        """Run ``check()`` every ``interval_s`` until ``stop`` is set:
        the body of a thread the caller starts, names and joins."""
        while not stop.wait(interval_s):
            self.check()
