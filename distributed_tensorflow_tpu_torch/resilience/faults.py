"""Seeded, deterministic fault injection — the chaos half of resilience.

Counterpart of ``distributed_tensorflow_tpu/resilience/faults.py``: the
same plan, kinds, triggers, seeded generator and audit trail, in the
port's own copy (it imports nothing of the JAX package).

A ``FaultPlan`` is a list of scheduled faults, each named by *kind* and
armed at a deterministic trigger index (the Nth checkpoint save, the Nth
prefetched batch, global step N, request id K).  The plan is activated
process-wide (``activate``/``activated`` — the same module-active idiom
as ``obs.trace``) or via the ``DTTPU_FAULTS`` env var (a JSON list, so
chaos runs work through subprocess boundaries); instrumented sites in
checkpoint/session/pipeline/serve call the plan's ``on_*`` hooks, which no-op unless a fault of the
matching kind is armed at that exact index.

Fault catalog (docs/RESILIENCE.md).  All 14 kinds are accepted; the port
wires the sites of the first eight (``checkpoint.save``: corrupt_checkpoint
and save_oserror; the prefetch producer: poison_batch and kill_prefetch;
``TrainSession.run_step``: nan_grads; the serve scheduler's pump:
stall_tick and wedge_replica; its token delivery: fail_decode) and the
fleet's: the router's pump for kill_replica and correlated_kill (the
fleet simulator arms correlated_kill on the active plan as its trace's
schedule comes due), the page wire's ``InProcessLink`` for drop_chunk,
corrupt_chunk, stall_wire and kill_host, and the launcher's poll for
kill_host (``on_host_poll``: the launcher SIGKILLs the matched host).

==================  =========================================================
kind                effect (trigger field ``at``)
==================  =========================================================
corrupt_checkpoint  after the ``at``-th successful ``checkpoint.save``,
                    truncate (``mode="truncate"``, default) or bit-flip
                    (``mode="flip"``) ``file`` (default ``arrays.npz``)
                    inside the just-written checkpoint dir
save_oserror        raise a transient ``OSError`` at entry of the ``at``-th
                    ``checkpoint.save`` call
poison_batch        replace every float leaf of the ``at``-th batch flowing
                    through ``data.prefetch_to_device`` with NaN
nan_grads           NaN-poison the batch of the training step whose
                    pre-step global step equals ``at`` (the gradients of
                    that step become non-finite in-graph)
kill_prefetch       raise ``OSError`` inside the ``dttpu-prefetch``
                    producer thread at the ``at``-th batch (the consumer
                    sees the producer die and re-raises)
fail_decode         raise ``InjectedFault`` when the serve scheduler
                    delivers tokens for request id ``at`` (fails exactly
                    that handle; scheduler isolation keeps the tick loop
                    and every other slot alive)
kill_replica        raise ``ConnectionError`` at the fleet Router's pump
                    site for replica id ``replica`` on its ``at``-th
                    pump — the router sees the replica die mid-traffic,
                    removes it, and migrates its in-flight requests to
                    the survivors (fleet/router.py)
stall_tick          sleep ``seconds`` inside the serve scheduler's pump
                    at its ``at``-th tick (engine tagged ``replica`` —
                    the fleet Router stamps ``Engine.chaos_tag`` with
                    the replica id) — the tick completes late, so the
                    fleet ``Watchdog`` sees a blown tick deadline in
                    ``Engine.stats()`` and quarantines the replica
wedge_replica       block the serve scheduler's pump at its ``at``-th
                    tick (engine tagged ``replica``) until
                    ``plan.release_wedges()`` or the ``seconds`` cap —
                    a stuck-but-alive replica: the pump holds its mutex
                    mid-tick, which only the watchdog's in-progress
                    heartbeat check can see
correlated_kill     kill ``k`` replicas within a window of ``window``
                    router pumps starting at the ``at``-th pump counted
                    across ALL replicas: when the window opens, the
                    plan's seeded generator picks the victims among the
                    replicas it has seen pumped so far, and each victim
                    raises ``ConnectionError`` on its next pump inside
                    the window (a victim never pumped in the window
                    escapes — failure domains, not a guaranteed body
                    count).  The fleet simulator and the real chaos
                    tests schedule rack/PSU-style correlated failures
                    through this one kind (``times`` is ignored; ``k``
                    governs)
drop_chunk          the page wire's ``at``-th chunk frame on wire
                    ``replica`` vanishes in flight (the sender sees a
                    per-chunk timeout and re-sends; fleet/pagewire.py)
corrupt_chunk       flip one byte of the page wire's ``at``-th chunk
                    frame on wire ``replica`` — the receiver's CRC32C
                    check NAKs it and the sender re-sends
stall_wire          delay delivery of the page wire's ``at``-th chunk
                    frame on wire ``replica`` by ``seconds`` — a late
                    frame the sender has already re-sent (the receiver
                    dedups the duplicate by chain key)
kill_host           raise ``ConnectionError`` at the page wire's
                    ``at``-th chunk on wire ``replica`` (host died
                    mid-transfer: the transfer degrades to re-prefill
                    migration), AND/OR kill the launcher-supervised
                    host process ``replica`` at the launcher's
                    ``at``-th liveness poll (fleet/launcher.py
                    restarts it).  The two sites keep separate
                    counters (``wire:N`` vs ``host:N``); arm one fault
                    per site when both must fire
==================  =========================================================

Every injection is auditable: it lands in ``plan.log``, increments the
``dttpu_faults_injected_total`` counter on the plan's registry, and emits
a ``fault`` instant on the active obs tracer (when one is active), so a
chaos run's timeline shows exactly where reality was bent.

Determinism: triggers are index-equality, each fault fires at most
``times`` times (default 1), and the only randomness (the flip offset of
``corrupt_checkpoint``) comes from the plan's seeded generator — the
same plan against the same run injects the same faults.

The port's step counter is a host int, so evaluating a ``nan_grads``
trigger costs no host sync; with no plan active every hook site is a
single module-global ``None`` check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..obs import metrics as metrics_lib
from ..obs import trace as trace_lib

__all__ = ["Fault", "FaultPlan", "InjectedFault", "KINDS", "activate",
           "activated", "active", "deactivate", "plan_from_env"]

KINDS = ("corrupt_checkpoint", "save_oserror", "poison_batch",
         "nan_grads", "kill_prefetch", "fail_decode", "kill_replica",
         "stall_tick", "wedge_replica", "correlated_kill",
         "drop_chunk", "corrupt_chunk", "stall_wire", "kill_host")


class InjectedFault(RuntimeError):
    """An injected failure with no realistic stdlib exception type.

    Used where the real-world analogue is a component-internal error
    (a poisoned request's decode); sites injecting faults that DO have a
    realistic type raise that type instead (``OSError`` for save/IO).
    """


@dataclasses.dataclass
class Fault:
    """One scheduled fault.  ``at`` is the trigger index — what it
    indexes depends on ``kind`` (see the module catalog)."""
    kind: str
    at: int
    mode: str = "truncate"          # corrupt_checkpoint: truncate | flip
    file: str = "arrays.npz"        # corrupt_checkpoint target file
    replica: int = 0                # kill_replica/stall_tick/wedge_replica:
    #                                 target replica (engine chaos_tag)
    seconds: float = 1.0            # stall_tick: sleep length;
    #                                 wedge_replica: max block before the
    #                                 wedge self-releases
    times: int = 1                  # max fires
    k: int = 2                      # correlated_kill: victim count
    window: int = 8                 # correlated_kill: pump window length
    victims: tuple = ()             # correlated_kill: chosen at window
    #                                 open by the plan's seeded rng (audit
    #                                 trail; leave empty when scheduling)
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choices: {KINDS}")


class FaultPlan:
    """A deterministic schedule of faults plus its audit trail."""

    def __init__(self, faults, seed: int = 0,
                 registry: Optional[metrics_lib.Registry] = None):
        import numpy as np
        self.faults: List[Fault] = [
            f if isinstance(f, Fault) else Fault(**f) for f in faults]
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._wedges: Dict[int, threading.Event] = {}
        self._seen_replicas: set = set()
        self._corr_killed: Dict[int, set] = {}   # id(fault) -> victims hit
        self.log: List[Dict[str, Any]] = []
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self._injected = reg.counter(
            "dttpu_faults_injected_total",
            "Faults injected by the resilience chaos harness.")

    # ----------------------------------------------------------- matching

    def add(self, fault: Fault) -> Fault:
        """Arm one more fault on a live plan — the fleet simulator
        translates trace-scheduled incidents into plan faults as their
        virtual time comes due."""
        with self._lock:
            self.faults.append(fault)
        return fault

    @property
    def global_pump_index(self) -> int:
        """The NEXT router-pump index across all replicas (what a
        ``correlated_kill`` scheduled with ``at=`` this value matches
        on the very next pump)."""
        with self._lock:
            return self._counters.get("replica:*", 0)

    def _tick(self, site: str) -> int:
        """0-based per-site call counter (thread-safe; the prefetch
        producer calls ``on_batch`` off the main thread)."""
        with self._lock:
            i = self._counters.get(site, 0)
            self._counters[site] = i + 1
            return i

    def _match(self, kind: str, index: int,
               replica: Optional[int] = None) -> Optional[Fault]:
        with self._lock:
            for f in self.faults:
                if f.kind == kind and f.at == index and f.fired < f.times \
                        and (replica is None or f.replica == replica):
                    f.fired += 1
                    return f
        return None

    def _record(self, fault: Fault, **ctx: Any) -> None:
        entry = {"kind": fault.kind, "at": fault.at, **ctx}
        with self._lock:
            self.log.append(entry)
        self._injected.inc()
        trace_lib.instant("fault", kind=fault.kind,
                          **{k: str(v) for k, v in ctx.items()})

    # ------------------------------------------------------ site hooks
    # Each is called by exactly one instrumented site; all are no-ops
    # (beyond a counter tick) unless a fault matches.

    def on_save(self) -> int:
        """Entry of ``checkpoint.save``: returns this call's save index;
        raises a transient ``OSError`` when a save_oserror is armed."""
        i = self._tick("save")
        f = self._match("save_oserror", i)
        if f is not None:
            self._record(f, save=i)
            raise OSError(f"injected fault: checkpoint save #{i} failed")
        return i

    def on_saved(self, ckpt_path: str, save_index: int) -> None:
        """After the atomic rename: corrupt the just-written checkpoint
        when a corrupt_checkpoint is armed at this save index."""
        f = self._match("corrupt_checkpoint", save_index)
        if f is not None:
            self._corrupt(ckpt_path, f)
            self._record(f, path=ckpt_path, mode=f.mode)

    def _corrupt(self, ckpt_path: str, fault: Fault) -> None:
        target = os.path.join(ckpt_path, fault.file)
        size = os.path.getsize(target)
        if fault.mode == "flip":
            off = int(self._rng.integers(0, max(1, size)))
            with open(target, "r+b") as fh:
                fh.seek(off)
                b = fh.read(1) or b"\x00"
                fh.seek(off)
                fh.write(bytes([b[0] ^ 0xFF]))
        else:                                   # truncate
            with open(target, "r+b") as fh:
                fh.truncate(size // 2)

    def on_batch(self, item: Any) -> Any:
        """One batch through the prefetch producer: kill the producer or
        poison the batch when armed; otherwise pass ``item`` through."""
        i = self._tick("batch")
        f = self._match("kill_prefetch", i)
        if f is not None:
            self._record(f, batch=i)
            raise OSError(
                f"injected fault: dttpu-prefetch producer killed at "
                f"batch #{i}")
        f = self._match("poison_batch", i)
        if f is not None:
            self._record(f, batch=i)
            return _poison(item)
        return item

    def on_step(self, step: int, args: tuple) -> tuple:
        """``TrainSession.run_step`` with pre-step global step ``step``:
        NaN-poison the step's args when a nan_grads fault is armed."""
        f = self._match("nan_grads", int(step))
        if f is not None:
            self._record(f, step=int(step))
            return _poison(args)
        return args

    def on_decode(self, rid: int) -> None:
        """Serve token delivery for request ``rid``: fail exactly that
        request when a fail_decode fault is armed."""
        f = self._match("fail_decode", int(rid))
        if f is not None:
            self._record(f, rid=int(rid))
            raise InjectedFault(
                f"injected fault: decode failed for request {rid}")

    def on_engine_tick(self, tag: int) -> None:
        """The serve scheduler's pump at tick entry for the engine
        tagged ``tag`` (the fleet Router stamps replica ids onto
        ``Engine.chaos_tag``; a standalone engine is tag 0).  A
        stall_tick armed at this tick index sleeps ``seconds`` — the
        tick completes, but past any sane watchdog deadline; a
        wedge_replica blocks the pump (mutex held, mid-tick) until
        ``release_wedges()`` or the ``seconds`` cap, the
        stuck-but-alive shape only an in-progress heartbeat check can
        see."""
        i = self._tick(f"tick:{tag}")
        f = self._match("stall_tick", i, replica=int(tag))
        if f is not None:
            self._record(f, replica=int(tag), tick=i, seconds=f.seconds)
            time.sleep(f.seconds)
        f = self._match("wedge_replica", i, replica=int(tag))
        if f is not None:
            with self._lock:
                ev = self._wedges.setdefault(int(tag), threading.Event())
            self._record(f, replica=int(tag), tick=i)
            ev.wait(f.seconds)

    def release_wedges(self) -> None:
        """Unblock every pump held by a fired wedge_replica fault (the
        test/bench driver's hand on the wedge — a wedge with no release
        self-frees at its ``seconds`` cap)."""
        with self._lock:
            evs = list(self._wedges.values())
        for ev in evs:
            ev.set()

    def on_replica_step(self, replica: int) -> None:
        """The fleet Router's pump of replica ``replica``: kill that
        replica (a ``ConnectionError`` — the realistic router-to-replica
        failure type) on its ``at``-th pump when a kill_replica fault
        targeting it is armed."""
        i = self._tick(f"replica:{replica}")
        f = self._match("kill_replica", i, replica=int(replica))
        if f is not None:
            self._record(f, replica=int(replica), step=i)
            raise ConnectionError(
                f"injected fault: replica {replica} killed at pump #{i}")
        f = self._match_correlated(int(replica))
        if f is not None:
            self._record(f, replica=int(replica), step=i,
                         victims=f.victims)
            raise ConnectionError(
                f"injected fault: replica {replica} killed by correlated "
                f"failure (victims {f.victims})")

    def on_wire_chunk(self, wire: int) -> Optional[str]:
        """The page wire's delivery of one chunk frame on wire ``wire``
        (``InProcessLink.deliver``, fleet/pagewire.py): returns the
        action the link applies to this frame — ``"drop"`` (vanish it),
        ``"corrupt"`` (flip a byte; the receiver's CRC NAKs), or
        ``None`` (deliver clean).  A stall_wire sleeps ``seconds``
        in-line (the whole flight lands late); a kill_host raises
        ``ConnectionError`` — the host died mid-transfer and the
        transfer is unrecoverable."""
        i = self._tick(f"wire:{wire}")
        f = self._match("kill_host", i, replica=int(wire))
        if f is not None:
            self._record(f, wire=int(wire), chunk=i)
            raise ConnectionError(
                f"injected fault: host behind wire {wire} died at "
                f"chunk #{i}")
        f = self._match("stall_wire", i, replica=int(wire))
        if f is not None:
            self._record(f, wire=int(wire), chunk=i, seconds=f.seconds)
            time.sleep(f.seconds)
        f = self._match("drop_chunk", i, replica=int(wire))
        if f is not None:
            self._record(f, wire=int(wire), chunk=i)
            return "drop"
        f = self._match("corrupt_chunk", i, replica=int(wire))
        if f is not None:
            self._record(f, wire=int(wire), chunk=i)
            return "corrupt"
        return None

    def on_host_poll(self, host: int) -> Optional[Fault]:
        """The launcher's ``at``-th liveness poll of host ``host``
        (fleet/launcher.py): returns the matched kill_host fault so the
        launcher SIGKILLs the child — the supervised-restart path —
        or ``None``.  Separate counter site from ``on_wire_chunk``
        (``host:N`` vs ``wire:N``); arm one fault per site when a test
        needs both the wire cut AND the process killed."""
        i = self._tick(f"host:{host}")
        f = self._match("kill_host", i, replica=int(host))
        if f is not None:
            self._record(f, host=int(host), poll=i)
        return f

    def _match_correlated(self, replica: int) -> Optional[Fault]:
        """correlated_kill matching: a *global* pump counter (across all
        replicas) opens the window at ``at``; victims are drawn once,
        seeded, from the replicas seen pumped so far; each victim dies on
        its first pump inside ``[at, at + window)``."""
        with self._lock:
            self._seen_replicas.add(replica)
            j = self._counters.get("replica:*", 0)
            self._counters["replica:*"] = j + 1
            for f in self.faults:
                if f.kind != "correlated_kill" or f.fired >= f.k:
                    continue
                if j < f.at or j >= f.at + f.window:
                    continue
                if not f.victims:
                    pool = sorted(self._seen_replicas)
                    size = min(f.k, len(pool))
                    f.victims = tuple(
                        int(x) for x in self._rng.choice(
                            pool, size=size, replace=False))
                killed = self._corr_killed.setdefault(id(f), set())
                if replica in f.victims and replica not in killed:
                    killed.add(replica)
                    f.fired += 1
                    return f
        return None


def _poison(tree: Any) -> Any:
    """Replace every floating leaf (a tensor, kept on its device, or a
    numpy array) of a tree of dicts, lists and tuples with NaN; integer
    leaves (token ids) pass through."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _poison(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_poison(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (torch.full_like(tree, float("nan"))
                if tree.is_floating_point() else tree)
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype,
                                                      np.floating):
        return np.full_like(tree, np.nan)
    return tree


# ---------------------------------------------------------------------------
# Active plan: process-wide activation (the obs.trace idiom) + env spec.

_ACTIVE: Optional[FaultPlan] = None
_ENV_CACHE = (None, None)   # (env string, parsed plan)
_ENV_LOCK = threading.Lock()  # rebuilds race across pump/producer threads


def activate(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def deactivate(plan: Optional[FaultPlan] = None) -> None:
    """Clear the active plan (only if it is ``plan``, when given)."""
    global _ACTIVE
    if plan is None or _ACTIVE is plan:
        _ACTIVE = None


@contextlib.contextmanager
def activated(plan: FaultPlan):
    """Scoped activation (tests, chaos runs)."""
    activate(plan)
    try:
        yield plan
    finally:
        deactivate(plan)


def active() -> Optional[FaultPlan]:
    """The plan injection sites consult: an explicitly activated plan
    wins; otherwise ``DTTPU_FAULTS`` (JSON) is parsed once per distinct
    value and cached — counters must persist across calls.

    Injection sites run on scheduler pumps, router sweeps, and prefetch
    producers concurrently; the rebuild is locked so one spec value maps
    to ONE plan instance (two racing rebuilds would split the per-site
    at-most-``times`` counters across two plans and over-fire faults)."""
    global _ENV_CACHE
    if _ACTIVE is not None:
        return _ACTIVE
    spec = os.environ.get("DTTPU_FAULTS")
    if not spec:
        return None
    with _ENV_LOCK:
        if _ENV_CACHE[0] != spec:
            _ENV_CACHE = (spec, plan_from_env(spec))
        return _ENV_CACHE[1]


def plan_from_env(spec: str) -> FaultPlan:
    """Parse a ``DTTPU_FAULTS`` value: either a JSON list of fault dicts
    or ``{"seed": S, "faults": [...]}``."""
    doc = json.loads(spec)
    if isinstance(doc, dict):
        return FaultPlan(doc.get("faults", []), seed=doc.get("seed", 0))
    return FaultPlan(doc)
