"""fleet — multi-replica serving over the port's engines.

Counterpart of ``distributed_tensorflow_tpu/fleet``, the tier above
``serve``: N ``Engine`` replicas (on one card, each with its own page
pool) behind one ``Router``.

* ``fleet.router``: ``Router``, least-loaded prefix-affine placement
  from ``Engine.stats()``, in-deadline retry, live migration with an
  exactly-once stream shim across failover, drain, removal and
  quarantine, rolling ``drain``/``remove``/``add``/``resume``.
* ``fleet.pagewire``: ``PageWire`` over ``InProcessLink``, CRC-checked
  frames of KV pages with bounded retry and seeded backoff; a migration
  ships the victim's pages so the destination skips those windows.
* ``fleet.watchdog``: ``Watchdog``, a tick-deadline policy over the pump
  heartbeat that quarantines wedged or stalled replicas.
* ``fleet.autoscaler``: ``Autoscaler`` and ``SLO``, scale-out on missed
  attainment or backlog, migrate-based scale-in, a heal below the floor.
* ``fleet.workload``: ``synthesize`` seeded traces (``Trace``,
  ``FleetEvent``), bit-equal to the reference's.
* ``fleet.tenancy``: per-tenant quotas and the deficit fair queue.

Not ported yet: the reference's ``fleet.sim`` (``CostModel``,
``FleetSim``, ``HardwarePoint``, ``SimEngine``) and ``fleet.launcher``
(``HostSpec``, ``Launcher``).
"""
from . import autoscaler, pagewire, router, tenancy, watchdog, workload
from .autoscaler import SLO, Autoscaler
from .pagewire import (InProcessLink, PageRecord, PageWire, WireError,
                       WireFrameError, frame_chunk, parse_frame)
from .router import EngineProtocol, FleetHandle, NoReplicaError, Router
from .tenancy import (DeficitFairQueue, QuotaExceededError, TenantPolicy,
                      TenantQuota)
from .watchdog import Watchdog
from .workload import FleetEvent, Trace, synthesize

__all__ = ["Autoscaler", "DeficitFairQueue", "EngineProtocol",
           "FleetEvent", "FleetHandle", "InProcessLink", "NoReplicaError",
           "PageRecord", "PageWire", "QuotaExceededError", "Router", "SLO",
           "TenantPolicy", "TenantQuota", "Trace", "Watchdog", "WireError",
           "WireFrameError", "autoscaler", "frame_chunk", "pagewire",
           "parse_frame", "router", "synthesize", "tenancy", "watchdog",
           "workload"]
