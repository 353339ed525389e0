"""fleet — multi-replica serving and the fleet's host tooling.

Counterpart of ``distributed_tensorflow_tpu/fleet``, the tier above
``serve``: N ``Engine`` replicas (on one card, each with its own page
pool) behind one ``Router``, and the host tools an operator runs around
them.

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
* ``fleet.sim``: the capacity planner.  ``FleetSim`` replays a trace
  through the real ``Router``, ``Watchdog``, ``Autoscaler`` and fault
  plan on virtual time, over ``SimEngine`` replicas priced by a
  ``CostModel`` (analytic on a ``HardwarePoint``, or calibrated from a
  real engine's measured window and tick on the card).
* ``fleet.launcher``: ``Launcher``, the supervisor of a multi-process
  run: one child a ``HostSpec`` (``local_topology`` assembles the env
  ``parallel/cluster.py`` reads), transient or fatal exits, seeded
  backoff restarts, heartbeat liveness, chief re-election, ``kill_host``
  chaos at its poll.
"""
from . import (autoscaler, launcher, pagewire, router, sim, tenancy,
               watchdog, workload)
from .autoscaler import SLO, Autoscaler
from .launcher import HostSpec, Launcher
from .pagewire import (InProcessLink, PageRecord, PageWire, WireError,
                       WireFrameError, frame_chunk, parse_frame)
from .router import EngineProtocol, FleetHandle, NoReplicaError, Router
from .sim import CostModel, FleetSim, HardwarePoint, SimEngine
from .tenancy import (DeficitFairQueue, QuotaExceededError, TenantPolicy,
                      TenantQuota)
from .watchdog import Watchdog
from .workload import FleetEvent, Trace, synthesize

__all__ = ["Autoscaler", "CostModel", "DeficitFairQueue", "EngineProtocol",
           "FleetEvent", "FleetHandle", "FleetSim", "HardwarePoint",
           "HostSpec", "InProcessLink", "Launcher", "NoReplicaError",
           "PageRecord", "PageWire", "QuotaExceededError", "Router", "SLO",
           "SimEngine", "TenantPolicy", "TenantQuota", "Trace", "Watchdog",
           "WireError", "WireFrameError", "autoscaler", "frame_chunk",
           "launcher", "pagewire", "parse_frame", "router", "sim",
           "synthesize", "tenancy", "watchdog", "workload"]
