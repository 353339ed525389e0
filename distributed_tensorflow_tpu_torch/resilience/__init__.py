"""resilience — fault injection, verified-checkpoint fallback, auto-resume.

Counterpart of ``distributed_tensorflow_tpu/resilience`` (docs/
RESILIENCE.md).  The source system's whole failure story is
``MonitoredTrainingSession`` restoring the latest checkpoint after a
restart; this package supplies what that story assumes:

* ``resilience.faults`` — a seeded, deterministic fault-injection
  harness (``FaultPlan``: corrupt a checkpoint after its write, a
  transient save ``OSError``, NaN-poisoned batches and steps, a killed
  prefetch producer, a stalled or wedged engine tick, a failed decode),
  activated via ``DTTPU_FAULTS`` or ``faults.activated(plan)``, every
  injection audited (``plan.log``, ``dttpu_faults_injected_total``, a
  ``fault`` trace instant).
* verified checkpoints — ``train.checkpoint.restore_latest_good`` walks
  newest to oldest, quarantining corrupt dirs (``TrainSession(restore=
  True)`` uses it).
* ``resilience.supervisor`` — ``Supervisor.run(build_session, train)``:
  transient-vs-fatal classification, bounded restarts with exponential
  backoff + jitter, ``dttpu_restarts_total`` / ``dttpu_recovery_seconds``;
  plus ``NonfiniteGuardHook``, the consecutive-non-finite tripwire over
  the step's ``device_health`` metrics.

Serve-side degradation (queue-depth admission, deadlines, failure
isolation of one request) lives in ``serve.engine`` / ``serve.scheduler``.
"""
from . import faults, supervisor
from .faults import Fault, FaultPlan, InjectedFault
from .supervisor import NonfiniteGuardHook, Supervisor

__all__ = ["faults", "supervisor", "Fault", "FaultPlan", "InjectedFault",
           "NonfiniteGuardHook", "Supervisor"]
