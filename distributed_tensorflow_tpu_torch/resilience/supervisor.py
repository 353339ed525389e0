"""Auto-resume supervisor: the survival half of fault tolerance.

Counterpart of ``distributed_tensorflow_tpu/resilience/supervisor.py``:
the same classification, seeded numpy backoff, metrics and guard hook.

The source system's whole failure story is "restart the process and
``MonitoredTrainingSession`` restores the latest checkpoint" (reference
example.py:189-192; TensorFlow paper §4.3 calls user-level checkpointing
the system's entire fault-tolerance mechanism).  ``Supervisor`` is that
restart loop brought in-process and made honest about *which* failures
deserve a restart:

* **transient** (preemption-shaped: ``OSError``/``ConnectionError``/
  ``TimeoutError`` from storage and RPC, ``FloatingPointError`` from a
  divergence guard, injected chaos faults) → restart from the last good
  checkpoint, with bounded retries and exponential backoff + jitter so a
  hard-down dependency is not hammered in lockstep by every host;
* **fatal** (everything else: shape errors, assertion failures,
  ``KeyboardInterrupt``) → re-raise immediately; a code bug replayed
  from a checkpoint fails identically forever and must reach the
  operator, not burn the retry budget.

Restarts are observable: ``dttpu_restarts_total`` counts them and
``dttpu_recovery_seconds`` measures failure → restored-session wall
clock (docs/OBSERVABILITY.md).

``NonfiniteGuardHook`` is the divergence tripwire that makes the NaN
fault class *transient*: it rides the ``device_health`` metrics the step
already returns (``obs.device.grad_health``), tolerates isolated
non-finite steps (the step option ``skip_nonfinite`` drops those
updates on the device, so params stay clean), and aborts with
``FloatingPointError`` — which the supervisor classifies transient —
after K *consecutive* bad steps, when skipping clearly isn't converging
back to health.  In the port the metrics it reads are 0-d device tensors
from ``make_custom_train_step(device_health=True)``.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from ..obs import device as obs_device
from ..obs import goodput as goodput_lib
from ..obs import metrics as metrics_lib
from .faults import InjectedFault

log = logging.getLogger(__name__)

__all__ = ["Supervisor", "NonfiniteGuardHook", "TRANSIENT_EXCEPTIONS"]

# The preemption-shaped failure set.  FloatingPointError is transient by
# design: NonfiniteGuardHook (and NaNHook) raise it exactly when a
# restart-from-checkpoint is the right recovery.  InjectedFault keeps
# chaos runs inside the same classification the real faults would get.
TRANSIENT_EXCEPTIONS = (OSError, ConnectionError, TimeoutError,
                        FloatingPointError, InjectedFault)


class Supervisor:
    """Bounded-retry auto-resume driver around a session factory.

    Usage::

        sup = Supervisor(max_restarts=3)

        def build_session():
            state, step_fn = rebuild()          # fresh state every attempt
            return TrainSession(state, step_fn, checkpoint_dir=d,
                                hooks=[...])    # restores the last GOOD ckpt

        def train(sess):
            for batch in batches():
                if sess.should_stop():
                    break
                sess.run_step(batch)
            return sess.step

        final_step = sup.run(build_session, train)

    ``build_session`` must return a *fresh* context-manager session that
    restores from the checkpoint dir (``TrainSession(restore=True)`` now
    walks ``restore_latest_good``, so a corrupt newest checkpoint falls
    back instead of killing every attempt identically).  ``train(sess)``
    runs inside the session's ``with`` block; its return value is
    ``run``'s.  Failures raised by either are classified; transient ones
    are retried up to ``max_restarts`` times with exponential backoff
    (``backoff_base * backoff_factor**(attempt-1)``, capped at
    ``backoff_max``) plus up to ``jitter`` fraction of random extra.

    ``classify``: optional ``exc -> "transient" | "fatal"`` override
    (e.g. to add a backend's preemption error type); default classifies
    by ``TRANSIENT_EXCEPTIONS``.  ``sleep`` is injectable for tests.
    """

    def __init__(self, *, max_restarts: int = 3,
                 backoff_base: float = 0.5,
                 backoff_factor: float = 2.0,
                 backoff_max: float = 30.0,
                 jitter: float = 0.5,
                 classify: Optional[Callable[[BaseException], str]] = None,
                 registry: Optional[metrics_lib.Registry] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: int = 0):
        import numpy as np
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.classify = classify
        self.sleep = sleep
        self._rng = np.random.default_rng(seed)
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self.restarts_total = reg.counter(
            "dttpu_restarts_total",
            "Supervisor restarts after transient failures.")
        self.recovery_seconds = reg.histogram(
            "dttpu_recovery_seconds",
            "Failure to restored-session wall clock (backoff + rebuild "
            "+ checkpoint restore).")
        self.restart_log: list = []   # (attempt, repr(exc)) audit trail

    # ----------------------------------------------------------------- run

    def _is_transient(self, exc: BaseException) -> bool:
        if self.classify is not None:
            return self.classify(exc) == "transient"
        return isinstance(exc, TRANSIENT_EXCEPTIONS)

    def _delay(self, attempt: int) -> float:
        base = min(self.backoff_max,
                   self.backoff_base * self.backoff_factor ** (attempt - 1))
        return base * (1.0 + self.jitter * float(self._rng.random()))

    def run(self, build_session: Callable[[], Any],
            train: Callable[[Any], Any]) -> Any:
        """Drive ``train`` over fresh sessions until it returns, a fatal
        error escapes, or the restart budget is exhausted (the last
        transient error is then re-raised)."""
        attempt = 0
        failed_at: Optional[float] = None
        while True:
            try:
                if failed_at is not None:
                    # goodput "fault_recovery": the post-failure session
                    # rebuild.  The checkpoint restore inside it accrues
                    # to its own exclusive "checkpoint_restore" frame, so
                    # this bucket is the rebuild glue around the restore.
                    with goodput_lib.account("fault_recovery"):
                        session = build_session()
                    self.recovery_seconds.observe(
                        time.monotonic() - failed_at)
                    failed_at = None
                else:
                    session = build_session()
                with session:
                    return train(session)
            except BaseException as e:
                if not self._is_transient(e) or attempt >= self.max_restarts:
                    raise
                attempt += 1
                failed_at = time.monotonic() if failed_at is None \
                    else failed_at
                self.restarts_total.inc()
                self.restart_log.append((attempt, repr(e)))
                delay = self._delay(attempt)
                log.warning(
                    "transient failure (%r) — restart %d/%d from last good "
                    "checkpoint in %.2fs", e, attempt, self.max_restarts,
                    delay)
                with goodput_lib.account("restart_backoff"):
                    self.sleep(delay)


class NonfiniteGuardHook:
    """Abort (transiently) after K consecutive non-finite steps.

    Reads the step's returned metrics dict — ``nonfinite_grads`` from
    ``device_health=True`` steps, falling back to the ``grads_finite``
    flag the ``loss_scale``/``skip_nonfinite`` builders emit — so it
    needs no extra device computation.  Pair with a step built with
    ``skip_nonfinite=True``: that drops the bad updates on the device
    (the step updates the parameters in place and leaves them as they
    were on a skipped step), and this hook supplies the escalation
    policy on top: isolated bad steps are skipped and survived;
    ``max_consecutive`` bad steps in a row raise ``FloatingPointError``,
    which ``Supervisor`` classifies transient and answers with a restart
    from the last good checkpoint.

    Cost note: evaluating the metric pulls one device scalar per step
    (the consecutive-run semantics need every step).  That is a
    deliberate exception to the hooks-don't-sync contract — install this
    hook when you want the guard, not by default.

    Duck-typed train Hook (no ``train.hooks`` import: resilience stays
    import-cycle-free below the train package).
    """

    def __init__(self, max_consecutive: int = 3):
        if max_consecutive < 1:
            raise ValueError(
                f"max_consecutive must be >= 1; got {max_consecutive}")
        self.max_consecutive = int(max_consecutive)
        self.consecutive = 0
        self.total_nonfinite = 0

    # Hook protocol ------------------------------------------------------
    def begin(self, session) -> None:
        self.consecutive = 0

    def before_step(self, session) -> None:
        pass

    def after_step(self, session, metrics) -> None:
        nf = metrics.get(obs_device.NONFINITE_KEY)
        if nf is not None:
            bad = float(nf) > 0
        else:
            finite = metrics.get("grads_finite")
            if finite is None:
                return
            bad = not bool(finite)
        if not bad:
            self.consecutive = 0
            return
        self.consecutive += 1
        self.total_nonfinite += 1
        log.warning("non-finite gradients at step %d (%d consecutive)",
                    session.step, self.consecutive)
        if self.consecutive >= self.max_consecutive:
            raise FloatingPointError(
                f"{self.consecutive} consecutive non-finite steps ending "
                f"at step {session.step} — aborting for restart from the "
                "last good checkpoint")

    def end(self, session) -> None:
        pass

    def close(self, session) -> None:
        pass
