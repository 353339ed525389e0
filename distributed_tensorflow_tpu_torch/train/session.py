"""``TrainState`` and ``TrainSession``, the training loop's driver, in
PyTorch.

Counterpart of ``distributed_tensorflow_tpu/train/session.py``:

  * chief semantics: only the chief writes checkpoints.
    ``is_chief=None`` means rank 0 of an initialised ``torch.distributed``
    process group, else True (the port has no cluster module yet);
  * auto-restore on entry through ``checkpoint.restore_latest_good``
    (verified, corrupt checkpoints quarantined), IN PLACE into the
    state's tensors: the model's parameters keep their identity;
  * the ``while not sess.should_stop():`` loop with hooks, periodic and
    final saves, optional background (``async_checkpoint``) writes.

The step function is ``make_custom_train_step``'s; its metrics are device
tensors, and a hook that does not fire never reads them.

Instrumentation, as in the JAX package: ``telemetry`` (an
``obs.Telemetry``) wraps each step function call in a ``dispatch`` span
and each save in a ``checkpoint`` span (and its duration in the
``dttpu_checkpoint_save_seconds`` histogram); an active goodput
accountant books each step call to ``step`` and each save to
``checkpoint_save``; an active fault plan may poison a step's arguments
(``nan_grads``, triggered by the pre-step count, a host int here).
Without them each site costs one attribute check.

``sharded_checkpoint=True`` (``train/sharded_checkpoint.py``): every
rank writes the chunks it owns of the state (a ZeRO state's blocks, or
a plain state's leaves on the chief) and the chief the manifest; a sync
save ends in a ``torch.distributed`` barrier on the mesh's group (the
state's ZeRO mesh, else the world), so that it returns once the
checkpoint is complete everywhere; a background (``async_checkpoint``)
save has none.  Restore walks newest to oldest through
``restore_latest_good_sharded`` and writes each rank's blocks in place.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import torch

from ..obs import goodput as goodput_lib
from ..resilience import faults as faults_lib
from . import checkpoint as ckpt_lib
from . import sharded_checkpoint as sharded_lib
from .hooks import Hook

log = logging.getLogger(__name__)

__all__ = ["TrainState", "TrainSession", "process_is_chief"]


class TrainState(NamedTuple):
    """The unit of checkpoint and restore.  ``step`` counts applied steps
    (the ``global_step`` analogue, a host int); ``params`` maps names to
    the model's parameters; ``model_state`` holds non-trainable state
    (empty for GPT; ``precision.LossScaled`` under loss scaling)."""
    step: int
    params: Mapping[str, torch.Tensor]
    opt_state: Any
    model_state: Any = ()

    @classmethod
    def create(cls, params, opt_state, model_state=()):
        return cls(step=0, params=params, opt_state=opt_state,
                   model_state=model_state)


StepFn = Callable[..., Tuple[TrainState, Dict[str, Any]]]


def process_is_chief() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` group, else True."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class TrainSession:
    """Monitored training loop driver::

        with TrainSession(state, step_fn, checkpoint_dir=logdir,
                          hooks=[StopAtStepHook(30000)]) as sess:
            for batch in data:
                if sess.should_stop():
                    break
                metrics = sess.run_step(batch)

    ``step_fn(state, batch) -> (new_state, metrics)``, typically from
    ``train.make_custom_train_step``."""

    def __init__(self, state: TrainState, step_fn: StepFn,
                 checkpoint_dir: Optional[str] = None,
                 hooks: Sequence[Hook] = (),
                 is_chief: Optional[bool] = None,
                 max_to_keep: int = 5,
                 restore: bool = True,
                 async_checkpoint: bool = False,
                 sharded_checkpoint: bool = False,
                 telemetry=None):
        self.state = state
        self.step_fn = step_fn
        self.checkpoint_dir = checkpoint_dir
        self.hooks = list(hooks)
        # the session never closes a telemetry object it was given
        self.telemetry = telemetry
        self.is_chief = process_is_chief() if is_chief is None \
            else is_chief
        self.max_to_keep = max_to_keep
        self.last_saved_step = None
        self._stop = False
        self.sharded = sharded_checkpoint
        self._async_ckpt = None
        if async_checkpoint:
            self._async_ckpt = (sharded_lib.AsyncShardedCheckpointer()
                                if sharded_checkpoint
                                else ckpt_lib.AsyncCheckpointer())
        if restore and checkpoint_dir:
            walk = (sharded_lib.restore_latest_good_sharded
                    if sharded_checkpoint else ckpt_lib.restore_latest_good)
            restored, latest = walk(self.state, checkpoint_dir)
            if restored is not None:
                self.state = restored
                self.last_saved_step = self.step    # disk has this step
                log.info("restored checkpoint %s (step %d)", latest,
                         self.step)
                print(f"Restored checkpoint {os.path.basename(latest)} at "
                      f"step {self.step}", flush=True)

    # -- loop protocol ----------------------------------------------------
    @property
    def step(self) -> int:
        return int(self.state.step)

    def should_stop(self) -> bool:
        return self._stop

    def request_stop(self) -> None:
        self._stop = True

    def run_step(self, *args, **kwargs) -> Dict[str, Any]:
        """One training step: hooks, the step function, cursor advance."""
        plan = faults_lib.active()
        if plan is not None:
            args = plan.on_step(self.step, args)
        for hook in self.hooks:
            hook.before_step(self)
        with goodput_lib.account("step"):
            if self.telemetry is not None:
                with self.telemetry.tracer.span("dispatch"):
                    self.state, metrics = self.step_fn(self.state, *args,
                                                       **kwargs)
            else:
                self.state, metrics = self.step_fn(self.state, *args,
                                                   **kwargs)
        for hook in self.hooks:
            hook.after_step(self, metrics)
        return metrics

    # -- checkpointing ----------------------------------------------------
    def save(self) -> Optional[str]:
        """Chief-only checkpoint write (every rank's under
        ``sharded_checkpoint``); a no-op elsewhere and without a
        checkpoint dir."""
        with goodput_lib.account("checkpoint_save"):
            if self.telemetry is None:
                return self._save_impl()
            t0 = time.perf_counter()
            with self.telemetry.tracer.span("checkpoint", step=self.step):
                path = self._save_impl()
            self.telemetry.checkpoint_seconds().observe(
                time.perf_counter() - t0)
            return path

    def _save_impl(self) -> Optional[str]:
        if self.sharded and self.checkpoint_dir:
            return self._save_sharded()
        if not self.checkpoint_dir or not self.is_chief:
            return None
        if self._async_ckpt is not None:
            self._async_ckpt.save(self.checkpoint_dir, self.step, self.state,
                                  max_to_keep=self.max_to_keep)
            path = ckpt_lib.ckpt_path(self.checkpoint_dir, self.step)
        else:
            path = ckpt_lib.save(self.checkpoint_dir, self.step, self.state,
                                 max_to_keep=self.max_to_keep)
        self.last_saved_step = self.step
        log.info("saved checkpoint %s", path)
        return path

    def _save_sharded(self) -> str:
        """Every rank writes its chunks; the sync path ends in a barrier
        on the mesh's group (none in the background: it would race the
        training loop's collectives)."""
        if self._async_ckpt is not None:
            self._async_ckpt.save(self.checkpoint_dir, self.step, self.state,
                                  max_to_keep=self.max_to_keep)
            path = ckpt_lib.ckpt_path(self.checkpoint_dir, self.step)
            log.info("queued sharded checkpoint %s", path)
        else:
            path = sharded_lib.save_sharded(
                self.checkpoint_dir, self.step, self.state,
                max_to_keep=self.max_to_keep, sync_fn=self._barrier())
            log.info("saved sharded checkpoint %s", path)
        self.last_saved_step = self.step
        return path

    def _barrier(self):
        """A barrier on the group of the state's ZeRO mesh (the world's
        without one), or None for a single process."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return None
        mesh = getattr(self.state.params, "mesh", None)
        group = mesh.group if mesh is not None else None
        return lambda: dist.barrier(group=group)

    def drain_checkpoints(self) -> None:
        """Block until every queued background write is on disk."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    # -- context manager --------------------------------------------------
    def __enter__(self) -> "TrainSession":
        if self.telemetry is not None:
            self.telemetry.start()      # idempotent; the hooks call it too
        for hook in self.hooks:
            hook.begin(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # clean exit: end hooks, then a final checkpoint at this step if
        # none is on disk yet; ``close`` and the writer's drain always run
        try:
            if exc_type is None:
                for hook in self.hooks:
                    hook.end(self)
                if (self.checkpoint_dir and (self.is_chief or self.sharded)
                        and self.last_saved_step != self.step):
                    self.save()
        finally:
            for hook in self.hooks:
                try:
                    hook.close(self)
                except Exception:  # pragma: no cover
                    log.exception("hook %r close() raised", hook)
            if self._async_ckpt is not None:
                try:
                    self._async_ckpt.close()
                except Exception:
                    if exc_type is None:
                        raise       # a lost checkpoint must be loud
                    log.exception("async checkpoint write failed during "
                                  "exception unwind")
