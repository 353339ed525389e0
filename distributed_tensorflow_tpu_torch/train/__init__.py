"""Training of the port: the step builders (``train/step.py``), precision
policies and loss scales (``train/precision.py``), ``TrainState`` and
``TrainSession`` (``train/session.py``), hooks (``train/hooks.py``),
checkpoints (``train/checkpoint.py``) and sharded checkpoints
(``train/sharded_checkpoint.py``)."""
from . import checkpoint, hooks, precision, sharded_checkpoint
from .hooks import (CheckpointHook, EvalHook, Hook, LoggingHook,
                    MetricsExportHook, NaNHook, PreemptionHook, ProfilerHook,
                    StepCounterHook, StopAtStepHook, SummaryHook, TraceHook,
                    WatchdogHook)
from .precision import (DynamicLossScale, LossScaled, NoLossScale, Policy,
                        StaticLossScale, attach_loss_scale)
from .session import TrainSession, TrainState
from .sharded_checkpoint import restore_sharded, save_sharded
from .step import (gather_params, init_train_state, make_1f1b_train_step,
                   make_custom_train_step, make_eval_step,
                   make_masked_eval_step,
                   make_multi_train_step, make_train_step,
                   shard_train_state)

__all__ = ["checkpoint", "hooks", "precision", "sharded_checkpoint",
           "CheckpointHook", "EvalHook",
           "Hook", "LoggingHook", "MetricsExportHook", "NaNHook",
           "PreemptionHook", "ProfilerHook", "StepCounterHook",
           "StopAtStepHook", "SummaryHook", "TraceHook", "WatchdogHook", "DynamicLossScale", "LossScaled",
           "NoLossScale", "Policy", "StaticLossScale", "attach_loss_scale",
           "TrainSession", "TrainState", "gather_params",
           "init_train_state", "make_1f1b_train_step",
           "make_custom_train_step", "make_eval_step",
           "make_masked_eval_step", "make_multi_train_step",
           "make_train_step", "restore_sharded", "save_sharded",
           "shard_train_state"]
