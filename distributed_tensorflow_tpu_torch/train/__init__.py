"""Training of the port: the step builders (``train/step.py``), precision
policies and loss scales (``train/precision.py``), ``TrainState`` and
``TrainSession`` (``train/session.py``), hooks (``train/hooks.py``) and
checkpoints (``train/checkpoint.py``)."""
from . import checkpoint, hooks, precision
from .hooks import (CheckpointHook, EvalHook, Hook, LoggingHook,
                    MetricsExportHook, NaNHook, PreemptionHook, ProfilerHook,
                    StepCounterHook, StopAtStepHook, SummaryHook, TraceHook,
                    WatchdogHook)
from .precision import (DynamicLossScale, LossScaled, NoLossScale, Policy,
                        StaticLossScale, attach_loss_scale)
from .session import TrainSession, TrainState
from .step import (init_train_state, make_custom_train_step,
                   make_eval_step, make_masked_eval_step,
                   make_multi_train_step, make_train_step)

__all__ = ["checkpoint", "hooks", "precision", "CheckpointHook", "EvalHook",
           "Hook", "LoggingHook", "MetricsExportHook", "NaNHook",
           "PreemptionHook", "ProfilerHook", "StepCounterHook",
           "StopAtStepHook", "SummaryHook", "TraceHook", "WatchdogHook", "DynamicLossScale", "LossScaled",
           "NoLossScale", "Policy", "StaticLossScale", "attach_loss_scale",
           "TrainSession", "TrainState", "init_train_state",
           "make_custom_train_step", "make_eval_step",
           "make_masked_eval_step", "make_multi_train_step",
           "make_train_step"]
