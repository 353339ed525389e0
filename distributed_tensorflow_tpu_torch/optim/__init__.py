"""Optimizers of the port (``optim/optimizers.py``, ``optim/adafactor.py``),
the EMA wrapper (``optim/ema.py``) and learning-rate schedules
(``optim/schedules.py``)."""
from . import schedules
from .adafactor import adafactor
from .ema import EMAState, ema, ema_params, with_ema
from .optimizers import (OptState, Optimizer, adadelta, adagrad, adam, adamw,
                         apply_updates, clip_by_global_norm,
                         default_decay_mask, ftrl, get, get_lr_scale,
                         global_norm, lamb, momentum, rmsprop, set_lr_scale,
                         sgd, with_lr_scale)

__all__ = ["EMAState", "OptState", "Optimizer", "adadelta", "adafactor",
           "adagrad", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "default_decay_mask", "ema", "ema_params",
           "ftrl", "get", "get_lr_scale", "global_norm", "lamb", "momentum",
           "rmsprop", "schedules", "set_lr_scale", "sgd", "with_ema",
           "with_lr_scale"]
