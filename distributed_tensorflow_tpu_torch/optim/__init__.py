"""Optimizers of the port (``optim/optimizers.py``), the EMA wrapper
(``optim/ema.py``) and learning-rate schedules (``optim/schedules.py``)."""
from . import schedules
from .ema import EMAState, ema, ema_params, with_ema
from .optimizers import (OptState, Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, default_decay_mask, global_norm)

__all__ = ["EMAState", "OptState", "Optimizer", "adam", "adamw",
           "apply_updates", "clip_by_global_norm", "default_decay_mask",
           "ema", "ema_params", "global_norm", "schedules", "with_ema"]
