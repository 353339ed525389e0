"""Optimizers of the port (``optim/optimizers.py``)."""
from .optimizers import (OptState, Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, default_decay_mask, global_norm)

__all__ = ["OptState", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "default_decay_mask", "global_norm"]
