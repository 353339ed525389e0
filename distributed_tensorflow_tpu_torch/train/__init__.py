"""Training of the port: ``TrainState`` and the step builder
(``train/step.py``)."""
from .step import TrainState, make_custom_train_step

__all__ = ["TrainState", "make_custom_train_step"]
