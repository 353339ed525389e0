"""Models of the port: GPT and Llama (``gpt.py``, ``llama.py``),
speculative decoding, weight conversion (``convert.py``), and the
high-level tier: ``Sequential`` with its callbacks and saving, and the
zoo (``xor_mlp``, ``mnist_mlp``, ``cifar_cnn``)."""
from . import callbacks, saving, zoo
from .callbacks import (Callback, CSVLogger, EarlyStopping, History,
                        LambdaCallback, LearningRateScheduler,
                        ModelCheckpoint, ReduceLROnPlateau, TensorBoard,
                        TerminateOnNaN)
from .saving import load_model, save_model
from .sequential import Sequential
from .zoo import cifar_cnn, mnist_mlp, xor_mlp

__all__ = ["callbacks", "saving", "zoo", "load_model", "save_model",
           "Callback", "CSVLogger", "EarlyStopping", "History",
           "LambdaCallback", "LearningRateScheduler", "ModelCheckpoint",
           "ReduceLROnPlateau", "TerminateOnNaN", "TensorBoard",
           "Sequential", "cifar_cnn", "mnist_mlp", "xor_mlp"]
