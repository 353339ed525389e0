"""Tensor ops of the port: the XOR tier of the layer library with its
activations, initializers, losses and metrics, attention and FFN bodies,
decoding helpers, and the hand-written kernels (``ops.kernels``)."""
from . import activations, initializers, layers, losses, metrics
from .layers import (Activation, Dense, Dropout, Flatten, Layer, Stack,
                     layer_spec, serial)

__all__ = ["activations", "initializers", "layers", "losses", "metrics",
           "Activation", "Dense", "Dropout", "Flatten", "Layer", "Stack",
           "layer_spec", "serial"]
