"""Tensor ops of the port: the layer library with its activations,
initializers, losses and metrics, attention and FFN bodies, decoding
helpers, and the hand-written kernels (``ops.kernels``)."""
from . import activations, attention, initializers, layers, losses, metrics
from .attention import (MultiHeadAttention, causal_mask,
                        dot_product_attention, resolve_activation)
from .layers import (GRU, LSTM, Activation, AvgPool2D, BatchNorm, Conv1D,
                     Conv2D, Dense, DepthwiseConv2D, Dropout, Embedding,
                     Flatten, GlobalAvgPool, Layer, LayerNorm, MaxPool2D,
                     SeparableConv2D, Stack, layer_spec, serial)

__all__ = ["activations", "attention", "initializers", "layers", "losses",
           "metrics", "MultiHeadAttention", "causal_mask",
           "dot_product_attention", "resolve_activation",
           "Activation", "AvgPool2D", "BatchNorm", "Conv1D", "Conv2D",
           "Dense", "DepthwiseConv2D", "Dropout", "Embedding", "Flatten",
           "GRU", "GlobalAvgPool", "LSTM", "Layer", "LayerNorm", "MaxPool2D",
           "SeparableConv2D", "Stack", "layer_spec", "serial"]
