"""Tensor ops of the port: the layer library with its activations,
initializers, losses and metrics, attention and FFN bodies, decoding
helpers, the MoE FFN (``ops.moe``), and the hand-written kernels
(``ops.kernels``)."""
from . import (activations, attention, initializers, layers, losses,
               metrics, moe)
from .attention import (MultiHeadAttention, causal_mask,
                        dot_product_attention, resolve_activation)
from .layers import (GRU, LSTM, Activation, AvgPool2D, BatchNorm, Conv1D,
                     Conv2D, Dense, DepthwiseConv2D, Dropout, Embedding,
                     Flatten, GlobalAvgPool, Layer, LayerNorm, MaxPool2D,
                     SeparableConv2D, Stack, layer_spec, serial)
from .moe import apply_moe, init_moe, moe_partition_rules

__all__ = ["activations", "attention", "initializers", "layers", "losses",
           "metrics", "moe", "apply_moe", "init_moe", "moe_partition_rules",
           "MultiHeadAttention", "causal_mask",
           "dot_product_attention", "resolve_activation",
           "Activation", "AvgPool2D", "BatchNorm", "Conv1D", "Conv2D",
           "Dense", "DepthwiseConv2D", "Dropout", "Embedding", "Flatten",
           "GRU", "GlobalAvgPool", "LSTM", "Layer", "LayerNorm", "MaxPool2D",
           "SeparableConv2D", "Stack", "layer_spec", "serial"]
