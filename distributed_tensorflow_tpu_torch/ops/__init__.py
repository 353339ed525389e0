"""Tensor ops of the port: attention and FFN bodies, decoding helpers,
and the hand-written kernels (``ops.kernels``)."""
