"""PyTorch/CUDA port of distributed_tensorflow_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports none of
it, nor JAX.  Slice 1 is the paged serving path: ``GPT`` (GPT-2 family)
driven by ``Engine`` over a KV page pool, with hand-written CUDA kernels
for paged attention and LayerNorm (``ops/kernels``, sources in
``csrc/``).  Entry points run on the card unless given ``device="cpu"``.
"""
from .models.convert import gpt_params_from_jax, load_jax_params
from .models.gpt import GPT, GPTConfig, gpt_small, gpt_tiny
from .serve.engine import Engine, EngineStats, RequestHandle

__all__ = ["Engine", "EngineStats", "GPT", "GPTConfig", "RequestHandle",
           "gpt_params_from_jax", "gpt_small", "gpt_tiny", "load_jax_params"]
