"""PyTorch/CUDA port of distributed_tensorflow_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports none of
it, nor JAX.  Slice 1 is the paged serving path: ``GPT`` (GPT-2 family)
driven by ``Engine`` over a KV page pool, with hand-written CUDA kernels
for paged attention and LayerNorm.  Slice 2 is causal-LM training:
``GPT.lm_loss_fn``, ``adamw`` and ``make_custom_train_step``, with
hand-written CUDA kernels for flash attention (forward, dK/dV, dQ) and
the Adam step.  Kernels live in ``ops/kernels``, their sources in
``csrc/``.  Entry points run on the card unless given ``device="cpu"``.
"""
from .models.convert import (gpt_params_from_jax, gpt_params_to_jax,
                             load_jax_params)
from .models.gpt import GPT, GPTConfig, gpt_small, gpt_tiny
from .optim import adam, adamw
from .serve.engine import Engine, EngineStats, RequestHandle
from .train import TrainState, make_custom_train_step

__all__ = ["Engine", "EngineStats", "GPT", "GPTConfig", "RequestHandle",
           "TrainState", "adam", "adamw", "gpt_params_from_jax",
           "gpt_params_to_jax", "gpt_small", "gpt_tiny", "load_jax_params",
           "make_custom_train_step"]
