"""Llama configurations: the GPT decoder with the Llama block recipe.

Counterpart of ``distributed_tensorflow_tpu/models/llama.py``.  Llama
(Touvron et al., 2023) is the port's ``GPT`` with its config switches
set together: ``norm="rmsnorm"``, ``ffn_activation="swiglu"``,
``position_embedding="rope"`` (rotate-half, as HF), ``use_bias=False``
and ``tied_head=False``.  Each function returns a ``GPTConfig``; any
field can be overridden (``dtype``, ``kv_cache_dtype``, ...)::

    model = GPT(llama3_8b(dtype=torch.bfloat16, kv_cache_dtype="int8"))

``llama(**kw)`` builds the model itself, as the JAX package's does:
``llama(device="cuda", generator=None, mesh=None, **config_fields) ->
GPT``.

The weights are random (``GPT(config, generator=...)``) or a JAX tree
carried across by ``models/convert.py``; the HF checkpoint loader of the
JAX package is not ported.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .gpt import GPT, GPTConfig

__all__ = ["llama", "llama2_7b", "llama3_8b", "llama_config", "llama_tiny"]


def llama_config(**kw) -> GPTConfig:
    """A ``GPTConfig`` with the Llama block recipe."""
    kw.setdefault("norm", "rmsnorm")
    kw.setdefault("ffn_activation", "swiglu")
    kw.setdefault("position_embedding", "rope")
    kw.setdefault("use_bias", False)
    kw.setdefault("tied_head", False)
    kw.setdefault("dropout_rate", 0.0)
    kw.setdefault("layer_norm_eps", 1e-5)
    return GPTConfig(**kw)


def llama(device: Union[str, torch.device] = "cuda",
          generator: Optional[torch.Generator] = None, mesh=None,
          shard_kv: Optional[bool] = None, **kw) -> GPT:
    """``GPT(llama_config(**kw))`` on ``device`` (the card unless the
    caller asks for the CPU), weights from ``generator``; ``mesh`` for a
    ``seq_axis`` config, as the JAX package's ``llama(mesh=...)``, or
    with a ``tensor`` axis for tensor parallelism, where ``shard_kv``
    shards the kv heads too (by default they replicate under GQA)."""
    return GPT(llama_config(**kw), device=device, generator=generator,
               mesh=mesh, shard_kv=shard_kv)


def llama_tiny(**kw) -> GPTConfig:
    """Test-sized Llama (GQA 4q/2kv, head_dim 32): the JAX package's
    smoke config; the paged kernel runs head dims 32, 64 and 128 on the
    card."""
    for k, v in dict(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, intermediate_size=256,
                     max_position=128).items():
        kw.setdefault(k, v)
    return llama_config(**kw)


def llama2_7b(**kw) -> GPTConfig:
    """Llama-2-7B dimensions (MHA, 4k context, rope base 10000)."""
    for k, v in dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                     num_heads=32, intermediate_size=11008,
                     max_position=4096).items():
        kw.setdefault(k, v)
    return llama_config(**kw)


def llama3_8b(**kw) -> GPTConfig:
    """Llama-3-8B dimensions (GQA 32q/8kv, head_dim 128, 8k context,
    rope base 500000)."""
    for k, v in dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                     num_heads=32, num_kv_heads=8, intermediate_size=14336,
                     max_position=8192, rope_base=500000.0).items():
        kw.setdefault(k, v)
    return llama_config(**kw)
