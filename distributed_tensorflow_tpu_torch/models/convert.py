"""Carry GPT weights between the JAX package's parameter tree and the port.

The JAX tree (``distributed_tensorflow_tpu/models/gpt.py GPT.init``) is
``{"embeddings": {"word", "position"}, "decoder": {...}, "ln_f": {...}}``
with every ``decoder`` leaf stacked over layers (leading axis ``L``, the
``vmap`` layout).  A Llama tree (``models/llama.py``) has no
``position``, ``beta`` or ``bias`` leaves, a ``w_gate`` in every FFN and
a top-level ``lm_head`` [vocab, d].  The caller hands it over as numpy
arrays (for example ``jax.tree.map(np.asarray, params)``); nothing here
imports JAX.
Weights stay float32, as in the JAX package.  ``gpt_params_to_jax`` goes
the other way, and since gradients and Adam moments are params-shaped
dicts under the same names, it carries them too.  ``lora_from_jax`` and
``lora_to_jax`` carry a LoRA adapter (``{target: {"a", "b"}}`` with
``[L, ...]`` leaves, the layout of both packages' ``init_lora``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .gpt import GPT, GPTConfig

__all__ = ["gpt_params_from_jax", "gpt_params_to_jax", "load_jax_params",
           "lora_from_jax", "lora_to_jax"]

# JAX tree keys that name configurations the port does not run yet
_UNPORTED = ("moe",)


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, val in tree.items():
        if key in _UNPORTED:
            raise ValueError(f"parameter {prefix}{key!r} belongs to a GPT "
                             "configuration the port does not run yet")
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def gpt_params_from_jax(tree: Dict[str, Any],
                        config: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's ``GPT`` state dict from a JAX GPT parameter tree whose
    leaves are numpy arrays."""
    for key in tree:
        if key not in ("embeddings", "decoder", "ln_f", "lm_head"):
            raise ValueError(f"parameter {key!r} belongs to a GPT "
                             "configuration the port does not run yet")
    sd = dict(tree["embeddings"])                  # word (and position)
    sd.update((f"ln_f.{k}", v) for k, v in tree["ln_f"].items())
    if "lm_head" in tree:
        sd["lm_head"] = tree["lm_head"]
    for path, leaf in _flatten(tree["decoder"]):
        if leaf.shape[0] != config.num_layers:
            raise ValueError(f"decoder leaf {path} leads with "
                             f"{leaf.shape[0]}, not {config.num_layers} "
                             "layers")
        for i in range(config.num_layers):
            sd[f"blocks.{i}.{path}"] = leaf[i]
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def gpt_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                      config: GPTConfig) -> Dict[str, Any]:
    """The JAX GPT parameter tree, numpy f32 leaves, from a port state dict
    (or any dict of tensors under the same names: gradients, moments).
    Layer ``i``'s ``blocks.<i>.<path>`` become row ``i`` of the stacked
    leaf ``decoder.<path>``.  The inverse of ``gpt_params_from_jax``."""
    tree: Dict[str, Any] = {"embeddings": {}, "ln_f": {}, "decoder": {}}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in state_dict.items():
        leaf = t.detach().to("cpu", torch.float32).numpy()
        head, _, rest = name.partition(".")
        if name in ("word", "position"):
            tree["embeddings"][name] = leaf
        elif name == "lm_head" and not config.tied_head:
            tree["lm_head"] = leaf
        elif head == "ln_f" and rest in ("gamma", "beta"):
            tree["ln_f"][rest] = leaf
        elif head == "blocks":
            i, _, path = rest.partition(".")
            layers.setdefault(path, {})[int(i)] = leaf
        else:
            raise ValueError(f"{name!r} is not a GPT parameter of the port")
    for path, rows in layers.items():
        if sorted(rows) != list(range(config.num_layers)):
            raise ValueError(f"decoder leaf {path} has layers {sorted(rows)}"
                             f", not 0..{config.num_layers - 1}")
        node = tree["decoder"]
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = np.stack([rows[i] for i in range(config.num_layers)])
    return tree


def load_jax_params(model: GPT, tree: Dict[str, Any]) -> GPT:
    """Copy a JAX GPT parameter tree (numpy leaves) into ``model``."""
    model.load_state_dict(gpt_params_from_jax(tree, model.config),
                          strict=True)
    return model


_LORA_TARGETS = ("query", "key", "value", "out")


def lora_from_jax(tree: Mapping[str, Any], device="cpu"
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A port adapter (f32 tensors on ``device``) from a JAX adapter tree
    whose leaves are numpy arrays."""
    if set(tree) != set(_LORA_TARGETS):
        raise ValueError(f"adapter targets {sorted(tree)}, expected "
                         f"{sorted(_LORA_TARGETS)}")
    return {name: {ab: torch.from_numpy(np.array(tree[name][ab],
                                                 np.float32)).to(device)
                   for ab in ("a", "b")}
            for name in _LORA_TARGETS}


def lora_to_jax(adapter: Mapping[str, Mapping[str, torch.Tensor]]
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX adapter tree, numpy f32 leaves, of a port adapter; the
    inverse of ``lora_from_jax``."""
    return {name: {ab: adapter[name][ab].detach().to(
                       "cpu", torch.float32).numpy()
                   for ab in ("a", "b")}
            for name in _LORA_TARGETS}
