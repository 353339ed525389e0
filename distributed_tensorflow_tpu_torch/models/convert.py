"""Carry weights between the JAX package's parameter trees and the port.

The JAX tree (``distributed_tensorflow_tpu/models/gpt.py GPT.init``) is
``{"embeddings": {"word", "position"}, "decoder": {...}, "ln_f": {...}}``
with every ``decoder`` leaf stacked over layers (leading axis ``L``, the
``vmap`` layout).  A MoE block's leaves (``decoder.moe.router.kernel``
[L, D, E], ``decoder.moe.experts.w_in`` [L, E, D, F], ...) carry over
as ``blocks.<i>.moe.*`` like any other.  A Llama tree (``models/llama.py``) has no
``position``, ``beta`` or ``bias`` leaves, a ``w_gate`` in every FFN and
a top-level ``lm_head`` [vocab, d].  The caller hands it over as numpy
arrays (for example ``jax.tree.map(np.asarray, params)``); nothing here
imports JAX.
Weights stay float32, as in the JAX package.  ``gpt_params_to_jax`` goes
the other way, and since gradients and Adam moments are params-shaped
dicts under the same names, it carries them too.  ``lora_from_jax`` and
``lora_to_jax`` carry a LoRA adapter (``{target: {"a", "b"}}`` with
``[L, ...]`` leaves, the layout of both packages' ``init_lora``).

``stack_params_to_jax`` and ``stack_params_from_jax`` carry a layer
``Stack``'s parameters (``example.py``'s MLP): the port keeps them in one
flat dict under ``<layer>.<param>`` names (``"dense.kernel"``), each of
which is one leaf of the JAX tree's nested ``{"dense": {"kernel",
"bias"}, ...}``.

``bert_params_*``, ``vit_params_*`` and ``seq2seq_params_*`` carry the
functional encoders' flat parameter dicts (``models/bert.py``,
``vit.py``, ``seq2seq.py``): the JAX tree's paths dot-joined, with each
stacked stack (``encoder``, and the seq2seq ``decoder``) unstacked into
``<stack>.<i>.<path>``.  Leaves the model does not own (a fine-tune
head added beside them) carry over under their own paths.  A ``ResNet``,
like any ``Layer`` tree, goes through ``stack_params_from_jax`` /
``stack_params_to_jax`` (its parameters are the dot-joined paths of the
JAX tree, and nothing in it is stacked).

``train_state_to_jax`` and ``train_state_from_jax`` carry a whole training
state: the port's ``TrainState`` (its params, ``OptState(count, {m, v})``,
the ``with_ema`` shadow, ``LossScaled`` and the loss scale's fields) as the
JAX package's tree of the same NamedTuple fields, with every params-shaped
dict in the JAX layout (a GPT's, whose names include ``word``, or a
``Stack``'s otherwise) and every host value an array of the JAX state's
type (a count int32, the EMA decay float32, ...).  The checkpoint module
writes and reads through them, so either package restores the other's
checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..ops.layers import _flat, _nest
from .bert import Bert
from .gpt import GPT, GPTConfig
from .seq2seq import Seq2Seq
from .vit import ViT

__all__ = ["bert_params_from_jax", "bert_params_to_jax",
           "gpt_params_from_jax", "gpt_params_to_jax", "load_jax_params",
           "lora_from_jax", "lora_to_jax", "seq2seq_params_from_jax",
           "seq2seq_params_to_jax", "stack_params_from_jax",
           "stack_params_to_jax", "train_state_from_jax",
           "train_state_to_jax", "vit_params_from_jax", "vit_params_to_jax"]

def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def gpt_params_from_jax(tree: Dict[str, Any],
                        config: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's ``GPT`` state dict from a JAX GPT parameter tree whose
    leaves are numpy arrays."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in _unstacked(tree, config.num_layers).items()}


def _unstacked(tree: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """The port's names -> leaves (layer ``i`` of a stacked one for
    ``blocks.<i>.<path>``) of a JAX GPT parameter tree."""
    for key in tree:
        if key not in ("embeddings", "decoder", "ln_f", "lm_head"):
            raise ValueError(f"parameter {key!r} belongs to a GPT "
                             "configuration the port does not run yet")
    sd = dict(tree["embeddings"])                  # word (and position)
    sd.update((f"ln_f.{k}", v) for k, v in tree["ln_f"].items())
    if "lm_head" in tree:
        sd["lm_head"] = tree["lm_head"]
    for path, leaf in _flatten(tree["decoder"]):
        if leaf.shape[0] != num_layers:
            raise ValueError(f"decoder leaf {path} leads with "
                             f"{leaf.shape[0]}, not {num_layers} layers")
        for i in range(num_layers):
            sd[f"blocks.{i}.{path}"] = leaf[i]
    return sd


def gpt_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                      config: GPTConfig) -> Dict[str, Any]:
    """The JAX GPT parameter tree, numpy f32 leaves, from a port state dict
    (or any dict of tensors under the same names: gradients, moments).
    Layer ``i``'s ``blocks.<i>.<path>`` become row ``i`` of the stacked
    leaf ``decoder.<path>``.  The inverse of ``gpt_params_from_jax``."""
    return _stacked(state_dict, config.num_layers, config.tied_head,
                    lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    np.stack)


def _stacked(state_dict: Mapping[str, Any], num_layers: int, tied: bool,
             leaf: Callable, stack: Callable) -> Dict[str, Any]:
    """The JAX GPT tree of a dict under the port's names: ``leaf(x)`` of
    each entry, and ``stack([...])`` of a decoder leaf's layers."""
    tree: Dict[str, Any] = {"embeddings": {}, "ln_f": {}, "decoder": {}}
    layers: Dict[str, Dict[int, Any]] = {}
    for name, t in state_dict.items():
        head, _, rest = name.partition(".")
        if name in ("word", "position"):
            tree["embeddings"][name] = leaf(t)
        elif name == "lm_head" and not tied:
            tree["lm_head"] = leaf(t)
        elif head == "ln_f" and rest in ("gamma", "beta"):
            tree["ln_f"][rest] = leaf(t)
        elif head == "blocks":
            i, _, path = rest.partition(".")
            layers.setdefault(path, {})[int(i)] = leaf(t)
        else:
            raise ValueError(f"{name!r} is not a GPT parameter of the port")
    for path, rows in layers.items():
        if sorted(rows) != list(range(num_layers)):
            raise ValueError(f"decoder leaf {path} has layers {sorted(rows)}"
                             f", not 0..{num_layers - 1}")
        node = tree["decoder"]
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = stack([rows[i] for i in range(num_layers)])
    return tree


def stack_params_from_jax(tree: Mapping[str, Any], device="cpu"
                          ) -> Dict[str, torch.Tensor]:
    """A ``Stack``'s flat parameter dict (f32 leaf tensors on ``device``
    that require gradients) from the JAX package's nested tree of a
    ``Stack`` (numpy leaves)."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            .requires_grad_(True) for k, v in _flat(dict(tree), "").items()}


def stack_params_to_jax(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The JAX package's nested tree, numpy f32 leaves, of a ``Stack``'s
    flat parameter dict (or of its gradients or moments); the inverse of
    ``stack_params_from_jax``."""
    return _nest({k: t.detach().to("cpu", torch.float32).numpy()
                  for k, t in params.items()})


# -- the functional encoders (BERT, ViT, seq2seq) ---------------------------

def _layered_from_jax(tree: Mapping[str, Any], stacks: Mapping[str, int],
                      device) -> Dict[str, torch.Tensor]:
    """Flat f32 leaf tensors on ``device`` that require gradients, from a
    JAX tree (numpy leaves) whose top-level keys in ``stacks`` hold
    leaves stacked over that many layers."""
    flat = {}
    for path, leaf in _flat(dict(tree), "").items():
        head, _, rest = path.partition(".")
        leaf = np.asarray(leaf, np.float32)
        if head not in stacks:
            flat[path] = leaf
            continue
        if leaf.shape[0] != stacks[head]:
            raise ValueError(f"{path} leads with {leaf.shape[0]}, not "
                             f"{stacks[head]} layers")
        for i in range(stacks[head]):
            flat[f"{head}.{i}.{rest}"] = leaf[i]
    return {k: torch.from_numpy(np.array(v)).to(device).requires_grad_(True)
            for k, v in flat.items()}


def _layered_to_jax(params: Mapping[str, torch.Tensor],
                    stacks: Mapping[str, int]) -> Dict[str, Any]:
    """The JAX tree (numpy f32 leaves) of a flat dict under the port's
    names (parameters, gradients or moments): ``<stack>.<i>.<path>``
    stacked back into ``<stack>.<path>``."""
    flat, layers = {}, {}
    for name, t in params.items():
        leaf = t.detach().to("cpu", torch.float32).numpy()
        head, _, rest = name.partition(".")
        if head in stacks:
            i, _, path = rest.partition(".")
            layers.setdefault(f"{head}.{path}", {})[int(i)] = leaf
        else:
            flat[name] = leaf
    for path, rows in layers.items():
        n = stacks[path.partition(".")[0]]
        if sorted(rows) != list(range(n)):
            raise ValueError(f"{path} has layers {sorted(rows)}, not "
                             f"0..{n - 1}")
        flat[path] = np.stack([rows[i] for i in range(n)])
    return _nest(flat)


def bert_params_from_jax(tree: Mapping[str, Any], config,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """A ``Bert``'s parameters from the JAX ``Bert.init`` tree."""
    return _layered_from_jax(tree, Bert(config).stacks, device)


def bert_params_to_jax(params: Mapping[str, torch.Tensor],
                       config) -> Dict[str, Any]:
    """The JAX ``Bert`` tree of the port's parameters (or gradients)."""
    return _layered_to_jax(params, Bert(config).stacks)


def vit_params_from_jax(tree: Mapping[str, Any], config,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """A ``ViT``'s parameters from the JAX ``ViT.init`` tree."""
    return _layered_from_jax(tree, ViT(config).stacks, device)


def vit_params_to_jax(params: Mapping[str, torch.Tensor],
                      config) -> Dict[str, Any]:
    """The JAX ``ViT`` tree of the port's parameters (or gradients)."""
    return _layered_to_jax(params, ViT(config).stacks)


def seq2seq_params_from_jax(tree: Mapping[str, Any], config,
                            device="cpu") -> Dict[str, torch.Tensor]:
    """A ``Seq2Seq``'s parameters from the JAX ``Seq2Seq.init`` tree."""
    return _layered_from_jax(tree, Seq2Seq(config).stacks, device)


def seq2seq_params_to_jax(params: Mapping[str, torch.Tensor],
                          config) -> Dict[str, Any]:
    """The JAX ``Seq2Seq`` tree of the port's parameters (or
    gradients)."""
    return _layered_to_jax(params, Seq2Seq(config).stacks)


# -- whole training states -----------------------------------------------

def _is_gpt(names) -> bool:
    """A GPT's parameter names include its word embedding; a ``Stack``'s
    are ``<layer>.<param>``."""
    return "word" in names


def _layers(names) -> int:
    """The layer count of a GPT parameter dict, from its names."""
    return 1 + max((int(n.split(".")[1]) for n in names
                    if n.startswith("blocks.")), default=-1)


def _host_scalar(x) -> np.ndarray:
    """A host value as the JAX state holds it after a step: bool, int32,
    float32 (0-d arrays)."""
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x, np.bool_)
    if isinstance(x, (int, np.integer)):
        return np.asarray(x, np.int32)
    return np.asarray(x, np.float32)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_jax(x, names, num_layers: int, leaf: Callable, stack: Callable):
    if isinstance(x, dict):
        if names and set(x) == names:        # params-shaped: JAX layout
            if not _is_gpt(names):
                return _nest({k: leaf(v) for k, v in x.items()})
            return _stacked(x, num_layers, "lm_head" not in names, leaf,
                            stack)
        return {k: _to_jax(v, names, num_layers, leaf, stack)
                for k, v in x.items()}
    if _is_namedtuple(x):
        return type(x)(*(_to_jax(v, names, num_layers, leaf, stack)
                         for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(v, names, num_layers, leaf, stack)
                       for v in x)
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return leaf(x)
    return leaf(torch.from_numpy(_host_scalar(x)))


def train_state_to_jax(state: Any, leaf: Callable = None,
                       stack: Callable = None) -> Any:
    """The JAX package's tree of a port training state (or of any tree of
    NamedTuples, dicts, tuples, tensors and host values): the same
    NamedTuple types and fields, dicts under the params' names in the JAX
    GPT layout (stacked decoder leaves), host values as the JAX state's
    0-d arrays.  Leaves are numpy arrays (``leaf``/``stack`` replace the
    tensor -> array and layer-stacking steps: the checkpoint module keeps
    tensors, and builds a tree of shapes only)."""
    names = set(state.params) if hasattr(state, "params") else set()
    return _to_jax(state, names, _layers(names),
                   leaf or (lambda t: t.detach().cpu().numpy()),
                   stack or np.stack)


def _as_tensor(x) -> torch.Tensor:
    """A CPU tensor of an array leaf (numpy, or anything ``np.asarray``
    takes, a jax array among them); bfloat16 arrives through its bits."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _from_jax(src, dst, names, num_layers: int):
    if isinstance(dst, dict):
        if names and set(dst) == names:
            src = (_unstacked(src, num_layers) if _is_gpt(names)
                   else _flat(dict(src), ""))
        return {k: _from_jax(src[k], v, names, num_layers)
                for k, v in dst.items()}
    if _is_namedtuple(dst):
        return type(dst)(*(_from_jax(getattr(src, f), getattr(dst, f),
                                     names, num_layers)
                           for f in dst._fields))
    if isinstance(dst, (list, tuple)):
        return type(dst)(_from_jax(s, d, names, num_layers)
                         for s, d in zip(src, dst))
    if dst is None:
        return None
    if isinstance(dst, torch.Tensor):
        t = _as_tensor(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"leaf of shape {tuple(t.shape)} for a tensor "
                             f"of shape {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(t)
        return dst
    return type(dst)(np.asarray(src).item())


def train_state_from_jax(tree: Any, state: Any) -> Any:
    """Copy the JAX package's tree of a training state (numpy or jax
    arrays; any NamedTuple types with the port's field names) INTO the
    port's ``state``: every tensor is written in place (the model's
    parameters, the optimizer's moments and the EMA shadow keep their
    identity), and the returned state, of ``state``'s types, holds those
    same tensors and the tree's host values (step, counts, the loss
    scale's fields).  The inverse of ``train_state_to_jax``."""
    names = set(state.params) if hasattr(state, "params") else set()
    return _from_jax(tree, state, names, _layers(names))


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
