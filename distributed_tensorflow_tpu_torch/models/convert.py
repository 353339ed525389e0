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

The Hugging Face half (``gpt2_``, ``bert_``, ``vit_`` and ``llama_`` +
``config_from_hf``, ``params_from_hf`` and ``from_hf``) is the JAX
package's, mapped once: each ``*_params_from_hf`` builds the JAX
package's numpy tree from an HF state dict (the same keys, layouts and
refusals), and the ``*_params_from_jax`` above place it, so each model
keeps one layout mapping.  The HF layout facts: GPT-2's ``Conv1D``
weights are [in, out] (no transpose) and ``attn.c_attn`` fuses q|k|v on
the output dim; BERT, ViT and Llama are ``nn.Linear`` [out, in]
(transposed); Llama's o_proj is reshaped head-major; ``lm_head.weight``
is GPT-2's word embedding (tied) and Llama's own head only when untied;
a ViT patch projection [out, in, kh, kw] becomes HWIO for NHWC images.
``*_from_hf(hf_model, device=..., dtype=...)`` reads only
``hf_model.config`` and ``hf_model.state_dict()`` (duck typing: nothing
here imports ``transformers``), or takes the ``(config, state_dict)``
pair that ``load_hf_dir(path)`` reads from a local checkpoint directory
(``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``)
without it.

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

import copy
import dataclasses
import json
import os
import types
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.layers import _flat, _nest
from ..parallel import tensor_parallel
from ..parallel.sharding import cut_blocks, shard_pytree
from .bert import Bert, BertConfig
from .gpt import GPT, GPTConfig, gpt_partition_rules
from .seq2seq import Seq2Seq
from .vit import ViT, ViTConfig

__all__ = ["bert_config_from_hf", "bert_from_hf", "bert_params_from_hf",
           "bert_params_from_jax", "bert_params_to_jax",
           "gpt2_config_from_hf", "gpt2_from_hf", "gpt2_params_from_hf",
           "gpt_params_from_jax", "gpt_params_to_jax", "llama_config_from_hf",
           "llama_from_hf", "llama_params_from_hf", "load_hf_dir",
           "load_jax_params", "lora_from_jax", "lora_to_jax",
           "seq2seq_params_from_jax", "seq2seq_params_to_jax",
           "stack_params_from_jax", "stack_params_to_jax",
           "train_state_from_jax", "train_state_to_jax",
           "vit_config_from_hf", "vit_from_hf", "vit_params_from_hf",
           "vit_params_from_jax", "vit_params_to_jax"]


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def gpt_params_from_jax(tree: Dict[str, Any], config: GPTConfig,
                        mesh=None, shard_kv: Optional[bool] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``GPT`` state dict from a JAX GPT parameter tree whose
    leaves are numpy arrays.  ``mesh``: this rank's blocks of every leaf
    under ``gpt_partition_rules(config, shard_kv=shard_kv)`` (``parallel.
    shard_pytree``), and with ``pipeline_stages`` only this rank's
    stage's layers: the state dict of ``GPT(config, mesh=mesh,
    shard_kv=shard_kv)``."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in _unstacked(tree, config.num_layers).items()}
    if mesh is None:
        return sd
    return shard_pytree(sd, mesh, gpt_partition_rules(config,
                                                      shard_kv=shard_kv))


def _layer_list(layers) -> list:
    """Layer indices: ``range(layers)`` of a count, else the sequence."""
    return list(range(layers)) if isinstance(layers, int) else list(layers)


def _unstacked(tree: Dict[str, Any], layers) -> Dict[str, Any]:
    """The port's names -> leaves of a JAX GPT parameter tree: row ``j``
    of a stacked leaf is ``blocks.<layers[j]>.<path>`` (``layers`` a
    count: every layer; a pipeline stage's indices: its rows)."""
    layers = _layer_list(layers)
    for key in tree:
        if key not in ("embeddings", "decoder", "ln_f", "lm_head"):
            raise ValueError(f"parameter {key!r} belongs to a GPT "
                             "configuration the port does not run yet")
    sd = dict(tree["embeddings"])                  # word (and position)
    sd.update((f"ln_f.{k}", v) for k, v in tree["ln_f"].items())
    if "lm_head" in tree:
        sd["lm_head"] = tree["lm_head"]
    for path, leaf in _flatten(tree["decoder"]):
        if leaf.shape[0] != len(layers):
            raise ValueError(f"decoder leaf {path} leads with "
                             f"{leaf.shape[0]}, not {len(layers)} layers")
        for j, i in enumerate(layers):
            sd[f"blocks.{i}.{path}"] = leaf[j]
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


def _stacked(state_dict: Mapping[str, Any], layers, tied: bool,
             leaf: Callable, stack: Callable) -> Dict[str, Any]:
    """The JAX GPT tree of a dict under the port's names: ``leaf(x)`` of
    each entry, and ``stack([...])`` of a decoder leaf's layers, which
    must be ``layers`` (a count: all of them; a pipeline stage's
    indices)."""
    layers = _layer_list(layers)
    tree: Dict[str, Any] = {"embeddings": {}, "ln_f": {}, "decoder": {}}
    by_path: Dict[str, Dict[int, Any]] = {}
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
            by_path.setdefault(path, {})[int(i)] = leaf(t)
        else:
            raise ValueError(f"{name!r} is not a GPT parameter of the port")
    for path, rows in by_path.items():
        if sorted(rows) != layers:
            raise ValueError(f"decoder leaf {path} has layers {sorted(rows)}"
                             f", not {layers[0]}..{layers[-1]}")
        node = tree["decoder"]
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = stack([rows[i] for i in layers])
    return tree


def stack_params_from_jax(tree: Mapping[str, Any], device="cpu",
                          rules=None, mesh=None
                          ) -> Dict[str, torch.Tensor]:
    """A ``Stack``'s flat parameter dict (f32 leaf tensors on ``device``
    that require gradients) from the JAX package's nested tree of a
    ``Stack`` (numpy leaves).  ``mesh`` with a ``tensor`` axis: this
    rank's blocks (marked) under ``rules`` (``ResNet.partition_rules()``),
    the parameters of ``ResNet(..., mesh=mesh)``."""
    params = {k: torch.from_numpy(np.array(v, np.float32)).to(device)
              .requires_grad_(True)
              for k, v in _flat(dict(tree), "").items()}
    if tensor_parallel.size(mesh) == 1:
        return params
    return cut_blocks(params, rules, mesh)


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
                         device="cpu", mesh=None
                         ) -> Dict[str, torch.Tensor]:
    """A ``Bert``'s parameters from the JAX ``Bert.init`` tree; ``mesh``
    with a ``tensor`` axis: this rank's blocks (marked), the parameters
    of ``Bert(config, mesh=mesh)`` (beside a ``seq`` axis too: a
    ``seq_axis`` config's weights are the same)."""
    params = _layered_from_jax(tree, _bert_stacks(config), device)
    if tensor_parallel.size(mesh) == 1:
        return params
    return cut_blocks(params, Bert(config, mesh).partition_rules(), mesh)


def _bert_stacks(config) -> Dict[str, int]:
    """``Bert.stacks`` of ``config``, whatever its ``seq_axis``."""
    return Bert(dataclasses.replace(config, seq_axis=None)).stacks


def bert_params_to_jax(params: Mapping[str, torch.Tensor],
                       config) -> Dict[str, Any]:
    """The JAX ``Bert`` tree of the port's parameters (or gradients)."""
    return _layered_to_jax(params, _bert_stacks(config))


def vit_params_from_jax(tree: Mapping[str, Any], config,
                        device="cpu", mesh=None
                        ) -> Dict[str, torch.Tensor]:
    """A ``ViT``'s parameters from the JAX ``ViT.init`` tree; ``mesh``
    with a ``tensor`` axis: this rank's blocks (marked), the parameters
    of ``ViT(config, mesh=mesh)``."""
    params = _layered_from_jax(tree, ViT(config).stacks, device)
    if tensor_parallel.size(mesh) == 1:
        return params
    return cut_blocks(params, ViT(config, mesh).partition_rules(), mesh)


def vit_params_to_jax(params: Mapping[str, torch.Tensor],
                      config) -> Dict[str, Any]:
    """The JAX ``ViT`` tree of the port's parameters (or gradients)."""
    return _layered_to_jax(params, ViT(config).stacks)


def seq2seq_params_from_jax(tree: Mapping[str, Any], config,
                            device="cpu", mesh=None
                            ) -> Dict[str, torch.Tensor]:
    """A ``Seq2Seq``'s parameters from the JAX ``Seq2Seq.init`` tree;
    ``mesh`` with a ``tensor`` axis: this rank's blocks (marked), the
    parameters of ``Seq2Seq(config, mesh=mesh)``."""
    params = _layered_from_jax(tree, Seq2Seq(config).stacks, device)
    if tensor_parallel.size(mesh) == 1:
        return params
    return cut_blocks(params, Seq2Seq(config, mesh).partition_rules(), mesh)


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


def _layers(names) -> list:
    """The layer indices of a GPT parameter dict, from its names (all of
    them, or a pipeline stage's)."""
    return sorted({int(n.split(".")[1]) for n in names
                   if n.startswith("blocks.")})


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


def _to_jax(x, names, layers, leaf: Callable, stack: Callable):
    if isinstance(x, dict):
        if names and set(x) == names:        # params-shaped: JAX layout
            if not _is_gpt(names):
                return _nest({k: leaf(v) for k, v in x.items()})
            return _stacked(x, layers, "lm_head" not in names, leaf, stack)
        return {k: _to_jax(v, names, layers, leaf, stack)
                for k, v in x.items()}
    if _is_namedtuple(x):
        return type(x)(*(_to_jax(v, names, layers, leaf, stack)
                         for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(v, names, layers, leaf, stack) for v in x)
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


def _from_jax(src, dst, names, layers):
    if isinstance(dst, dict):
        if names and set(dst) == names:
            src = (_unstacked(src, layers) if _is_gpt(names)
                   else _flat(dict(src), ""))
        out = {k: _from_jax(src[k], v, names, layers)
               for k, v in dst.items()}
        if type(dst) is dict:
            return out
        kept = copy.copy(dst)       # a dict subclass keeps its attributes
        kept.update(out)            # (a ZeRO layout's ``ShardedDict``)
        return kept
    if _is_namedtuple(dst):
        return type(dst)(*(_from_jax(getattr(src, f), getattr(dst, f),
                                     names, layers)
                           for f in dst._fields))
    if isinstance(dst, (list, tuple)):
        return type(dst)(_from_jax(s, d, names, layers)
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
    """Copy a JAX GPT parameter tree (numpy leaves) into ``model`` (its
    blocks of it under tensor or expert parallelism, its stage's layers
    under pipeline parallelism)."""
    cut = (model.config.pipeline_stages > 1
           or tensor_parallel.active(model.mesh) is not None
           or tensor_parallel.active(model.mesh, "expert") is not None)
    mesh = model.mesh if cut else None
    model.load_state_dict(gpt_params_from_jax(
        tree, model.config, mesh=mesh,
        shard_kv=(model._kv_on_tensor()
                  if tensor_parallel.active(mesh) is not None else None)),
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


# -- Hugging Face checkpoints ---------------------------------------------

def _np(t) -> np.ndarray:
    """A state-dict entry (a tensor of any float type, bf16 included, or
    an array) as f32 numpy on the host; a view when it already is one,
    which the ``*_params_from_jax`` placers copy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _ln_of(sd, prefix):
    """HF LayerNorm {weight, bias} -> the JAX tree's {gamma, beta}."""
    return {"gamma": _np(sd[f"{prefix}.weight"]),
            "beta": _np(sd[f"{prefix}.bias"])}


def _stack_layers(layers):
    """Per-layer trees -> one tree with a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in layers]) for k in first}
    return np.stack(layers)


def _hf_parts(hf_model) -> Tuple[Any, Mapping[str, Any]]:
    """(config, state dict) of an HF model (its ``config`` and
    ``state_dict()``) or of ``load_hf_dir``'s pair."""
    if isinstance(hf_model, tuple):
        return hf_model
    return hf_model.config, hf_model.state_dict()


def gpt2_config_from_hf(hf_config, dtype: torch.dtype = torch.float32
                        ) -> GPTConfig:
    """A ``transformers.GPT2Config`` (or anything with its attribute
    names) as a ``GPTConfig`` computing in ``dtype``."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(
            f"GPT-2 activation {act!r} unsupported: this zoo's FFN is "
            "tanh-approximate GELU (gelu_new), the GPT-2 default")
    if not getattr(hf_config, "scale_attn_weights", True):
        raise ValueError("scale_attn_weights=False is unsupported")
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx is unsupported: "
                         "this attention never divides logits by the "
                         "layer index")
    if getattr(hf_config, "reorder_and_upcast_attn", False):
        raise ValueError("reorder_and_upcast_attn is unsupported")
    return GPTConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        intermediate_size=(hf_config.n_inner or 4 * hf_config.n_embd),
        max_position=hf_config.n_positions,
        dropout_rate=float(hf_config.resid_pdrop),
        layer_norm_eps=float(hf_config.layer_norm_epsilon),
        position_embedding="learned",
        dtype=dtype,
    )


def gpt2_params_from_hf(state_dict: Mapping[str, Any],
                        config: GPTConfig) -> Dict[str, Any]:
    """The JAX package's GPT tree (numpy f32, decoder stacked) of a GPT-2
    state dict (GPT2Model or GPT2LMHeadModel)."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    d, h, hd = config.hidden_size, config.num_heads, config.head_dim

    def layer(i):
        qw, kw, vw = np.split(_np(sd[f"h.{i}.attn.c_attn.weight"]), 3,
                              axis=1)                 # [d, 3d], in-out
        qb, kb, vb = np.split(_np(sd[f"h.{i}.attn.c_attn.bias"]), 3)

        def qkv(w, b):
            return {"kernel": w.reshape(d, h, hd), "bias": b.reshape(h, hd)}

        def conv1d(prefix):
            return {"kernel": _np(sd[f"{prefix}.weight"]),
                    "bias": _np(sd[f"{prefix}.bias"])}
        return {
            "ln_1": _ln_of(sd, f"h.{i}.ln_1"),
            "attention": {
                "query": qkv(qw, qb), "key": qkv(kw, kb),
                "value": qkv(vw, vb),
                "out": {"kernel": _np(sd[f"h.{i}.attn.c_proj.weight"]
                                      ).reshape(h, hd, d),
                        "bias": _np(sd[f"h.{i}.attn.c_proj.bias"])},
            },
            "ln_2": _ln_of(sd, f"h.{i}.ln_2"),
            "ffn": {"w_in": conv1d(f"h.{i}.mlp.c_fc"),
                    "w_out": conv1d(f"h.{i}.mlp.c_proj")},
        }

    return {
        "embeddings": {"word": _np(sd["wte.weight"]),
                       "position": _np(sd["wpe.weight"])},
        "decoder": _stack_layers([layer(i)
                                  for i in range(config.num_layers)]),
        "ln_f": _ln_of(sd, "ln_f"),
    }


def _gpt_from_tree(config: GPTConfig, tree, device):
    """A ``GPT`` on ``device`` holding the JAX tree's weights, and its
    own parameters (the dict ``lm_loss_fn`` and the train step take)."""
    model = GPT(config, device=device)
    load_jax_params(model, tree)
    return model, dict(model.named_parameters())


def gpt2_from_hf(hf_model, device="cuda", dtype: torch.dtype = torch.float32
                 ) -> Tuple[GPT, Dict[str, torch.Tensor]]:
    """(GPT, params) from a GPT-2 model (``config`` and ``state_dict()``;
    a ``transformers`` GPT2Model / GPT2LMHeadModel, or a checkpoint
    ``load_hf_dir`` read): every path the port's GPT offers (training,
    ``generate``, the engines) with the checkpoint's logits."""
    hf_config, sd = _hf_parts(hf_model)
    config = gpt2_config_from_hf(hf_config, dtype)
    return _gpt_from_tree(config, gpt2_params_from_hf(sd, config), device)


def bert_config_from_hf(hf_config, dtype: torch.dtype = torch.float32
                        ) -> BertConfig:
    """A ``transformers.BertConfig`` as a ``BertConfig``; HF BERT's exact
    (erf) GELU is ``hidden_act="gelu"``."""
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "relu"):
        raise ValueError(f"BERT hidden_act {act!r} unsupported")
    pos = getattr(hf_config, "position_embedding_type", "absolute")
    if pos != "absolute":
        raise ValueError(
            f"position_embedding_type {pos!r} unsupported: this Bert "
            "implements absolute positions only — a relative-position "
            "checkpoint would convert silently wrong")
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        dropout_rate=float(hf_config.hidden_dropout_prob),
        layer_norm_eps=float(hf_config.layer_norm_eps),
        hidden_act=act,
        dtype=dtype,
    )


def _linear_t(sd, prefix):
    """``nn.Linear`` [out, in] -> (kernel [in, out], bias)."""
    return _np(sd[f"{prefix}.weight"]).T, _np(sd[f"{prefix}.bias"])


def _encoder_layer(sd, base, attn, ln_attn, ln_ffn, d, h, hd):
    """One BERT-style layer (``nn.Linear`` projections) of the JAX tree;
    ``attn`` is the q/k/v modules' prefix under ``base``."""
    def qkv(name):
        w, b = _linear_t(sd, f"{base}.{attn}.{name}")
        return {"kernel": w.reshape(d, h, hd), "bias": b.reshape(h, hd)}

    def dense(prefix):
        w, b = _linear_t(sd, f"{base}.{prefix}")
        return {"kernel": w, "bias": b}
    ow, ob = _linear_t(sd, f"{base}.attention.output.dense")
    return {
        "attention": {"query": qkv("query"), "key": qkv("key"),
                      "value": qkv("value"),
                      "out": {"kernel": ow.reshape(h, hd, d), "bias": ob},
                      "ln": _ln_of(sd, f"{base}.{ln_attn}")},
        "ffn": {"w_in": dense("intermediate.dense"),
                "w_out": dense("output.dense"),
                "ln": _ln_of(sd, f"{base}.{ln_ffn}")},
    }


def bert_params_from_hf(state_dict: Mapping[str, Any],
                        config: BertConfig) -> Dict[str, Any]:
    """The JAX package's BERT tree of a BertModel / BertForMaskedLM state
    dict: the pooler and the MLM head (transform, LayerNorm, output bias;
    the decoder is the tied word embedding) when present, absent
    otherwise."""
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    d, h, hd = config.hidden_size, config.num_heads, config.head_dim
    params: Dict[str, Any] = {
        "embeddings": {
            "word": _np(sd["embeddings.word_embeddings.weight"]),
            "position": _np(sd["embeddings.position_embeddings.weight"]),
            "type": _np(sd["embeddings.token_type_embeddings.weight"]),
            "ln": _ln_of(sd, "embeddings.LayerNorm"),
        },
        "encoder": _stack_layers([
            _encoder_layer(sd, f"encoder.layer.{i}", "attention.self",
                           "attention.output.LayerNorm", "output.LayerNorm",
                           d, h, hd)
            for i in range(config.num_layers)]),
    }
    if "pooler.dense.weight" in sd:
        pw, pb = _linear_t(sd, "pooler.dense")
        params["pooler"] = {"kernel": pw, "bias": pb}
    if "cls.predictions.transform.dense.weight" in state_dict:
        tw, tb = _linear_t(state_dict, "cls.predictions.transform.dense")
        params["mlm"] = {
            "transform": {"kernel": tw, "bias": tb},
            "ln": _ln_of(state_dict, "cls.predictions.transform.LayerNorm"),
            "output_bias": _np(state_dict["cls.predictions.bias"]),
        }
    return params


def bert_from_hf(hf_model, device="cuda", dtype: torch.dtype = torch.float32
                 ) -> Tuple[Bert, Dict[str, torch.Tensor]]:
    """(Bert, params on ``device``) from a BertModel / BertForMaskedLM:
    sequence output, pooler and MLM logits as the checkpoint's."""
    hf_config, sd = _hf_parts(hf_model)
    config = bert_config_from_hf(hf_config, dtype)
    return Bert(config), bert_params_from_jax(
        bert_params_from_hf(sd, config), config, device)


def vit_config_from_hf(hf_config, num_classes: int,
                       dtype: torch.dtype = torch.float32) -> ViTConfig:
    """A ``transformers.ViTConfig`` as a ``ViTConfig`` with
    ``num_classes`` outputs."""
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_approx"):
        raise ValueError(f"ViT hidden_act {act!r} unsupported")
    if not getattr(hf_config, "qkv_bias", True):
        raise ValueError("qkv_bias=False is unsupported: this zoo's "
                         "attention projections always carry biases")
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        channels=hf_config.num_channels,
        num_classes=num_classes,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        dropout_rate=float(hf_config.hidden_dropout_prob),
        layer_norm_eps=float(hf_config.layer_norm_eps),
        hidden_act=act,
        dtype=dtype,
    )


def vit_params_from_hf(state_dict: Mapping[str, Any],
                       config: ViTConfig) -> Dict[str, Any]:
    """The JAX package's ViT tree of a ViTModel /
    ViTForImageClassification state dict: the patch projection in HWIO
    for NHWC images, pre-LN layers (``layernorm_before``/``after``), and
    the ``classifier`` as the head when present, else a zero head (then
    ``apply(return_features=True)`` is what matches)."""
    sd = {k.removeprefix("vit."): v for k, v in state_dict.items()}
    d, h, hd = config.hidden_size, config.num_heads, config.head_dim
    proj = _np(sd["embeddings.patch_embeddings.projection.weight"])
    params: Dict[str, Any] = {
        "patch_embed": {
            # torch conv [out, in, kh, kw] -> HWIO [kh, kw, in, out]
            "kernel": np.ascontiguousarray(proj.transpose(2, 3, 1, 0)),
            "bias": _np(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "cls_token": _np(sd["embeddings.cls_token"]),
        "pos_embed": _np(sd["embeddings.position_embeddings"]),
        "encoder": _stack_layers([
            _encoder_layer(sd, f"encoder.layer.{i}", "attention.attention",
                           "layernorm_before", "layernorm_after", d, h, hd)
            for i in range(config.num_layers)]),
        "final_ln": _ln_of(sd, "layernorm"),
    }
    if "classifier.weight" in state_dict:
        cw, cb = _linear_t(state_dict, "classifier")
        params["head"] = {"kernel": cw, "bias": cb}
    else:
        params["head"] = {
            "kernel": np.zeros((d, config.num_classes), np.float32),
            "bias": np.zeros((config.num_classes,), np.float32)}
    return params


def vit_from_hf(hf_model, device="cuda", dtype: torch.dtype = torch.float32
                ) -> Tuple[ViT, Dict[str, torch.Tensor]]:
    """(ViT, params on ``device``) from a ViTModel /
    ViTForImageClassification.  Features (and, with a classifier,
    logits) are the checkpoint's; images are NHWC here, NCHW in torch."""
    hf_config, sd = _hf_parts(hf_model)
    n_classes = getattr(hf_config, "num_labels", 0)
    if "classifier.weight" not in sd:
        n_classes = max(int(n_classes or 0), 1)
    config = vit_config_from_hf(hf_config, n_classes, dtype)
    return ViT(config), vit_params_from_jax(
        vit_params_from_hf(sd, config), config, device)


def llama_config_from_hf(hf_config, dtype: torch.dtype = torch.float32
                         ) -> GPTConfig:
    """A ``transformers.LlamaConfig`` as the Llama recipe of
    ``GPTConfig`` (``models/llama.py``)."""
    from .llama import llama_config
    act = getattr(hf_config, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ValueError(f"Llama hidden_act {act!r} unsupported: the "
                         "swiglu FFN gate is silu")
    if getattr(hf_config, "attention_bias", False) or \
            getattr(hf_config, "mlp_bias", False):
        raise ValueError("attention_bias/mlp_bias checkpoints are "
                         "unsupported: the Llama recipe is bias-free")
    scaling = getattr(hf_config, "rope_scaling", None)
    if scaling:
        raise ValueError(f"rope_scaling {scaling!r} unsupported: plain "
                         "rotate-half RoPE only")
    head_dim = getattr(hf_config, "head_dim", None)
    derived = hf_config.hidden_size // hf_config.num_attention_heads
    if head_dim is not None and head_dim != derived:
        raise ValueError(
            f"explicit head_dim {head_dim} != hidden_size//num_heads "
            f"{derived} unsupported: GPTConfig derives head_dim")
    return llama_config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None),
        intermediate_size=hf_config.intermediate_size,
        max_position=hf_config.max_position_embeddings,
        layer_norm_eps=hf_config.rms_norm_eps,
        rope_base=getattr(hf_config, "rope_theta", 10000.0),
        tied_head=bool(getattr(hf_config, "tie_word_embeddings", False)),
        dtype=dtype,
    )


def llama_params_from_hf(state_dict: Mapping[str, Any],
                         config: GPTConfig) -> Dict[str, Any]:
    """The JAX package's Llama tree of a LlamaModel / LlamaForCausalLM
    state dict: ``nn.Linear`` kernels transposed to [in, ...out], q/k/v
    head-major, o_proj [h, hd, d], and ``lm_head`` [vocab, d] only when
    the head is untied (HF checkpoints already use rotate-half RoPE)."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    d, h = config.hidden_size, config.num_heads
    hd, kv = config.head_dim, config.kv_heads

    def rms(prefix):
        return {"gamma": _np(sd[f"{prefix}.weight"])}

    def lin_t(prefix, shape):
        return {"kernel": np.ascontiguousarray(
            _np(sd[f"{prefix}.weight"]).T.reshape(shape))}

    def layer(i):
        p = f"layers.{i}"
        return {
            "ln_1": rms(f"{p}.input_layernorm"),
            "attention": {
                "query": lin_t(f"{p}.self_attn.q_proj", (d, h, hd)),
                "key": lin_t(f"{p}.self_attn.k_proj", (d, kv, hd)),
                "value": lin_t(f"{p}.self_attn.v_proj", (d, kv, hd)),
                "out": lin_t(f"{p}.self_attn.o_proj", (h, hd, d)),
            },
            "ln_2": rms(f"{p}.post_attention_layernorm"),
            "ffn": {"w_in": lin_t(f"{p}.mlp.up_proj", (d, -1)),
                    "w_gate": lin_t(f"{p}.mlp.gate_proj", (d, -1)),
                    "w_out": lin_t(f"{p}.mlp.down_proj", (-1, d))},
        }

    params = {
        "embeddings": {"word": _np(sd["embed_tokens.weight"])},
        "decoder": _stack_layers([layer(i)
                                  for i in range(config.num_layers)]),
        "ln_f": rms("norm"),
    }
    if not config.tied_head:
        head = state_dict.get("lm_head.weight")
        if head is None:
            raise ValueError(
                "state_dict has no lm_head.weight (a bare LlamaModel?) — "
                "convert from LlamaForCausalLM, or set tied_head=True")
        params["lm_head"] = _np(head)
    return params


def llama_from_hf(hf_model, device="cuda", dtype: torch.dtype = torch.float32
                  ) -> Tuple[GPT, Dict[str, torch.Tensor]]:
    """(GPT, params) from a LlamaModel / LlamaForCausalLM: the port's
    whole decoder surface (GQA cache, ``generate``, the engines,
    training) with the checkpoint's logits."""
    hf_config, sd = _hf_parts(hf_model)
    config = llama_config_from_hf(hf_config, dtype)
    return _gpt_from_tree(config, llama_params_from_hf(sd, config), device)


# -- local checkpoint directories ------------------------------------------

# HF's defaults for the config keys the converters read, by model type
_HF_DEFAULTS = {
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12, n_inner=None, activation_function="gelu_new",
                 resid_pdrop=0.1, layer_norm_epsilon=1e-5,
                 scale_attn_weights=True,
                 scale_attn_by_inverse_layer_idx=False,
                 reorder_and_upcast_attn=False, tie_word_embeddings=True),
    "bert": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, position_embedding_type="absolute",
                 tie_word_embeddings=True),
    "vit": dict(hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                hidden_act="gelu", hidden_dropout_prob=0.0,
                layer_norm_eps=1e-12, image_size=224, patch_size=16,
                num_channels=3, qkv_bias=True, tie_word_embeddings=True),
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, hidden_act="silu",
                  max_position_embeddings=2048, rms_norm_eps=1e-6,
                  tie_word_embeddings=False, rope_theta=10000.0,
                  rope_scaling=None, attention_bias=False, mlp_bias=False,
                  head_dim=None),
}

# safetensors dtype names -> (numpy dtype of the raw bytes, torch dtype)
_ST_DTYPES = {"F32": (np.float32, torch.float32),
              "F16": (np.float16, torch.float16),
              "BF16": (np.int16, torch.bfloat16)}


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then
    the raw little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(n)))
        data = np.frombuffer(f.read(), np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"read: {sorted(_ST_DTYPES)}")
        raw, dtype = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        arr = data[lo:hi].view(np.dtype(raw).newbyteorder("<"))
        t = torch.from_numpy(arr.astype(raw).reshape(info["shape"]))
        out[name] = t.view(dtype)
    return out


def load_hf_dir(path: str) -> Tuple[types.SimpleNamespace,
                                    Dict[str, torch.Tensor]]:
    """``(config, state_dict)`` of a local Hugging Face checkpoint
    directory, without ``transformers``: ``config.json`` as a namespace
    under HF's attribute names (HF's defaults filled in for the keys the
    converters read, by ``model_type``; ``num_labels`` from
    ``id2label``), and the weights of ``model.safetensors`` (f32, f16,
    bf16) or else ``pytorch_model.bin`` (``torch.load(weights_only=
    True)``) as CPU tensors in their stored dtype.  The ``*_from_hf``
    converters take the pair as they take an HF model."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        raw = json.load(f)
    fields = dict(_HF_DEFAULTS.get(raw.get("model_type"), {}))
    fields.update(raw)
    if "id2label" in raw:
        fields["num_labels"] = len(raw["id2label"])
    fields.setdefault("num_labels", 2)
    config = types.SimpleNamespace(**fields)
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        sd = _read_safetensors(st)
    else:
        sd = torch.load(os.path.join(path, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    return config, sd
