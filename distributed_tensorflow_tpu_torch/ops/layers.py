"""The layer library's XOR tier, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/layers.py`` for the layers
``example.py`` builds: ``Layer``, ``layer_spec``, ``Dense``, ``Dropout``,
``Flatten``, ``Activation``, ``Stack`` and ``serial``.  The others (the
convolutions and pools, ``BatchNorm``, ``LayerNorm``, ``Embedding``,
``LSTM``, ``GRU``) are not ported yet.

Conventions, as in the JAX package:

* A ``Layer`` is a small config object; tensors live outside it.
  ``init(generator, in_shape) -> (params, state)`` with ``in_shape`` the
  per-example feature shape, and ``apply(params, state, x, *, train=False,
  rng=None) -> (y, new_state)``.  ``rng`` is a ``torch.Generator`` on
  ``x``'s device (the JAX package passes a PRNG key); initializers draw
  from the generator given to ``init``, on its device.
* ``Stack`` names its layers "dense", "dense_1", ... and keeps their
  parameters in ONE flat dict under ``<layer>.<param>`` names
  (``"dense.kernel"``, ``"dense.bias"``, ``"dense_1.kernel"``, ...), the
  form the port's optimizers and ``TrainState`` take.  Each name is one
  leaf of the JAX package's nested ``{"dense": {"kernel", "bias"}, ...}``
  tree (``models.convert.stack_params_to_jax``).  ``Stack.init`` returns
  them as leaf tensors that require gradients.
* ``Dense`` stores its kernel ``[in, out]``; parameters are cast to the
  input's dtype at apply time.
* ``get_config`` returns the same JSON-able constructor arguments.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import activations as act_lib
from . import initializers as init_lib

__all__ = ["Layer", "layer_spec", "Dense", "Dropout", "Flatten",
           "Activation", "serial", "Stack"]

Params = Dict[str, Any]
State = Dict[str, Any]
Shape = Tuple[int, ...]


def _by_name(value, what: str, layer: "Layer"):
    """Serialization guard: config entries must be registry names, not
    callables (a callable can't round-trip through JSON)."""
    if value is None or isinstance(value, str):
        return value
    raise ValueError(
        f"{type(layer).__name__} {layer.name!r} was constructed with a "
        f"callable {what}; pass it by registry name to serialize the model")


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _dtype_name(dtype) -> str:
    return str(_dtype(dtype)).replace("torch.", "")


def layer_spec(layer: "Layer") -> Dict[str, Any]:
    """The {class_name, config} serialization spec of a layer."""
    return {"class_name": type(layer).__name__, "config": layer.get_config()}


class Layer:
    """Base layer: stateless identity."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__.lower()

    def get_config(self) -> Dict[str, Any]:
        """JSON-able constructor kwargs; ``type(self)(**config)`` rebuilds
        the layer."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement get_config; the "
            "model can't be serialized with this layer")

    def init(self, generator, in_shape: Shape) -> Tuple[Params, State]:
        del generator, in_shape
        return {}, {}

    def out_shape(self, in_shape: Shape) -> Shape:
        return tuple(in_shape)

    def apply(self, params: Params, state: State, x, *, train: bool = False,
              rng=None):
        del params, train, rng
        return x, state

    def __repr__(self):
        return f"{type(self).__name__}()"


class Dense(Layer):
    """y = act(x @ W + b), the kernel ``[in, out]``; glorot_uniform / zeros
    by default."""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_init="glorot_uniform", bias_init="zeros",
                 param_dtype=torch.float32, name: Optional[str] = None):
        super().__init__(name)
        self.units = int(units)
        self.activation = act_lib.get(activation)
        self.use_bias = use_bias
        self.kernel_init = init_lib.get(kernel_init)
        self.bias_init = init_lib.get(bias_init)
        self.param_dtype = _dtype(param_dtype)
        self._raw = dict(activation=activation, kernel_init=kernel_init,
                         bias_init=bias_init)

    def get_config(self):
        return dict(units=self.units,
                    activation=_by_name(self._raw["activation"],
                                        "activation", self),
                    use_bias=self.use_bias,
                    kernel_init=_by_name(self._raw["kernel_init"],
                                         "kernel_init", self),
                    bias_init=_by_name(self._raw["bias_init"],
                                       "bias_init", self),
                    param_dtype=_dtype_name(self.param_dtype),
                    name=self.name)

    def init(self, generator, in_shape):
        params = {"kernel": self.kernel_init(
            generator, (in_shape[-1], self.units), self.param_dtype)}
        if self.use_bias:
            params["bias"] = self.bias_init(generator, (self.units,),
                                            self.param_dtype)
        return params, {}

    def out_shape(self, in_shape):
        return tuple(in_shape[:-1]) + (self.units,)

    def apply(self, params, state, x, *, train=False, rng=None):
        bias = params["bias"].to(x.dtype) if self.use_bias else None
        y = F.linear(x, params["kernel"].to(x.dtype).t(), bias)
        return self.activation(y), state

    def __repr__(self):
        return f"Dense({self.units})"


class Dropout(Layer):
    """Inverted dropout, active only when ``train``; the mask is drawn
    from the generator ``rng`` (required then).  In eval mode, and at rate
    0, the identity."""

    def __init__(self, rate: float, name: Optional[str] = None):
        super().__init__(name)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = float(rate)

    def get_config(self):
        return dict(rate=self.rate, name=self.name)

    def apply(self, params, state, x, *, train=False, rng=None):
        if not train or self.rate == 0.0:
            return x, state
        if rng is None:
            raise ValueError("Dropout.apply(train=True) requires a "
                             "generator (rng)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0), state

    def __repr__(self):
        return f"Dropout({self.rate})"


class Flatten(Layer):
    def get_config(self):
        return dict(name=self.name)

    def out_shape(self, in_shape):
        return (math.prod(in_shape),)

    def apply(self, params, state, x, *, train=False, rng=None):
        return x.reshape(x.shape[0], -1), state


class Activation(Layer):
    def __init__(self, fn, name: Optional[str] = None):
        super().__init__(name)
        self.fn = act_lib.get(fn)
        self._raw_fn = fn

    def get_config(self):
        return dict(fn=_by_name(self._raw_fn, "fn", self), name=self.name)

    def apply(self, params, state, x, *, train=False, rng=None):
        return self.fn(x), state


def _flat(tree: Params, prefix: str) -> Dict[str, Any]:
    """``{prefix<path>: leaf}`` of a nested dict, paths dot-joined."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _nest(flat: Dict[str, Any]) -> Params:
    """The nested dict of dot-joined names (the inverse of ``_flat``)."""
    tree: Params = {}
    for name, val in flat.items():
        *parents, last = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = val
    return tree


class Stack(Layer):
    """Serial composition of layers; parameters in one flat dict under
    ``<layer key>.<param>``, state a dict by layer key."""

    def __init__(self, layers: Sequence[Layer], name: Optional[str] = None):
        super().__init__(name)
        self.layers = list(layers)
        # Unique name per layer: "dense", "dense_1", ...
        counts: Dict[str, int] = {}
        self.keys = []
        for layer in self.layers:
            base = layer.name
            n = counts.get(base, 0)
            counts[base] = n + 1
            self.keys.append(base if n == 0 else f"{base}_{n}")

    def get_config(self):
        return dict(layers=[layer_spec(l) for l in self.layers],
                    name=self.name)

    def init(self, generator, in_shape):
        """(params, state): every layer initialised in turn from
        ``generator``, on its device; the parameters are leaf tensors
        that require gradients."""
        params, state = {}, {}
        shape = tuple(in_shape)
        for name, layer in zip(self.keys, self.layers):
            p, s = layer.init(generator, shape)
            params.update(_flat(p, f"{name}."))
            if s:
                state[name] = s
            shape = layer.out_shape(shape)
        for p in params.values():
            if p.is_floating_point():
                p.requires_grad_(True)
        return params, state

    def out_shape(self, in_shape):
        shape = tuple(in_shape)
        for layer in self.layers:
            shape = layer.out_shape(shape)
        return shape

    def _layer_params(self, params: Params, key: str) -> Params:
        """The nested parameter dict of the layer named ``key``."""
        prefix = key + "."
        return _nest({k[len(prefix):]: v for k, v in params.items()
                      if k.startswith(prefix)})

    def apply(self, params, state, x, *, train=False, rng=None):
        """Every layer in turn; all of them draw from the one generator
        ``rng``, in order."""
        new_state = dict(state)
        for name, layer in zip(self.keys, self.layers):
            x, s = layer.apply(self._layer_params(params, name),
                               state.get(name, {}), x, train=train, rng=rng)
            if s:
                new_state[name] = s
        return x, new_state

    def __repr__(self):
        return "Stack(" + ", ".join(repr(l) for l in self.layers) + ")"


def serial(*layers: Layer) -> Stack:
    """stax-style combinator: ``serial(Dense(128, "relu"), Dropout(0.3),
    ...)``."""
    return Stack(layers)
