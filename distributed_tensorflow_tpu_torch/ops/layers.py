"""The layer library, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/layers.py``: ``Layer``,
``layer_spec``, ``Dense``, ``Dropout``, ``Flatten``, ``Activation``, the
convolutions (``Conv2D``, ``Conv1D``, ``DepthwiseConv2D``,
``SeparableConv2D``), the pools (``MaxPool2D``, ``AvgPool2D``,
``GlobalAvgPool``), ``BatchNorm``, ``LayerNorm``, ``Embedding``, the
recurrent ``LSTM`` and ``GRU``, ``Stack`` and ``serial``.

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
* Images are NHWC and sequences NWC, conv kernels HWIO / WIO, as in the
  JAX package, so weights carry over one to one.  The convolutions run
  ``F.conv2d`` / ``F.conv1d`` (cuDNN on the card; the JAX package's
  ``lax.conv_general_dilated`` is no Pallas kernel either) on a
  channels-first view of the NHWC tensor, and permute the result back,
  so a ``Flatten`` after them sees NHWC order.  SAME padding is XLA's:
  ``total = max((ceil(n / s) - 1) * s + k - n, 0)``, ``total // 2``
  before and the rest after, passed to the conv when it is symmetric and
  padded explicitly when it is not (torch's ``padding="same"`` refuses
  strides above 1).  ``MaxPool2D`` pads with -inf; ``AvgPool2D`` at SAME
  divides each window by its count of real elements.
* ``BatchNorm`` normalises with the moments of the global batch, as the
  JAX package's jit over a sharded batch does: under a data-parallel
  mesh of more than one rank (``train.make_custom_train_step(mesh=...)``
  enters ``parallel.data_parallel.cross_rank_moments`` around its loss
  function) each rank sums its shard's x and x^2 and its row count over
  the batch line (``data_parallel.batch_sum``, whose backward sums the
  gradients of the sums), so the gradients are the global batch's too,
  and shards of different sizes stay exact.  The batch line is the
  ranks that hold other rows of the same channels (``data_parallel.
  batch_group``: the mesh's replicas, its ``data`` x ``fsdp`` plane
  beside a ``tensor`` axis, where a tensor-parallel ResNet's ranks hold
  different channel blocks), never a whole mesh whose ranks hold
  different channels.  The layer reads the line as it runs (no model in
  the port recomputes a ``BatchNorm`` in its backward).
* ``LayerNorm(fused=True)`` and ``fused="auto"`` run the LayerNorm
  kernel (``ops.kernels.fused.fused_layernorm``; its plain version on a
  CPU tensor); the JAX package's TPU-only ``"auto"`` gate is not ported:
  on the card the kernel is the path.
* ``get_config`` returns the same JSON-able constructor arguments.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel import data_parallel as dp_lib
from . import activations as act_lib
from . import initializers as init_lib
from .kernels import fused as fused_lib

__all__ = ["Layer", "layer_spec", "Dense", "Dropout", "Flatten",
           "Activation", "Conv2D", "Conv1D", "DepthwiseConv2D",
           "SeparableConv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool",
           "BatchNorm", "LayerNorm", "Embedding", "LSTM", "GRU", "serial",
           "Stack"]

Params = Dict[str, Any]
State = Dict[str, Any]
Shape = Tuple[int, ...]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


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


def _conv_out(size: int, k: int, s: int, padding: str) -> int:
    """Spatial output extent for SAME/VALID (every conv and pool)."""
    if padding == "SAME":
        return -(-size // s)
    return -(-(size - k + 1) // s)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(padding: str, sizes, ks, ss):
    """[(before, after)] per spatial dim; zeros for VALID."""
    if padding == "SAME":
        return [_same_pads(n, k, s) for n, k, s in zip(sizes, ks, ss)]
    if padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID'; got "
                         f"{padding!r}")
    return [(0, 0)] * len(sizes)


def _flat_pads(pads):
    """``F.pad``'s argument (last dim first) of [(before, after)]."""
    return [p for pair in reversed(pads) for p in pair]


def _conv(x_cf, weight, strides, padding: str, groups: int = 1):
    """Channels-first conv (1-d or 2-d) with XLA's SAME/VALID padding:
    symmetric padding goes to the conv, asymmetric through ``F.pad``."""
    conv = F.conv2d if x_cf.dim() == 4 else F.conv1d
    pads = _pads(padding, x_cf.shape[2:], weight.shape[2:], strides)
    if all(a == b for a, b in pads):
        return conv(x_cf, weight, stride=tuple(strides),
                    padding=tuple(a for a, _ in pads), groups=groups)
    return conv(F.pad(x_cf, _flat_pads(pads)), weight,
                stride=tuple(strides), groups=groups)


def _nhwc_conv(x, kernel, strides, padding, groups: int = 1):
    """NHWC x, HWIO kernel -> NHWC output."""
    y = _conv(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), strides,
              padding, groups)
    return y.permute(0, 2, 3, 1)


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


class _Conv(Layer):
    """Shared constructor and config of the convolutions."""

    def _common(self, activation, use_bias, kernel_init, bias_init,
                param_dtype):
        self.activation = act_lib.get(activation)
        self.use_bias = use_bias
        self.kernel_init = init_lib.get(kernel_init)
        self.bias_init = init_lib.get(bias_init)
        self.param_dtype = _dtype(param_dtype)
        self._raw = dict(activation=activation, kernel_init=kernel_init,
                         bias_init=bias_init)

    def _common_config(self):
        return dict(activation=_by_name(self._raw["activation"],
                                        "activation", self),
                    use_bias=self.use_bias,
                    kernel_init=_by_name(self._raw["kernel_init"],
                                         "kernel_init", self),
                    bias_init=_by_name(self._raw["bias_init"],
                                       "bias_init", self),
                    param_dtype=_dtype_name(self.param_dtype),
                    name=self.name)

    def _kernel_and_bias(self, generator, kernel_shape, out: int):
        params = {"kernel": self.kernel_init(generator, kernel_shape,
                                             self.param_dtype)}
        if self.use_bias:
            params["bias"] = self.bias_init(generator, (out,),
                                            self.param_dtype)
        return params

    def _finish(self, params, y):
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        return self.activation(y)


class Conv2D(_Conv):
    """NHWC conv, kernel HWIO; he_normal / zeros by default."""

    def __init__(self, filters: int, kernel_size, strides=1, padding="SAME",
                 activation=None, use_bias: bool = True,
                 kernel_init="he_normal", bias_init="zeros",
                 param_dtype=torch.float32, name: Optional[str] = None):
        super().__init__(name)
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self._common(activation, use_bias, kernel_init, bias_init,
                     param_dtype)

    def get_config(self):
        return dict(filters=self.filters,
                    kernel_size=list(self.kernel_size),
                    strides=list(self.strides), padding=self.padding,
                    **self._common_config())

    def init(self, generator, in_shape):
        kh, kw = self.kernel_size
        return self._kernel_and_bias(
            generator, (kh, kw, in_shape[-1], self.filters), self.filters), {}

    def out_shape(self, in_shape):
        h, w, _ = in_shape
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        return (_conv_out(h, kh, sh, self.padding),
                _conv_out(w, kw, sw, self.padding), self.filters)

    def apply(self, params, state, x, *, train=False, rng=None):
        y = _nhwc_conv(x, params["kernel"].to(x.dtype), self.strides,
                       self.padding)
        return self._finish(params, y), state

    def __repr__(self):
        return f"Conv2D({self.filters}, {self.kernel_size})"


class Conv1D(_Conv):
    """NWC 1-d conv, kernel WIO."""

    def __init__(self, filters: int, kernel_size: int, strides: int = 1,
                 padding: str = "SAME", activation=None,
                 use_bias: bool = True, kernel_init="he_normal",
                 bias_init="zeros", param_dtype=torch.float32,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = int(filters)
        self.kernel_size = int(kernel_size)
        self.strides = int(strides)
        self.padding = padding
        self._common(activation, use_bias, kernel_init, bias_init,
                     param_dtype)

    def get_config(self):
        return dict(filters=self.filters, kernel_size=self.kernel_size,
                    strides=self.strides, padding=self.padding,
                    **self._common_config())

    def init(self, generator, in_shape):
        return self._kernel_and_bias(
            generator, (self.kernel_size, in_shape[-1], self.filters),
            self.filters), {}

    def out_shape(self, in_shape):
        t, _ = in_shape
        return (_conv_out(t, self.kernel_size, self.strides, self.padding),
                self.filters)

    def apply(self, params, state, x, *, train=False, rng=None):
        y = _conv(x.permute(0, 2, 1),
                  params["kernel"].to(x.dtype).permute(2, 1, 0),
                  (self.strides,), self.padding)
        return self._finish(params, y.permute(0, 2, 1)), state

    def __repr__(self):
        return f"Conv1D({self.filters}, {self.kernel_size})"


class DepthwiseConv2D(_Conv):
    """Per-channel spatial conv (groups = channels), kernel
    ``[kh, kw, 1, channels * depth_multiplier]``."""

    def __init__(self, kernel_size, strides=1, padding="SAME",
                 depth_multiplier: int = 1, activation=None,
                 use_bias: bool = True, kernel_init="he_normal",
                 bias_init="zeros", param_dtype=torch.float32,
                 name: Optional[str] = None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.depth_multiplier = int(depth_multiplier)
        self._common(activation, use_bias, kernel_init, bias_init,
                     param_dtype)

    def get_config(self):
        return dict(kernel_size=list(self.kernel_size),
                    strides=list(self.strides), padding=self.padding,
                    depth_multiplier=self.depth_multiplier,
                    **self._common_config())

    def init(self, generator, in_shape):
        kh, kw = self.kernel_size
        out = in_shape[-1] * self.depth_multiplier
        return self._kernel_and_bias(generator, (kh, kw, 1, out), out), {}

    def out_shape(self, in_shape):
        h, w, c = in_shape
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        return (_conv_out(h, kh, sh, self.padding),
                _conv_out(w, kw, sw, self.padding),
                c * self.depth_multiplier)

    def apply(self, params, state, x, *, train=False, rng=None):
        y = _nhwc_conv(x, params["kernel"].to(x.dtype), self.strides,
                       self.padding, groups=x.shape[-1])
        return self._finish(params, y), state

    def __repr__(self):
        return f"DepthwiseConv2D({self.kernel_size})"


class SeparableConv2D(_Conv):
    """Depthwise then pointwise (1x1) conv; parameters ``depthwise.kernel``,
    ``pointwise.kernel`` and ``bias``."""

    def __init__(self, filters: int, kernel_size, strides=1, padding="SAME",
                 depth_multiplier: int = 1, activation=None,
                 use_bias: bool = True, kernel_init="he_normal",
                 bias_init="zeros", param_dtype=torch.float32,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = int(filters)
        self.depthwise = DepthwiseConv2D(
            kernel_size, strides=strides, padding=padding,
            depth_multiplier=depth_multiplier, use_bias=False,
            kernel_init=kernel_init, param_dtype=param_dtype)
        self._common(activation, use_bias, kernel_init, bias_init,
                     param_dtype)

    def get_config(self):
        d = self.depthwise
        return dict(filters=self.filters,
                    kernel_size=list(d.kernel_size),
                    strides=list(d.strides), padding=d.padding,
                    depth_multiplier=d.depth_multiplier,
                    **self._common_config())

    def init(self, generator, in_shape):
        dw, _ = self.depthwise.init(generator, in_shape)
        mid = in_shape[-1] * self.depthwise.depth_multiplier
        params = {"depthwise": dw,
                  "pointwise": {"kernel": self.kernel_init(
                      generator, (1, 1, mid, self.filters),
                      self.param_dtype)}}
        if self.use_bias:
            params["bias"] = self.bias_init(generator, (self.filters,),
                                            self.param_dtype)
        return params, {}

    def out_shape(self, in_shape):
        h, w, _ = self.depthwise.out_shape(in_shape)
        return (h, w, self.filters)

    def apply(self, params, state, x, *, train=False, rng=None):
        y, _ = self.depthwise.apply(params["depthwise"], {}, x)
        y = _nhwc_conv(y, params["pointwise"]["kernel"].to(y.dtype), (1, 1),
                       "VALID")
        return self._finish(params, y), state

    def __repr__(self):
        return f"SeparableConv2D({self.filters})"


class _Pool2D(Layer):
    def __init__(self, pool_size=2, strides=None, padding="VALID",
                 name: Optional[str] = None):
        super().__init__(name)
        self.pool_size = _pair(pool_size)
        self.strides = (_pair(strides) if strides is not None
                        else self.pool_size)
        self.padding = padding

    def get_config(self):
        return dict(pool_size=list(self.pool_size),
                    strides=list(self.strides), padding=self.padding,
                    name=self.name)

    def out_shape(self, in_shape):
        h, w, c = in_shape
        (kh, kw), (sh, sw) = self.pool_size, self.strides
        return (_conv_out(h, kh, sh, self.padding),
                _conv_out(w, kw, sw, self.padding), c)

    def _padded(self, x_cf, value: float):
        """The channels-first input padded for SAME with ``value``."""
        pads = _pads(self.padding, x_cf.shape[2:], self.pool_size,
                     self.strides)
        if not any(a or b for a, b in pads):
            return x_cf
        return F.pad(x_cf, _flat_pads(pads), value=value)


class MaxPool2D(_Pool2D):
    def apply(self, params, state, x, *, train=False, rng=None):
        y = F.max_pool2d(self._padded(x.permute(0, 3, 1, 2), -math.inf),
                         self.pool_size, self.strides)
        return y.permute(0, 2, 3, 1), state


class AvgPool2D(_Pool2D):
    def apply(self, params, state, x, *, train=False, rng=None):
        x_cf = x.permute(0, 3, 1, 2)
        if self.padding != "SAME":
            y = F.avg_pool2d(x_cf, self.pool_size, self.strides)
            return y.permute(0, 2, 3, 1), state
        # a window's sum over its count of real (unpadded) elements
        total = F.avg_pool2d(self._padded(x_cf, 0.0), self.pool_size,
                             self.strides, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x_cf.shape[2:]), dtype=x.dtype,
                          device=x.device)
        count = F.avg_pool2d(self._padded(ones, 0.0), self.pool_size,
                             self.strides, divisor_override=1)
        return (total / count).permute(0, 2, 3, 1), state


class GlobalAvgPool(Layer):
    """NHWC -> NC mean over the spatial dims."""

    def get_config(self):
        return dict(name=self.name)

    def out_shape(self, in_shape):
        return (in_shape[-1],)

    def apply(self, params, state, x, *, train=False, rng=None):
        return x.mean(dim=(1, 2)), state


class BatchNorm(Layer):
    """Batch normalization over every dim but the last, with running
    moments (``mean``, ``var``) as state.  In training the batch's f32
    moments (``var = max(E[x^2] - E[x]^2, 0)``) normalise, and the state
    moves by ``momentum``; in eval the state normalises.  Under
    ``parallel.data_parallel.cross_rank_moments`` the batch is the global one (module
    docstring).  ``axis_name`` is kept for the JAX signature and the
    config."""

    def __init__(self, momentum: float = 0.9, epsilon: float = 1e-5,
                 scale: bool = True, center: bool = True,
                 axis_name: Optional[str] = None, name: Optional[str] = None):
        super().__init__(name)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale = scale
        self.center = center
        self.axis_name = axis_name

    def get_config(self):
        return dict(momentum=self.momentum, epsilon=self.epsilon,
                    scale=self.scale, center=self.center,
                    axis_name=self.axis_name, name=self.name)

    def init(self, generator, in_shape):
        dim, dev = in_shape[-1], init_lib._device(generator)
        params = {}
        if self.scale:
            params["gamma"] = torch.ones((dim,), device=dev)
        if self.center:
            params["beta"] = torch.zeros((dim,), device=dev)
        return params, {"mean": torch.zeros((dim,), device=dev),
                        "var": torch.ones((dim,), device=dev)}

    def apply(self, params, state, x, *, train=False, rng=None):
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            group = dp_lib.batch_group()
            if group is None:
                mean = xf.mean(dim=axes)
                mean_sq = torch.square(xf).mean(dim=axes)
            else:
                d = x.shape[-1]
                sums = dp_lib.batch_sum(torch.cat([
                    xf.sum(dim=axes), torch.square(xf).sum(dim=axes),
                    xf.new_full((1,), xf.numel() // d)]), group)
                mean = sums[:d] / sums[-1]
                mean_sq = sums[d:2 * d] / sums[-1]
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            m = self.momentum
            # the moving moments are state, not part of the loss's graph
            new_state = {"mean": m * state["mean"] + (1 - m) * mean.detach(),
                         "var": m * state["var"] + (1 - m) * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        inv = torch.rsqrt(var + self.epsilon)
        if self.scale:
            inv = inv * params["gamma"]
        y = (xf - mean) * inv
        if self.center:
            y = y + params["beta"]
        return y.to(x.dtype), new_state


class LayerNorm(Layer):
    """Layer normalization over the last dim.  ``fused=True`` or
    ``"auto"`` runs the LayerNorm kernel (needs both scale and center);
    ``fused=False`` the plain arithmetic."""

    def __init__(self, epsilon: float = 1e-6, scale: bool = True,
                 center: bool = True, fused=False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.epsilon = float(epsilon)
        self.scale = scale
        self.center = center
        if fused and not (scale and center):
            raise ValueError("LayerNorm(fused=True) requires scale and "
                             "center (the kernel applies gamma and beta)")
        self.fused = fused

    def get_config(self):
        return dict(epsilon=self.epsilon, scale=self.scale,
                    center=self.center, fused=self.fused, name=self.name)

    def init(self, generator, in_shape):
        dim, dev = in_shape[-1], init_lib._device(generator)
        params = {}
        if self.scale:
            params["gamma"] = torch.ones((dim,), device=dev)
        if self.center:
            params["beta"] = torch.zeros((dim,), device=dev)
        return params, {}

    def apply(self, params, state, x, *, train=False, rng=None):
        if self.fused:
            return fused_lib.fused_layernorm(
                x.contiguous(), params["gamma"], params["beta"],
                eps=self.epsilon), state
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        if self.scale:
            y = y * params["gamma"]
        if self.center:
            y = y + params["beta"]
        return y.to(x.dtype), state


class Embedding(Layer):
    """Token embedding table ``[vocab, dim]``."""

    def __init__(self, vocab_size: int, dim: int,
                 embedding_init=init_lib.normal(0.02),
                 name: Optional[str] = None):
        super().__init__(name)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.embedding_init = init_lib.get(embedding_init)
        self._raw_init = embedding_init

    def get_config(self):
        cfg = dict(vocab_size=self.vocab_size, dim=self.dim, name=self.name)
        # the default is a callable made at def time; leaving it out of
        # the config round-trips to the same default
        if self._raw_init is not Embedding.__init__.__defaults__[0]:
            cfg["embedding_init"] = _by_name(self._raw_init,
                                             "embedding_init", self)
        return cfg

    def init(self, generator, in_shape):
        return {"embedding": self.embedding_init(
            generator, (self.vocab_size, self.dim), torch.float32)}, {}

    def out_shape(self, in_shape):
        return tuple(in_shape) + (self.dim,)

    def apply(self, params, state, x, *, train=False, rng=None):
        return F.embedding(x.long(), params["embedding"]), state

    def attend(self, params, x):
        """Tied-softmax logits: x @ E^T."""
        return x @ params["embedding"].t().to(x.dtype)


class _Recurrent(Layer):
    """[b, t, f] -> [b, t, u] (``return_sequences``) or [b, u].  The input
    projection of every step is one product ``[b*t, f] @ [f, g*u]``; the
    time loop does the ``[b, u] @ [u, g*u]`` recurrent product a step.
    All recurrent arithmetic runs in f32.  Keras-2 defaults: tanh, and
    hard_sigmoid gates."""

    gates = 1

    def __init__(self, units: int, return_sequences: bool = False,
                 activation="tanh", recurrent_activation="hard_sigmoid",
                 kernel_init="glorot_uniform",
                 recurrent_init="orthogonal",
                 name: Optional[str] = None):
        super().__init__(name)
        self.units = int(units)
        self.return_sequences = bool(return_sequences)
        self.act = act_lib.get(activation)
        self.rec_act = act_lib.get(recurrent_activation)
        self.kernel_init = init_lib.get(kernel_init)
        self.recurrent_init = init_lib.get(recurrent_init)
        self._raw = dict(activation=activation,
                         recurrent_activation=recurrent_activation,
                         kernel_init=kernel_init,
                         recurrent_init=recurrent_init)

    def get_config(self):
        return dict(units=self.units,
                    return_sequences=self.return_sequences,
                    activation=_by_name(self._raw["activation"],
                                        "activation", self),
                    recurrent_activation=_by_name(
                        self._raw["recurrent_activation"],
                        "recurrent_activation", self),
                    kernel_init=_by_name(self._raw["kernel_init"],
                                         "kernel_init", self),
                    recurrent_init=_by_name(self._raw["recurrent_init"],
                                            "recurrent_init", self),
                    name=self.name)

    def init(self, generator, in_shape):
        g, u = self.gates, self.units
        return {"kernel": self.kernel_init(generator, (in_shape[-1], g * u),
                                           torch.float32),
                "recurrent_kernel": self.recurrent_init(
                    generator, (u, g * u), torch.float32),
                "bias": self._bias_init(init_lib._device(generator))}, {}

    def _bias_init(self, device):
        return torch.zeros((self.gates * self.units,), device=device)

    def out_shape(self, in_shape):
        t, _ = in_shape
        return (t, self.units) if self.return_sequences else (self.units,)

    def apply(self, params, state, x, *, train=False, rng=None):
        u = self.units
        xin = x.float() @ params["kernel"] + params["bias"]   # [b, t, g*u]
        carry = self._carry0(x.shape[0], u, x.device)
        ys = []
        for t in range(x.shape[1]):
            carry, y = self._step(params, carry, xin[:, t], u)
            ys.append(y)
        if self.return_sequences:
            return torch.stack(ys, dim=1).to(x.dtype), state
        return self._last(carry).to(x.dtype), state


class LSTM(_Recurrent):
    """Keras-2 LSTM (gate order i, f, c, o; forget bias 1.0)."""

    gates = 4

    def _bias_init(self, device):
        b = torch.zeros((4 * self.units,), device=device)
        b[self.units:2 * self.units] = 1.0
        return b

    def _carry0(self, b, u, device):
        return (torch.zeros((b, u), device=device),
                torch.zeros((b, u), device=device))

    def _step(self, params, carry, x_t, u):
        h, c = carry
        z = x_t + h @ params["recurrent_kernel"]
        i = self.rec_act(z[:, :u])
        f = self.rec_act(z[:, u:2 * u])
        g = self.act(z[:, 2 * u:3 * u])
        o = self.rec_act(z[:, 3 * u:])
        c = f * c + i * g
        h = o * self.act(c)
        return (h, c), h

    def _last(self, carry):
        return carry[0]

    def __repr__(self):
        return f"LSTM({self.units})"


class GRU(_Recurrent):
    """Keras-2 GRU (gate order z, r, h; the reset gate applied to the
    recurrent state before the candidate's product, reset_after=False)."""

    gates = 3

    def _carry0(self, b, u, device):
        return torch.zeros((b, u), device=device)

    def _step(self, params, carry, x_t, u):
        h = carry
        rk = params["recurrent_kernel"]
        rec_zr = h @ rk[:, :2 * u]
        z = self.rec_act(x_t[:, :u] + rec_zr[:, :u])
        r = self.rec_act(x_t[:, u:2 * u] + rec_zr[:, u:])
        hh = self.act(x_t[:, 2 * u:] + (r * h) @ rk[:, 2 * u:])
        h = z * h + (1.0 - z) * hh
        return h, h

    def _last(self, carry):
        return carry

    def __repr__(self):
        return f"GRU({self.units})"

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
