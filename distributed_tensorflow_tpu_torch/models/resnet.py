"""ResNet (v1.5 bottleneck), in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/resnet.py``:
``_Bottleneck``, ``ResNet``, ``resnet50``, ``resnet18`` and
``resnet_cifar``, over the layer library's ``Conv2D``, ``BatchNorm``,
``Dense``, ``GlobalAvgPool`` and ``MaxPool2D`` (NHWC, HWIO kernels, XLA's
SAME padding; the stem's 3x3 max pool at stride 2 pads with -inf as the
JAX package's ``reduce_window`` does).  The convolutions run on cuDNN on
the card: the JAX package computes them outside Pallas too, so this path
has no kernel of the port's.

A ``ResNet`` is a ``Layer``: ``init(generator, in_shape) -> (params,
state)`` and ``apply(params, state, x, *, train) -> (logits, new_state)``.
Like a ``Stack``, it returns its parameters as ONE flat dict of leaf
tensors that require gradients, under the dot-joined paths of the JAX
tree (``stem.kernel``, ``stage0_block0.conv1.kernel``, ``head.bias``),
the form the port's optimizers and ``train.make_train_step`` take;
``apply`` takes them flat or nested (a ``Stack`` hands its layers nested
dicts).  The BatchNorm moments are the state, nested by block as in the
JAX package, and stay f32 under a ``mixed_bfloat16`` policy (the norm
computes its moments in f32).  ``models.convert.stack_params_from_jax``
/ ``stack_params_to_jax`` carry the parameters, and the same nesting
the state, between the packages.

``partition_rules(fsdp=)`` is the JAX table: every convolution's output
channels and the head's classes over ``tensor`` (``fsdp=True`` also
cuts a convolution's input channels over ``fsdp``, which the stem's 3
do not divide over 2 ranks: ``ValueError``, as the JAX package's
``device_put``).  Tensor parallelism (``ResNet(..., mesh=...)`` with a
``tensor`` axis of T > 1 ranks, beside ``data``): ``init`` returns this
rank's blocks, and every convolution runs column-parallel on the whole
NHWC input (entered by ``copy_to_line``), its BatchNorm on the rank's
channel block, and ``gather_from_line`` joins the blocks along the last
dim before the next convolution and the residual add.  The BatchNorm's
``gamma`` and ``beta`` have no rule, so they replicate: a rank reads its
channels' slice, and their gradients ride in ``copy_to_line``'s backward
all-reduce; its moving ``mean`` and ``var`` stay whole on every rank (a
rank updates its slice, one all-gather a norm joins them).  The head is
column-parallel over the classes, with the replicated bias sliced the
same way, and its logits are gathered whole, so any named loss takes
them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.layers import (BatchNorm, Conv2D, Dense, GlobalAvgPool, Layer,
                          MaxPool2D, _flat, _nest)
from ..parallel import sharding as sharding_lib
from ..parallel import tensor_parallel as tp_lib

__all__ = ["ResNet", "resnet18", "resnet50", "resnet_cifar"]


def _tree(params):
    """The nested parameter dict of flat or nested ``params``."""
    return _nest(_flat(params, ""))


def _conv_bn(line, conv: Conv2D, bn: BatchNorm, pconv, pbn, state, x,
             train: bool):
    """(``bn(conv(x))``, the norm's new state).  ``line``: the tensor line
    (None at T = 1), over which the convolution is column-parallel: its
    kernel is this rank's output channels, the norm runs on them with its
    slice of the replicated ``gamma``/``beta`` and moments, and the
    output and the moving moments are gathered whole."""
    if line is None:
        h, _ = conv.apply(pconv, {}, x)
        return bn.apply(pbn, state, h, train=train)
    names = [k for k in ("gamma", "beta") if k in pbn]
    x, *affine = tp_lib.copy_to_line(x, line, *[pbn[k] for k in names])
    h, _ = conv.apply(pconv, {}, x)
    n = h.shape[-1]
    cut = slice(tp_lib.index(line) * n, (tp_lib.index(line) + 1) * n)
    y, new = bn.apply({k: a[cut] for k, a in zip(names, affine)},
                      {k: v[cut] for k, v in state.items()}, h,
                      train=train)
    if train:
        both = tp_lib.gather_state(torch.stack([new["mean"], new["var"]]),
                                   line)
        new = {"mean": both[0], "var": both[1]}
    else:
        new = state
    return tp_lib.gather_from_line(y, line), new


class _Bottleneck(Layer):
    """1x1 -> 3x3 -> 1x1 (x4) with a projection shortcut when the shape
    changes."""
    expansion = 4

    def __init__(self, filters: int, in_channels: int, stride: int = 1,
                 name: Optional[str] = None):
        super().__init__(name or "bottleneck")
        self.filters = filters
        self.stride = stride
        # the tensor line its ResNet computes over (None at T = 1)
        self.line = None
        self.conv1 = Conv2D(filters, 1, use_bias=False)
        self.bn1 = BatchNorm()
        self.conv2 = Conv2D(filters, 3, strides=stride, use_bias=False)
        self.bn2 = BatchNorm()
        self.conv3 = Conv2D(filters * self.expansion, 1, use_bias=False)
        self.bn3 = BatchNorm()
        out_ch = filters * self.expansion
        if stride != 1 or in_channels != out_ch:
            self.proj: Optional[Conv2D] = Conv2D(out_ch, 1, strides=stride,
                                                 use_bias=False)
            self.bn_proj: Optional[BatchNorm] = BatchNorm()
        else:
            self.proj = None
            self.bn_proj = None

    def _parts(self):
        parts = [("conv1", self.conv1), ("bn1", self.bn1),
                 ("conv2", self.conv2), ("bn2", self.bn2),
                 ("conv3", self.conv3), ("bn3", self.bn3)]
        if self.proj is not None:
            parts += [("proj", self.proj), ("bn_proj", self.bn_proj)]
        return parts

    def init(self, generator, in_shape):
        params, state = {}, {}
        shape = tuple(in_shape)
        shapes = {"conv1": shape}
        shapes["bn1"] = self.conv1.out_shape(shape)
        shapes["conv2"] = shapes["bn1"]
        shapes["bn2"] = self.conv2.out_shape(shapes["conv2"])
        shapes["conv3"] = shapes["bn2"]
        shapes["bn3"] = self.conv3.out_shape(shapes["conv3"])
        shapes["proj"] = shape
        shapes["bn_proj"] = shapes["bn3"]
        for name, layer in self._parts():
            p, s = layer.init(generator, shapes[name])
            if p:
                params[name] = p
            if s:
                state[name] = s
        return params, state

    def out_shape(self, in_shape):
        return self.conv3.out_shape(
            self.conv2.out_shape(self.conv1.out_shape(in_shape)))

    def apply(self, params, state, x, *, train=False, rng=None):
        new_state = dict(state)

        def run(conv, bn, h):
            out, new_state[bn] = _conv_bn(
                self.line, getattr(self, conv), getattr(self, bn),
                params.get(conv, {}), params.get(bn, {}), state[bn], h,
                train)
            return out

        h = F.relu(run("conv1", "bn1", x))
        h = F.relu(run("conv2", "bn2", h))
        h = run("conv3", "bn3", h)
        shortcut = x
        if self.proj is not None:
            shortcut = run("proj", "bn_proj", x)
        return F.relu(h + shortcut), new_state


class ResNet(Layer):
    """Stage-structured ResNet; ``stages`` = blocks a stage.  ``mesh``: a
    ``parallel.Mesh`` with a ``tensor`` axis for tensor parallelism
    (module docstring)."""

    def __init__(self, stages: Sequence[int], num_classes: int = 1000,
                 stem_stride: int = 2, stem_pool: bool = True,
                 width: int = 64, name: Optional[str] = None, mesh=None):
        super().__init__(name or "resnet")
        self.mesh = mesh
        # the tensor line, None at T = 1
        self.line = tp_lib.active(mesh)
        if self.line is not None:
            sharding_lib.check_mesh(mesh)
        self.stem = Conv2D(width, 7 if stem_pool else 3,
                           strides=stem_stride, use_bias=False)
        self.stem_bn = BatchNorm()
        self.stem_pool = stem_pool
        self.pool_3x3 = MaxPool2D(3, 2, "SAME")
        self.blocks = []
        filters = width
        in_channels = width
        for stage_idx, num_blocks in enumerate(stages):
            for block_idx in range(num_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                block = _Bottleneck(filters, in_channels, stride)
                block.line = self.line
                self.blocks.append(
                    (f"stage{stage_idx}_block{block_idx}", block))
                in_channels = filters * _Bottleneck.expansion
            filters *= 2
        self.head = Dense(num_classes)
        self.pool = GlobalAvgPool()

    def init(self, generator, in_shape):
        """(params, state): the parameters flat, as leaf tensors that
        require gradients (under tensor parallelism this rank's blocks,
        marked); the BatchNorm moments nested by block, whole."""
        params, state = {}, {}
        shape = tuple(in_shape)
        params["stem"], _ = self.stem.init(generator, shape)
        shape = self.stem.out_shape(shape)
        p, state["stem_bn"] = self.stem_bn.init(generator, shape)
        if p:
            params["stem_bn"] = p
        if self.stem_pool:
            shape = self.pool_3x3.out_shape(shape)
        for name, block in self.blocks:
            p, s = block.init(generator, shape)
            params[name] = p
            if s:
                state[name] = s
            shape = block.out_shape(shape)
        params["head"], _ = self.head.init(generator, (shape[-1],))
        flat = _flat(params, "")
        for t in flat.values():
            t.requires_grad_(True)
        if self.line is not None:
            flat = sharding_lib.cut_blocks(flat, self.partition_rules(),
                                           self.line)
        return flat, state

    def out_shape(self, in_shape):
        return (self.head.units,)

    def apply(self, params, state, x, *, train=False, rng=None):
        params = _tree(params)
        new_state = dict(state)
        h, new_state["stem_bn"] = _conv_bn(
            self.line, self.stem, self.stem_bn, params["stem"],
            params.get("stem_bn", {}), state["stem_bn"], x, train)
        h = F.relu(h)
        if self.stem_pool:
            h, _ = self.pool_3x3.apply({}, {}, h)
        for name, block in self.blocks:
            h, s = block.apply(params[name], state.get(name, {}), h,
                               train=train)
            if s:
                new_state[name] = s
        h, _ = self.pool.apply({}, {}, h)
        if self.line is None:
            logits, _ = self.head.apply(params["head"], {}, h)
            return logits, new_state
        kernel = params["head"]["kernel"]
        n = kernel.shape[-1]
        h, bias = tp_lib.copy_to_line(h, self.line, params["head"]["bias"])
        at = tp_lib.index(self.line) * n
        logits = h @ kernel.to(h.dtype) + bias[at:at + n].to(h.dtype)
        return tp_lib.gather_from_line(logits, self.line), new_state

    @staticmethod
    def partition_rules(fsdp: bool = False) -> sharding_lib.PartitionRules:
        """The JAX package's table over the flat names (``stem.kernel``,
        ``stage0_block0.conv1.kernel``, ``head.kernel``): a convolution's
        output channels over ``tensor`` (its input channels over
        ``fsdp`` with ``fsdp=True``), the head's classes over
        ``tensor``."""
        f = "fsdp" if fsdp else None
        return sharding_lib.PartitionRules([
            # conv kernels [kh, kw, cin, cout]: output channels on tensor
            (r"(conv|proj|stem).*kernel", (None, None, f, "tensor")),
            (r"head.kernel", (f, "tensor")),
        ])


def resnet50(num_classes: int = 1000, mesh=None) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes, mesh=mesh)


def resnet18(num_classes: int = 1000, mesh=None) -> ResNet:
    """Bottleneck-based, as the JAX package keeps it: a depth-equivalent
    small net."""
    return ResNet([2, 2, 2, 2], num_classes, mesh=mesh)


def resnet_cifar(num_classes: int = 10, mesh=None) -> ResNet:
    """3x3 stem, no max pool, width 32: the CIFAR variant."""
    return ResNet([2, 2, 2], num_classes, stem_stride=1, stem_pool=False,
                  width=32, mesh=mesh)
