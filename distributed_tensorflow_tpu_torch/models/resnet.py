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
the state, between the packages.  ``partition_rules`` waits for the
parallelism slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn.functional as F

from ..ops.layers import (BatchNorm, Conv2D, Dense, GlobalAvgPool, Layer,
                          MaxPool2D, _flat, _nest)
from .bert import _PARALLEL

__all__ = ["ResNet", "resnet18", "resnet50", "resnet_cifar"]


def _tree(params):
    """The nested parameter dict of flat or nested ``params``."""
    return _nest(_flat(params, ""))


class _Bottleneck(Layer):
    """1x1 -> 3x3 -> 1x1 (x4) with a projection shortcut when the shape
    changes."""
    expansion = 4

    def __init__(self, filters: int, in_channels: int, stride: int = 1,
                 name: Optional[str] = None):
        super().__init__(name or "bottleneck")
        self.filters = filters
        self.stride = stride
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

        def run(name, layer, h):
            out, s = layer.apply(params.get(name, {}), state.get(name, {}),
                                 h, train=train)
            if s:
                new_state[name] = s
            return out

        h = F.relu(run("bn1", self.bn1, run("conv1", self.conv1, x)))
        h = F.relu(run("bn2", self.bn2, run("conv2", self.conv2, h)))
        h = run("bn3", self.bn3, run("conv3", self.conv3, h))
        shortcut = x
        if self.proj is not None:
            shortcut = run("bn_proj", self.bn_proj,
                           run("proj", self.proj, x))
        return F.relu(h + shortcut), new_state


class ResNet(Layer):
    """Stage-structured ResNet; ``stages`` = blocks a stage."""

    def __init__(self, stages: Sequence[int], num_classes: int = 1000,
                 stem_stride: int = 2, stem_pool: bool = True,
                 width: int = 64, name: Optional[str] = None):
        super().__init__(name or "resnet")
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
                self.blocks.append(
                    (f"stage{stage_idx}_block{block_idx}", block))
                in_channels = filters * _Bottleneck.expansion
            filters *= 2
        self.head = Dense(num_classes)
        self.pool = GlobalAvgPool()

    def init(self, generator, in_shape):
        """(params, state): the parameters flat, as leaf tensors that
        require gradients; the BatchNorm moments nested by block."""
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
        return flat, state

    def out_shape(self, in_shape):
        return (self.head.units,)

    def apply(self, params, state, x, *, train=False, rng=None):
        params = _tree(params)
        new_state = dict(state)
        h, _ = self.stem.apply(params["stem"], {}, x)
        h, new_state["stem_bn"] = self.stem_bn.apply(
            params.get("stem_bn", {}), state["stem_bn"], h, train=train)
        h = F.relu(h)
        if self.stem_pool:
            h, _ = self.pool_3x3.apply({}, {}, h)
        for name, block in self.blocks:
            h, s = block.apply(params[name], state.get(name, {}), h,
                               train=train)
            if s:
                new_state[name] = s
        h, _ = self.pool.apply({}, {}, h)
        logits, _ = self.head.apply(params["head"], {}, h)
        return logits, new_state

    @staticmethod
    def partition_rules(fsdp: bool = False):
        raise NotImplementedError(f"ResNet.partition_rules: {_PARALLEL}")


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes)


def resnet18(num_classes: int = 1000) -> ResNet:
    """Bottleneck-based, as the JAX package keeps it: a depth-equivalent
    small net."""
    return ResNet([2, 2, 2, 2], num_classes)


def resnet_cifar(num_classes: int = 10) -> ResNet:
    """3x3 stem, no max pool, width 32: the CIFAR variant."""
    return ResNet([2, 2, 2], num_classes, stem_stride=1, stem_pool=False,
                  width=32)
