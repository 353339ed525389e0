"""Symmetric int8 quantization, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/quant.py``, with the
same arithmetic: ``scale = max(amax / 127, 1e-12)`` over the reduced
axes, ``q = clip(round(w / scale), -127, 127)`` as int8 (``torch.round``
rounds half to even, as ``jnp.round`` does), and ``q * scale`` in f32 to
dequantize.  The serving path uses it for the int8 KV cache: each
written key or value vector gets its own scale (``reduce_axes=(-1,)``,
one f32 per token and kv head), and the paged-attention kernel
dequantizes at the operand.

The default reduction (``"auto"``) keeps the first and last axes of
>=3-D tensors (the ``[L, ...]`` layer stack and the output channel), the
last axis of matrices, and one scale for vectors and scalars.  Trees are
nested dicts (lists and tuples too) of tensors; ``QTensor`` leaves stand
in place of the tensors they quantize.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

__all__ = ["QTensor", "dequantize_tensor", "dequantize_tree",
           "quantize_tensor", "quantize_tree", "quantized_bytes"]


class QTensor(NamedTuple):
    """int8 values and an f32 scale that broadcasts against them."""
    q: torch.Tensor          # int8, the original shape
    scale: torch.Tensor      # f32, broadcastable against q


def _auto_reduce_axes(ndim: int) -> Optional[tuple]:
    if ndim <= 1:
        return None
    if ndim == 2:
        return (0,)
    return tuple(range(1, ndim - 1))


def quantize_tensor(w: torch.Tensor, reduce_axes="auto") -> QTensor:
    """Symmetric int8 quantization.  ``reduce_axes``: the axes the scale's
    max runs over (every other axis keeps a scale per slice); ``"auto"``
    the module's rule; ``None`` one scale for the whole tensor."""
    wf = w.float()
    if reduce_axes == "auto":
        reduce_axes = _auto_reduce_axes(wf.ndim)
    if reduce_axes is None:
        amax = wf.abs().max()
    else:
        axes = tuple(a % wf.ndim for a in reduce_axes)
        amax = wf.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize_tensor(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, QTensor) or not isinstance(tree, (dict, list,
                                                           tuple)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def _leaves(tree: Any):
    if isinstance(tree, QTensor):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_tree(params: Any, min_size: int = 1024,
                  reduce_axes="auto") -> Any:
    """Quantize every floating tensor of >= 2 dims and >= ``min_size``
    elements (biases, norm scales and small tensors stay as they are);
    ``QTensor`` leaves are left alone, so re-quantizing is a no-op."""
    def visit(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and leaf.is_floating_point() and leaf.numel() >= min_size):
            return quantize_tensor(leaf, reduce_axes=reduce_axes)
        return leaf
    return _map(visit, params)


def dequantize_tree(qparams: Any, dtype=torch.float32) -> Any:
    """Inverse of ``quantize_tree``."""
    return _map(lambda leaf: (dequantize_tensor(leaf, dtype)
                              if isinstance(leaf, QTensor) else leaf),
                qparams)


def quantized_bytes(tree: Any) -> int:
    """Total bytes of a (possibly partly) quantized tree's tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))
