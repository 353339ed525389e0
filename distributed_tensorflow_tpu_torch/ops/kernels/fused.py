"""LayerNorm over the last axis: CUDA kernel and plain version.

Replaces the Pallas kernel ``_layernorm_forward`` of
``distributed_tensorflow_tpu/ops/pallas/fused.py`` (body
``_layernorm_kernel``), reached there through ``fused_layernorm``.  The
kernel is ``csrc/layernorm.cu``: one thread block per row, f32 mean and
variance by block reductions, output in the input's type.

What bounds it on the H100: bytes (x read once, the output written
once); at the serving path's 8 to 256 rows of d = 768 the launch itself
dominates.  The design keeps a row in L1 across its three passes; fusing
the norm into the next projection is later work.

Dispatch is by the tensor's device: the plain version (the f32 formula of
the JAX package's ``_layernorm_reference``, not ``F.layer_norm``) for a
CPU tensor, the kernel or an exception for a CUDA tensor.  ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "fused_layernorm", "layernorm_plain"]

# kernel launches ("layernorm")
LAUNCHES: collections.Counter = collections.Counter()


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32, output in x's type."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of x [..., d] with f32 gamma/beta [d]."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32; got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32 \
                or t.shape != (d,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{d}] on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _build.load("layernorm").layernorm_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), rows, d, float(eps),
            _build.stream_ptr(x))
    _build.check(rc, "layernorm_forward")
    LAUNCHES["layernorm"] += 1
    return out
