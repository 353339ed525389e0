"""LayerNorm, RMSNorm and one Adam(W) step: CUDA kernels and plain versions.

LayerNorm replaces the Pallas kernel ``_layernorm_forward`` of
``distributed_tensorflow_tpu/ops/pallas/fused.py`` (body
``_layernorm_kernel``), reached there through ``fused_layernorm``.  The
kernel is ``csrc/layernorm.cu``: one warp per row, the row read once into
registers with 16-byte loads, mean and centred variance by warp shuffles
alone (no shared memory, no barrier), 16-byte stores; a looped scalar
path for a d or an address that is not 16-byte aligned or a row above
the register budget.  Its backward recomputes through the plain version
under autograd, as the JAX ``_layernorm_bwd`` takes ``jax.vjp`` of its
XLA reference: the JAX package has no backward kernel, so neither has
the port.

RMSNorm (the Llama block norm) replaces the Pallas kernel
``_rmsnorm_forward`` of the same file (body ``_rmsnorm_kernel``),
reached there through ``fused_rmsnorm``.  The kernel is
``csrc/rmsnorm.cu``: the row read once into registers with 16-byte
loads, gamma kept in registers for every row a block does, an f32 sum
of squares by warp shuffles and one shared-memory exchange a row,
output in the input's type.  Few rows (up to the SM count) get one
block a row of up to 512 threads; many rows get as many narrow blocks
as the card holds, each walking rows with the next row's loads in flight
(the wrapper passes the SM count, read once per device); a looped path
for a d or an address that is not 16-byte aligned or a row above 16 KB.
Its backward recomputes through ``rmsnorm_plain`` under autograd, as the
JAX ``_rmsnorm_bwd`` takes ``jax.vjp`` of its reference.

``fused_adam_update`` replaces the Pallas kernel of the same name (body
``_adam_kernel``).  The kernel is ``csrc/adam.cu``: one elementwise pass
over the flat f32 tensor, four streams in and three out, 16-byte loads;
the bias correction is folded into ``lr_t``/``eps_t`` on the host, and
the outputs may be the inputs' own buffers (an in-place update).

What bounds the H100 here: bytes for Adam (28 bytes an element for about
12 flops, 85% of the byte bound at the word embedding); for the norms,
whose rows at the serving paths' shapes (8 to 256 rows of d = 768 for
LayerNorm, 8 or 32 rows of d = 4096 for RMSNorm) are a few kilobytes, the
launch, and at the prompt prefills' rows (RMSNorm's 2048 rows of d =
4096: 33.5 MB in and out) bytes again.  A launch costs the host's issue
time and the kernel's latency.
The norm wrappers keep the host's share small: their C functions are
bound once (``_build.bind``, as Adam's is), their guards are one
expression, and when no input needs a gradient (serving, under
``torch.no_grad()``) they launch directly, without the
``autograd.Function``; LayerNorm's latency is a handful of dependent
steps (one 16-byte load per vector, ten shuffles, the stores).

Dispatch is by the tensor's device: the plain version (the f32 formulas
of the JAX package, not ``F.layer_norm`` or ``torch.optim``) for a CPU
tensor, the kernel or an exception for a CUDA tensor.  ``LAUNCHES``
counts kernel launches ("layernorm", "rmsnorm", "adam").
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["LAUNCHES", "adam_plain", "fused_adam_update", "fused_layernorm",
           "fused_rmsnorm", "layernorm_plain", "rmsnorm_plain"]

# kernel launches ("layernorm", "rmsnorm", "adam")
LAUNCHES: collections.Counter = collections.Counter()


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32, output in x's type."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


_LAYERNORM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p]


def _layernorm_launch(x, gamma, beta, eps):
    # one cheap test on the launch path; the message is worked out only
    # when it fails
    d = x.shape[-1]
    dev = x.get_device()
    if (x.dtype is not torch.bfloat16 and x.dtype is not torch.float32) \
            or gamma.get_device() != dev or beta.get_device() != dev \
            or gamma.dtype is not torch.float32 \
            or beta.dtype is not torch.float32 \
            or gamma.shape != (d,) or beta.shape != (d,) \
            or not (x.is_contiguous() and gamma.is_contiguous()
                    and beta.is_contiguous()):
        _layernorm_refuse(x, gamma, beta)
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rc = _build.bind("layernorm", "layernorm_forward", _LAYERNORM_ARGS)(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        x.dtype is torch.bfloat16, rows, d, float(eps), _build.stream_ptr(x))
    _build.check(rc, "layernorm_forward")
    LAUNCHES["layernorm"] += 1
    return out


def _layernorm_refuse(x, gamma, beta):
    """Raise with what the LayerNorm kernel cannot take."""
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32; got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32 \
                or t.shape != (d,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{d}] on "
                             f"{x.device}")
    raise ValueError("x must be contiguous")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _LayerNorm(torch.autograd.Function):
    """Kernel forward; backward through ``layernorm_plain`` recomputed
    under autograd (residuals x, gamma, beta, as in the JAX package)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return _layernorm_launch(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, gamma, beta)]
            y = layernorm_plain(*inputs, ctx.eps)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of x [..., d] with f32 gamma/beta [d]; differentiable.
    A CUDA call that autograd would not record launches the kernel
    directly; one it would goes through ``_LayerNorm``."""
    if x.is_cpu:
        return layernorm_plain(x, gamma, beta, eps)
    if _needs_grad(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, float(eps))
    return _layernorm_launch(x, gamma, beta, eps)


# ------------------------------------------------------------- RMSNorm

def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * gamma`` in f32, output in x's type
    (the JAX package's ``_rmsnorm_reference``)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * gamma.float()).to(x.dtype)


# (x, gamma, out, is_bf16, rows, d, eps, the card's SM count, stream)
_RMSNORM_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

# SM count by device index, read once per device
_SMS: dict = {}


def _sm_count(dev: int) -> int:
    n = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _rmsnorm_launch(x, gamma, eps):
    # one cheap test on the launch path; the message is worked out only
    # when it fails
    d = x.shape[-1]
    dev = x.get_device()
    if (x.dtype is not torch.bfloat16 and x.dtype is not torch.float32) \
            or gamma.get_device() != dev \
            or gamma.dtype is not torch.float32 or gamma.shape != (d,) \
            or not (x.is_contiguous() and gamma.is_contiguous()):
        _rmsnorm_refuse(x, gamma)
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rc = _build.bind("rmsnorm", "rmsnorm_forward", _RMSNORM_ARGS)(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(),
        x.dtype is torch.bfloat16, rows, d, float(eps),
        _SMS.get(dev) or _sm_count(dev), _build.stream_ptr(x))
    _build.check(rc, "rmsnorm_forward")
    LAUNCHES["rmsnorm"] += 1
    return out


def _rmsnorm_refuse(x, gamma):
    """Raise with what the RMSNorm kernel cannot take."""
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32; got {x.dtype}")
    if gamma.device != x.device or gamma.dtype != torch.float32 \
            or gamma.shape != (d,) or not gamma.is_contiguous():
        raise ValueError(f"gamma must be a contiguous f32 [{d}] on "
                         f"{x.device}")
    raise ValueError("x must be contiguous")


class _RMSNorm(torch.autograd.Function):
    """Kernel forward; backward through ``rmsnorm_plain`` recomputed
    under autograd (residuals x and gamma, as in the JAX package)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _rmsnorm_launch(x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, gamma)]
            y = rmsnorm_plain(*inputs, ctx.eps)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def fused_rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of x [..., d] with an f32 gamma [d]; differentiable.
    A CUDA call that autograd would not record launches the kernel
    directly; one it would goes through ``_RMSNorm``."""
    if x.is_cpu:
        return rmsnorm_plain(x, gamma, eps)
    if _needs_grad(x, gamma):
        return _RMSNorm.apply(x, gamma, float(eps))
    return _rmsnorm_launch(x, gamma, eps)


# ---------------------------------------------------------------- Adam

def _adam_scalars(step: int, lr: float, b1: float, b2: float, eps: float,
                  tf14_eps: bool):
    """(lr_t, eps_t) in f32, as the JAX wrapper folds them:
    ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``; ``eps_t = eps`` with
    ``tf14_eps`` (eps on raw v, the TF-1.4 rule), else
    ``eps * sqrt(1 - b2^t)``."""
    f = np.float32
    t = f(step)
    bc1 = f(1.0) - np.power(f(b1), t)
    bc2 = f(1.0) - np.power(f(b2), t)
    lr_t = f(lr) * np.sqrt(bc2) / bc1
    eps_t = f(eps) if tf14_eps else f(eps) * np.sqrt(bc2)
    return float(lr_t), float(eps_t)


def adam_plain(params: torch.Tensor, grads: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, step: int, lr: float = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, tf14_eps: bool = False,
               return_delta: bool = False, out=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the Adam kernel, the same formula in torch ops
    (f32).  ``out``: as for ``fused_adam_update``."""
    lr_t, eps_t = _adam_scalars(step, lr, b1, b2, eps, tf14_eps)
    p, g = params.float(), grads.float()
    new_m = b1 * m.float() + (1.0 - b1) * g
    new_v = b2 * v.float() + (1.0 - b2) * g * g
    u = -lr_t * (new_m / (torch.sqrt(new_v) + eps_t))
    if weight_decay:
        u = u - float(np.float32(lr) * np.float32(weight_decay)) * p
    results = (u if return_delta else p + u, new_m, new_v)
    if out is None:
        return results
    return tuple(r if o is None else o.copy_(r)
                 for r, o in zip(results, out))


_ADAM_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [
    ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_void_p]


def fused_adam_update(params: torch.Tensor, grads: torch.Tensor,
                      m: torch.Tensor, v: torch.Tensor, step: int,
                      lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.0,
                      tf14_eps: bool = False, return_delta: bool = False,
                      out: Optional[Sequence[Optional[torch.Tensor]]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exact Adam(W) step for one f32 tensor.

    ``step`` is the 1-based step count (a host int).  Bias correction is
    folded into ``lr_t``/``eps_t``; ``tf14_eps=True`` applies eps
    unscaled on raw v (the TF-1.4 rule ``optim.adam`` documents).
    ``weight_decay`` subtracts ``lr * wd * p``.  ``return_delta=True``
    returns ``new_p - p`` in slot 0.  ``out``: optional (p_out, m_out,
    v_out), any of them None (allocated) or a tensor to write, which may
    be the input's own buffer.  Returns (new_params_or_delta, new_m,
    new_v)."""
    if params.device.type == "cpu":
        return adam_plain(params, grads, m, v, step, lr, b1, b2, eps,
                          weight_decay, tf14_eps, return_delta, out)
    out = tuple(out) if out is not None else (None, None, None)
    tensors = {"params": params, "grads": grads, "m": m, "v": v}
    out = tuple(torch.empty_like(params) if o is None else o for o in out)
    tensors.update(zip(("p_out", "m_out", "v_out"), out))
    for name, t in tensors.items():
        if t.device != params.device or t.dtype != torch.float32 \
                or t.shape != params.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 "
                             f"{tuple(params.shape)} on {params.device}")
    if step < 1:
        raise ValueError(f"step is 1-based; got {step}")
    lr_t, eps_t = _adam_scalars(step, lr, b1, b2, eps, tf14_eps)
    n = params.numel()
    if n:
        rc = _build.bind("adam", "adam_update", _ADAM_ARGS)(
            *(t.data_ptr() for t in (params, grads, m, v, *out)), n, b1,
            1.0 - b1, b2, 1.0 - b2, lr_t, eps_t, lr, weight_decay,
            int(return_delta), _build.stream_ptr(params))
        _build.check(rc, "adam_update")
        LAUNCHES["adam"] += 1
    return out
