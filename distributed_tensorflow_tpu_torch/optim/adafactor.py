"""Adafactor (Shazeer & Stern, 2018), in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/optim/adafactor.py``, the same
rule: for a weight whose two trailing dims are both at least
``min_dim_size_to_factor`` a row EMA ``vr`` and a column EMA ``vc`` of
squared gradients stand for the full second moment; other tensors keep
a full ``v``.  No first moment.  The decay is ``beta2_t = 1 - t^-0.8``;
each update is clipped to RMS ``clipping_threshold``; without a learning
rate the step is ``max(eps2, RMS(p)) * min(relative_step_cap,
1/sqrt(t))``.  A rank >= 3 tensor reduces its RMS per leading slice.
State ``{"vr", "vc", "v"}`` by parameter name, with empty ``[0]`` tensors
in the slots a tensor does not use (the JAX layout).  No kernel: plain
per-tensor arithmetic in f32, the state updated in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .optimizers import (_REGISTRY, Optimizer, OptState, ScalarOrSchedule,
                         _lr_at)

__all__ = ["adafactor"]


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)))


def _slice_rms(x):
    """Per-tensor RMS, per leading slice for rank >= 3 (a layer stack)."""
    if x.dim() >= 3:
        dims = tuple(range(1, x.dim()))
        return torch.sqrt(torch.mean(torch.square(x), dim=dims,
                                     keepdim=True))
    return _rms(x)


def adafactor(learning_rate: Optional[ScalarOrSchedule] = None,
              min_dim_size_to_factor: int = 128,
              decay_exponent: float = 0.8,
              clipping_threshold: float = 1.0,
              eps1: float = 1e-30, eps2: float = 1e-3,
              relative_step_cap: float = 1e-2) -> Optimizer:
    """``learning_rate=None``: the relative step size; a float or schedule
    overrides it."""

    def _factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params) -> OptState:
        vr, vc, v = {}, {}, {}
        for k, p in params.items():
            empty = torch.zeros((0,), device=p.device)
            if _factored(p):
                vr[k] = torch.zeros(p.shape[:-1], device=p.device)
                vc[k] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                    device=p.device)
                v[k] = empty
            else:
                vr[k], vc[k] = empty, empty.clone()
                v[k] = torch.zeros_like(p, dtype=torch.float32)
        return OptState(0, {"vr": vr, "vc": vc, "v": v})

    def update(grads, state: OptState, params):
        if params is None:
            raise ValueError("adafactor needs params at update() (relative "
                             "step + factored reconstruction)")
        count = state.count + 1
        beta2 = 1.0 - math.pow(count, -decay_exponent)
        inner = state.inner
        ups = {}
        for k, g in grads.items():
            p = params[k].detach()
            g = g.detach().float()
            g2 = torch.square(g) + eps1
            if _factored(p):
                vr, vc = inner["vr"][k], inner["vc"][k]
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
                r_inv = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True))
                c_inv = torch.rsqrt(vc)
                u = g * r_inv[..., None] * c_inv[..., None, :]
            else:
                v = inner["v"][k]
                v.mul_(beta2).add_((1 - beta2) * g2)
                u = g * torch.rsqrt(v)
            u = u / torch.clamp(_slice_rms(u) / clipping_threshold,
                                min=1.0)
            if learning_rate is None:
                step_size = (torch.clamp(_slice_rms(p.float()), min=eps2)
                             * min(relative_step_cap,
                                   1.0 / math.sqrt(count)))
            else:
                step_size = _lr_at(learning_rate, count)
            ups[k] = -step_size * u
        return ups, OptState(count, inner)

    return Optimizer(init, update, elementwise=False)


# registered by name here, so that the module dependency stays one-way
_REGISTRY["adafactor"] = adafactor
