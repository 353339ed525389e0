"""Optimizers, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/optim/optimizers.py``, the part
the causal-LM training path runs: ``adam`` (the TF-1.4 update rule: bias
correction folded into the learning rate, epsilon added OUTSIDE the sqrt
on the raw second moment)

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p   -= lr_t * m / (sqrt(v) + eps)

and ``adamw`` (decoupled weight decay), with ``global_norm``,
``clip_by_global_norm`` and ``apply_updates``.

Design: the JAX package's ``init(params) -> state`` and ``update(grads,
state, params) -> (updates, state)`` pair over dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``).  Every leaf's step is
one call of ``ops.kernels.fused.fused_adam_update`` (``tf14_eps=True``,
``return_delta=True``): a launch of the Adam kernel for a CUDA tensor,
the plain version for a CPU tensor.  The moments are f32 and are updated
in place by that kernel, so ``update`` consumes the state it is given.
The step count is a host int, so the bias correction needs no device
read.

adamw folds its decay ``lr * wd * p`` into the kernel (the kernel's
``weight_decay`` term) where the JAX package subtracts it after the Adam
update in a separate op: the same f32 operations, so the two agree to
the last bits up to the order of one subtraction.

Decay mask: the JAX default is ``p.ndim > 1`` on its parameter tree, in
which every decoder leaf is stacked over layers with a leading ``[L]``
axis.  So its per-layer biases and LayerNorm scales (``[L, d]``) ARE
decayed, and only the unstacked ``ln_f`` gamma/beta and other 1-d leaves
are not.  The port keeps layer ``i``'s slice of such a leaf as
``blocks.<i>.<path>``; ``default_decay_mask`` counts the layer axis back
in, so the mask is the JAX tree's, not one re-derived from the port's own
shapes.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Union

import torch

from ..ops.kernels import fused as fused_lib

__all__ = ["OptState", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "default_decay_mask", "global_norm"]

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]
Tree = Mapping[str, torch.Tensor]

_STACKED = re.compile(r"blocks\.\d+\.")


class OptState(NamedTuple):
    count: int                  # step counter (the global_step cursor)
    inner: Any                  # optimizer-specific state


class Optimizer(NamedTuple):
    init: Callable[[Tree], OptState]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def _lr_at(lr: ScalarOrSchedule, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def default_decay_mask(params: Tree) -> Dict[str, bool]:
    """The JAX ``adamw`` default mask, ``ndim > 1`` on the JAX tree: a
    per-layer slice ``blocks.<i>.<path>`` has one axis more there."""
    return {name: p.dim() + (1 if _STACKED.match(name) else 0) > 1
            for name, p in params.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float):
    """(tree scaled by ``min(1, max_norm / max(norm, 1e-12))``, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return ({k: (g.float() * scale).to(g.dtype) for k, g in tree.items()},
            norm)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` in f32, cast to each parameter's type, written into the
    parameters in place; returns ``params``."""
    for name, p in params.items():
        u = updates[name]
        if p.dtype == torch.float32:
            p.add_(u.float())
        else:
            p.copy_((p.float() + u.float()).to(p.dtype))
    return params


def _moments_init(params: Tree) -> OptState:
    """Adam-family state: f32 first/second moments + step count."""
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
    return OptState(0, {"m": zeros(), "v": zeros()})


def _adam_update(grads: Tree, state: OptState, params: Tree,
                 learning_rate: ScalarOrSchedule, b1: float, b2: float,
                 eps: float, decay: Optional[Mapping[str, bool]],
                 weight_decay: float):
    if params is None:
        raise ValueError("adam needs params at update()")
    count = state.count + 1
    lr = _lr_at(learning_rate, count)
    m, v = state.inner["m"], state.inner["v"]
    updates = {}
    for name, p in params.items():
        wd = weight_decay if decay is not None and decay[name] else 0.0
        updates[name], _, _ = fused_lib.fused_adam_update(
            p.detach(), grads[name].float().contiguous(), m[name], v[name],
            count, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
            tf14_eps=True, return_delta=True, out=(None, m[name], v[name]))
    return updates, OptState(count, {"m": m, "v": v})


def adam(learning_rate: ScalarOrSchedule = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """TF-1.4-parity Adam; every leaf is one Adam kernel launch."""
    def update(grads, state: OptState, params=None):
        return _adam_update(grads, state, params, learning_rate, b1, b2,
                            eps, None, 0.0)
    return Optimizer(_moments_init, update)


def adamw(learning_rate: ScalarOrSchedule = 1e-3, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
          mask: Optional[Callable[[Tree], Mapping[str, bool]]] = None
          ) -> Optimizer:
    """Adam with decoupled weight decay ``lr * wd * p`` on the leaves
    ``mask(params)`` selects (default: ``default_decay_mask``, the JAX
    tree's ``ndim > 1``)."""
    mask = mask or default_decay_mask

    def update(grads, state: OptState, params):
        return _adam_update(grads, state, params, learning_rate, b1, b2,
                            eps, mask(params), weight_decay)
    return Optimizer(_moments_init, update)
