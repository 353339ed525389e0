"""Exponential moving average of parameters, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/optim/ema.py``: a shadow copy
``s <- d*s + (1-d)*p`` of every parameter, to evaluate or serve from.

  * ``ema(decay)``: a standalone tracker (init/update/value).
  * ``with_ema(optimizer, decay)``: an Optimizer wrapper whose shadow rides
    inside ``opt_state`` (``opt_state.inner["ema"]``), so the step builder,
    checkpoints and sessions carry it unchanged; ``ema_params`` reads the
    averaged parameters out.

Both debias by default (divide by ``1 - d^t``), as the JAX package does.

Design: the shadow is a dict of f32 tensors under the parameters' names,
updated in place with multi-tensor ops (no kernel of the JAX package runs
here: its update is plain elementwise XLA).  ``count``, ``decay`` and
``debias`` are host values, as the port's ``OptState.count`` is;
``decay`` is kept rounded to float32, the type the JAX state holds it in,
so the arithmetic and a checkpoint round trip agree with it.
``with_ema.update`` folds the post-update parameters ``p + u`` into the
shadow, as the JAX wrapper does, with the caller's contract unchanged
(``update``, then ``apply_updates``).  It folds ``p`` and ``u`` as two
multi-tensor adds, ``s <- d*s + (1-d)*p + (1-d)*u``, so no copy of the
parameters is built; that differs from folding the rounded ``p + u`` by
round-off only.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..parallel import data_parallel as dp_lib
from ..parallel.sharding import ShardedDict
from .optimizers import Optimizer, OptState

__all__ = ["EMAState", "ema", "with_ema", "ema_params"]

Tree = Mapping[str, torch.Tensor]


class EMAState(NamedTuple):
    count: int                      # updates folded in
    decay: float                    # float32-rounded decay
    debias: bool
    shadow: Dict[str, torch.Tensor]


def _update_shadow(state: EMAState, params: Tree,
                   updates: Optional[Tree] = None) -> EMAState:
    """Fold ``params`` (plus ``updates``, when given) into the shadow, in
    place, in f32."""
    d = np.float32(state.decay)
    alpha = float(np.float32(1) - d)
    names = list(state.shadow)
    shadow = [state.shadow[k] for k in names]
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, [params[k].detach() for k in names],
                        alpha=alpha)
    if updates is not None:
        torch._foreach_add_(shadow, [updates[k] for k in names],
                            alpha=alpha)
    return state._replace(count=state.count + 1)


def _value(state: EMAState) -> Dict[str, torch.Tensor]:
    """The averaged parameters (new tensors): the shadow, divided by
    ``1 - d^t`` when debiased (t = count, at least 1), in f32."""
    scale = np.float32(1)
    if state.debias:
        scale = np.float32(1) / (np.float32(1) - np.float32(state.decay)
                                 ** np.float32(max(state.count, 1)))
    return {k: s * float(scale) for k, s in state.shadow.items()}


class _EMA(NamedTuple):
    init: Any
    update: Any
    value: Any


def ema(decay: float = 0.999, debias: bool = True) -> _EMA:
    """Standalone tracker: ``state = e.init(params)``, ``state =
    e.update(state, params)`` each step, ``e.value(state)`` -> averaged
    params."""

    def init(params: Tree) -> EMAState:
        return EMAState(0, float(np.float32(decay)), bool(debias),
                        {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()})

    def update(state: EMAState, params: Tree) -> EMAState:
        return _update_shadow(state, params)

    return _EMA(init, update, _value)


def with_ema(optimizer: Optimizer, decay: float = 0.999,
             debias: bool = True) -> Optimizer:
    """Wrap an Optimizer so that the post-update parameters feed a shadow
    average carried in ``opt_state.inner["ema"]`` (``opt_state.inner
    ["opt"]`` holds the wrapped optimizer's state).  ``update`` needs the
    parameters (before the update) and folds ``params + updates`` into
    the shadow."""
    tracker = ema(decay, debias)

    def init(params: Tree) -> OptState:
        return OptState(0, {"opt": optimizer.init(params),
                            "ema": tracker.init(params)})

    def update(grads, state: OptState, params=None):
        if params is None:
            raise ValueError("with_ema needs params passed to update()")
        updates, new_inner = optimizer.update(grads, state.inner["opt"],
                                              params)
        new_ema = _update_shadow(state.inner["ema"], params, updates)
        return updates, OptState(state.count + 1,
                                 {"opt": new_inner, "ema": new_ema})

    return Optimizer(init, update, optimizer.elementwise)


def ema_params(opt_state: OptState) -> Dict[str, torch.Tensor]:
    """The averaged parameters of a ``with_ema`` optimizer's state.  A
    shadow cut by ``train.shard_train_state`` over ``fsdp`` is gathered
    over its line into whole tensors (one all-gather; every rank of the
    line must call), for eval and ``generate``, and beside a ``tensor``
    axis its ``fsdp`` parts into tensor blocks (the same all-gather);
    one cut over ``tensor`` alone stays the blocks, which a
    tensor-parallel model reads; a MoE bank cut
    over ``expert`` is gathered whole along its expert dim over that line
    (one all-gather), as ``train.gather_params`` does; a pipeline
    stage's gathers every stage's layers over the ``pipe`` line into the
    whole model's (one all-gather), which a model built without the
    pipeline loads."""
    try:
        state = opt_state.inner["ema"]
    except (TypeError, KeyError):
        raise ValueError("opt_state does not carry an EMA (build the "
                         "optimizer with optim.with_ema)") from None
    value = _value(state)
    shadow = state.shadow
    if not isinstance(shadow, ShardedDict):
        return value
    if shadow.line == "pipe":
        return dp_lib.gather_stages(value, shadow.layout, shadow.mesh)
    # a tensor line's blocks stay; fsdp's and expert's gather
    for line in ("fsdp", "expert"):
        if line in (shadow.line or ""):
            return dp_lib.gather_shards(value, shadow.layout, shadow.mesh,
                                        axis=line)
    return value
