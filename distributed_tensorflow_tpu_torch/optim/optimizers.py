"""Optimizers, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/optim/optimizers.py``: ``adam``
(the TF-1.4 update rule: bias correction folded into the learning rate,
epsilon added OUTSIDE the sqrt on the raw second moment)

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p   -= lr_t * m / (sqrt(v) + eps)

and ``adamw`` (decoupled weight decay); ``sgd``, ``momentum``, ``lamb``,
``rmsprop``, ``adagrad``, ``adadelta`` and ``ftrl`` with the JAX
package's update rules; ``with_lr_scale`` / ``get_lr_scale`` /
``set_lr_scale`` (a host-settable learning-rate multiplier) and the
registry ``get``; with ``global_norm``, ``clip_by_global_norm`` and
``apply_updates``.  ``optim/adafactor.py`` registers ``adafactor``.

The optimizers other than Adam have no kernel in the JAX package either
(its only Pallas optimizer is ``fused_adam_update``): here they are
multi-tensor ``torch._foreach_*`` arithmetic over the leaves, in f32,
with their state updated in place.

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

import numpy as np
import torch

from ..ops.kernels import fused as fused_lib

__all__ = ["OptState", "Optimizer", "sgd", "momentum", "adam", "adamw",
           "lamb", "rmsprop", "adagrad", "adadelta", "ftrl",
           "apply_updates", "clip_by_global_norm", "default_decay_mask",
           "global_norm", "get", "with_lr_scale", "get_lr_scale",
           "set_lr_scale"]

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
    # every element's update depends on that element's gradient, state
    # and parameter alone, so it runs on a ZeRO shard as on the whole
    # leaf; lamb and adafactor reduce over each tensor and do not
    elementwise: bool = True


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


def clip_by_global_norm(tree: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """(tree scaled by ``min(1, max_norm / max(norm, 1e-12))``, norm).
    ``norm``: the global norm when the caller has it (a ZeRO step's
    blocks sum their squares over the ``fsdp`` line); else
    ``global_norm(tree)``."""
    norm = global_norm(tree) if norm is None else norm
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


# -- the other optimizers (multi-tensor arithmetic) ------------------------

def _f32(tree: Tree):
    """The leaves of ``tree`` in its key order, as f32 tensors."""
    return [t.detach().float() for t in tree.values()]


def _zeros_like(params: Tree, fill: float = 0.0) -> Dict[str, torch.Tensor]:
    return {k: torch.full_like(p, fill, dtype=torch.float32)
            for k, p in params.items()}


def _sq(xs):
    return torch._foreach_mul(xs, xs)


def sgd(learning_rate: ScalarOrSchedule = 0.01) -> Optimizer:
    def init(params):
        del params
        return OptState(0, ())

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        ups = torch._foreach_mul(_f32(grads), -lr)
        return dict(zip(grads, ups)), OptState(count, ())

    return Optimizer(init, update)


def momentum(learning_rate: ScalarOrSchedule = 0.01, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_like(params))

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        mu = [state.inner[k] for k in grads]
        g = _f32(grads)
        torch._foreach_mul_(mu, beta)
        torch._foreach_add_(mu, g)
        if nesterov:
            ups = torch._foreach_add(torch._foreach_mul(mu, beta), g)
            torch._foreach_mul_(ups, -lr)
        else:
            ups = torch._foreach_mul(mu, -lr)
        return dict(zip(grads, ups)), OptState(count, state.inner)

    return Optimizer(init, update)


def _moments_step(inner, grads, b1: float, b2: float):
    """One EMA step of the (m, v) pair, in place, in f32; returns (g, m,
    v) lists in the grads' key order."""
    g = _f32(grads)
    m = [inner["m"][k] for k in grads]
    v = [inner["v"][k] for k in grads]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(_sq(g), 1 - b2))
    return g, m, v


def lamb(learning_rate: ScalarOrSchedule = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01,
         mask: Optional[Callable[[Tree], Mapping[str, bool]]] = None,
         min_trust: float = 0.0, max_trust: float = 10.0) -> Optimizer:
    """LAMB: the Adam direction (+ decoupled weight decay) scaled by the
    trust ratio ``|p| / |r|`` on the leaves ``mask`` selects (default
    ``default_decay_mask``); the others take the plain Adam step."""
    mask = mask or default_decay_mask

    def update(grads, state: OptState, params):
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        _, m, v = _moments_step(state.inner, grads, b1, b2)
        decay = mask(params)
        r = torch._foreach_div(
            torch._foreach_div(m, bc1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(v, bc2)), eps))
        ups = {}
        for k, rk in zip(grads, r):
            if decay[k]:
                p = params[k].detach().float()
                rk = rk + weight_decay * p
                w_norm = torch.linalg.vector_norm(p)
                r_norm = torch.linalg.vector_norm(rk)
                trust = torch.where(
                    (w_norm > 0) & (r_norm > 0),
                    torch.clamp(w_norm / r_norm, min_trust, max_trust), 1.0)
                ups[k] = -lr * trust * rk
            else:
                ups[k] = -lr * rk
        return ups, OptState(count, state.inner)

    return Optimizer(_moments_init, update, elementwise=False)


def rmsprop(learning_rate: ScalarOrSchedule = 0.001, decay: float = 0.9,
            momentum: float = 0.0, eps: float = 1e-10,
            centered: bool = False) -> Optimizer:
    """tf.train.RMSPropOptimizer's rule: ``mom = momentum * mom + lr * g /
    sqrt(ms + eps)``, the update ``-mom``; ``centered`` divides by
    ``sqrt(ms - mg^2 + eps)``."""

    def init(params):
        inner = {"ms": _zeros_like(params), "mom": _zeros_like(params)}
        if centered:
            inner["mg"] = _zeros_like(params)
        return OptState(0, inner)

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        g = _f32(grads)
        ms = [state.inner["ms"][k] for k in grads]
        mom = [state.inner["mom"][k] for k in grads]
        torch._foreach_mul_(ms, decay)
        torch._foreach_add_(ms, torch._foreach_mul(_sq(g), 1 - decay))
        if centered:
            mg = [state.inner["mg"][k] for k in grads]
            torch._foreach_mul_(mg, decay)
            torch._foreach_add_(mg, torch._foreach_mul(g, 1 - decay))
            denom = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_sub(ms, _sq(mg)), eps))
        else:
            denom = torch._foreach_sqrt(torch._foreach_add(ms, eps))
        torch._foreach_mul_(mom, momentum)
        torch._foreach_add_(mom, torch._foreach_div(
            torch._foreach_mul(g, lr), denom))
        ups = torch._foreach_neg(mom)
        return dict(zip(grads, ups)), OptState(count, state.inner)

    return Optimizer(init, update)


def adagrad(learning_rate: ScalarOrSchedule = 0.01,
            initial_accumulator_value: float = 0.1) -> Optimizer:
    """tf.train.AdagradOptimizer's rule: ``acc += g^2``, the update
    ``-lr * g / sqrt(acc)``."""
    if initial_accumulator_value <= 0:
        raise ValueError("adagrad needs initial_accumulator_value > 0 "
                         "(it is the only thing keeping step 1 finite)")

    def init(params):
        return OptState(0, _zeros_like(params, initial_accumulator_value))

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        g = _f32(grads)
        acc = [state.inner[k] for k in grads]
        torch._foreach_add_(acc, _sq(g))
        ups = torch._foreach_div(torch._foreach_mul(g, -lr),
                                 torch._foreach_sqrt(acc))
        return dict(zip(grads, ups)), OptState(count, state.inner)

    return Optimizer(init, update)


def adadelta(learning_rate: ScalarOrSchedule = 0.001, rho: float = 0.95,
             eps: float = 1e-8) -> Optimizer:
    """tf.train.AdadeltaOptimizer's rule: two EMAs (squared gradients,
    squared updates), the step ``sqrt(acc_d + eps) / sqrt(acc_g + eps) *
    g`` scaled by ``lr``."""

    def init(params):
        return OptState(0, {"acc_g": _zeros_like(params),
                            "acc_d": _zeros_like(params)})

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        g = _f32(grads)
        acc_g = [state.inner["acc_g"][k] for k in grads]
        acc_d = [state.inner["acc_d"][k] for k in grads]
        torch._foreach_mul_(acc_g, rho)
        torch._foreach_add_(acc_g, torch._foreach_mul(_sq(g), 1 - rho))
        delta = torch._foreach_mul(torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(acc_d, eps)),
            torch._foreach_sqrt(torch._foreach_add(acc_g, eps))), g)
        torch._foreach_mul_(acc_d, rho)
        torch._foreach_add_(acc_d, torch._foreach_mul(_sq(delta), 1 - rho))
        ups = torch._foreach_mul(delta, -lr)
        return dict(zip(grads, ups)), OptState(count, state.inner)

    return Optimizer(init, update)


def ftrl(learning_rate: ScalarOrSchedule = 0.001,
         learning_rate_power: float = -0.5,
         initial_accumulator_value: float = 0.1,
         l1_regularization_strength: float = 0.0,
         l2_regularization_strength: float = 0.0) -> Optimizer:
    """FTRL-Proximal, the tf.train.FtrlOptimizer surface: the weight is
    recomputed from the (z, n) state in closed form, so ``params`` is
    needed at update and the update is ``w_new - p``."""
    if initial_accumulator_value < 0:
        raise ValueError("ftrl needs initial_accumulator_value >= 0")
    l1, l2 = l1_regularization_strength, l2_regularization_strength
    p_pow = -learning_rate_power

    def init(params):
        return OptState(0, {"n": _zeros_like(params,
                                             initial_accumulator_value),
                            "z": _zeros_like(params)})

    def update(grads, state: OptState, params=None):
        if params is None:
            raise ValueError("ftrl needs params at update()")
        count = state.count + 1
        lr = _lr_at(learning_rate, count)
        g = _f32(grads)
        p = [params[k].detach().float() for k in grads]
        n = [state.inner["n"][k] for k in grads]
        z = [state.inner["z"][k] for k in grads]
        n_new = torch._foreach_add(n, _sq(g))
        sigma = torch._foreach_div(torch._foreach_sub(
            torch._foreach_pow(n_new, p_pow), torch._foreach_pow(n, p_pow)),
            lr)
        torch._foreach_add_(z, torch._foreach_sub(
            g, torch._foreach_mul(sigma, p)))
        torch._foreach_copy_(n, n_new)
        ups = {}
        for k, zk, nk, pk in zip(grads, z, n, p):
            w = torch.where(torch.abs(zk) <= l1, 0.0,
                            -(zk - torch.sign(zk) * l1)
                            / (torch.pow(nk, p_pow) / lr + 2.0 * l2))
            ups[k] = w - pk
        return ups, OptState(count, state.inner)

    return Optimizer(init, update)


def with_lr_scale(optimizer: Optimizer) -> Optimizer:
    """Wrap an optimizer with a host-settable learning-rate multiplier,
    kept in ``opt_state.inner["scale"]`` (an f32 value on the host): the
    returned update is ``update * scale`` (the JAX wrapper's rule, exact
    for every optimizer linear in its learning rate; ftrl's target is
    damped instead).  At scale 1 the update is returned as it is (a
    multiply by 1 changes no bit), so the common case costs nothing."""

    def init(params):
        return OptState(0, {"scale": 1.0, "inner": optimizer.init(params)})

    def update(grads, state: OptState, params=None):
        scale = state.inner["scale"]
        updates, new_inner = optimizer.update(grads, state.inner["inner"],
                                              params)
        if scale != 1.0:
            names = list(updates)
            scaled = torch._foreach_mul([updates[k] for k in names], scale)
            updates = dict(zip(names, scaled))
        return updates, OptState(state.count + 1,
                                 {"scale": scale, "inner": new_inner})

    return Optimizer(init, update, optimizer.elementwise)


def get_lr_scale(opt_state: OptState) -> float:
    """The multiplier of a ``with_lr_scale``-wrapped opt_state."""
    try:
        return float(opt_state.inner["scale"])
    except (TypeError, KeyError, IndexError):
        raise ValueError("opt_state was not created by a with_lr_scale-"
                         "wrapped optimizer") from None


def set_lr_scale(opt_state: OptState, value: float) -> OptState:
    """The opt_state with the multiplier replaced by ``value`` rounded to
    f32, as the JAX package stores it."""
    get_lr_scale(opt_state)  # structure check
    inner = dict(opt_state.inner)
    inner["scale"] = float(np.float32(value))
    return OptState(opt_state.count, inner)


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adamw": adamw,
    "lamb": lamb,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adadelta": adadelta,
    "ftrl": ftrl,
}


def get(name_or_opt, **kwargs) -> Optimizer:
    """An optimizer by registry name (``compile(optimizer="adam")``), or
    the optimizer itself."""
    if isinstance(name_or_opt, Optimizer):
        return name_or_opt
    try:
        return _REGISTRY[name_or_opt](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name_or_opt!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
