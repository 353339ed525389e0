"""The training step, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/train/step.py``
``make_custom_train_step`` (and ``TrainState`` of ``train/session.py``)
for one device and ``accum_steps=1``: loss and gradients, the global-norm
clip, the optimizer update, the parameters updated in place, the step
advanced.  The JAX step is one jit-compiled program over a donated state;
here PyTorch runs eagerly and the parameters are the model's own tensors,
updated in place under ``torch.no_grad()``, which is what donation buys
there.

Dropout randomness: a ``torch.Generator`` on the parameters' device,
seeded from ``(seed, step)`` for every step: deterministic, resume-stable
and unique per step, as the JAX step folds the step into its key.  The
bits differ from ``jax.random``'s, so parity with the JAX package is
tested at dropout rate 0.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..optim import optimizers as opt_lib

__all__ = ["TrainState", "make_custom_train_step"]


class TrainState(NamedTuple):
    """``step`` counts applied updates (the ``global_step`` analogue);
    ``params`` maps names to the model's parameters; ``model_state``
    holds non-trainable state (empty for GPT)."""
    step: int
    params: Mapping[str, torch.Tensor]
    opt_state: Any
    model_state: Any = ()

    @classmethod
    def create(cls, params, opt_state, model_state=()):
        return cls(step=0, params=params, opt_state=opt_state,
                   model_state=model_state)


def _step_generator(seed: int, step: int,
                    device: torch.device) -> torch.Generator:
    """The dropout generator of step ``step``."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def make_custom_train_step(loss_fn: Callable, optimizer: opt_lib.Optimizer,
                           seed: int = 0,
                           grad_clip_norm: Optional[float] = None
                           ) -> Callable:
    """Build ``step(state, batch) -> (new_state, metrics)``.

    ``loss_fn(params, model_state, batch, generator, train) -> (loss,
    (metrics, new_model_state))`` (``GPT.lm_loss_fn()``).  Metrics are
    device tensors (nothing here reads them back to the host): ``loss``,
    the loss function's own, and ``grad_norm`` (before clipping) when
    ``grad_clip_norm`` is set.  The state's parameters are updated in
    place; the returned state holds the same tensors."""
    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        names = list(params)
        device = params[names[0]].device
        gen = _step_generator(seed, state.step, device)
        loss, (metrics, new_model_state) = loss_fn(
            params, state.model_state, batch, gen, True)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()}}
        if grad_clip_norm is not None:
            grads, gnorm = opt_lib.clip_by_global_norm(grads, grad_clip_norm)
            metrics["grad_norm"] = gnorm
        updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                  params)
        opt_lib.apply_updates(params, updates)
        return TrainState(step=state.step + 1, params=params,
                          opt_state=new_opt_state,
                          model_state=new_model_state), metrics

    return step
