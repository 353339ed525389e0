"""Mixed-precision policies and loss scaling, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/train/precision.py``:

  * ``Policy(param_dtype, compute_dtype, output_dtype)`` and the
    ``policy(str)`` parser, over torch dtypes: ``"mixed_bfloat16"``,
    ``"mixed_float16"``, ``"float32"``, or an explicit
    ``"params=float32,compute=bfloat16,output=float32"`` (the same strings
    as the JAX package's);
  * ``StaticLossScale`` / ``DynamicLossScale`` / ``NoLossScale``;
  * ``attach_loss_scale(state, ls)`` wraps a TrainState's ``model_state``
    in a ``LossScaled`` record for ``make_custom_train_step(loss_scale=
    True)``.

The loss scales keep the JAX NamedTuples' fields in their order (``value``
a 0-d f32 tensor, ``streak`` a 0-d int32 tensor, then the host
``growth_interval``, ``factor`` and ``min_value``), so a checkpoint holds
the same leaves as the JAX package's.  ``adjust`` is device arithmetic
(``torch.where``): it reads nothing back to the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from ..models.gpt import resolve_device

__all__ = ["Policy", "policy", "all_finite", "NoLossScale",
           "StaticLossScale", "DynamicLossScale", "LossScaled",
           "attach_loss_scale"]

_ABBREV = {
    "f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "f64": torch.float64,
}


def _cast(tree, dtype):
    """Floating tensors of a dict, a tuple or list (an ``(x, y)`` batch), or
    a lone tensor -> ``dtype``, as a differentiable cast; anything else
    untouched."""
    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    if isinstance(tree, dict):
        return {k: leaf(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(leaf(v) for v in tree)
    return leaf(tree)


class Policy(NamedTuple):
    """Which dtype each class of tensor lives in."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Floating tensors -> the compute dtype (ints and bools
        untouched)."""
        return _cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast(tree, self.output_dtype)


def policy(spec: Union[str, Policy, None]) -> Policy:
    """Parse a policy string (see the module docstring); keys may be
    abbreviated ``p=/c=/o=``, dtypes ``f32/bf16/f16``."""
    if spec is None:
        return Policy()
    if isinstance(spec, Policy):
        return spec
    s = spec.strip().lower()
    if s in ("mixed_bfloat16", "mixed_bf16"):
        return Policy(torch.float32, torch.bfloat16, torch.float32)
    if s in ("mixed_float16", "mixed_f16"):
        return Policy(torch.float32, torch.float16, torch.float32)
    if s in _ABBREV:
        d = _ABBREV[s]
        return Policy(d, d, d)
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        k = {"p": "param", "params": "param", "param": "param",
             "c": "compute", "compute": "compute",
             "o": "output", "output": "output"}.get(k.strip())
        if k is None or v.strip() not in _ABBREV:
            raise ValueError(f"unparseable policy fragment {part!r} in "
                             f"{spec!r}")
        out[k + "_dtype"] = _ABBREV[v.strip()]
    return Policy(**out)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every floating tensor of a dict
    (or of a lone tensor) is finite.  One reduction a tensor, on the
    device; nothing is read back."""
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    flags = [torch.isfinite(x).all() for x in leaves
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def _unscale(tree, value: torch.Tensor):
    inv = 1.0 / value
    return {k: g * inv.to(g.dtype) for k, g in tree.items()} \
        if isinstance(tree, dict) else tree * inv.to(tree.dtype)


class NoLossScale(NamedTuple):
    """Identity scale: one code path serves scaled and unscaled runs."""

    def scale(self, x):
        return x

    def unscale(self, tree):
        return tree

    def adjust(self, grads_finite):
        del grads_finite
        return self

    @property
    def scale_value(self):
        return torch.ones(())


class StaticLossScale(NamedTuple):
    """Fixed multiplier (a non-finite step is still skipped)."""
    value: torch.Tensor

    @classmethod
    def create(cls, value: float, device="cuda"):
        return cls(torch.tensor(value, dtype=torch.float32,
                                device=resolve_device(device)))

    def scale(self, x):
        return x * self.value.to(x.dtype)

    def unscale(self, tree):
        return _unscale(tree, self.value)

    def adjust(self, grads_finite):
        del grads_finite
        return self

    @property
    def scale_value(self):
        return self.value


class DynamicLossScale(NamedTuple):
    """TF/jmp-style dynamic scale: halve on overflow, double after
    ``growth_interval`` consecutive finite steps."""
    value: torch.Tensor           # 0-d f32, the current scale
    streak: torch.Tensor          # 0-d int32, consecutive finite steps
    growth_interval: int = 2000
    factor: float = 2.0
    min_value: float = 1.0

    @classmethod
    def create(cls, initial: float = 2.0 ** 15, growth_interval: int = 2000,
               factor: float = 2.0, min_value: float = 1.0, device="cuda"):
        device = resolve_device(device)
        return cls(torch.tensor(initial, dtype=torch.float32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device),
                   growth_interval=growth_interval, factor=factor,
                   min_value=min_value)

    def scale(self, x):
        return x * self.value.to(x.dtype)

    def unscale(self, tree):
        return _unscale(tree, self.value)

    def adjust(self, grads_finite: torch.Tensor) -> "DynamicLossScale":
        grow = self.streak + 1 >= self.growth_interval
        new_value = torch.where(
            grads_finite,
            torch.where(grow, self.value * self.factor, self.value),
            torch.clamp(self.value / self.factor, min=self.min_value))
        new_streak = torch.where(grads_finite & ~grow, self.streak + 1,
                                 torch.zeros_like(self.streak))
        return self._replace(value=new_value,
                             streak=new_streak.to(torch.int32))

    @property
    def scale_value(self):
        return self.value


LossScale = Union[NoLossScale, StaticLossScale, DynamicLossScale]


class LossScaled(NamedTuple):
    """``model_state`` wrapper that carries the loss-scale state through
    the TrainState (so it checkpoints and resumes with the rest)."""
    model_state: Any
    loss_scale: Any


def attach_loss_scale(state, loss_scale: LossScale):
    """Wrap ``state.model_state`` so that a ``loss_scale=True`` step can
    thread the scale.  Use before the first step."""
    return state._replace(
        model_state=LossScaled(state.model_state, loss_scale))
