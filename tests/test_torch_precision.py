"""The port's precision policies and loss scales held against the JAX
package's ``train/precision.py``.

- ``policy()`` parses the same strings into the same three dtypes, and
  refuses the same fragments with ``ValueError``.
- ``StaticLossScale`` and ``DynamicLossScale``: ``scale``, ``unscale``
  and the sequence of (value, streak) that ``adjust`` walks over a
  pattern of finite and non-finite steps are equal to the JAX ones,
  exactly (powers of two, one f32 operation each).
- ``all_finite`` over dicts with NaN, inf, integer and empty leaves.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tensorflow_tpu.train import precision as jprec
from distributed_tensorflow_tpu_torch.train import TrainState
from distributed_tensorflow_tpu_torch.train import precision as tprec

torch.set_num_threads(1)

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16", torch.float64: "float64"}


@pytest.mark.parametrize("spec", [
    None, "mixed_bfloat16", "mixed_bf16", "mixed_float16", "mixed_f16",
    "float32", "bf16", "f16", " Mixed_BFloat16 ",
    "params=float32,compute=bfloat16,output=float32",
    "p=f32,c=f16,o=f32", "compute=bf16", "o=f64"])
def test_policy_parses_the_jax_strings(spec):
    got, want = tprec.policy(spec), jprec.policy(spec)
    assert [_NAMES[d] for d in got] == [jnp.dtype(d).name for d in want]
    assert tprec.policy(got) is got


@pytest.mark.parametrize("spec", ["int8", "params=int8", "x=f32",
                                  "mixed_int8", "compute=bf16,foo"])
def test_policy_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError, match="unparseable policy fragment"):
        jprec.policy(spec)
    with pytest.raises(ValueError, match="unparseable policy fragment"):
        tprec.policy(spec)


def test_policy_casts_floating_tensors_only():
    pol = tprec.policy("mixed_bfloat16")
    tree = {"w": torch.ones(3, requires_grad=True),
            "ids": torch.arange(3), "flag": torch.tensor(True)}
    out = pol.cast_to_compute(tree)
    assert out["w"].dtype == torch.bfloat16 and out["w"].requires_grad
    assert out["ids"] is tree["ids"] and out["flag"] is tree["flag"]
    assert pol.cast_to_output(out)["w"].dtype == torch.float32
    assert pol.cast_to_param(out)["w"].dtype == torch.float32
    assert pol.cast_to_compute(torch.ones(2)).dtype == torch.bfloat16


_PATTERN = [True, True, True, False, True, False, False, True, True, True,
            True, True, False, False, False, False, False, True]


@pytest.mark.parametrize("initial,interval,factor,floor",
                         [(2.0 ** 15, 3, 2.0, 1.0), (4.0, 2, 2.0, 1.0),
                          (2.0 ** 127, 2000, 2.0, 1.0), (8.0, 1, 4.0, 0.5)])
def test_dynamic_loss_scale_walks_the_jax_sequence(initial, interval, factor,
                                                   floor):
    kw = dict(growth_interval=interval, factor=factor, min_value=floor)
    got = tprec.DynamicLossScale.create(initial, device="cpu", **kw)
    want = jprec.DynamicLossScale.create(initial, **kw)
    assert got._fields == want._fields
    for finite in _PATTERN:
        got = got.adjust(torch.tensor(finite))
        want = want.adjust(jnp.asarray(finite))
        assert float(got.value) == float(want.value)
        assert int(got.streak) == int(want.streak)
        assert got.value.dtype == torch.float32
        assert got.streak.dtype == torch.int32
    x = np.float32(3.25)
    assert float(got.scale(torch.tensor(x))) == float(want.scale(
        jnp.asarray(x)))
    g = {"a": torch.tensor([1.5, -2.0]), "b": torch.tensor(8.0)}
    ug, uw = got.unscale(g), want.unscale({k: jnp.asarray(v.numpy())
                                          for k, v in g.items()})
    for k in g:
        np.testing.assert_array_equal(ug[k].numpy(), np.asarray(uw[k]))


def test_static_and_no_loss_scale():
    got = tprec.StaticLossScale.create(128.0, device="cpu")
    want = jprec.StaticLossScale.create(128.0)
    for finite in (True, False):
        assert float(got.adjust(torch.tensor(finite)).scale_value) == \
            float(want.adjust(jnp.asarray(finite)).scale_value) == 128.0
    assert float(got.scale(torch.tensor(0.5))) == 64.0
    assert float(got.unscale(torch.tensor(64.0))) == 0.5
    none = tprec.NoLossScale()
    x = torch.tensor(3.0)
    assert none.scale(x) is x and none.unscale(x) is x
    assert none.adjust(torch.tensor(False)) is none
    assert float(none.scale_value) == 1.0


def test_attach_loss_scale_wraps_model_state():
    state = TrainState.create({}, None, model_state={"bn": torch.zeros(1)})
    ls = tprec.DynamicLossScale.create(device="cpu")
    wrapped = tprec.attach_loss_scale(state, ls)
    assert isinstance(wrapped.model_state, tprec.LossScaled)
    assert wrapped.model_state.model_state is state.model_state
    assert wrapped.model_state.loss_scale is ls


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 -float("inf")])
def test_all_finite_matches_jax(bad):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones(4, np.float32), "i": np.arange(3, dtype=np.int32)}
    if bad is not None:
        tree["b"][2] = bad
    got = tprec.all_finite({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jprec.all_finite({k: jnp.asarray(v) for k, v in tree.items()})
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(want) == (bad is None)
    assert bool(tprec.all_finite({"i": torch.arange(2)}))
    assert bool(tprec.all_finite({}))
