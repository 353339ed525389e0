"""The port's optimizers, held against the JAX package's.

Every optimizer of the registry (``sgd``, ``momentum``, ``adam``,
``adamw``, ``lamb``, ``rmsprop``, ``adagrad``, ``adadelta``, ``ftrl``,
and ``adafactor``, which registers itself), at its defaults and with its
options (nesterov, centered with momentum, L1/L2, a schedule, an explicit
learning rate), runs 3 steps on the same parameters and gradients (numpy,
from a seed) in both packages: the parameters after every step and the
optimizer state after the last are within ``1e-6 * max(1, max |want|)``
(f32 arithmetic in another order; ftrl's ``z`` reaches |4e3|, where one
f32 ulp is 5e-4).  The parameters are a [130, 129] matrix (adafactor
factors it), a [3, 4, 5] tensor (a per-slice RMS), a [4, 6] matrix and a
vector.  ``with_lr_scale`` is held to the JAX wrapper at scale 0.5 and
0, and at 1 (where the port returns the update as it is);
``get_lr_scale``/``set_lr_scale`` round the value to f32 as the JAX
package stores it and refuse a state that is not wrapped; ``get`` knows
the same names and passes an optimizer through.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu_torch.optim import optimizers as topt

torch.set_num_threads(1)

TOL = 1e-6
STEPS = 3
SHAPES = {"w": (130, 129), "t": (3, 4, 5), "k": (4, 6), "b": (7,)}

CASES = {
    "sgd": {},
    "sgd_schedule": {"learning_rate": lambda c: 0.1 / c},
    "momentum": {},
    "momentum_nesterov": {"nesterov": True, "beta": 0.8},
    "adam": {},
    "adamw": {},
    "lamb": {},
    "lamb_clipped": {"max_trust": 0.5, "weight_decay": 0.1},
    "rmsprop": {},
    "rmsprop_centered": {"centered": True, "momentum": 0.9},
    "adagrad": {},
    "adadelta": {"learning_rate": 1.0},
    "ftrl": {},
    "ftrl_l1_l2": {"learning_rate": 0.1, "l1_regularization_strength": 0.01,
                   "l2_regularization_strength": 0.1},
    "adafactor": {},
    "adafactor_lr": {"learning_rate": 0.01, "min_dim_size_to_factor": 4},
}


def _name(case):
    for base in ("adafactor", "momentum", "rmsprop", "adagrad", "adadelta",
                 "adamw", "adam", "lamb", "ftrl", "sgd"):
        if case.startswith(base):
            return base


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * scale, err_msg=what)


def _compare_state(got, want, path="state"):
    """Walk the port's opt state beside the JAX one: dicts by key,
    tuples by position, leaves within TOL (host numbers too)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _compare_state(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_state(g, w, f"{path}[{i}]")
    else:
        g = got.detach().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        _close(g, want, path)


def _run(jo, to, params, grads, jscale=None):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    if jscale is not None:
        js = jopt.set_lr_scale(js, jscale)
        ts = topt.set_lr_scale(ts, jscale)
    for g in grads:
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                           tp)
        topt.apply_updates(tp, tu)
        for k in params:
            _close(tp[k].numpy(), jp[k], k)
    _compare_state(ts, js)
    return tp


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_equals_jax(case):
    name, kw = _name(case), CASES[case]
    params, grads = _inputs()
    _run(jopt.get(name, **kw), topt.get(name, **kw), params, grads)


@pytest.mark.parametrize("name", ["adam", "sgd", "momentum", "rmsprop",
                                  "adafactor", "ftrl"])
@pytest.mark.parametrize("scale", [0.5, 0.0, 1.0])
def test_with_lr_scale_equals_jax(name, scale):
    params, grads = _inputs(1)
    tp = _run(jopt.with_lr_scale(jopt.get(name)),
              topt.with_lr_scale(topt.get(name)), params, grads,
              jscale=scale)
    if scale == 0.0:      # every update multiplied by 0
        for k, v in params.items():
            np.testing.assert_array_equal(tp[k].numpy(), v)


def test_lr_scale_state_surgery():
    tp = {"w": torch.zeros(3)}
    state = topt.with_lr_scale(topt.adam()).init(tp)
    jstate = jopt.with_lr_scale(jopt.adam()).init({"w": jnp.zeros(3)})
    assert topt.get_lr_scale(state) == jopt.get_lr_scale(jstate) == 1.0
    for v in (0.1, 1 / 3, 2.5):
        assert topt.get_lr_scale(topt.set_lr_scale(state, v)) == \
            jopt.get_lr_scale(jopt.set_lr_scale(jstate, v))
    for lib, st in ((topt, topt.adam().init(tp)),
                    (jopt, jopt.adam().init({"w": jnp.zeros(3)}))):
        with pytest.raises(ValueError, match="with_lr_scale"):
            lib.get_lr_scale(st)
        with pytest.raises(ValueError, match="with_lr_scale"):
            lib.set_lr_scale(st, 0.5)


def test_registry_names_and_get():
    assert sorted(topt._REGISTRY) == sorted(jopt._REGISTRY)
    assert "adafactor" in topt._REGISTRY
    opt = topt.sgd(0.5)
    assert topt.get(opt) is opt
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get("nope")
    with pytest.raises(ValueError, match="initial_accumulator_value"):
        topt.adagrad(initial_accumulator_value=0.0)
    with pytest.raises(ValueError, match="initial_accumulator_value"):
        topt.ftrl(initial_accumulator_value=-1.0)
