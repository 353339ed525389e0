"""``with_ema`` keeps the JAX package's contract: ``update``, then
``apply_updates``, and the shadow follows the parameters.

- ``with_ema(adamw(0.1), decay=0.9)``, 3 steps of ``update`` and
  ``apply_updates`` alone (no step builder) on a tree of ones with
  gradients of ones, then of twos:
  ``ema_params`` (debiased and not), the shadow, its count and the
  parameters against the JAX optimizer within 1e-6 absolute (the shadow
  folds ``p`` and ``u`` as two adds where JAX folds the rounded ``p +
  u``: round-off only).  With gradients of ones throughout, the JAX
  side reads 0.79299 on the undecayed leaf.
- ``make_train_step(optimizer=with_ema(adam()))`` on ``example.py``'s MLP
  at dropout 0, 5 steps: ``ema_params`` against the JAX step's within
  1e-6, and the EMA count equals the step count (the step folds the
  shadow once a step).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import ops as jops
from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu_torch import ops as tops
from distributed_tensorflow_tpu_torch import optim as topt
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.models.convert import (
    stack_params_from_jax, stack_params_to_jax)

torch.set_num_threads(1)

TOL = 1e-6


@pytest.mark.parametrize("debias,grads", [(True, (1.0, 1.0, 1.0)),
                                          (True, (1.0, 2.0, 3.0)),
                                          (False, (1.0, 2.0, 3.0))])
def test_update_then_apply_moves_the_shadow_as_jax(debias, grads):
    shapes = {"w": (4, 5), "b": (5,)}
    jparams = {k: jnp.ones(s, jnp.float32) for k, s in shapes.items()}
    params = {k: torch.ones(s) for k, s in shapes.items()}
    jo = jopt.with_ema(jopt.adamw(0.1), decay=0.9, debias=debias)
    to = topt.with_ema(topt.adamw(0.1), decay=0.9, debias=debias)
    jstate, tstate = jo.init(jparams), to.init(params)
    for g in grads:
        ju, jstate = jo.update({k: jnp.full(s, g, jnp.float32)
                                for k, s in shapes.items()}, jstate,
                               jparams)
        jparams = jopt.apply_updates(jparams, ju)
        tu, tstate = to.update({k: torch.full(s, g)
                                for k, s in shapes.items()}, tstate, params)
        topt.apply_updates(params, tu)
    assert tstate.inner["ema"].count == int(jstate.inner["ema"].count) == 3
    got, want = topt.ema_params(tstate), jopt.ema_params(jstate)
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tstate.inner["ema"].shadow[k].numpy(),
                                   np.asarray(jstate.inner["ema"].shadow[k]),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=0)
    if debias and grads == (1.0, 1.0, 1.0):
        assert float(want["b"][0]) == pytest.approx(0.79299, abs=1e-5)
    assert float(got["w"].abs().min()) > 0.1      # the parent gave 0.0


def _models():
    def build(lib):
        return lib.serial(lib.Dense(128, activation="relu"),
                          lib.Dropout(0.0),
                          lib.Dense(128, activation="relu"),
                          lib.Dropout(0.0),
                          lib.Dense(32, activation="sigmoid"))
    return build(jops), build(tops)


def test_make_train_step_with_ema_matches_jax_on_the_xor_mlp():
    jm, tm = _models()
    jo, to = jopt.with_ema(jopt.adam()), topt.with_ema(topt.adam())
    jstate = jtrain.init_train_state(jm, jo, jax.random.PRNGKey(0), (64,))
    params = stack_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    tstate = ttrain.TrainState.create(params, to.init(params), {})
    jstep = jtrain.make_train_step(jm, "mse", jo)
    tstep = ttrain.make_train_step(tm, "mse", to)
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = rng.integers(0, 2, (50, 64)).astype(np.float32)
        y = np.bitwise_xor(x[:, :32].astype(int),
                           x[:, 32:].astype(int)).astype(np.float32)
        jstate, _ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, _ = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
    assert tstate.step == 5
    assert tstate.opt_state.inner["ema"].count == 5
    got = stack_params_to_jax(topt.ema_params(tstate.opt_state))
    want = jopt.ema_params(jstate.opt_state)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=str(path))
