"""The port's Adam kernel (plain version), optimizers and LayerNorm
gradient held against the JAX package.

- ``fused_adam_update`` (its plain version on the CPU) against the JAX
  ``fused_adam_update`` (Pallas, interpret mode): tf14_eps on and off,
  weight decay, return_delta, ragged sizes.  Tolerance: 1e-5 relative
  plus 1e-7 absolute (the same f32 formula; pow and sqrt may round
  differently by an ulp).
- ``adamw`` + ``clip_by_global_norm`` + ``apply_updates`` against the JAX
  ``optim`` over a GPT parameter tree, two steps: params and m/v per leaf
  within 1e-5 absolute, the global norm within 1e-5 relative.  The decay
  mask must be the JAX tree's ``ndim > 1`` on its layer-stacked leaves.
- LayerNorm's gradient (autograd through the plain version, what the
  kernel's backward recomputes) against ``jax.vjp`` of the JAX
  ``fused_layernorm``: 1e-4 absolute.
- Every learning-rate schedule at counts 0..50 against the JAX
  schedule: 1e-6 relative plus 1e-9 absolute (both compute in float32;
  ``cos`` and ``pow`` may round differently by an ulp).
- ``with_ema(adamw)`` over 3 steps (``update``, then ``apply_updates``,
  as the step builder calls them) and
  ``ema_params`` (debiased or not) against the JAX optimizer: params,
  moments and the shadow within 1e-5 absolute, the counts and the stored decay equal; the standalone
  ``ema`` tracker likewise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu import optim as jema
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.optim import schedules as jsched
from distributed_tensorflow_tpu.ops.pallas import fused as jfused
from distributed_tensorflow_tpu_torch import optim as topt
from distributed_tensorflow_tpu_torch.optim import schedules as tsched
from distributed_tensorflow_tpu_torch.models.convert import (
    gpt_params_from_jax, gpt_params_to_jax)
from distributed_tensorflow_tpu_torch.models.gpt import gpt_tiny
from distributed_tensorflow_tpu_torch.ops.kernels import fused as tfused

torch.set_num_threads(1)

ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-7
TREE_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("shape", [(10, 100), (7, 13), (257,)],
                         ids=["lanes", "ragged", "vector"])
@pytest.mark.parametrize("tf14,wd,delta", [(True, 0.0, True),
                                           (False, 0.0, False),
                                           (False, 0.01, True),
                                           (True, 0.05, False)])
def test_adam_matches_pallas_kernel(shape, tf14, wd, delta):
    rng = np.random.default_rng(0)
    p, g, m = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    v = rng.random(shape, dtype=np.float32)
    kw = dict(lr=1e-3, weight_decay=wd, tf14_eps=tf14, return_delta=delta)
    want = jfused.fused_adam_update(
        *(jnp.asarray(x) for x in (p, g, m, v)), jnp.asarray(3), **kw)
    got = tfused.fused_adam_update(
        *(torch.from_numpy(x) for x in (p, g, m, v)), 3, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)


def test_adam_in_place_outputs():
    rng = np.random.default_rng(1)
    p, g, m = (torch.from_numpy(rng.standard_normal(50, dtype=np.float32))
               for _ in range(3))
    v = torch.from_numpy(rng.random(50, dtype=np.float32))
    want = tfused.adam_plain(p, g, m, v, 2)
    before = dict(tfused.LAUNCHES)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    out = tfused.fused_adam_update(p2, g, m2, v2, 2, out=(p2, m2, v2))
    assert all(a is b for a, b in zip(out, (p2, m2, v2)))
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert dict(tfused.LAUNCHES) == before


def _trees(seed=0):
    """A JAX gpt_tiny parameter tree, a gradient tree of its shape (numpy
    f32) and the port's dicts of both."""
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    jgrads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape, dtype=np.float32) * 0.1,
        jparams)
    config = gpt_tiny()
    params = {k: v.clone() for k, v in
              gpt_params_from_jax(jparams, config).items()}
    grads = gpt_params_from_jax(jgrads, config)
    return jparams, jgrads, params, grads, config


def test_default_decay_mask_is_the_jax_trees():
    jparams, _, params, _, config = _trees()
    jmask = jax.tree.map(lambda p: np.full(p.shape, p.ndim > 1, np.float32),
                         jparams)
    want = gpt_params_from_jax(jmask, config)
    got = topt.default_decay_mask(params)
    assert got == {k: bool(v.flatten()[0]) for k, v in want.items()}
    # per-layer biases and norms are [L, ...] in the JAX tree: decayed
    assert got["blocks.0.ln_1.gamma"] and got["blocks.1.attention.out.bias"]
    assert not got["ln_f.gamma"] and not got["ln_f.beta"]
    assert got["word"] and got["blocks.0.ffn.w_in.kernel"]


def test_adamw_and_clip_match_jax_over_a_gpt_tree():
    jparams, jgrads, params, grads, config = _trees()
    jo = jopt.adamw(1e-3, weight_decay=0.5)
    to = topt.adamw(1e-3, weight_decay=0.5)
    jstate, tstate = jo.init(jparams), to.init(params)
    jp = jax.tree.map(jnp.asarray, jparams)
    for step in range(2):
        jg, jnorm = jopt.clip_by_global_norm(
            jax.tree.map(lambda x: jnp.asarray(x) * (step + 1), jgrads), 1.0)
        tg, tnorm = topt.clip_by_global_norm(
            {k: g * (step + 1) for k, g in grads.items()}, 1.0)
        np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-5)
        np.testing.assert_allclose(topt.global_norm(tg).item(), 1.0,
                                   rtol=1e-5)
        ju, jstate = jo.update(jg, jstate, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, tstate = to.update(tg, tstate, params)
        topt.apply_updates(params, tu)
    assert tstate.count == int(jstate.count) == 2
    for got, want in ((params, jp), (tstate.inner["m"], jstate.inner["m"]),
                      (tstate.inner["v"], jstate.inner["v"])):
        got = gpt_params_to_jax(got, config)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=TREE_TOL,
                                       rtol=0, err_msg=str(path))


@pytest.mark.parametrize("schedule", [False, True], ids=["constant",
                                                        "schedule"])
def test_adam_without_decay_matches_jax(schedule):
    """Two steps of plain adam; the learning rate is a constant or a
    function of the 1-based step count."""
    jparams, jgrads, params, grads, _ = _trees(1)
    lr = (lambda count: 1e-2 / count) if schedule else 1e-2
    jo, to = jopt.adam(lr), topt.adam(lr)
    jstate, tstate = jo.init(jparams), to.init(params)
    for _ in range(2):
        ju, jstate = jo.update(jax.tree.map(jnp.asarray, jgrads), jstate,
                               jparams)
        tu, tstate = to.update(grads, tstate, params)
    want = gpt_params_from_jax(jax.tree.map(np.asarray, ju), gpt_tiny())
    for k in want:
        np.testing.assert_allclose(tu[k].numpy(), want[k].numpy(),
                                   atol=ADAM_ATOL, rtol=ADAM_RTOL)


@pytest.mark.parametrize("shape", [(4, 8, 64), (3, 768)])
def test_layernorm_gradient_matches_jax_vjp(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape, dtype=np.float32) * 2 + 0.3
    d = shape[-1]
    gamma = rng.standard_normal(d, dtype=np.float32)
    beta = rng.standard_normal(d, dtype=np.float32)
    dy = rng.standard_normal(shape, dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jfused.fused_layernorm(a, b, c,
                                                            eps=1e-5),
                     *(jnp.asarray(t) for t in (x, gamma, beta)))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, gamma, beta)]
    got = torch.autograd.grad(tfused.fused_layernorm(*leaves, eps=1e-5),
                              leaves, torch.from_numpy(dy))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=0)


_SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "exponential": lambda m: m.exponential_decay(1e-3, 7, 0.8),
    "exponential_staircase": lambda m: m.exponential_decay(1e-3, 7, 0.8,
                                                           staircase=True),
    "cosine": lambda m: m.cosine_decay(1e-3, 40, alpha=0.1),
    "warmup_cosine": lambda m: m.warmup_cosine_decay(1e-3, 5, 40, 1e-5),
    "warmup_linear": lambda m: m.warmup_linear_decay(1e-3, 10, 45),
    "polynomial": lambda m: m.polynomial_decay(1e-3, 30, 1e-5, power=2.0),
    "polynomial_cycle": lambda m: m.polynomial_decay(1e-3, 12, 1e-5,
                                                     power=0.5, cycle=True),
    "piecewise": lambda m: m.piecewise_constant([10, 25], [1e-3, 5e-4,
                                                           1e-4]),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_matches_jax(name):
    got, want = _SCHEDULES[name](tsched), _SCHEDULES[name](jsched)
    counts = np.arange(51)
    g = np.array([got(int(c)) for c in counts])
    w = np.array([float(want(jnp.asarray(c, jnp.int32))) for c in counts])
    assert all(isinstance(got(int(c)), float) for c in counts[:3])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("debias", [True, False])
def test_with_ema_matches_jax_over_three_steps(debias):
    jparams, jgrads, params, grads, config = _trees(2)
    jo = jema.with_ema(jopt.adamw(1e-2), decay=0.9, debias=debias)
    to = topt.with_ema(topt.adamw(1e-2), decay=0.9, debias=debias)
    jstate, tstate = jo.init(jparams), to.init(params)
    jp = jax.tree.map(jnp.asarray, jparams)
    for step in range(3):
        jg = jax.tree.map(lambda x: jnp.asarray(x) * (step + 1), jgrads)
        tg = {k: g * (step + 1) for k, g in grads.items()}
        ju, jstate = jo.update(jg, jstate, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, tstate = to.update(tg, tstate, params)
        topt.apply_updates(params, tu)
    tema, jema_state = tstate.inner["ema"], jstate.inner["ema"]
    assert tstate.count == int(jstate.count) == 3
    assert tema.count == int(jema_state.count) == 3
    assert tstate.inner["opt"].count == int(jstate.inner["opt"].count) == 3
    assert tema.decay == float(jema_state.decay)
    assert tema.debias == bool(jema_state.debias) == debias
    for got, want in ((params, jp), (tema.shadow, jema_state.shadow),
                      (tstate.inner["opt"].inner["m"],
                       jstate.inner["opt"].inner["m"]),
                      (topt.ema_params(tstate), jema.ema_params(jstate))):
        got = gpt_params_to_jax(got, config)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=TREE_TOL,
                                       rtol=0, err_msg=str(path))
    with pytest.raises(ValueError, match="with_ema"):
        topt.ema_params(topt.adamw().init(params))


def test_standalone_ema_tracker_matches_jax():
    rng = np.random.default_rng(3)
    seq = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(4)]
    t, j = topt.ema(decay=0.75), jema.ema(decay=0.75)
    ts, js = t.init({"w": torch.zeros(4, 5)}), j.init({"w": jnp.zeros((4,
                                                                       5))})
    for x in seq:
        ts = t.update(ts, {"w": torch.from_numpy(x)})
        js = j.update(js, {"w": jnp.asarray(x)})
        np.testing.assert_allclose(t.value(ts)["w"].numpy(),
                                   np.asarray(j.value(js)["w"]),
                                   atol=1e-6, rtol=1e-6)
