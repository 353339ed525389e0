"""The port's ViT held against the JAX package's.

Same weights (the JAX ``vit_tiny`` tree carried across by
``vit_params_from_jax``, with a nonzero head so the logits are not all
zero), same numpy images, dropout 0.  The port runs on the CPU, so its
flash and LayerNorm wrappers take their plain versions; the JAX package
runs its dense path (``use_flash="auto"`` off a TPU) and, in one case,
its flash kernel in interpret mode:

- logits and the final-LN features (``return_features``);
- ``loss_fn``: loss, accuracy and every gradient leaf;
- three ``adamw`` steps with a global-norm clip through both packages'
  ``make_custom_train_step``: losses, metrics and parameters;
- ``vit_params_to_jax`` inverts ``vit_params_from_jax``.

Tolerances: 1e-4 absolute on logits, losses, gradients and parameters
(f32, another summation order), relative to the logits' scale where it
exceeds 1.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import vit as jvit
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch.models import vit as tvit
from distributed_tensorflow_tpu_torch.models.convert import (
    vit_params_from_jax, vit_params_to_jax)

torch.set_num_threads(1)

TOL = 1e-4


def _models(**kw):
    jmodel = jvit.vit_tiny(**kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    head = np.random.default_rng(9).standard_normal(
        jparams["head"]["kernel"].shape).astype(np.float32) * 0.1
    jparams["head"]["kernel"] = jnp.asarray(head)
    model = tvit.vit_tiny(**kw)
    params = vit_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 model.config)
    return jmodel, jparams, model, params


def _images(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def _close(got, want, atol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol * scale, rtol=0)


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["jax_dense", "jax_flash_kernel"])
def test_logits_and_features_match_jax(use_flash):
    jmodel, jparams, model, params = _models(use_flash=use_flash)
    x, _ = _images(0)
    _close(model.apply(params, torch.from_numpy(x)).detach().numpy(),
           jmodel.apply(jparams, jnp.asarray(x)))
    _close(model.apply(params, torch.from_numpy(x),
                       return_features=True).detach().numpy(),
           jmodel.apply(jparams, jnp.asarray(x), return_features=True))


def test_loss_and_grads_match_jax():
    jmodel, jparams, model, params = _models()
    x, y = _images(1)

    def jloss(p):
        return jmodel.loss_fn()(p, {}, (jnp.asarray(x), jnp.asarray(y)),
                                jax.random.PRNGKey(0), True)
    (want, (jm, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    loss, (m, _) = model.loss_fn()(params, {}, (torch.from_numpy(x),
                                                torch.from_numpy(y)),
                                   torch.Generator(), True)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(m["accuracy"].item(), float(jm["accuracy"]))
    tree = vit_params_to_jax(grads, model.config)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_three_adamw_steps_with_clip_match_jax_step():
    jmodel, jparams, model, params = _models()
    jo, to = jopt.adamw(1e-3), adamw(1e-3, mask=model.decay_mask)
    jstep = jmake_step(jmodel.loss_fn(), jo, grad_clip_norm=1.0)
    jstate = JState.create(jparams, jo.init(jparams))
    step = make_custom_train_step(model.loss_fn(), to, grad_clip_norm=1.0)
    state = TrainState.create(params, to.init(params))
    for i in range(3):
        x, y = _images(10 + i, b=4)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=TOL,
                                       rtol=0, err_msg=f"step {i} {k}")
    tree = vit_params_to_jax(state.params, model.config)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_decay_mask_is_the_jax_trees():
    _, jparams, model, params = _models()
    want = vit_params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim > 1, np.float32), jparams),
        model.config)
    mask = model.decay_mask(params)
    assert mask == {k: bool(v.flatten()[0]) for k, v in want.items()}
    assert mask["encoder.0.attention.ln.beta"] and not mask["final_ln.beta"]


def test_params_to_jax_inverts_params_from_jax():
    jmodel, jparams, model, params = _models()
    tree = vit_params_to_jax(params, model.config)
    assert jax.tree.structure(tree) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    init = model.init(torch.Generator())
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in params.items()}
    # the JAX table over the port's names (every leaf in
    # tests/test_torch_tp_vision.py)
    assert model.partition_rules().spec_for("encoder.1.ffn.w_in.kernel") \
        == tuple(jmodel.partition_rules().spec_for(
            "encoder/ffn/w_in/kernel"))[1:] == (None, "tensor")
