"""Per-block recomputation (``GPTConfig.remat``) in the port.

- ``"full"``, ``"dots"`` and ``"dots_no_batch"`` against no remat, WITH
  dropout 0.1: the recomputed blocks must draw the masks the forward drew
  (``torch.utils.checkpoint`` replays only the global RNG, never the
  explicit generator the port draws from), so the loss and every
  gradient agree to 1e-6 (f32; in fact they are equal: the same
  operations on the same values), and so do two training steps.
- The remat loss and gradients against the JAX package's ``remat=True``
  at dropout 0: 1e-4 absolute (f32, another summation order; the
  tolerance of ``tests/test_torch_gpt_train.py``).
- An invalid policy raises ``ValueError``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, TrainState,
                                              adamw, gpt_params_to_jax,
                                              load_jax_params,
                                              make_custom_train_step)

torch.set_num_threads(1)

REMAT_TOL = 1e-6
JAX_TOL = 1e-4
POLICIES = ["full", "dots", "dots_no_batch"]


def _config(**kw):
    kw.setdefault("dropout_rate", 0.1)
    return GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=512, max_position=128,
                     **kw)


def _ids(seed=0, b=2, s=33):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (b, s)))


def _loss_and_grads(config, gen_seed=3, mask=None):
    model = GPT(config, device="cpu")
    params = dict(model.named_parameters())
    batch = {"input_ids": _ids()}
    if mask is not None:
        batch["loss_mask"] = mask
    gen = torch.Generator("cpu").manual_seed(gen_seed)
    loss, (metrics, _) = model.lm_loss_fn()(params, (), batch, gen, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), metrics, dict(zip(params, grads))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat_with_dropout(policy):
    want = _loss_and_grads(_config())
    got = _loss_and_grads(_config(remat=True, remat_policy=policy))
    assert abs(got[0] - want[0]) <= REMAT_TOL
    for k, g in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), g.numpy(),
                                   atol=REMAT_TOL, rtol=0, err_msg=k)
    # the dropout draws matter: another generator seed moves the loss
    assert abs(_loss_and_grads(_config(), gen_seed=4)[0] - want[0]) > 1e-3


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_training_steps_equal_no_remat(policy):
    runs = []
    for kw in ({}, {"remat": True, "remat_policy": policy}):
        model = GPT(_config(**kw), device="cpu")
        params = dict(model.named_parameters())
        opt = adamw(1e-3)
        step = make_custom_train_step(model.lm_loss_fn(), opt, seed=7,
                                      grad_clip_norm=1.0, accum_steps=2)
        state = TrainState.create(params, opt.init(params))
        losses = []
        for i in range(2):
            state, m = step(state, {"input_ids": _ids(10 + i, b=4)})
            losses.append(m["loss"].item())
        runs.append((losses, model.state_dict()))
    (want_l, want_p), (got_l, got_p) = runs
    np.testing.assert_allclose(got_l, want_l, atol=REMAT_TOL, rtol=0)
    for k, p in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), p.numpy(),
                                   atol=REMAT_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_remat(policy):
    jmodel = jgpt_tiny(dropout_rate=0.0, remat=True, remat_policy=policy)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = load_jax_params(
        GPT(_config(dropout_rate=0.0, remat=True, remat_policy=policy),
            device="cpu"), jax.tree.map(np.asarray, jparams))
    ids = _ids()
    batch = {"input_ids": jnp.asarray(ids.numpy())}
    jloss_fn = jmodel.lm_loss_fn()
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, (), batch, jax.random.PRNGKey(0), True),
        has_aux=True)(jparams)
    params = dict(model.named_parameters())
    loss, _ = model.lm_loss_fn()(params, (), {"input_ids": ids}, None, True)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(want), atol=JAX_TOL,
                               rtol=0)
    got = gpt_params_to_jax(grads, model.config)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=JAX_TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_invalid_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        _config(remat=True, remat_policy="everything")
    config = _config()
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(config, remat_policy="dots_saveable")
    with pytest.raises(ValueError, match="loss_seq_chunk"):
        dataclasses.replace(config, loss_seq_chunk=-1)
