"""The port's causal-LM training path held against the JAX package.

Same weights (the JAX ``gpt_tiny`` tree carried across by
``gpt_params_from_jax``), same numpy token batches, dropout 0 (the two
frameworks draw different dropout bits):

- ``GPT.lm_loss_fn`` loss, token accuracy and every gradient leaf against
  the JAX ``lm_loss_fn`` under ``jax.grad``, once with the JAX kernels
  (``use_flash=True, fused_layernorm=True``, Pallas in interpret mode)
  and once on its dense reference path;
- three steps of ``make_custom_train_step(adamw, grad_clip_norm=1.0)``
  against the JAX step: losses, ``grad_norm``, parameters and Adam
  moments per leaf;
- ``gpt_params_to_jax`` inverts ``gpt_params_from_jax``;
- serving after a training step: no autograd graph, and the same greedy
  tokens as the JAX package's ``generate`` on the trained weights.

The port runs on the CPU here, so its kernel wrappers take their plain
versions.  Tolerances: 1e-4 absolute on losses, gradients, the grad norm
and parameters (f32, another summation order; after a few Adam steps a
gradient element near 0 can move by a rounding difference times lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              TrainState, adamw,
                                              gpt_params_from_jax,
                                              gpt_params_to_jax,
                                              load_jax_params,
                                              make_custom_train_step)

torch.set_num_threads(1)

TOL = 1e-4


def _models(**kw):
    jmodel = jgpt_tiny(dropout_rate=0.0, **kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position,
                       layer_norm_eps=c.layer_norm_eps,
                       num_kv_heads=c.num_kv_heads,
                       dropout_rate=c.dropout_rate)
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _ids(seed, b=2, s=33, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _tree_close(got_sd, want_tree, config, atol=TOL):
    got = gpt_params_to_jax(got_sd, config)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kernels,masked", [(True, False), (False, True)],
                         ids=["jax_kernels", "jax_dense_masked"])
def test_lm_loss_and_grads_match_jax(kernels, masked):
    jmodel, jparams, model = _models(use_flash=kernels,
                                     fused_layernorm=kernels)
    ids = _ids(0)
    batch = {"input_ids": jnp.asarray(ids)}
    tbatch = {"input_ids": torch.from_numpy(ids)}
    if masked:
        mask = np.random.default_rng(1).random((2, 32)) < 0.6
        batch["loss_mask"] = jnp.asarray(mask, jnp.float32)
        tbatch["loss_mask"] = torch.from_numpy(mask)
    jloss_fn = jmodel.lm_loss_fn()

    def jloss(p):
        return jloss_fn(p, (), batch, jax.random.PRNGKey(0), True)
    (want, (jmetrics, _)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(jparams)

    params = dict(model.named_parameters())
    loss, (metrics, _) = model.lm_loss_fn()(params, (), tbatch, None, True)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=0)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   atol=TOL, rtol=0)
    _tree_close(grads, jgrads, model.config)


def test_three_adamw_steps_match_jax_step():
    jmodel, jparams, model = _models(use_flash=False)
    jo, to = jopt.adamw(1e-3), adamw(1e-3)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, grad_clip_norm=1.0)
    jstate = JState.create(jparams, jo.init(jparams))
    params = dict(model.named_parameters())
    step = make_custom_train_step(model.lm_loss_fn(), to, grad_clip_norm=1.0)
    state = TrainState.create(params, to.init(params))
    for i in range(3):
        ids = _ids(10 + i)
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = step(state, {"input_ids": torch.from_numpy(ids)})
        assert set(m) == set(jm)
        for k in ("loss", "grad_norm", "token_accuracy"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=TOL,
                                       rtol=0, err_msg=f"step {i} {k}")
    assert state.step == int(jstate.step) == 3
    assert state.opt_state.count == int(jstate.opt_state.count) == 3
    _tree_close(model.state_dict(), jstate.params, model.config)
    _tree_close(state.opt_state.inner["m"], jstate.opt_state.inner["m"],
                model.config, atol=1e-6)
    _tree_close(state.opt_state.inner["v"], jstate.opt_state.inner["v"],
                model.config, atol=1e-7)


def test_dropout_is_seeded_by_seed_and_step():
    """With dropout on, a step is a function of (weights, batch, seed,
    step): the same inputs repeat it exactly, another seed does not, and
    training without a generator raises."""
    _, jparams, base = _models()
    config = dataclasses.replace(base.config, dropout_rate=0.1)
    tree = jax.tree.map(np.asarray, jparams)
    ids = torch.from_numpy(_ids(7))

    def one_step(seed):
        model = load_jax_params(GPT(config, device="cpu"), tree)
        params = dict(model.named_parameters())
        opt = adamw(1e-3)
        step = make_custom_train_step(model.lm_loss_fn(), opt, seed=seed)
        _, m = step(TrainState.create(params, opt.init(params)),
                    {"input_ids": ids})
        return m["loss"].item(), model
    (a, model), (b, _), (c, _) = one_step(0), one_step(0), one_step(1)
    assert a == b and a != c
    with pytest.raises(ValueError, match="Generator"):
        model.apply(ids, train=True)


def test_params_to_jax_inverts_params_from_jax():
    _, jparams, model = _models(num_heads=4, num_kv_heads=2)
    tree = jax.tree.map(np.asarray, jparams)
    back = gpt_params_to_jax(gpt_params_from_jax(tree, model.config),
                             model.config)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a GPT parameter"):
        gpt_params_to_jax({"lm_head": torch.zeros(2)}, model.config)


def test_serving_after_a_training_step_matches_jax_generate():
    jmodel, _, model = _models()
    params = dict(model.named_parameters())
    opt = adamw(1e-2)
    step = make_custom_train_step(model.lm_loss_fn(), opt)
    state = TrainState.create(params, opt.init(params))
    state, _ = step(state, {"input_ids": torch.from_numpy(_ids(3))})
    assert all(p.requires_grad for p in params.values())

    kv = {n: torch.zeros(2, 5, 8, 2, 64) for n in ("k", "v")}
    logits, _ = model.decode_window_paged(
        kv, torch.from_numpy(_ids(4, b=1, s=8)), torch.arange(
            1, 5, dtype=torch.int32), 0)
    assert not logits.requires_grad and logits.grad_fn is None

    trained = jax.tree.map(jnp.asarray, gpt_params_to_jax(
        model.state_dict(), model.config))
    prompts = [_ids(5 + i, b=1, s=n)[0] for i, n in enumerate((5, 19))]
    eng = Engine(model, device="cpu", num_slots=2, max_len=64,
                 prefill_chunk=8, tick_steps=3)
    got = eng.generate_batch(prompts, 6)
    for prompt, tokens in zip(prompts, got):
        out = jmodel.generate(trained, jnp.asarray(prompt[None]),
                              max_new_tokens=6, max_len=64)
        assert tokens == np.asarray(out)[0, prompt.size:].tolist()
