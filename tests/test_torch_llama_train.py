"""Llama-recipe training in the port against the JAX package.

A JAX ``llama_tiny`` tree (RMSNorm, SwiGLU, RoPE, GQA 4q/2kv, no biases,
an untied ``lm_head``) carried across by ``gpt_params_from_jax``, the
same numpy token batches, dropout 0:

- ``GPT.lm_loss_fn``: loss, token accuracy (and ``loss_weight`` under a
  mask) and every gradient against ``jax.value_and_grad`` of the JAX
  ``lm_loss_fn``, without remat and under remat "full" and "dots", with
  and without ``loss_seq_chunk`` and ``loss_mask``.  The port runs its
  plain versions here: RMSNorm's backward through the plain version
  (``ops/kernels/fused.py``) and the GQA attention's dK/dV summed over
  each query group; the JAX side runs its Pallas kernels in interpret
  mode (``use_flash=True``, ``fused_layernorm=True``) or its dense path;
- three ``adamw`` steps with a clip of 1.0 against the JAX step (losses,
  grad norms, parameters);
- ``llama(...)`` builds the config's ``GPT``.

Tolerances: 1e-4 on losses, metrics, gradients and parameters, relative
to the values' scale where it exceeds 1 (f32 in another summation
order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import llama as jllama
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, TrainState,
                                              adamw, gpt_params_to_jax,
                                              llama, llama_tiny,
                                              load_jax_params,
                                              make_custom_train_step)

torch.set_num_threads(1)

TOL = 1e-4
_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "position_embedding", "rope_base", "norm",
           "ffn_activation", "use_bias", "tied_head", "remat",
           "remat_policy", "loss_seq_chunk")


def _models(**kw):
    jmodel = jllama.llama_tiny(**kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _ids(seed, b=2, s=33, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _tree_close(got_sd, want_tree, config):
    got = gpt_params_to_jax(got_sd, config)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want_tree))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want_tree)):
        _close(a, b, jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat,chunk,masked,kernels", [
    (None, 0, False, True), (None, 0, True, False),
    ("full", 0, False, True), ("full", 16, True, False),
    ("dots", 0, True, True), ("dots", 24, False, False)],
    ids=["plain_kernels", "plain_masked", "remat_full_kernels",
         "remat_full_chunked_masked", "remat_dots_masked_kernels",
         "remat_dots_chunked"])
def test_llama_loss_and_grads_match_jax(remat, chunk, masked, kernels):
    kw = dict(loss_seq_chunk=chunk, use_flash=kernels,
              fused_layernorm=kernels)
    if remat:
        kw.update(remat=True, remat_policy=remat)
    jmodel, jparams, model = _models(**kw)
    ids = _ids(0)
    batch = {"input_ids": jnp.asarray(ids)}
    tbatch = {"input_ids": torch.from_numpy(ids)}
    if masked:
        mask = np.random.default_rng(1).random((2, 32)) < 0.6
        batch["loss_mask"] = jnp.asarray(mask, jnp.float32)
        tbatch["loss_mask"] = torch.from_numpy(mask)
    jloss_fn = jmodel.lm_loss_fn()
    (want, (jmetrics, _)), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, (), batch, jax.random.PRNGKey(0), True),
        has_aux=True)(jparams)
    params = dict(model.named_parameters())
    assert "lm_head" in params and "blocks.0.ffn.w_gate.kernel" in params
    loss, (metrics, _) = model.lm_loss_fn()(params, (), tbatch, None, True)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    _close(loss.item(), float(want), "loss")
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        _close(metrics[k].item(), float(jmetrics[k]), k)
    _tree_close(grads, jgrads, model.config)
    # every leaf learns: the untied head, the norms' gammas, k and v
    for name in ("lm_head", "ln_f.gamma", "blocks.0.ln_1.gamma",
                 "blocks.1.attention.key.kernel",
                 "blocks.1.attention.value.kernel"):
        assert float(grads[name].abs().sum()) > 0, name


def test_three_adamw_steps_match_jax_step():
    jmodel, jparams, model = _models(remat=True, loss_seq_chunk=16)
    jo, to = jopt.adamw(1e-3), adamw(1e-3)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, grad_clip_norm=1.0)
    jstate = JState.create(jparams, jo.init(jparams))
    params = dict(model.named_parameters())
    step = make_custom_train_step(model.lm_loss_fn(), to, grad_clip_norm=1.0)
    state = TrainState.create(params, to.init(params))
    losses = []
    for i in range(3):
        ids = _ids(10 + i, b=4)
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = step(state, {"input_ids": torch.from_numpy(ids)})
        assert set(m) == set(jm)
        for k in jm:
            _close(float(m[k]), float(jm[k]), f"step {i} {k}")
        losses.append(float(m["loss"]))
    _tree_close(dict(model.named_parameters()), jstate.params, model.config)
    assert np.all(np.isfinite(losses))


def test_llama_builds_the_configs_gpt():
    model = llama(device="cpu", generator=torch.Generator().manual_seed(1),
                  vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=256, max_position=128)
    assert isinstance(model, GPT)
    assert model.config == llama_tiny()
    assert model.device.type == "cpu"
    jmodel = jllama.llama(vocab_size=512, hidden_size=128, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_size=256,
                          max_position=128)
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          jmodel.init(jax.random.PRNGKey(0)))
    got = gpt_params_to_jax(model.state_dict(), model.config)
    assert jax.tree.map(lambda a: tuple(a.shape), got) == shapes
    again = llama(device="cpu", generator=torch.Generator().manual_seed(1),
                  **{f: getattr(llama_tiny(), f) for f in (
                      "vocab_size", "hidden_size", "num_layers", "num_heads",
                      "num_kv_heads", "intermediate_size", "max_position")})
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            llama(vocab_size=64)               # the card by default
