"""The chunked LM loss (``GPTConfig.loss_seq_chunk``) in the port, held
against the port's unchunked loss and the JAX package's chunked loss
(its ``tests/test_gpt.py::TestChunkedLoss`` cases).

Chunks of 8 (dividing the 32 tokens), 7 (not dividing: the port's last
chunk is short where the JAX package pads it) and 1000 (above the token
count, clamped), with and without a mask.  Tolerances:
- against the port's unchunked loss: loss and ``token_accuracy`` 1e-6
  relative, ``loss_weight`` exact, gradients 2e-5 absolute (the JAX
  test's own tolerances: the same math, summed chunk by chunk);
- against the JAX package's chunked loss: 1e-4 absolute on the loss,
  the metrics and every gradient (f32, another summation order; the
  tolerance of ``tests/test_torch_gpt_train.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig,
                                              gpt_params_to_jax,
                                              load_jax_params)

torch.set_num_threads(1)

JAX_TOL = 1e-4
GRAD_TOL = 2e-5


def _ids(b=2, s=17):
    return np.random.default_rng(0).integers(0, 512, (b, s)).astype(np.int32)


def _mask():
    mask = np.zeros((2, 16), np.float32)
    mask[:, 3:9] = 1.0
    mask[1, 12] = 1.0
    return mask


def _jax(chunk, mask):
    jmodel = jgpt_tiny(dropout_rate=0.0, loss_seq_chunk=chunk)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = {"input_ids": jnp.asarray(_ids())}
    if mask is not None:
        batch["loss_mask"] = jnp.asarray(mask)
    loss_fn = jmodel.lm_loss_fn()
    (loss, (metrics, _)), grads = jax.value_and_grad(
        lambda p: loss_fn(p, (), batch, None, False), has_aux=True)(jparams)
    return jparams, float(loss), metrics, grads


def _port(jparams, chunk, mask):
    config = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                       num_heads=2, intermediate_size=512, max_position=128,
                       dropout_rate=0.0, loss_seq_chunk=chunk)
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    params = dict(model.named_parameters())
    batch = {"input_ids": torch.from_numpy(_ids())}
    if mask is not None:
        batch["loss_mask"] = torch.from_numpy(mask)
    loss, (metrics, _) = model.lm_loss_fn()(params, (), batch, None, False)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    return loss.item(), metrics, gpt_params_to_jax(grads, config)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("chunk", [8, 7, 1000])
def test_chunked_loss_matches_unchunked_and_jax(chunk, masked):
    mask = _mask() if masked else None
    jparams, jloss, jmetrics, jgrads = _jax(chunk, mask)
    loss, metrics, grads = _port(jparams, chunk, mask)
    loss0, metrics0, grads0 = _port(jparams, 0, mask)
    assert set(metrics) == set(metrics0) == set(jmetrics)
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    np.testing.assert_allclose(loss, jloss, atol=JAX_TOL, rtol=0)
    for k in metrics:
        if k == "loss_weight":
            assert float(metrics[k]) == float(metrics0[k]) == \
                float(jmetrics[k]) == float(mask.sum())
            continue
        np.testing.assert_allclose(float(metrics[k]), float(metrics0[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=JAX_TOL, rtol=0)
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(grads),
                               jax.tree_util.tree_leaves(grads0),
                               jax.tree_util.tree_leaves(jgrads)):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(c), atol=JAX_TOL, rtol=0,
                                   err_msg=name)
