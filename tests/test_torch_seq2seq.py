"""The port's encoder-decoder held against the JAX package's.

Same weights (the JAX ``seq2seq_tiny`` tree carried across by
``seq2seq_params_from_jax``), same numpy token batches, dropout 0:

- ``encode`` and ``decode`` with a ragged source mask, and the tied
  head's logits;
- ``seq2seq_loss_fn`` with and without a loss mask: loss, metrics and
  every gradient leaf;
- greedy ``generate`` and ``beam_search`` (with and without ``eos_id``):
  the same tokens;
- ``seq2seq_params_to_jax`` inverts ``seq2seq_params_from_jax``.

The tiny model's weights are scaled up (x5) so that greedy decoding
varies its tokens.  Tolerances: 1e-4 absolute on hidden states, losses
and gradients (f32, another summation order), relative to the scale
where it exceeds 1; tokens exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import seq2seq as js2s
from distributed_tensorflow_tpu_torch.models import seq2seq as ts2s
from distributed_tensorflow_tpu_torch.models.convert import (
    seq2seq_params_from_jax, seq2seq_params_to_jax)

torch.set_num_threads(1)

TOL = 1e-4
B, S, T = 3, 12, 10


def _models(scale=1.0):
    jmodel = js2s.seq2seq_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jparams = jax.tree.map(lambda a: a * scale if a.ndim > 1 else a,
                           jparams)
    model = ts2s.seq2seq_tiny(dropout_rate=0.0)
    params = seq2seq_params_from_jax(jax.tree.map(np.asarray, jparams),
                                     model.config)
    return jmodel, jparams, model, params


def _batch(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(2, 128, (B, S)).astype(np.int32)
    tgt = rng.integers(2, 128, (B, T)).astype(np.int32)
    tgt[:, 0] = 0
    valid = (np.arange(S)[None] < np.array([[12], [7], [4]])).astype(
        np.int32)
    return {"src_ids": src, "tgt_ids": tgt, "src_valid": valid}


def _close(got, want, atol=TOL, what=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol * scale, rtol=0, err_msg=what)


def test_encode_decode_and_logits_match_jax():
    jmodel, jparams, model, params = _models()
    b = _batch(0)
    jmem = jmodel.encode(jparams, jnp.asarray(b["src_ids"]),
                         jnp.asarray(b["src_valid"]))
    mem = model.encode(params, torch.from_numpy(b["src_ids"]),
                       torch.from_numpy(b["src_valid"]))
    _close(mem.detach().numpy(), jmem, what="memory")
    jh = jmodel.decode(jparams, jmem, jnp.asarray(b["tgt_ids"]),
                       jnp.asarray(b["src_valid"]))
    h = model.decode(params, mem, torch.from_numpy(b["tgt_ids"]),
                     torch.from_numpy(b["src_valid"]))
    _close(h.detach().numpy(), jh, what="hidden")
    _close(model.logits(params, h).detach().numpy(),
           jmodel.logits(jparams, jh), what="logits")


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask",
                                                       "loss_mask"])
def test_loss_metrics_and_grads_match_jax(masked):
    jmodel, jparams, model, params = _models()
    b = _batch(1)
    if masked:
        b["loss_mask"] = (np.random.default_rng(2).random((B, T - 1))
                          < 0.7).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        return jmodel.seq2seq_loss_fn()(p, {}, jb, jax.random.PRNGKey(0),
                                        True)
    (want, (jm, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    loss, (m, _) = model.seq2seq_loss_fn()(
        params, {}, {k: torch.from_numpy(v) for k, v in b.items()},
        torch.Generator(), True)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=0)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=TOL,
                                   rtol=0, err_msg=k)
    tree = seq2seq_params_to_jax(grads, model.config)
    for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(g), atol=TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("eos", [None, 5], ids=["no_eos", "eos"])
def test_greedy_generate_matches_jax_tokens(eos):
    jmodel, jparams, model, params = _models(scale=5.0)
    b = _batch(3)
    want = np.asarray(jmodel.generate(
        jparams, jnp.asarray(b["src_ids"]), 16, bos_id=0,
        src_valid=jnp.asarray(b["src_valid"]), eos_id=eos))
    got = model.generate(params, torch.from_numpy(b["src_ids"]), 16,
                         bos_id=0, src_valid=torch.from_numpy(b["src_valid"]),
                         eos_id=eos)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 3


@pytest.mark.parametrize("eos", [None, 5], ids=["no_eos", "eos"])
def test_beam_search_matches_jax_tokens(eos):
    jmodel, jparams, model, params = _models(scale=5.0)
    b = _batch(4)
    want = np.asarray(jmodel.beam_search(
        jparams, jnp.asarray(b["src_ids"]), 12, beam_size=3, bos_id=0,
        eos_id=eos, src_valid=jnp.asarray(b["src_valid"])))
    got = model.beam_search(params, torch.from_numpy(b["src_ids"]), 12,
                            beam_size=3, bos_id=0, eos_id=eos,
                            src_valid=torch.from_numpy(b["src_valid"]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_decay_mask_is_the_jax_trees():
    _, jparams, model, params = _models()
    want = seq2seq_params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim > 1, np.float32), jparams),
        model.config)
    mask = model.decay_mask(params)
    assert mask == {k: bool(v.flatten()[0]) for k, v in want.items()}
    assert mask["decoder.0.ffn.w_in.bias"] and not mask["ln_dec_f.gamma"]


def test_params_to_jax_inverts_params_from_jax():
    jmodel, jparams, model, params = _models()
    tree = seq2seq_params_to_jax(params, model.config)
    assert jax.tree.structure(tree) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    init = model.init(torch.Generator())
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in params.items()}
