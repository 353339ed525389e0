"""The port's BERT held against the JAX package's.

Same weights (the JAX ``bert_tiny`` tree carried across by
``bert_params_from_jax``), same numpy batches, dropout 0 (the two
frameworks draw different dropout bits).  The port runs on the CPU, so
its flash and LayerNorm wrappers take their plain versions:

- the sequence output and the MLM logits without a mask and with a
  ragged ``attention_mask`` (against the JAX package's dense path: no
  row is fully padded), and with a fully padded row against the JAX
  flash kernel (``use_flash=True``, Pallas in interpret mode), which
  gives that row zeros as the port does; the pooler;
- ``mlm_loss_fn`` (loss, metrics and every gradient leaf) projecting
  every position and gathering 4 positions a row with rows that
  overflow (more than 4 masked), where the port's stable sort must pick
  the positions ``lax.top_k`` picks;
- three ``adamw`` steps with a global-norm clip through both packages'
  ``make_custom_train_step`` (losses, metrics, parameters);
- remat ("full" and "dots") against no remat: the same loss and
  gradients;
- ``bert_params_to_jax`` inverts ``bert_params_from_jax``, and adamw's
  default decay mask is the JAX tree's (stacked encoder leaves decay).

Tolerances: 1e-4 absolute on logits, losses, gradients and parameters
(f32, another summation order), relative to the logits' scale where it
exceeds 1.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (TrainState, adamw, parallel,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models.convert import (
    bert_params_from_jax, bert_params_to_jax)
from distributed_tensorflow_tpu_torch.optim.optimizers import \
    default_decay_mask

torch.set_num_threads(1)

TOL = 1e-4
B, S = 3, 16


def _models(**kw):
    jmodel = jbert.bert_tiny(dropout_rate=0.0, **kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = tbert.bert_tiny(dropout_rate=0.0, **kw)
    params = bert_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  model.config)
    return jmodel, jparams, model, params


def _close(got, want, atol=TOL, what=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol * scale, rtol=0, err_msg=what)


def _tree_close(got, want_tree, config, atol=TOL):
    tree = bert_params_to_jax(got, config)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _batch(seed, n_mask=0.15, valid=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (B, S)).astype(np.int32)
    labels = rng.integers(0, 1000, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < n_mask).astype(np.float32)
    batch = {"input_ids": ids, "labels": labels, "mlm_mask": mask}
    if valid is not None:
        batch["attention_mask"] = valid
    return batch


def _valid(lengths):
    return (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


MASKS = {"none": None, "ragged": [16, 9, 3]}


@pytest.mark.parametrize("mask", list(MASKS))
def test_sequence_output_and_mlm_logits_match_jax(mask):
    jmodel, jparams, model, params = _models()
    ids = _batch(0)["input_ids"]
    valid = None if MASKS[mask] is None else _valid(MASKS[mask])
    types = np.random.default_rng(1).integers(0, 2, (B, S)).astype(np.int32)
    want = jmodel.apply(jparams, jnp.asarray(ids),
                        token_type_ids=jnp.asarray(types),
                        attention_mask=None if valid is None
                        else jnp.asarray(valid))
    got = model.apply(params, torch.from_numpy(ids),
                      token_type_ids=torch.from_numpy(types),
                      attention_mask=None if valid is None
                      else torch.from_numpy(valid))
    _close(got.detach().numpy(), want, what="sequence output")
    _close(model.mlm_logits(params, got).detach().numpy(),
           jmodel.mlm_logits(jparams, want), what="mlm logits")
    _close(model.pooled(params, got).detach().numpy(),
           jmodel.pooled(jparams, want), what="pooled")


def test_fully_padded_row_matches_jax_flash_kernel():
    """A row with no valid key: the port's flash path gives zeros there,
    as the JAX flash kernel (interpret mode) does."""
    jmodel, jparams, model, params = _models(use_flash=True)
    ids = _batch(2)["input_ids"]
    valid = _valid([16, 0, 5])
    want = jmodel.apply(jparams, jnp.asarray(ids),
                        attention_mask=jnp.asarray(valid))
    got = model.apply(params, torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(valid))
    _close(got.detach().numpy(), want, what="sequence output")
    _close(model.mlm_logits(params, got).detach().numpy(),
           jmodel.mlm_logits(jparams, want), what="mlm logits")


def _loss_and_grads(jmodel, jparams, model, params, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jmodel.mlm_loss_fn()(p, {}, jbatch, jax.random.PRNGKey(0),
                                    True)
    (want, (jm, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, (m, _) = model.mlm_loss_fn()(params, {}, tbatch,
                                       torch.Generator(), True)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in grads.items()}
    return (want, jm, jgrads), (loss, m, grads)


@pytest.mark.parametrize("gather", [0, 4], ids=["all_positions",
                                               "gather4_overflow"])
def test_mlm_loss_metrics_and_grads_match_jax(gather):
    jmodel, jparams, model, params = _models(mlm_predictions_per_seq=gather)
    batch = _batch(3, n_mask=0.4, valid=_valid([16, 12, 7]))
    if gather:
        # row 0 overflows (more masked than gathered), row 2 has fewer
        batch["mlm_mask"][0] = (np.arange(S) % 2 == 0)
        batch["mlm_mask"][2] = 0.0
        batch["mlm_mask"][2, [3, 11]] = 1.0
    (want, jm, jgrads), (loss, m, grads) = _loss_and_grads(
        jmodel, jparams, model, params, batch)
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=0)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=TOL,
                                   rtol=0, err_msg=k)
    if gather:
        assert m["mlm_overflow"].item() > 0
    _tree_close(grads, jgrads, model.config)


def test_gather_picks_the_lower_positions_first_like_top_k():
    mask = np.zeros((2, 12), np.float32)
    mask[0, [1, 4, 5, 9, 11]] = 1.0
    mask[1, [7]] = 1.0
    jw, jidx = jax.lax.top_k(jnp.asarray(mask), 3)
    w, idx = tbert.gather_masked(torch.from_numpy(mask), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_three_adamw_steps_with_clip_match_jax_step():
    jmodel, jparams, model, params = _models(mlm_predictions_per_seq=5)
    jo, to = jopt.adamw(1e-3), adamw(1e-3, mask=model.decay_mask)
    jstep = jmake_step(jmodel.mlm_loss_fn(), jo, grad_clip_norm=1.0)
    jstate = JState.create(jparams, jo.init(jparams))
    step = make_custom_train_step(model.mlm_loss_fn(), to,
                                  grad_clip_norm=1.0)
    state = TrainState.create(params, to.init(params))
    for i in range(3):
        batch = _batch(10 + i, valid=_valid([16, 10, 13]))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=TOL,
                                       rtol=0, err_msg=f"step {i} {k}")
    _tree_close(state.params, jstate.params, model.config)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy):
    _, jparams, model, params = _models()
    tree = jax.tree.map(np.asarray, jparams)
    remat = tbert.bert_tiny(dropout_rate=0.1, remat=True,
                            remat_policy=policy)
    plain = tbert.bert_tiny(dropout_rate=0.1)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(5, valid=_valid([16, 8, 12])).items()}
    out = []
    for m in (plain, remat):
        p = bert_params_from_jax(tree, m.config)
        loss, _ = m.mlm_loss_fn()(p, {}, batch,
                                  torch.Generator().manual_seed(7), True)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        out.append((loss.item(), [None if g is None else g.numpy()
                                  for g in grads]))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=0)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_params_to_jax_inverts_params_from_jax():
    jmodel, jparams, model, params = _models()
    tree = bert_params_to_jax(params, model.config)
    assert jax.tree.structure(tree) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert all(p.requires_grad and p.is_leaf for p in params.values())
    assert len(params) == len(model.init(torch.Generator())) == 5 + 16 * 2 \
        + 5 + 2


def test_adamw_decay_mask_is_the_jax_trees():
    """``Bert.decay_mask`` is JAX adamw's default, ``ndim > 1`` on the JAX
    tree, where every encoder leaf carries the layer axis: a layer's
    biases and norm scales decay, the embeddings' norm and the head's
    biases do not."""
    _, jparams, model, params = _models()
    mask = model.decay_mask(params)
    want = bert_params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim > 1, np.float32), jparams),
        model.config)
    assert mask == {k: bool(v.flatten()[0]) for k, v in want.items()}
    assert mask["encoder.0.attention.ln.gamma"]
    assert not mask["embeddings.ln.gamma"]


def test_default_decay_mask_takes_no_encoder_name_as_stacked():
    """The optimizer's own default knows only the GPT's ``blocks.<i>``:
    another tree's ``encoder.<i>`` leaves (a user's model) keep
    ``ndim > 1`` on their own shapes."""
    tree = {"encoder.0.bias": torch.zeros(4), "decoder.1.ln.gamma":
            torch.ones(4), "encoder.0.kernel": torch.zeros(4, 4)}
    assert default_decay_mask(tree) == {"encoder.0.bias": False,
                                        "decoder.1.ln.gamma": False,
                                        "encoder.0.kernel": True}


def test_parallel_options_raise():
    """``seq_axis`` runs now, and needs a mesh naming the axis; tensor
    parallelism runs on the JAX package's table, beside ``seq_axis`` too
    (``tests/test_torch_tp_sp.py`` trains it); beside ``seq`` and
    ``fsdp`` at once it raises, naming ROADMAP Queue 1 item 7.5."""
    with pytest.raises(ValueError, match="mesh"):
        tbert.bert_tiny(seq_axis="seq")
    rules = tbert.bert_tiny().partition_rules()
    jrules = jbert.bert_tiny().partition_rules()
    assert rules.spec_for("encoder.1.ffn.w_in.kernel") == tuple(
        jrules.spec_for("encoder/ffn/w_in/kernel"))[1:] == (None, "tensor")
    mesh = parallel.Mesh(4, 0, None, axes={"seq": 2, "tensor": 2},
                         lines={})
    assert tbert.Bert(tbert.BertConfig(seq_axis="seq"), mesh).line is mesh
    beside_fsdp = parallel.Mesh(8, 0, None, axes={"fsdp": 2, "seq": 2,
                                                  "tensor": 2}, lines={})
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.5"):
        tbert.Bert(tbert.BertConfig(seq_axis="seq"), beside_fsdp)
