"""The port's MoE GPT (``GPTConfig(moe_experts=...)``) against the JAX
package.

Same weights (a JAX ``gpt_tiny(moe_experts=4)`` tree carried across by
``gpt_params_from_jax``), same numpy token batches, dropout 0:

- the converter carries a MoE tree both ways bit for bit, and the
  ``adamw`` decay mask of the port's names is the JAX tree's;
- ``apply(return_aux=True)``: hidden states and the summed aux;
- ``lm_loss_fn`` at ``train=False``: loss (with the aux folded in),
  ``moe_aux``, token accuracy and every gradient against
  ``jax.value_and_grad``, with and without remat, the chunked loss and a
  loss mask;
- three ``adamw`` steps (one and two microbatches) against the JAX step,
  with the router jitter off in both packages (its bits differ): the
  step's metrics carry ``moe_aux``; under remat the recomputed forward
  draws the jitter the forward drew (loss and gradients equal without
  remat);
- KV-cache decoding at capacity factor 4.0 (nothing dropped) equals the
  full forward position by position (the JAX package's own test), and
  the paged ``Engine``'s greedy tokens equal the JAX engine's;
- the swiglu refusal and ``moe_partition_rules``.

Tolerances: 1e-4 on losses, metrics, logits and gradients (relative to
the values' scale where it exceeds 1; f32 in another summation order),
2e-4 between decode steps and the full forward (the JAX test's);
tokens exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models import gpt as jgpt_mod
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu.ops import moe as jmoe
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
from distributed_tensorflow_tpu_torch.models import gpt as tgpt_mod
from distributed_tensorflow_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_tpu_torch.optim import default_decay_mask

torch.set_num_threads(1)

TOL = 1e-4
_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "moe_experts", "moe_top_k", "moe_capacity_factor",
           "moe_aux_weight", "moe_z_weight")


def _models(scale=1.0, **kw):
    kw.setdefault("moe_experts", 4)
    jmodel = jgpt_mod.gpt_tiny(dropout_rate=0.0, **kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if scale != 1.0:
        jparams = jax.tree.map(lambda x: x * scale if x.ndim >= 2 else x,
                               jparams)
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


def test_convert_round_trips_a_moe_tree_and_its_decay_mask():
    jmodel, jparams, model = _models()
    tree = jax.tree.map(np.asarray, jparams)
    assert "moe" in tree["decoder"] and "ffn" not in tree["decoder"]
    sd = gpt_params_from_jax(tree, model.config)
    assert set(sd) == set(model.state_dict())
    assert sd["blocks.1.moe.experts.w_in"].shape == (4, 128, 512)
    assert sd["blocks.0.moe.router.kernel"].shape == (128, 4)
    back = gpt_params_to_jax(model.state_dict(), model.config)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # adamw's default mask: ndim > 1 of the JAX leaves ([L, ...] stacked)
    mask = default_decay_mask(dict(model.named_parameters()))
    flags = gpt_params_from_jax(
        jax.tree.map(lambda p: np.full(p.shape, p.ndim > 1), tree),
        model.config)
    assert mask == {k: bool(v.all()) for k, v in flags.items()}
    assert mask["blocks.0.moe.experts.b_in"]
    assert mask["blocks.0.moe.router.kernel"]
    assert mask["word"] and not mask["ln_f.beta"]


def test_port_init_is_a_moe_bank():
    model = GPT(tgpt_mod.gpt_tiny(moe_experts=4), device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "blocks.0.moe.experts.w_out" in names
    assert not any(".ffn." in n for n in names)
    w = model.blocks[0].moe.experts.w_in.detach()
    assert float(w.abs().max()) <= np.sqrt(6.0 / (128 + 512))
    assert float(w.std()) > 0.02          # glorot, not the 0.02 normal


def test_apply_returns_the_jax_aux():
    jmodel, jparams, model = _models()
    ids = _ids(0)[:, :32]
    jh, jaux = jmodel.apply(jparams, jnp.asarray(ids), return_aux=True)
    with torch.no_grad():
        h, aux = model.apply(torch.from_numpy(ids), return_aux=True)
    _close(h.numpy(), jh)
    _close(float(aux), float(jaux))
    assert float(aux) > 0
    dense = GPT(tgpt_mod.gpt_tiny(dropout_rate=0.0), device="cpu")
    with torch.no_grad():
        _, zero = dense.apply(torch.from_numpy(ids), return_aux=True)
    assert float(zero) == 0.0


@pytest.mark.parametrize("remat,chunk,masked", [
    (None, 0, False), ("full", 0, True), ("dots", 16, False),
    (None, 24, True)],
    ids=["plain", "remat_full_masked", "remat_dots_chunked",
         "chunked_masked"])
def test_lm_loss_moe_aux_and_grads_match_jax(remat, chunk, masked):
    kw = dict(loss_seq_chunk=chunk)
    if remat:
        kw.update(remat=True, remat_policy=remat)
    jmodel, jparams, model = _models(**kw)
    model.config = dataclasses.replace(
        model.config, loss_seq_chunk=chunk, remat=bool(remat),
        remat_policy=remat or "full")
    ids = _ids(0)
    batch = {"input_ids": jnp.asarray(ids)}
    tbatch = {"input_ids": torch.from_numpy(ids)}
    if masked:
        mask = np.random.default_rng(1).random((2, 32)) < 0.6
        batch["loss_mask"] = jnp.asarray(mask, jnp.float32)
        tbatch["loss_mask"] = torch.from_numpy(mask)
    jloss_fn = jmodel.lm_loss_fn()
    (want, (jmetrics, _)), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, (), batch, jax.random.PRNGKey(0), False),
        has_aux=True)(jparams)
    params = dict(model.named_parameters())
    loss, (metrics, _) = model.lm_loss_fn()(params, (), tbatch, None, False)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    _close(loss.item(), float(want), "loss")
    assert set(metrics) == set(jmetrics) and "moe_aux" in metrics
    for k in metrics:
        _close(metrics[k].item(), float(jmetrics[k]), k)
    _tree_close(grads, jgrads, model.config)
    assert float(grads["blocks.1.moe.router.kernel"].abs().sum()) > 0


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_steps_match_jax_with_jitter_off(accum, monkeypatch):
    monkeypatch.setattr(jgpt_mod, "apply_moe",
                        functools.partial(jmoe.apply_moe, jitter=0.0))
    monkeypatch.setattr(tgpt_mod, "apply_moe",
                        functools.partial(tmoe.apply_moe, jitter=0.0))
    jmodel, jparams, model = _models()
    jo, to = jopt.adamw(1e-3), adamw(1e-3)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, grad_clip_norm=1.0,
                       accum_steps=accum)
    jstate = JState.create(jparams, jo.init(jparams))
    params = dict(model.named_parameters())
    step = make_custom_train_step(model.lm_loss_fn(), to, grad_clip_norm=1.0,
                                  accum_steps=accum)
    state = TrainState.create(params, to.init(params))
    for i in range(3):
        ids = _ids(10 + i, b=4)
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = step(state, {"input_ids": torch.from_numpy(ids)})
        assert set(m) == set(jm) and "moe_aux" in m
        for k in jm:
            _close(float(m[k]), float(jm[k]), f"step {i} {k}")
    _tree_close(dict(model.named_parameters()), jstate.params, model.config)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_replays_the_router_jitter(policy):
    """At train=True the router input is jittered from the step's
    generator; the recomputed forward of a remat block must draw the
    same noise, so loss and gradients equal those without remat."""
    _, _, model = _models()
    ids = {"input_ids": torch.from_numpy(_ids(2))}
    got = []
    for remat in (False, True):
        model.config = dataclasses.replace(model.config, remat=remat,
                                           remat_policy=policy)
        params = dict(model.named_parameters())
        loss, (m, _) = model.lm_loss_fn()(
            params, None, ids, torch.Generator().manual_seed(9), True)
        grads = torch.autograd.grad(loss, list(params.values()))
        got.append((loss.item(), m["moe_aux"].item(), grads))
    (l0, a0, g0), (l1, a1, g1) = got
    assert l0 == l1 and a0 == a1
    for x, y in zip(g0, g1):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    # the jitter was drawn: another seed routes differently
    params = dict(model.named_parameters())
    other, _ = model.lm_loss_fn()(params, None, ids,
                                  torch.Generator().manual_seed(10), True)
    assert other.item() != l1


def test_trains_with_jitter_and_reports_moe_aux():
    _, _, model = _models()
    params = dict(model.named_parameters())
    opt = adamw(1e-3)
    step = make_custom_train_step(model.lm_loss_fn(), opt)
    state = TrainState.create(params, opt.init(params))
    batch = {"input_ids": torch.from_numpy(_ids(3, b=4))}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["moe_aux"])) and float(m["moe_aux"]) > 0
    assert losses[-1] < losses[0]


def test_decode_steps_equal_the_full_forward_at_ample_capacity():
    jmodel, jparams, model = _models(moe_capacity_factor=4.0)
    ids = _ids(4, b=2, s=10)
    jfull = jmodel.logits(jparams, jmodel.apply(jparams, jnp.asarray(ids)))
    with torch.no_grad():
        full = model.logits(model.apply(torch.from_numpy(ids)))
    _close(full.numpy(), jfull)
    cache = model.init_cache(2, max_len=10)
    for t in range(10):
        lg, cache = model.decode_step(cache, torch.from_numpy(ids[:, t]))
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=2e-4, rtol=0)
    # a prefill window routes its own tokens: decode_block == the forward
    cache = model.init_cache(2, max_len=16)
    lg, cache = model.decode_block(cache, torch.from_numpy(ids))
    _close(lg.numpy(), np.asarray(jfull)[:, -1])


def test_paged_engine_greedy_matches_jax_engine():
    jmodel, jparams, model = _models(scale=5.0, moe_capacity_factor=4.0)
    prompts = [_ids(20 + i, b=1, s=n)[0] for i, n in enumerate((7, 5, 9, 3))]
    budgets = [9, 6, 4, 8]
    eng = Engine(model, device="cpu", num_slots=2, max_len=64,
                 prefill_chunk=4, tick_steps=3)
    hs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    eng.drain()
    jeng = jserve.Engine(jmodel, jparams, paged=True, num_slots=2,
                         max_len=64, prefill_chunk=4, tick_steps=3,
                         registry=metrics_lib.Registry())
    jhs = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    jeng.drain()
    assert all(h.status == "ok" for h in hs)
    got = [h.tokens for h in hs]
    assert got == [h.tokens for h in jhs]
    assert len({t for toks in got for t in toks}) > 4   # tokens vary
    want = [np.asarray(jmodel.generate(jparams, jnp.asarray(p[None]),
                                       max_new_tokens=n, max_len=64)
                       )[0, p.size:].tolist()
            for p, n in zip(prompts, budgets)]
    assert got == want


def test_swiglu_refusal_and_partition_rules():
    with pytest.raises(ValueError, match="moe_experts with ffn_activation="
                                         "'swiglu' is unsupported"):
        GPTConfig(ffn_activation="swiglu", moe_experts=4)
    with pytest.raises(ValueError, match="swiglu"):
        jgpt_mod.GPTConfig(ffn_activation="swiglu", moe_experts=4)
    from distributed_tensorflow_tpu_torch import ops
    assert ops.moe_partition_rules()[0] == (r"experts[./]w_in$",
                                            ("expert", None, "tensor"))
