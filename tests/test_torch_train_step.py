"""The port's ``make_custom_train_step`` options held against the JAX
package's step: gradient accumulation, the precision policy, loss scaling,
the non-finite skip and the device-health metrics.

Same weights (the JAX ``gpt_tiny`` tree carried across), same numpy
batches with a ``loss_mask`` whose counts differ per row (so they differ
per microbatch), dropout 0, ``adamw(1e-3)``, clip 1.0, two steps.

Tolerances:
- f32: 1e-5 absolute on losses, metrics and parameters (another
  summation order; the accumulators add the same weighted terms).
- bf16 / f16 policies (each side rounds its activations and the cast
  parameters on its own): losses within 2e-3 absolute and the grad norm
  within 2e-2 relative (a few ulps of 2**-8 / 2**-11 through two layers);
  parameters within ``4 * lr`` (an Adam step moves an element by at most
  ~lr, and an element whose gradient is ~0 may step the other way on one
  side, in each of two steps), with at most 2% of elements off by more
  than ``lr / 10`` (a few-percent difference of a gradient moves an Adam
  step by that fraction of lr).
- Loss scaling and the skip: the skipped steps, the scale sequence and
  the finite flags are equal; parameters are bit-equal across a skip.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.train import precision as jprec
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, TrainState,
                                              adamw, gpt_params_to_jax,
                                              load_jax_params,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch.train import precision as tprec

torch.set_num_threads(1)

F32_TOL = 1e-5
LR = 1e-3
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16)}


def _models(dtype="float32"):
    jdt, tdt = _DTYPES[dtype]
    jmodel = jgpt_tiny(dropout_rate=0.0, dtype=jdt)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position, dropout_rate=0.0,
                       dtype=tdt)
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _batches(n, seed=5, b=4, s=17):
    """``n`` batches of [b, s] ids and a [b, s - 1] mask whose rows keep
    about 20%, 50%, 80% and 100% of their tokens."""
    rng = np.random.default_rng(seed)
    keep = np.array([0.2, 0.5, 0.8, 1.0])[:b, None]
    return [(rng.integers(0, 512, (b, s)).astype(np.int32),
             (rng.random((b, s - 1)) < keep).astype(np.float32))
            for _ in range(n)]


def _pair(ids, mask):
    return ({"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)},
            {"input_ids": torch.from_numpy(ids),
             "loss_mask": torch.from_numpy(mask)})


def _run(steps=2, dtype="float32", batches=None, **kw):
    """Both packages' steps over the same batches: (per-step port
    metrics, per-step JAX metrics, port state, JAX state, port model)."""
    jmodel, jparams, model = _models(dtype)
    jo, to = jopt.adamw(LR), adamw(LR)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, grad_clip_norm=1.0, **kw)
    step = make_custom_train_step(model.lm_loss_fn(), to, grad_clip_norm=1.0,
                                  **kw)
    params = dict(model.named_parameters())
    jstate = JState.create(jparams, jo.init(jparams))
    state = TrainState.create(params, to.init(params))
    got, want = [], []
    for ids, mask in batches or _batches(steps):
        jb, tb = _pair(ids, mask)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        got.append(m)
        want.append(jm)
    return got, want, state, jstate, model


def _params_err(model, jparams):
    got = gpt_params_to_jax(model.state_dict(), model.config)
    return np.concatenate([np.ravel(np.abs(a - np.asarray(b)))
                           for a, b in zip(jax.tree.leaves(got),
                                           jax.tree.leaves(jparams))])


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_accumulation_matches_jax(accum):
    got, want, state, jstate, model = _run(accum_steps=accum)
    for i, (m, jm) in enumerate(zip(got, want)):
        assert set(m) == set(jm) == {"loss", "token_accuracy", "loss_weight",
                                     "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       atol=F32_TOL, rtol=0,
                                       err_msg=f"step {i} {k}")
    assert state.step == int(jstate.step) == 2
    assert state.opt_state.count == int(jstate.opt_state.count) == 2
    assert _params_err(model, jstate.params).max() <= F32_TOL


def test_accumulation_of_four_equals_the_full_batch():
    """Weighted by each microbatch's mask count, four microbatches give
    the full batch's masked-mean loss, metrics and update."""
    full = _run(accum_steps=1)
    four = _run(accum_steps=4)
    for m1, m4 in zip(full[0], four[0]):
        for k in m1:
            np.testing.assert_allclose(float(m4[k]), float(m1[k]),
                                       atol=F32_TOL, rtol=0, err_msg=k)
    for k, p in full[4].state_dict().items():
        np.testing.assert_allclose(four[4].state_dict()[k].numpy(),
                                   p.numpy(), atol=F32_TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("policy,dtype,accum",
                         [("mixed_bfloat16", "bfloat16", 1),
                          ("mixed_float16", "float16", 2)])
def test_precision_policy_matches_jax(policy, dtype, accum):
    got, want, state, jstate, model = _run(dtype=dtype, policy=policy,
                                           accum_steps=accum)
    for i, (m, jm) in enumerate(zip(got, want)):
        assert set(m) == set(jm)
        assert all(v.dtype == torch.float32 for v in m.values())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=2e-3, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2,
                                   err_msg=f"step {i}")
        assert float(m["loss_weight"]) == float(jm["loss_weight"])
    # the f32 parameters took the updates; the gradients landed on them
    assert all(p.dtype == torch.float32 for p in model.parameters())
    err = _params_err(model, jstate.params)
    assert err.max() <= 4 * LR, err.max()
    assert (err > LR / 10).mean() <= 0.02, (err > LR / 10).mean()


def _planted(steps, bad):
    """Batches whose step ``i in bad`` carries an infinite mask weight:
    its loss, and every gradient, is NaN on both sides."""
    batches = _batches(steps)
    for i in bad:
        batches[i][1][0, 0] = np.inf
    return batches


def test_loss_scale_skips_the_jax_steps_with_its_scale_sequence():
    bad = (1, 2, 5)
    batches = _planted(7, bad)

    def create(lib, kw):
        return lib.DynamicLossScale.create(2.0 ** 8, growth_interval=2,
                                           **kw)
    jmodel, jparams, model = _models()
    jo, to = jopt.adamw(LR), adamw(LR)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, grad_clip_norm=1.0,
                       loss_scale=True)
    step = make_custom_train_step(model.lm_loss_fn(), to, grad_clip_norm=1.0,
                                  loss_scale=True)
    params = dict(model.named_parameters())
    jstate = jprec.attach_loss_scale(JState.create(jparams, jo.init(jparams)),
                                     create(jprec, {}))
    state = tprec.attach_loss_scale(TrainState.create(params,
                                                      to.init(params)),
                                    create(tprec, {"device": "cpu"}))
    scales, jscales = [], []
    for i, (ids, mask) in enumerate(batches):
        jb, tb = _pair(ids, mask)
        before = {k: p.detach().clone() for k, p in params.items()}
        count = state.opt_state.count
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) == \
            (i not in bad), i
        scales.append(float(m["loss_scale"]))
        jscales.append(float(jm["loss_scale"]))
        ls = state.model_state.loss_scale
        assert float(ls.value) == float(jstate.model_state.loss_scale.value)
        assert int(ls.streak) == int(jstate.model_state.loss_scale.streak)
        if i in bad:
            assert float(m["loss"]) == float(jm["loss"]) == 0.0
            assert all(torch.equal(p, before[k]) for k, p in params.items())
            assert state.opt_state.count == count
        else:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       atol=F32_TOL, rtol=0)
    assert scales == jscales
    assert scales == [256.0, 128.0, 64.0, 64.0, 128.0, 64.0, 64.0]
    assert state.step == 7 and state.opt_state.count == 7 - len(bad)
    assert _params_err(model, jstate.params).max() <= F32_TOL


def test_skip_nonfinite_matches_jax():
    bad = (1,)
    got, want, state, jstate, model = _run(
        batches=_planted(3, bad), skip_nonfinite=True, device_health=True)
    for i, (m, jm) in enumerate(zip(got, want)):
        assert set(m) == set(jm)
        assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) == \
            (i not in bad)
        if i in bad:
            assert np.isnan(float(m["grad_norm"])) and \
                np.isnan(float(jm["grad_norm"]))
            assert float(m["nonfinite_grads"]) == float(jm["nonfinite_grads"])
    assert state.opt_state.count == int(jstate.opt_state.count) == 2
    assert _params_err(model, jstate.params).max() <= F32_TOL


@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
def test_device_health_keys_and_values(clip):
    jmodel, jparams, model = _models()
    jo, to = jopt.adamw(LR), adamw(LR)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, grad_clip_norm=clip,
                       device_health=True)
    step = make_custom_train_step(model.lm_loss_fn(), to,
                                  grad_clip_norm=clip, device_health=True)
    params = dict(model.named_parameters())
    jb, tb = _pair(*_batches(1)[0])
    _, jm = jstep(JState.create(jparams, jo.init(jparams)), jb)
    _, m = step(TrainState.create(params, to.init(params)), tb)
    assert set(m) == set(jm) >= {"grad_norm", "nonfinite_grads"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=F32_TOL, err_msg=k)
    assert float(m["nonfinite_grads"]) == 0.0


def test_the_reference_errors():
    _, _, model = _models()
    opt = adamw(LR)
    params = dict(model.named_parameters())
    state = TrainState.create(params, opt.init(params))
    with pytest.raises(ValueError, match="already skips"):
        make_custom_train_step(model.lm_loss_fn(), opt, loss_scale=True,
                               skip_nonfinite=True)
    scaled = make_custom_train_step(model.lm_loss_fn(), opt, loss_scale=True)
    ids, mask = _batches(1)[0]
    with pytest.raises(TypeError, match="attach_loss_scale"):
        scaled(state, {"input_ids": torch.from_numpy(ids)})
    three = make_custom_train_step(model.lm_loss_fn(), opt, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        three(state, {"input_ids": torch.from_numpy(ids)})


def test_loss_fn_takes_only_the_models_parameters_or_their_casts():
    """The policy's casts pass; a dict of clones (a restore or a
    conversion that rebound the state) is refused, because it would
    train tensors that generation and the engines never read."""
    _, _, model = _models()
    loss_fn = model.lm_loss_fn()
    params = dict(model.named_parameters())
    batch = {"input_ids": torch.from_numpy(_batches(1)[0][0])}
    for ok in (params, tprec.policy("mixed_bfloat16").cast_to_compute(params)):
        loss, _ = loss_fn(ok, None, batch, None, False)
        assert torch.isfinite(loss)
    clones = {k: p.detach().clone().requires_grad_() for k, p in params.items()}
    for bad in (clones, tprec.policy("mixed_bfloat16").cast_to_compute(clones),
                {**params, "word": clones["word"]}):
        with pytest.raises(ValueError, match="own parameters"):
            loss_fn(bad, None, batch, None, False)


def test_overflowed_scaled_loss_reports_the_loss():
    """At a scale where the scaled loss overflows to inf and every
    gradient stays finite, both packages apply the update; the JAX step
    reports the scaled loss unscaled (inf, which would stop a run under
    ``NaNHook``), the port reports the loss itself (a fault of the
    reference that the port repairs; see ``train/step.py``)."""
    def create(lib, kw):
        return lib.DynamicLossScale.create(2.0 ** 126, **kw)
    jmodel, jparams, model = _models()
    jo, to = jopt.adamw(LR), adamw(LR)
    jstep = jmake_step(jmodel.lm_loss_fn(), jo, loss_scale=True)
    plain = jmake_step(jmodel.lm_loss_fn(), jo)
    step = make_custom_train_step(model.lm_loss_fn(), to, loss_scale=True)
    params = dict(model.named_parameters())
    jstate = jprec.attach_loss_scale(JState.create(jparams, jo.init(jparams)),
                                     create(jprec, {}))
    state = tprec.attach_loss_scale(TrainState.create(params,
                                                      to.init(params)),
                                    create(tprec, {"device": "cpu"}))
    # 8 rows: over this many tokens every gradient stays finite at 2**126
    # (over 2 or 4 rows some overflow, and both sides skip the step)
    ids = np.random.default_rng(0).integers(0, 512, (8, 17)).astype(np.int32)
    copy = jax.tree.map(jnp.copy, jparams)      # the step donates its state
    _, want = plain(JState.create(copy, jo.init(copy)),
                    {"input_ids": jnp.asarray(ids)})
    jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
    state, m = step(state, {"input_ids": torch.from_numpy(ids)})
    assert bool(jm["grads_finite"]) and bool(m["grads_finite"])
    assert np.isinf(float(jm["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(want["loss"]),
                               atol=F32_TOL, rtol=0)
    assert state.opt_state.count == int(jstate.opt_state.count) == 1
    # unclipped gradients at 2**126, unscaled: an element whose gradient
    # is ~0 may take a rounding-sized different Adam step (the 1e-4 of
    # tests/test_torch_gpt_train.py)
    assert _params_err(model, jstate.params).max() <= 1e-4


def test_grad_health_and_tree_bytes_match_jax():
    from distributed_tensorflow_tpu.obs import device as jdev
    from distributed_tensorflow_tpu_torch.obs import device as tdev
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    tree["b"][1], tree["a"][2, 0] = np.nan, np.inf
    got = tdev.grad_health({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jdev.grad_health({k: jnp.asarray(v) for k, v in tree.items()})
    assert set(got) == set(want) == {"grad_norm", "nonfinite_grads"}
    assert float(got["nonfinite_grads"]) == float(want["nonfinite_grads"])
    assert np.isnan(float(got["grad_norm"])) == \
        np.isnan(float(want["grad_norm"]))
    tree["b"][1] = tree["a"][2, 0] = 1.0
    got = tdev.grad_health({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jdev.grad_health({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-6)
    _, jparams, model = _models()
    opt = adamw(LR)
    params = dict(model.named_parameters())
    state = TrainState.create(params, opt.init(params))
    jstate = JState.create(jparams, jopt.adamw(LR).init(jparams))
    # the port's step and Adam count are host ints, the JAX state's two
    # int32 scalars
    assert tdev.tree_bytes(state) == jdev.tree_bytes(jstate) - 8
    assert tdev.tree_bytes(params) == jdev.tree_bytes(jparams)
