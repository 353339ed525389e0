"""Checkpoints of the port held against the JAX package's
``train/checkpoint.py``: the same files, read by either side.

- A port save restores into the port, in place: the model's parameters,
  the moments and the EMA shadow keep their identity, and the values and
  host fields come back bit for bit.
- A JAX ``checkpoint.save`` of a 2-step ``TrainState`` (``with_ema(adamw)``
  and ``LossScaled(DynamicLossScale)``) restores into the port, and the
  port's third step matches JAX's third step (1e-5 absolute on metrics
  and parameters, f32: another summation order); the port's save of
  that step restores with JAX's ``checkpoint.restore`` to the same
  values.
- For one state (carried across by ``train_state_from_jax``) the two
  packages write equal manifests: paths, shapes, dtypes and CRCs.
- A bf16 leaf round-trips through both packages (stored as uint16).
- ``verify`` finds a flipped byte; ``restore_latest_good`` quarantines it
  and falls back one step; ``max_to_keep``, the index file and
  ``AsyncCheckpointer``.
- The leaves' CRC-32C, native and numpy, equals the JAX package's byte
  loop.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.train import checkpoint as jckpt
from distributed_tensorflow_tpu.train import precision as jprec
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (GPT, TrainState, adamw,
                                              ema_params, gpt_params_to_jax,
                                              gpt_tiny,
                                              make_custom_train_step,
                                              train_state_from_jax, with_ema)
from distributed_tensorflow_tpu_torch.train import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.train import precision as tprec

torch.set_num_threads(1)

TOL = 1e-5


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (2, 17)).astype(np.int32) for _ in range(n)]


def _port_state(seed=0):
    """A port gpt_tiny state: with_ema(adamw), a dynamic loss scale."""
    model = GPT(gpt_tiny(dropout_rate=0.0), device="cpu",
                generator=torch.Generator().manual_seed(seed))
    params = dict(model.named_parameters())
    opt = with_ema(adamw(1e-3), decay=0.9)
    state = tprec.attach_loss_scale(
        TrainState.create(params, opt.init(params)),
        tprec.DynamicLossScale.create(2.0 ** 8, growth_interval=2,
                                      device="cpu"))
    step = make_custom_train_step(model.lm_loss_fn(), opt,
                                  grad_clip_norm=1.0, loss_scale=True)
    return model, state, step


def _jax_state(steps):
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    opt = jopt.with_ema(jopt.adamw(1e-3), decay=0.9)
    jstate = jprec.attach_loss_scale(
        JState.create(jparams, opt.init(jparams)),
        jprec.DynamicLossScale.create(2.0 ** 8, growth_interval=2))
    jstep = jmake_step(jmodel.lm_loss_fn(), opt, grad_clip_norm=1.0,
                       loss_scale=True)
    for ids in _batches()[:steps]:
        jstate, _ = jstep(jstate, {"input_ids": jnp.asarray(ids)})
    return jstate, jstep


def _snapshot(state):
    return tckpt._host_tree(state)


def _assert_trees_equal(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), path


def test_port_save_restores_into_the_port_in_place(tmp_path):
    model, state, step = _port_state()
    for ids in _batches(2):
        state, _ = step(state, {"input_ids": torch.from_numpy(ids)})
    path = tckpt.save(str(tmp_path), state.step, state)
    want = _snapshot(state)
    # a fresh state from other weights, restored in place
    model2, fresh, _ = _port_state(seed=1)
    tensors = [t for _, t in tckpt._flatten(fresh)
               if isinstance(t, torch.Tensor)]
    got = tckpt.restore(fresh, path)
    _assert_trees_equal(_snapshot(got), want)
    assert got.step == 2 and got.opt_state.count == 2
    assert got.opt_state.inner["ema"].count == 2
    assert got.model_state.loss_scale.growth_interval == 2
    after = [t for _, t in tckpt._flatten(got) if isinstance(t, torch.Tensor)]
    assert len(after) == len(tensors)
    assert all(a is b for a, b in zip(after, tensors))
    own = dict(model2.named_parameters())
    assert all(got.params[k] is own[k] for k in own)


def test_jax_checkpoint_restores_into_the_port_and_trains_on(tmp_path):
    jstate, jstep = _jax_state(2)
    jpath = jckpt.save(str(tmp_path / "jax"), 2, jstate)
    model, state, step = _port_state(seed=1)
    ok, why = tckpt.verify(jpath, target=state)
    assert ok, why
    state = tckpt.restore(state, jpath)
    assert state.step == 2 and state.opt_state.inner["opt"].count == 2
    ids = _batches()[2]
    jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
    state, m = step(state, {"input_ids": torch.from_numpy(ids)})
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=TOL,
                                   rtol=0, err_msg=k)
    for got, want in ((gpt_params_to_jax(model.state_dict(), model.config),
                       jstate.params),
                      (gpt_params_to_jax(ema_params(state.opt_state),
                                         model.config),
                       jopt.ema_params(jstate.opt_state))):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0)
    # and back: the port's save of step 3 restores with JAX's restore
    path = tckpt.save(str(tmp_path / "port"), state.step, state)
    back = jckpt.restore(jstate, path)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=TOL,
                                   rtol=0)


def test_manifests_equal_the_jax_manifest(tmp_path):
    jstate, _ = _jax_state(2)
    _, state, _ = _port_state()
    state = train_state_from_jax(jstate, state)
    jpath = jckpt.save(str(tmp_path / "jax"), 2, jstate)
    path = tckpt.save(str(tmp_path / "port"), state.step, state)
    with open(os.path.join(jpath, "manifest.json")) as f:
        want = json.load(f)
    with open(os.path.join(path, "manifest.json")) as f:
        got = json.load(f)
    assert got == want
    assert len(got["leaves"]) == len(jax.tree.leaves(jstate))


def test_a_bf16_leaf_round_trips(tmp_path):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tree = {"w": x, "n": torch.arange(4, dtype=torch.int32)}
    path = tckpt.save(str(tmp_path), 1, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        metas = json.load(f)["leaves"]
    assert [m["dtype"] for m in metas] == ["int32", "bfloat16"]
    target = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
              "n": torch.zeros(4, dtype=torch.int32)}
    got = tckpt.restore(target, path)
    assert got["w"] is target["w"] and torch.equal(got["w"], x)
    jtarget = {"w": jnp.zeros((3, 5), jnp.bfloat16),
               "n": jnp.zeros(4, jnp.int32)}
    jgot = jckpt.restore(jtarget, path)
    np.testing.assert_array_equal(
        np.asarray(jgot["w"]).view(np.uint16),
        x.view(torch.int16).numpy().view(np.uint16))
    # and a JAX bf16 save restores into the port
    jpath = jckpt.save(str(tmp_path / "j"), 1, {
        "w": jnp.asarray(x.float().numpy().astype(ml_dtypes.bfloat16)),
        "n": jnp.arange(4, dtype=jnp.int32)})
    target["w"].zero_()
    assert torch.equal(tckpt.restore(target, jpath)["w"], x)


def _flip_a_byte(path):
    """Flip one byte in the middle of the npz's largest member."""
    npz = os.path.join(path, "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(data))


def test_verify_quarantine_and_fall_back(tmp_path):
    model, state, step = _port_state()
    d = str(tmp_path)
    saved = {}
    for ids in _batches(3):
        state, _ = step(state, {"input_ids": torch.from_numpy(ids)})
        tckpt.save(d, state.step, state, max_to_keep=2)
        saved[state.step] = _snapshot(state)
    assert [os.path.basename(p) for p in tckpt.all_checkpoints(d)] == \
        ["ckpt-0000000002", "ckpt-0000000003"]
    assert open(os.path.join(d, "checkpoint")).read() == "ckpt-0000000003\n"
    assert tckpt.latest_step(d) == 3
    newest = tckpt.latest_checkpoint(d)
    assert tckpt.verify(newest, target=state) == (True, "")
    _flip_a_byte(newest)
    ok, why = tckpt.verify(newest)
    assert not ok and ("CRC mismatch" in why or "unreadable" in why), why
    _, fresh, _ = _port_state(seed=1)
    got, path = tckpt.restore_latest_good(fresh, d)
    assert os.path.basename(path) == "ckpt-0000000002"
    assert got.step == 2
    _assert_trees_equal(_snapshot(got), saved[2])
    quarantined = os.path.join(d, "corrupt-ckpt-0000000003")
    assert os.path.isdir(quarantined)
    assert "CRC" in open(os.path.join(quarantined, "QUARANTINE_REASON")
                         ).read() or "unreadable" in open(os.path.join(
                             quarantined, "QUARANTINE_REASON")).read()
    assert tckpt.latest_step(d) == 2          # the index entry is gone
    ok, why = tckpt.verify(path, target={"x": torch.zeros(1)})
    assert not ok and "leaves but target has" in why


def test_async_checkpointer_writes_in_order(tmp_path):
    model, state, step = _port_state()
    writer = tckpt.AsyncCheckpointer()
    snaps = {}
    try:
        for ids in _batches(3):
            state, _ = step(state, {"input_ids": torch.from_numpy(ids)})
            writer.save(str(tmp_path), state.step, state, max_to_keep=3)
            snaps[state.step] = _snapshot(state)
        writer.wait()
    finally:
        writer.close()
    assert tckpt.latest_step(str(tmp_path)) == 3
    _, fresh, _ = _port_state(seed=1)
    for s in (1, 2, 3):
        got = tckpt.restore(fresh, tckpt.ckpt_path(str(tmp_path), s))
        _assert_trees_equal(_snapshot(got), snaps[s])


def test_restore_refuses_another_structure(tmp_path):
    _, state, _ = _port_state()
    path = tckpt.save(str(tmp_path), 0, state)
    model = GPT(gpt_tiny(num_layers=1), device="cpu")
    params = dict(model.named_parameters())
    other = TrainState.create(params, adamw().init(params))
    with pytest.raises(ValueError, match="leaves but target has"):
        tckpt.restore(other, path)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, 256, 1000, 70_001])
def test_crc32c_forms_equal_the_reference_byte_loop(n):
    """The checkpoint's CRC-32C: the host routine of ``csrc/crc32c.cpp``
    (what ``crc32c`` and ``masked_crc32c`` run) equals the JAX package's
    byte loop, bit for bit, from a zero and from a given register, on a
    bytes object and on a numpy array."""
    from distributed_tensorflow_tpu.summary.crc32c import \
        masked_crc32c as jmasked
    from distributed_tensorflow_tpu.summary.crc32c import py_crc32c
    from distributed_tensorflow_tpu_torch.summary import crc32c as tcrc
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    want = py_crc32c(data, 0x1234 if n % 2 else 0)
    assert tcrc._native() is not None
    assert tcrc.crc32c(data, 0x1234 if n % 2 else 0) == want
    assert tcrc.masked_crc32c(data) == jmasked(data)
    assert tcrc.crc32c(np.frombuffer(data, np.uint8)) == py_crc32c(data)


def test_train_state_round_trips_through_the_jax_tree():
    """``train_state_from_jax`` then ``train_state_to_jax`` give back the
    JAX state's leaves in its flatten order, paths, dtypes and values
    equal."""
    from distributed_tensorflow_tpu_torch import train_state_to_jax
    jstate, _ = _jax_state(2)
    _, state, _ = _port_state(seed=1)
    got = tckpt._flatten(train_state_to_jax(train_state_from_jax(jstate,
                                                                 state)))
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
