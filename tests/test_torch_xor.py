"""``example.py``'s path in the port, held against the JAX package.

- ``data.xor_data`` equals the JAX package's arrays for the same seed;
  ``xor_batch_native`` (``csrc/xor.cpp``) is byte-equal to the JAX
  package's ``utils.native.xor_generate`` for n = 1, 4095, 4096 and
  10,000 and two seeds (skipped only where the JAX package's own native
  library cannot build, as ``tests/test_native.py`` skips).
- ``prefetch_to_device`` on the CPU: every batch in order and in its
  structure; at most ``size`` batches staged ahead; an abandoned
  generator ends its producer; a producer error reaches the consumer.
- ``make_train_step`` / ``make_eval_step`` on the XOR MLP at dropout 0
  against the JAX builders, 10 steps from the same weights and batches:
  losses within 1e-6 relative, parameters and both Adam moments within
  1e-5 absolute (f32; another summation order), the eval metrics within
  1e-6; the same with ``accum_steps=2`` over ``(x, y)`` batches.
- Under ``policy="mixed_bfloat16"`` the ``(x, y)`` batch and the
  parameters are cast to bf16 inside the step: parameters stay f32, and 3
  steps' losses and the eval metrics are within 2e-2 of the JAX
  package's (bf16 products rounded on each side).
- ``stack_params_*`` and ``train_state_*`` round trips, and a
  ``TrainState`` carried across gives equal leaves in the JAX layout.
- ``add_graph``: the graph record (with a fixed wall time) is
  byte-equal to the JAX package's, through ``SummaryWriter``.
- Checkpoints across the packages: a port ``TrainSession`` checkpoint
  of the XOR MLP with ``with_ema(adam())`` restores through the JAX
  package's ``train.checkpoint`` into ``example.py``'s state tree with
  equal leaves, and a JAX checkpoint of that tree restores into the
  port's state with equal leaves.
- The entry point ``python -m distributed_tensorflow_tpu_torch.example
  --device=cpu --epochs=1`` (run in-process): ``example.py``'s 30,000
  samples, 600 steps; the epoch line, a checkpoint at step 600, and an
  event file with the graph record and the ``val/*`` scalars; with no
  card, ``--device`` left at its default raises.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import data as jdata
from distributed_tensorflow_tpu import ops as jops
from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.summary import SummaryWriter as JWriter
from distributed_tensorflow_tpu.train import checkpoint as jckpt
from distributed_tensorflow_tpu.utils import native as jnative
from distributed_tensorflow_tpu_torch import data as tdata
from distributed_tensorflow_tpu_torch import example as texample
from distributed_tensorflow_tpu_torch import ops as tops
from distributed_tensorflow_tpu_torch import optim as topt
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.data import tfrecord as trec
from distributed_tensorflow_tpu_torch.data.xor import xor_batch_native
from distributed_tensorflow_tpu_torch.models.convert import (
    stack_params_from_jax, stack_params_to_jax, train_state_from_jax,
    train_state_to_jax)
from distributed_tensorflow_tpu_torch.summary import SummaryWriter
from distributed_tensorflow_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5
METRIC_TOL = 1e-6


def test_xor_data_equals_jax():
    (a, b), (c, d) = tdata.xor_data(300, 40, seed=3)
    (ja, jb), (jc, jd) = jdata.xor_data(300, 40, seed=3)
    for got, want in ((a, ja), (b, jb), (c, jc), (d, jd)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b, np.bitwise_xor(
        a[:, :32].astype(int), a[:, 32:].astype(int)))


@pytest.mark.parametrize("n", [1, 4095, 4096, 10_000])
@pytest.mark.parametrize("seed", [0, 12345])
def test_native_xor_is_byte_equal_to_jax(n, seed):
    if not jnative.native_available():
        pytest.skip("the JAX package's native library cannot build here")
    x, y = xor_batch_native(n, seed)
    jx, jy = jnative.xor_generate(n, 32, seed)
    assert x.shape == (n, 64) and y.shape == (n, 32)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


# -- prefetch_to_device ----------------------------------------------------

def _source(n, pulled=None, fail_at=None):
    for i in range(n):
        if fail_at == i:
            raise RuntimeError("producer failed")
        if pulled is not None:
            pulled.append(i)
        yield (np.full((2, 3), i, np.float32), {"id": np.array([i])})


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "dttpu-torch-prefetch" and t.is_alive()]


def test_prefetch_yields_every_batch_in_order():
    out = list(tdata.prefetch_to_device(_source(7), size=2, device="cpu"))
    assert len(out) == 7
    for i, (x, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert int(d["id"]) == i
    with pytest.raises(ValueError, match="size"):
        next(tdata.prefetch_to_device(_source(1), size=0, device="cpu"))


def test_prefetch_bounds_what_it_stages_and_ends_when_abandoned():
    pulled = []
    before = len(_producers())
    gen = tdata.prefetch_to_device(_source(50, pulled), size=3,
                                   device="cpu")
    first = next(gen)
    time.sleep(0.2)
    # the consumer holds one; the producer stages up to 3 and waits with
    # one more pulled
    assert int(first[1]["id"]) == 0 and len(pulled) <= 3 + 1
    gen.close()
    deadline = time.time() + 10
    while len(_producers()) > before and time.time() < deadline:
        time.sleep(0.01)
    assert len(_producers()) == before
    assert len(pulled) < 50


def test_prefetch_raises_the_producers_error():
    gen = tdata.prefetch_to_device(_source(5, fail_at=2), device="cpu")
    assert int(next(gen)[1]["id"]) == 0
    assert int(next(gen)[1]["id"]) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(gen)


# -- the step builders against the JAX package -----------------------------

def _models(rate=0.0):
    def build(lib):
        return lib.serial(lib.Dense(128, activation="relu"),
                          lib.Dropout(rate),
                          lib.Dense(128, activation="relu"),
                          lib.Dropout(rate),
                          lib.Dense(32, activation="sigmoid"))
    return build(jops), build(tops)


def _states(jo, to, seed=0):
    jm, tm = _models()
    jstate = jtrain.init_train_state(jm, jo, jax.random.PRNGKey(seed), (64,))
    params = stack_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    return jm, tm, jstate, ttrain.TrainState.create(params, to.init(params),
                                                    {})


def _assert_tree(got, want, tol, what):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0,
                                   err_msg=f"{what}{path}")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_and_eval_steps_match_jax(accum):
    jo, to = jopt.adam(), topt.adam()
    jm, tm, jstate, tstate = _states(jo, to)
    metric_fns = {"accuracy": "bitwise_accuracy", "mae": "mae"}
    jstep = jtrain.make_train_step(jm, "mse", jo, metric_fns=metric_fns,
                                   accum_steps=accum)
    tstep = ttrain.make_train_step(tm, "mse", to, metric_fns=metric_fns,
                                   accum_steps=accum)
    (xt, yt), (xv, yv) = tdata.xor_data(500, 100, seed=1)
    batches = list(tdata.Dataset([xt, yt], 50, seed=1))[:10]
    for x, y in batches:
        jstate, jm_ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm_ = tstep(tstate, (torch.from_numpy(x),
                                     torch.from_numpy(y)))
        assert set(tm_) == set(jm_) == {"loss", "accuracy", "mae"}
        for k in tm_:
            assert isinstance(tm_[k], torch.Tensor) and tm_[k].dim() == 0
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL, atol=0)
        for k in ("accuracy", "mae"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       atol=METRIC_TOL, rtol=0)
    assert tstate.step == int(jstate.step) == 10
    assert tstate.opt_state.count == int(jstate.opt_state.count)
    _assert_tree(stack_params_to_jax(tstate.params), jstate.params,
                 PARAM_TOL, "params")
    for k in ("m", "v"):
        _assert_tree(stack_params_to_jax(tstate.opt_state.inner[k]),
                     jstate.opt_state.inner[k], PARAM_TOL, k)
    jeval = jtrain.make_eval_step(jm, "mse", metric_fns=metric_fns)
    teval = ttrain.make_eval_step(tm, "mse", metric_fns=metric_fns)
    jv = jeval(jstate, (jnp.asarray(xv), jnp.asarray(yv)))
    tv = teval(tstate, (torch.from_numpy(xv), torch.from_numpy(yv)))
    assert set(tv) == set(jv)
    for k in tv:
        assert not tv[k].requires_grad
        np.testing.assert_allclose(float(tv[k]), float(jv[k]),
                                   atol=METRIC_TOL, rtol=LOSS_RTOL)


def test_mixed_bfloat16_policy_casts_the_tuple_batch():
    jo, to = jopt.adam(), topt.adam()
    jm, tm, jstate, tstate = _states(jo, to, seed=3)
    kw = dict(metric_fns={"accuracy": "bitwise_accuracy"},
              policy="mixed_bfloat16")
    jstep = jtrain.make_train_step(jm, "mse", jo, **kw)
    in_bf16 = {"in_bf16": lambda p, y: torch.tensor(
        float(p.dtype == torch.bfloat16))}
    tstep = ttrain.make_train_step(tm, "mse", to, **dict(
        kw, metric_fns={**kw["metric_fns"], **in_bf16}))
    (x, y), _ = tdata.xor_data(150, 1, seed=4)
    for i in range(0, 150, 50):
        jstate, jm_ = jstep(jstate, (jnp.asarray(x[i:i + 50]),
                                     jnp.asarray(y[i:i + 50])))
        tstate, tm_ = tstep(tstate, (torch.from_numpy(x[i:i + 50]),
                                     torch.from_numpy(y[i:i + 50])))
        assert tm_["loss"].dtype == torch.float32
        assert float(tm_["in_bf16"]) == 1.0     # x was cast, not only W
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   atol=2e-2, rtol=0)
    assert all(p.dtype == torch.float32 for p in tstate.params.values())
    jv = jtrain.make_eval_step(jm, "mse", **kw)(jstate, (jnp.asarray(x),
                                                         jnp.asarray(y)))
    tv = ttrain.make_eval_step(tm, "mse", **kw)(tstate, (torch.from_numpy(x),
                                                         torch.from_numpy(y)))
    for k in tv:
        np.testing.assert_allclose(float(tv[k]), float(jv[k]), atol=2e-2,
                                   rtol=0)


def test_dropout_steps_are_deterministic_and_train_mode_only():
    """At the model's 0.3 the step's generator comes from (seed, step):
    two runs are equal, another seed differs; eval mode is dropout-free."""
    def run(seed):
        _, tm = _models(0.3)
        opt = topt.adam()
        state = ttrain.init_train_state(tm, opt,
                                        torch.Generator().manual_seed(0),
                                        (64,))
        step = ttrain.make_train_step(tm, "mse", opt, seed=seed)
        (x, y), _ = tdata.xor_data(50, 1, seed=0)
        for _ in range(3):
            state, m = step(state, (torch.from_numpy(x),
                                    torch.from_numpy(y)))
        return state, float(m["loss"])
    a, b, c = run(0), run(0), run(1)
    assert a[1] == b[1] != c[1]
    assert all(torch.equal(a[0].params[k], b[0].params[k])
               for k in a[0].params)


def test_stack_state_round_trips_through_the_jax_tree():
    jo, to = jopt.with_ema(jopt.adam()), topt.with_ema(topt.adam())
    jm, tm, jstate, tstate = _states(jo, to, seed=4)
    step = ttrain.make_train_step(tm, "mse", to)
    (x, y), _ = tdata.xor_data(50, 1, seed=2)
    for _ in range(2):
        tstate, _ = step(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
    tree = train_state_to_jax(tstate)

    def paths(t):
        return [(jax.tree_util.keystr(p), np.shape(x)) for p, x in
                jax.tree_util.tree_leaves_with_path(t)]
    assert paths(tree) == paths(jstate)
    assert sorted(tree.params) == ["dense", "dense_1", "dense_2"]
    assert tree.params["dense"]["kernel"].shape == (64, 128)
    _, _, _, fresh = _states(jo, to, seed=5)
    back = train_state_from_jax(tree, fresh)
    assert back.step == 2 and back.opt_state.inner["ema"].count == 2
    for k, p in tstate.params.items():
        assert torch.equal(back.params[k], p)
        assert back.params[k] is fresh.params[k]
        assert torch.equal(back.opt_state.inner["ema"].shadow[k],
                           tstate.opt_state.inner["ema"].shadow[k])


def test_add_graph_record_is_byte_equal_to_jax(tmp_path):
    jm, tm = _models(0.3)
    records = []
    for cls, model, sub in ((SummaryWriter, tm, "port"),
                            (JWriter, jm, "jax")):
        with cls(str(tmp_path / sub)) as w:
            w._writer.add_graph(model, wall_time=1234.5)
            w.add_graph([("a", "Placeholder", ()), ("b", "Dense", ("a",),
                                                    "/gpu:0")])
        (path,) = list((tmp_path / sub).iterdir())
        records.append(list(trec.read_tfrecord(str(path))))
    port, ref = records
    assert len(port) == len(ref) == 3
    assert port[1] == ref[1]
    assert port[2][9:] == ref[2][9:]        # past the wall time
    assert b"Placeholder" in port[1] and b"dense_2" in port[1]


# -- checkpoints across the packages ---------------------------------------

def _example_tree(seed=0):
    """``example.py``'s state tree, with ``with_ema(adam())``."""
    jm, _ = _models(0.3)
    return jtrain.init_train_state(jm, jopt.with_ema(jopt.adam()),
                                   jax.random.PRNGKey(seed), (64,))


def test_port_session_checkpoint_restores_into_jax(tmp_path, capsys):
    _, tm = _models(0.3)
    opt = topt.with_ema(topt.adam())
    state = ttrain.init_train_state(tm, opt, torch.Generator().manual_seed(0),
                                    (64,))
    step = ttrain.make_train_step(tm, "mse", opt,
                                  metric_fns={"acc": "bitwise_accuracy"})
    (x, y), _ = tdata.xor_data(200, 1, seed=0)
    ds = tdata.Dataset([x, y], 50)
    with ttrain.TrainSession(state, step, checkpoint_dir=str(tmp_path),
                             hooks=[ttrain.StopAtStepHook(last_step=4)]
                             ) as sess:
        for batch in tdata.prefetch_to_device(iter(ds), device="cpu"):
            if sess.should_stop():
                break
            sess.run_step(batch)
    assert sess.step == 4 and tckpt.latest_step(str(tmp_path)) == 4
    restored = jckpt.restore(_example_tree(seed=9),
                             jckpt.latest_checkpoint(str(tmp_path)))
    want = train_state_to_jax(sess.state)
    assert int(restored.step) == 4
    assert int(restored.opt_state.inner["ema"].count) == 4
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(restored),
            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_jax_checkpoint_restores_into_the_port(tmp_path, capsys):
    jm, _ = _models(0.0)
    jo = jopt.with_ema(jopt.adam())
    jstate = _example_tree(seed=1)
    jstep = jtrain.make_train_step(jm, "mse", jo)
    (x, y), _ = jdata.xor_data(50, 1, seed=0)
    for _ in range(3):
        jstate, _ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    jckpt.save(str(tmp_path), 3, jstate)
    _, tm = _models(0.3)
    opt = topt.with_ema(topt.adam())
    target = ttrain.init_train_state(tm, opt, torch.Generator().manual_seed(0),
                                     (64,))
    with ttrain.TrainSession(target, ttrain.make_train_step(tm, "mse", opt),
                             checkpoint_dir=str(tmp_path)) as sess:
        assert sess.step == 3
        got = train_state_to_jax(sess.state)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    assert "Restored checkpoint ckpt-0000000003" in capsys.readouterr().out


# -- the entry point ---------------------------------------------------------

def _graph_records(log_dir):
    (events,) = [p for p in os.listdir(log_dir) if "tfevents" in p]
    recs = list(trec.read_tfrecord(os.path.join(log_dir, events)))
    # Event{wall_time=1 (double), graph_def=4}: tag 0x09, 8 bytes, 0x22
    return recs, [r for r in recs if r[0] == 0x09 and r[9] == 0x22]


def test_entry_point_trains_one_epoch_on_the_cpu(tmp_path, capsys):
    log_dir = str(tmp_path / "xor")
    assert texample.main(["--device=cpu", "--epochs=1",
                          f"--log_dir={log_dir}"]) == 0
    out = capsys.readouterr().out
    assert "Running single-machine training" in out
    lines = [l for l in out.splitlines() if l.startswith("Epoch:")]
    assert len(lines) == 1 and lines[0].startswith("Epoch:    0  loss: ")
    assert float(lines[0].split("val acc:")[1]) > 0.5
    assert tckpt.latest_step(log_dir) == 600
    recs, graphs = _graph_records(log_dir)
    assert len(graphs) == 1
    jm, _ = _models(0.3)
    with JWriter(str(tmp_path / "ref")) as w:
        w._writer.add_graph(jm, wall_time=0.0)
    (ref,) = [p for p in os.listdir(tmp_path / "ref")]
    ref_graph = list(trec.read_tfrecord(str(tmp_path / "ref" / ref)))[1]
    assert graphs[0][9:] == ref_graph[9:]
    assert any(b"val/accuracy" in r for r in recs)
    assert sum(b"loss" in r for r in recs) >= 60   # SummaryHook every 10


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        texample.main(["--epochs=1", "--log_dir=/nonexistent/never"])
