"""The port's ``Sequential`` tier (callbacks, saving, the zoo, the
multi-step and masked eval steps, the three new entry points), held
against the JAX package.

Every comparison starts both packages from the same weights: the JAX
model is built from ``PRNGKey(0)``, and the port's takes them through
``set_weights(jax_model.get_weights())``.  Dropout is 0 wherever two
runs are compared (the two packages' dropout bits differ), the data are
numpy from a seed, and History values, ``evaluate`` means and predictions
agree within ``TOL * max(1, |want|)``, TOL 1e-5 (f32; summation order
only, through a few Adam steps).

- The XOR MLP (``xor_mlp``'s layers at dropout 0) and ``cifar_cnn``
  (dropout 0, 32x32x3, 64 samples): two-epoch ``fit`` with validation,
  ``evaluate``, ``predict``.
- ``steps_per_execution=4`` is bit-equal to 1 in the port (dropout 0.3:
  each step draws from its own generator; ``fit`` runs single steps at
  every K); another compile seed draws other dropout bits.
- A ``Sequential`` built with ``add`` from every serializable layer class,
  and the zoo's three models, serialize to the JAX package's JSON and
  configs; ``LAYER_CLASSES`` names the same classes.
- ``sample_weight``, ``class_weight``, ``validation_split`` and
  ``grad_accum_steps=2`` fits against the JAX package's.
- ``EarlyStopping`` stops at the same epoch; ``ReduceLROnPlateau`` and
  ``LearningRateScheduler`` move ``lr_scale`` alike (same History);
  ``TerminateOnNaN`` stops at the same epoch; ``LambdaCallback`` hooks.
- ``CSVLogger`` writes the same header and rows; ``TensorBoard`` writes
  the same records (the graph record byte-equal, the scalars' tags and
  steps equal, their values within TOL), with the clock and host fixed.
- ``to_json`` is string-equal; ``save_model`` crosses both ways with equal
  predictions; ``ModelCheckpoint`` / ``save_weights`` (BatchNorm moments
  included) load into the JAX model and back.
- ``train_on_batch`` / ``test_on_batch`` / ``predict_on_batch``,
  ``fit_stream`` / ``evaluate_stream``, ``get_weights`` / ``set_weights``,
  ``summary`` and ``lr_scale`` against the JAX package's.
- ``make_multi_train_step`` (metrics stacked to ``[K]``) and
  ``make_masked_eval_step`` against the JAX builders.
- A model with ``BatchNorm`` fits alike; on a mesh of 2 ranks it
  compiles (its moments are all-reduced; held against the JAX mesh in
  ``tests/test_torch_parallel.py``), and two gloo ranks of its
  ``fit(sample_weight=...)``, some weights 0, equal the JAX mesh's fit.
- The entry points ``example2``, ``outline_keras`` and
  ``outline_tensorflow`` on ``--device=cpu``, their data loaders
  monkeypatched to a few hundred rows; with no card the default device
  raises.
- Two gloo ranks of ``fit(mesh=...)`` against the JAX package's fit on a
  2-device mesh: History, evaluate and weights within TOL, one all-reduce
  a step.
"""
import os
import socket
import struct
import time

import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import data as jdata
from distributed_tensorflow_tpu import models as jmodels
from distributed_tensorflow_tpu import ops as jops
from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import parallel as jpar
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.train import step as jstep_lib
from distributed_tensorflow_tpu_torch import data as tdata
from distributed_tensorflow_tpu_torch import example2 as texample2
from distributed_tensorflow_tpu_torch import models as tmodels
from distributed_tensorflow_tpu_torch import ops as tops
from distributed_tensorflow_tpu_torch import optim as topt
from distributed_tensorflow_tpu_torch import outline_keras as tkeras
from distributed_tensorflow_tpu_torch import outline_tensorflow as ttf
from distributed_tensorflow_tpu_torch import parallel as tpar
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.data import tfrecord as trec
from distributed_tensorflow_tpu_torch.models.convert import \
    stack_params_from_jax

torch.set_num_threads(1)

TOL = 1e-5
JOIN_S = 90


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=TOL * scale, err_msg=what)


def _hist_close(got, want):
    assert list(got.history) == list(want.history)
    assert got.epochs == want.epochs
    for k in want.history:
        _close(got.history[k], want.history[k], k)


def _xor(lib, rate=0.0):
    return [lib.Dense(128, activation="relu"), lib.Dropout(rate),
            lib.Dense(128, activation="relu"), lib.Dropout(rate),
            lib.Dense(32, activation="sigmoid")]


def _cifar(models_lib, ops_lib):
    return [ops_lib.Dropout(0.0) if isinstance(l, ops_lib.Dropout) else l
            for l in models_lib.cifar_cnn().layers]


def _small(lib):
    return [lib.Dense(16, activation="relu"), lib.Dense(3)]


def _pair(jlayers, tlayers, in_shape, name="m", **compile_kw):
    """(JAX model, port model) with the JAX model's initial weights."""
    jm = jmodels.Sequential(jlayers, name=name)
    jm.compile(**compile_kw)
    jm.build(in_shape, seed=0)
    tm = tmodels.Sequential(tlayers, name=name, device="cpu")
    tm.compile(**compile_kw)
    tm.build(in_shape)
    tm.set_weights(jm.get_weights())
    return jm, tm


XOR_COMPILE = dict(loss="mean_squared_error", optimizer="adam",
                   metrics=["bitwise_accuracy"])
CLS_COMPILE = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
                   metrics=["accuracy"])


@pytest.fixture(scope="module")
def xor_data():
    return jdata.xor_data(300, val_size=64, seed=0)


@pytest.fixture(scope="module")
def cls_data():
    return jdata.synthetic_image_classes((8,), 3, 120, 40, seed=1)


def _fit_both(jm, tm, *args, method="fit", **kw):
    jh = getattr(jm, method)(*args, verbose=0, **kw)
    th = getattr(tm, method)(*args, verbose=0, **kw)
    _hist_close(th, jh)
    return jh, th


def test_xor_fit_evaluate_predict_equal_jax(xor_data):
    (xt, yt), (xv, yv) = xor_data
    jm, tm = _pair(_xor(jops), _xor(tops), (64,), **XOR_COMPILE)
    _fit_both(jm, tm, xt, yt, epochs=2, batch_size=50,
              validation_data=(xv, yv))
    got, want = tm.evaluate(xv, yv, verbose=0), jm.evaluate(xv, yv,
                                                            verbose=0)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], k)
    _close(tm.predict(xv, batch_size=24), jm.predict(xv, batch_size=24))
    for g, w in zip(tm.get_weights(), jm.get_weights()):
        _close(g, w)


def test_cifar_cnn_fit_evaluate_predict_equal_jax():
    (xt, yt), (xv, yv) = jdata.synthetic_image_classes((32, 32, 3), 10, 64,
                                                       32, seed=0)
    jm, tm = _pair(_cifar(jmodels, jops), _cifar(tmodels, tops),
                   (32, 32, 3), **CLS_COMPILE)
    _fit_both(jm, tm, xt, yt, epochs=2, batch_size=16,
              validation_data=(xv, yv))
    got, want = tm.evaluate(xv, yv, verbose=0), jm.evaluate(xv, yv,
                                                            verbose=0)
    for k in want:
        _close(got[k], want[k], k)
    _close(tm.predict(xv), jm.predict(xv))
    assert len(tm.get_weights()) == 12


def test_steps_per_execution_is_bit_equal_to_single_steps(xor_data):
    (xt, yt), _ = xor_data
    runs = []
    for spe in (1, 4):
        m = tmodels.Sequential(_xor(tops, 0.3), device="cpu")
        m.compile(steps_per_execution=spe, **XOR_COMPILE)
        h = m.fit(xt, yt, epochs=2, batch_size=50, verbose=0)
        runs.append((h.history, m.get_weights(), m.state.step))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2] == 12
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
    # the dropout bits follow the compile seed and the step, nothing else
    m = tmodels.Sequential(_xor(tops, 0.3), device="cpu")
    m.compile(seed=1, **XOR_COMPILE)
    h = m.fit(xt, yt, epochs=2, batch_size=50, verbose=0)
    assert h.history["loss"] != runs[0][0]["loss"]
    with pytest.raises(ValueError, match="steps_per_execution"):
        tmodels.Sequential(device="cpu").compile(steps_per_execution=0,
                                                 **XOR_COMPILE)


def test_weighted_and_split_fits_equal_jax(cls_data):
    (x, y), _ = cls_data
    sw = np.random.default_rng(0).random(len(x)).astype(np.float32)
    sw[::7] = 0.0
    for kw in (dict(sample_weight=sw), dict(class_weight={0: 2.0, 2: 0.5}),
               dict(validation_split=0.25)):
        jm, tm = _pair(_small(jops), _small(tops), (8,), **CLS_COMPILE)
        _fit_both(jm, tm, x, y, epochs=2, batch_size=20, **kw)
    with pytest.raises(ValueError, match="not both"):
        tm.fit(x, y, sample_weight=sw, class_weight={0: 1.0}, verbose=0)
    with pytest.raises(ValueError, match="one float per sample"):
        tm.fit(x, y, sample_weight=sw[:5], verbose=0)


def test_grad_accum_fit_equals_jax(xor_data):
    (xt, yt), _ = xor_data
    jm, tm = _pair(_xor(jops), _xor(tops), (64,), grad_accum_steps=2,
                   **XOR_COMPILE)
    _fit_both(jm, tm, xt, yt, epochs=1, batch_size=50)
    with pytest.raises(ValueError, match="not divisible"):
        tm.fit(xt, yt, batch_size=51, verbose=0)


def test_lr_callbacks_and_stopping_equal_jax(xor_data):
    (xt, yt), _ = xor_data
    runs = {}
    for name, lib, ops_lib in (("jax", jmodels, jops),
                               ("port", tmodels, tops)):
        jm, tm = _pair(_xor(jops), _xor(tops), (64,), **XOR_COMPILE)
        m = jm if name == "jax" else tm
        seen = []
        probe = lib.LambdaCallback(
            on_epoch_begin=lambda mm, e: seen.append(mm.lr_scale))
        h1 = m.fit(xt, yt, epochs=2, batch_size=50, verbose=0, callbacks=[
            lib.LearningRateScheduler(lambda e: [1.0, 0.25][e]), probe])
        h2 = m.fit(xt, yt, epochs=4, batch_size=50, verbose=0, callbacks=[
            lib.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                                  min_delta=10.0), probe])
        h3 = m.fit(xt, yt, epochs=10, batch_size=50, verbose=0, callbacks=[
            lib.EarlyStopping(monitor="loss", patience=2, min_delta=10.0)])
        runs[name] = (seen, m.lr_scale, h1, h2, h3)
    (js, jl, *jh), (ts, tl, *th) = runs["jax"], runs["port"]
    assert ts == js == [1.0, 0.25, 0.25, 0.25, 0.125, 0.0625]
    assert tl == jl == 0.03125
    for t, j in zip(th, jh):
        _hist_close(t, j)
    assert len(th[2].epochs) == 3


def test_terminate_on_nan_equals_jax(xor_data):
    (xt, yt), _ = xor_data
    jm, tm = _pair(_xor(jops), _xor(tops), (64,), **XOR_COMPILE)

    def poison(m, e, logs):
        if e == 0:
            if m is jm:
                m.state = m.state._replace(params=jax.tree.map(
                    lambda p: p * np.nan, m.state.params))
            else:
                with torch.no_grad():
                    for p in m.state.params.values():
                        p.mul_(float("nan"))
    lengths = [len(m.fit(xt, yt, epochs=10, batch_size=50, verbose=0,
                         callbacks=[lib.LambdaCallback(on_epoch_end=poison),
                                    lib.TerminateOnNaN()]).epochs)
               for m, lib in ((jm, jmodels), (tm, tmodels))]
    assert lengths == [2, 2]


def _events(log_dir):
    """(graph records, [(step, {tag: value})]) of the event file."""
    (name,) = os.listdir(log_dir)
    graphs, scalars = [], []
    for rec in trec.read_tfrecord(os.path.join(log_dir, name)):
        fields = _fields(rec)
        if 4 in fields:
            graphs.append(rec)
        if 5 in fields:
            values = {}
            for v in _fields(fields[5][0]).get(1, []):
                f = _fields(v)
                values[f[1][0].decode()] = struct.unpack("<f", f[2][0])[0]
            scalars.append((fields[2][0], values))
    return name, graphs, scalars


def _varint(buf, i):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return out, i


def _fields(buf):
    """{field number: [values]} of a protobuf message (varints as ints,
    fixed64/fixed32/bytes as bytes)."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        out.setdefault(num, []).append(val)
    return out


def test_csv_logger_and_tensorboard_equal_jax(xor_data, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    monkeypatch.setattr(socket, "gethostname", lambda: "trainer-0")
    (xt, yt), (xv, yv) = xor_data
    jm, tm = _pair(_xor(jops), _xor(tops), (64,), **XOR_COMPILE)
    out = {}
    for name, m, lib in (("jax", jm, jmodels), ("port", tm, tmodels)):
        d = tmp_path / name
        m.fit(xt, yt, epochs=3, batch_size=50, verbose=0,
              validation_data=(xv, yv),
              callbacks=[lib.CSVLogger(str(d / "log.csv")),
                         lib.TensorBoard(str(d / "tb"))])
        out[name] = (open(d / "log.csv").read().splitlines(),
                     _events(d / "tb"))
    (jcsv, jev), (tcsv, tev) = out["jax"], out["port"]
    assert tcsv[0] == jcsv[0] == ("epoch,bitwise_accuracy,loss,"
                                  "val_bitwise_accuracy,val_loss")
    assert len(tcsv) == len(jcsv) == 4
    for t, j in zip(tcsv[1:], jcsv[1:]):
        _close([float(v) for v in t.split(",")],
               [float(v) for v in j.split(",")])
    assert tev[0] == jev[0] == "events.out.tfevents.1700000000.trainer-0"
    assert tev[1] == jev[1] and len(tev[1]) == 1     # the graph record
    assert [(s, sorted(v)) for s, v in tev[2]] == \
        [(s, sorted(v)) for s, v in jev[2]]
    for (_, t), (_, j) in zip(tev[2], jev[2]):
        _close([t[k] for k in sorted(j)], [j[k] for k in sorted(j)])


ALL_LAYERS = [
    lambda lib: lib.Conv2D(4, (3, 2), strides=2, padding="VALID",
                           activation="relu", kernel_init="glorot_normal"),
    lambda lib: lib.Conv1D(3, 5), lambda lib: lib.DepthwiseConv2D(3, 2),
    lambda lib: lib.SeparableConv2D(4, 3, depth_multiplier=2),
    lambda lib: lib.MaxPool2D(3, 2, "SAME"), lambda lib: lib.AvgPool2D(),
    lambda lib: lib.GlobalAvgPool(), lambda lib: lib.BatchNorm(0.8),
    lambda lib: lib.LayerNorm(fused="auto"), lambda lib: lib.Embedding(9, 4),
    lambda lib: lib.LSTM(5, True), lambda lib: lib.GRU(3),
    lambda lib: lib.Flatten(), lambda lib: lib.Activation("tanh"),
    lambda lib: lib.Dropout(0.5), lambda lib: lib.Dense(2, "softmax")]


def test_every_layer_and_zoo_model_serializes_as_the_jax_package():
    from distributed_tensorflow_tpu.models import saving as jsaving
    from distributed_tensorflow_tpu_torch.models import saving as tsaving
    assert sorted(tsaving.LAYER_CLASSES) == sorted(jsaving.LAYER_CLASSES)
    jm, tm = jmodels.Sequential(name="all"), tmodels.Sequential(
        name="all", device="cpu")
    for f in ALL_LAYERS:
        jm.add(f(jops))
        tm.add(f(tops))
    assert tm.to_json() == jm.to_json()
    assert tmodels.Sequential.from_json(jm.to_json(), device="cpu"
                                        ).to_json() == jm.to_json()
    for name in ("xor_mlp", "mnist_mlp", "cifar_cnn"):
        assert getattr(tmodels, name)().get_config() == \
            getattr(jmodels, name)().get_config()


def test_json_and_saved_models_cross_both_ways(xor_data, tmp_path):
    (xt, yt), (xv, yv) = xor_data
    jm, tm = _pair(_xor(jops), _xor(tops), (64,), name="xor_mlp",
                   **XOR_COMPILE)
    _fit_both(jm, tm, xt, yt, epochs=1, batch_size=50)
    assert tm.to_json() == jm.to_json()
    assert tm.to_json(indent=1) == jm.to_json(indent=1)
    rebuilt = tmodels.Sequential.from_json(jm.to_json(), device="cpu")
    assert rebuilt.to_json() == \
        jmodels.Sequential.from_json(jm.to_json()).to_json()
    tm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    from_port = jmodels.load_model(str(tmp_path / "port"))
    from_jax = tmodels.load_model(str(tmp_path / "jax"), device="cpu")
    want = jm.predict(xv)
    _close(from_port.predict(xv), want)
    _close(from_jax.predict(xv), want)
    assert from_jax._compile_config == jm._compile_config
    # compile=False still restores the weights, uncompiled
    bare = tmodels.load_model(str(tmp_path / "jax"), compile=False,
                              device="cpu")
    assert bare._compiled is None
    for g, w in zip(bare.get_weights(), jm.get_weights()):
        _close(g, w)


def _bn(lib):
    return [lib.Conv2D(4, 3, activation="relu"), lib.BatchNorm(),
            lib.MaxPool2D(2), lib.GlobalAvgPool(), lib.Dense(3)]


def test_batchnorm_model_fits_and_checkpoints_equal_jax(tmp_path):
    (x, y), (xv, yv) = jdata.synthetic_image_classes((6, 6, 2), 3, 48, 16,
                                                     seed=2)
    jm, tm = _pair(_bn(jops), _bn(tops), (6, 6, 2), **CLS_COMPILE)
    ckpt = tmp_path / "ckpt"
    tcb = tmodels.ModelCheckpoint(str(ckpt / "port"))
    jcb = jmodels.ModelCheckpoint(str(ckpt / "jax"))
    jm.fit(x, y, epochs=2, batch_size=12, verbose=0, callbacks=[jcb])
    tm.fit(x, y, epochs=2, batch_size=12, verbose=0, callbacks=[tcb])
    _close(tm.predict(xv), jm.predict(xv))       # the running moments
    ms = tm.state.model_state["batchnorm"]
    _close(ms["var"], jm.state.model_state["batchnorm"]["var"])
    # each package's checkpoint loads into the other's model
    jm2, tm2 = _pair(_bn(jops), _bn(tops), (6, 6, 2), **CLS_COMPILE)
    jm2.load_weights(str(ckpt / "port"))
    tm2.load_weights(str(ckpt / "jax"))
    _close(jm2.predict(xv), jm.predict(xv))
    _close(tm2.predict(xv), jm.predict(xv))
    tm.save_weights(str(tmp_path / "w"))
    jm2.load_weights(str(tmp_path / "w"))
    _close(jm2.predict(xv), tm.predict(xv))
    # on a mesh of 2 it compiles now: the moments are all-reduced
    # (2 gloo ranks against the JAX mesh: tests/test_torch_parallel.py)
    tmodels.Sequential(_bn(tops), device="cpu").compile(
        mesh=tpar.Mesh(2, 0), **CLS_COMPILE)


def test_on_batch_methods_equal_jax(cls_data):
    (x, y), (xv, yv) = cls_data
    jm, tm = _pair(_small(jops), _small(tops), (8,), **CLS_COMPILE)
    for lo in (0, 20):
        got = tm.train_on_batch(x[lo:lo + 20], y[lo:lo + 20])
        want = jm.train_on_batch(x[lo:lo + 20], y[lo:lo + 20])
        for k in want:
            _close(got[k], want[k], k)
    got, want = tm.test_on_batch(xv, yv), jm.test_on_batch(xv, yv)
    for k in want:
        _close(got[k], want[k], k)
    _close(tm.predict_on_batch(xv[:7]), jm.predict_on_batch(xv[:7]))


def test_streams_equal_jax(cls_data):
    (x, y), (xv, yv) = cls_data

    def batches(epoch):
        rng = np.random.default_rng(epoch)
        for _ in range(5):
            idx = rng.integers(0, len(x), 16)
            yield x[idx], y[idx]

    jm, tm = _pair(_small(jops), _small(tops), (8,), steps_per_execution=2,
                   **CLS_COMPILE)
    _fit_both(jm, tm, batches, method="fit_stream", steps_per_epoch=4,
              epochs=3, validation_data=(xv, yv))
    # a source that runs dry ends training early (5 batches, 3 an epoch)
    jh = jm.fit_stream(batches(9), steps_per_epoch=3, epochs=4, verbose=0)
    th = tm.fit_stream(batches(9), steps_per_epoch=3, epochs=4, verbose=0)
    _hist_close(th, jh)
    assert th.epochs == [0, 1]

    def stream():
        return iter([(xv[i:i + 8], yv[i:i + 8]) for i in range(0, 40, 8)])
    for steps in (None, 3):
        got = tm.evaluate_stream(stream(), steps=steps, verbose=0)
        want = jm.evaluate_stream(stream(), steps=steps, verbose=0)
        for k in want:
            _close(got[k], want[k], k)


def test_weights_summary_and_lr_scale_equal_jax(capsys):
    layers = [lambda lib: lib.SeparableConv2D(4, 3),
              lambda lib: lib.BatchNorm(),
              lambda lib: lib.Flatten()] + [
        lambda lib, i=i: lib.Dense(3 + i) for i in range(11)]
    jm, tm = _pair([f(jops) for f in layers], [f(tops) for f in layers],
                   (5, 5, 2), **CLS_COMPILE)
    got, want = tm.get_weights(), jm.get_weights()
    assert [w.shape for w in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    capsys.readouterr()
    assert tm.summary() == jm.summary()
    tm.lr_scale = 0.3
    jm.lr_scale = 0.3
    assert tm.lr_scale == jm.lr_scale
    with pytest.raises(ValueError, match="expected"):
        tm.set_weights(got[:-1])
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.set_weights(got[:-1] + [np.zeros((1,), np.float32)])
    bare = tmodels.Sequential(_small(tops), device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        bare.fit(np.zeros((4, 8), np.float32), np.zeros(4), verbose=0)
    with pytest.raises(NotImplementedError, match="params_spec"):
        bare.compile(params_spec={}, **CLS_COMPILE)


def test_multi_and_masked_eval_steps_equal_jax(cls_data):
    (x, y), _ = cls_data
    jmodel, tmodel = jops.serial(*_small(jops)), tops.serial(*_small(tops))
    jo, to = jopt.adam(), topt.adam()
    jstate = jtrain.init_train_state(jmodel, jo, jax.random.PRNGKey(0),
                                     (8,))
    params = stack_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    tstate = ttrain.TrainState.create(params, to.init(params), {})
    kw = dict(metric_fns={"accuracy": "accuracy"}, steps_per_call=3)
    jstep = jtrain.make_multi_train_step(
        jmodel, "sparse_categorical_crossentropy", jo, **kw)
    tstep = ttrain.make_multi_train_step(
        tmodel, "sparse_categorical_crossentropy", to, **kw)
    xs, ys = x[:60].reshape(3, 20, 8), y[:60].reshape(3, 20)
    jstate, jm = jstep(jstate, (xs, ys))
    tstate, tm = tstep(tstate, (torch.from_numpy(xs), torch.from_numpy(ys)))
    assert tstate.step == 3
    for k in jm:
        assert tuple(tm[k].shape) == tuple(jm[k].shape) == (3,)
        _close(tm[k], jm[k], k)
    with pytest.raises(ValueError, match="group of 2"):
        tstep(tstate, (torch.from_numpy(xs[:2]), torch.from_numpy(ys[:2])))
    # masked eval: padded rows drop out of the means
    w = np.asarray([1.0] * 15 + [0.0] * 5, np.float32)
    xp = x[:20].copy()
    xp[15:] = 7.0
    jev = jstep_lib.make_masked_eval_step(
        jmodel, "sparse_categorical_crossentropy",
        metric_fns={"accuracy": "accuracy"})(jstate, (xp, y[:20], w))
    tev = ttrain.make_masked_eval_step(
        tmodel, "sparse_categorical_crossentropy",
        metric_fns={"accuracy": "accuracy"})(
        tstate, (torch.from_numpy(xp), torch.from_numpy(y[:20]),
                 torch.from_numpy(w)))
    plain = ttrain.make_eval_step(
        tmodel, "sparse_categorical_crossentropy",
        metric_fns={"accuracy": "accuracy"})(
        tstate, (torch.from_numpy(x[:15]), torch.from_numpy(y[:15])))
    for k in jev:
        _close(tev[k], jev[k], k)
        _close(tev[k], plain[k], k)


# -- the entry points --------------------------------------------------

def test_example2_entry_point_on_the_cpu(monkeypatch, tmp_path, capsys):
    real = tdata.xor_data
    monkeypatch.setattr(tdata, "xor_data",
                        lambda n, v, seed=0: real(300, 100, seed=seed))
    assert texample2.main(["--device=cpu", "--epochs=2",
                           f"--log_dir={tmp_path}/xor2_{{}}"]) == 0
    out = capsys.readouterr().out
    assert out.count("Epoch ") == 2 and "val_bitwise_accuracy" in out
    assert "Final validation accuracy:" in out
    (log_dir,) = os.listdir(tmp_path)
    _, graphs, scalars = _events(tmp_path / log_dir)
    assert len(graphs) == 1 and [s for s, _ in scalars] == [0, 1]


def test_outline_keras_entry_point_on_the_cpu(monkeypatch, tmp_path,
                                              capsys):
    monkeypatch.setattr(tdata, "cifar10", lambda d=None, seed=0:
                        tdata.synthetic_image_classes((32, 32, 3), 10, 96,
                                                      40, seed=seed))
    assert tkeras.main(["--device=cpu", "--epochs=1", "--batch_size=32",
                        "--steps_per_execution=2",
                        f"--log_dir={tmp_path}/c_{{}}"]) == 0
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "val_accuracy" in out
    assert "Final validation accuracy:" in out


def test_outline_tensorflow_entry_point_on_the_cpu(monkeypatch, tmp_path,
                                                   capsys):
    monkeypatch.setattr(tdata, "mnist", lambda d=None, flatten=False,
                        seed=0: tdata.synthetic_image_classes(
                            (784,), 10, 400, 100, seed=seed))
    assert ttf.main(["--device=cpu", "--epochs=2", "--batch_size=100",
                     f"--log_dir={tmp_path}"]) == 0
    out = capsys.readouterr().out
    assert "Final step 8:" in out and "val accuracy" in out
    assert "ckpt-0000000008" in os.listdir(tmp_path)


@pytest.mark.parametrize("main", [texample2.main, tkeras.main, ttf.main])
def test_entry_points_default_to_the_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main([f"--log_dir={tmp_path}/x"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.Sequential(_small(tops))


# -- data parallel -----------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_fit_equals_the_jax_mesh(tmp_path):
    import torch_dp_worker

    world = 2
    (xt, yt), (xv, yv) = jdata.xor_data(256, val_size=40, seed=1)
    jm = jmodels.Sequential(_xor(jops), name="xor")
    jm.compile(mesh=jpar.data_parallel_mesh(jax.devices()[:world]),
               **XOR_COMPILE)
    jm.build((64,), seed=0)
    weights = jm.get_weights()

    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=torch_dp_worker.run_fit_rank,
                         args=(r, world, port, weights, xt, yt, xv, yv,
                               outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = [dict(np.load(o)) for o in outs]
    jh = jm.fit(xt, yt, epochs=2, batch_size=63, validation_data=(xv, yv),
                verbose=0)
    final = jm.evaluate(xv, yv, verbose=0)
    steps = 2 * (256 // 64)                    # 63 rounds to 64 on 2 ranks
    for r in ranks:
        assert int(r["all_reduces"]) == steps
        for k, v in jh.history.items():
            _close(r[f"h_{k}"], v, k)
        for k, v in final.items():
            _close(r[f"e_{k}"], v, k)
        for i, w in enumerate(jm.get_weights()):
            _close(r[f"w{i}"], w, f"w{i}")
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_two_gloo_ranks_weighted_batchnorm_fit_equals_the_jax_mesh(tmp_path):
    """``fit(sample_weight=...)`` takes its own step builder: under a mesh
    its ``BatchNorm`` still normalises by the global batch's moments, and
    its loss divides by the global batch's count of non-zero weights
    (the ranks' counts differ), as the JAX package's fit on a 2-device
    mesh does."""
    import torch_dp_worker

    world = 2
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(64, 8)) * 2 + 1).astype(np.float32)
    y = rng.uniform(size=(64, 4)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=64).astype(np.float32)
    w[rng.random(64) < 0.3] = 0.0

    def layers(lib):
        return [lib.Dense(16, use_bias=False), lib.BatchNorm(),
                lib.Dense(4, activation="sigmoid")]
    jm = jmodels.Sequential(layers(jops), name="bn")
    jm.compile("mean_squared_error", "adam",
               mesh=jpar.data_parallel_mesh(jax.devices()[:world]))
    jm.build((8,), seed=0)
    weights = jm.get_weights()

    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=torch_dp_worker.run_weighted_bn_fit_rank,
                         args=(r, world, port, weights, x, y, w, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = [dict(np.load(o)) for o in outs]
    jh = jm.fit(x, y, epochs=2, batch_size=16, sample_weight=w, verbose=0)
    jbn = jm.state.model_state["batchnorm"]
    for r in ranks:
        for k, v in jh.history.items():
            _close(r[f"h_{k}"], v, k)
        for i, want in enumerate(jm.get_weights()):
            _close(r[f"w{i}"], want, f"w{i}")
        for k in ("mean", "var"):
            _close(r[f"bn_{k}"], jbn[k], k)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
