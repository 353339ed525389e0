"""The port's zoo entry points and ``MultiHeadAttention``.

- ``python -m distributed_tensorflow_tpu_torch.examples.finetune_bert``
  and ``.train_vit`` run in-process on ``--device=cpu`` at a few steps
  and print the JAX scripts' lines (the same f-strings: ``step N:
  loss=... acc=...``, ``mlm step N: ...``, ``eval accuracy: ...``); their
  batches are the JAX scripts' for the same seed (each script's
  ``make_batch`` called on generators of one seed).  The entry points
  default to the card and raise without one.
- ``MultiHeadAttention`` against the JAX layer: one layer's output with
  an additive padding mask, and in a ``Sequential`` (attention, flatten,
  dense) carried from the JAX model's weights, two epochs of ``fit``
  (history) and ``predict``.

Tolerances: 1e-5 relative to the values' scale (f32, another summation
order), as the high-level tier's tests hold ``Sequential``.
"""
import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import models as jmodels
from distributed_tensorflow_tpu import ops as jops
from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu_torch import models as tmodels
from distributed_tensorflow_tpu_torch import ops as tops
from distributed_tensorflow_tpu_torch.examples import finetune_bert, train_vit
from distributed_tensorflow_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

TOL = 1e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    """The root ``examples/<name>.py`` as a module (its flags register
    with the JAX package's registry; ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(_REPO, "examples",
                                             name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


NUM = r"-?\d+\.\d{3,4}"


def test_finetune_bert_prints_the_jax_scripts_lines():
    lines = _run(finetune_bert.main, [
        "--device=cpu", "--steps=25", "--batch_size=8", "--seq_len=16",
        "--mlm_steps=4", "--mlm_predictions_per_seq=4", "--remat",
        "--remat_policy=dots"])
    assert re.fullmatch(rf"mlm step 4: loss={NUM} acc={NUM}", lines[0])
    assert re.fullmatch(rf"step 25: loss={NUM} acc={NUM}", lines[1])
    assert re.fullmatch(rf"eval accuracy: {NUM}", lines[2])
    assert len(lines) == 3


def test_train_vit_prints_the_jax_scripts_lines():
    lines = _run(train_vit.main, ["--device=cpu", "--steps=20",
                                  "--batch_size=8"])
    assert re.fullmatch(rf"step 20: loss={NUM} acc={NUM}", lines[0])
    acc = re.fullmatch(rf"eval accuracy: ({NUM})", lines[1])
    assert acc and 0.0 <= float(acc.group(1)) <= 1.0
    assert len(lines) == 2


def test_entry_points_draw_the_jax_scripts_batches():
    jbert, jvit = _jax_script("finetune_bert"), _jax_script("train_vit")
    for got, want in zip(
            finetune_bert.make_batch(np.random.default_rng(3), 64, 8, 16),
            jbert.make_batch(np.random.default_rng(3), 64, 8, 16)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(train_vit.make_batch(np.random.default_rng(4), 6),
                         jvit.make_batch(np.random.default_rng(4), 6)):
        np.testing.assert_array_equal(got, want)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults would run on it")
    for main in (finetune_bert.main, train_vit.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--steps=1"])


def test_multi_head_attention_layer_matches_jax():
    jl = jattn.MultiHeadAttention(4, 32, dropout_rate=0.0)
    params, _ = jl.init(jax.random.PRNGKey(0), (7, 32))
    x = np.random.default_rng(0).standard_normal((2, 7, 32)).astype(
        np.float32)
    valid = np.array([[1] * 7, [1] * 4 + [0] * 3])
    want, _ = jl.apply(params, {}, jnp.asarray(x),
                       mask=jattn.padding_mask(jnp.asarray(valid)))
    tl = tattn.MultiHeadAttention(4, 32)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    got, _ = tl.apply(tparams, {}, torch.from_numpy(x),
                      mask=tattn.padding_mask(torch.from_numpy(valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    tinit, _ = tl.init(torch.Generator(), (7, 32))
    assert jax.tree.map(lambda t: tuple(t.shape), tinit) == \
        jax.tree.map(lambda a: tuple(a.shape), params)
    assert tl.out_shape((7, 32)) == jl.out_shape((7, 32))


def test_multi_head_attention_in_a_sequential_fits_as_jax():
    def layers(lib, attn):
        return [attn.MultiHeadAttention(2, 16), lib.Flatten(),
                lib.Dense(3)]
    compile_kw = dict(loss="sparse_categorical_crossentropy",
                      optimizer="adam", metrics=["accuracy"])
    jm = jmodels.Sequential(layers(jops, jattn), name="mha")
    jm.compile(**compile_kw)
    jm.build((5, 16), seed=0)
    tm = tmodels.Sequential(layers(tops, tattn), name="mha", device="cpu")
    tm.compile(**compile_kw)
    tm.build((5, 16))
    tm.set_weights(jm.get_weights())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((48, 5, 16)).astype(np.float32)
    y = rng.integers(0, 3, 48).astype(np.int32)
    jh = jm.fit(x, y, epochs=2, batch_size=16, verbose=0)
    th = tm.fit(x, y, epochs=2, batch_size=16, verbose=0)
    assert list(th.history) == list(jh.history)
    for k in jh.history:
        want = np.asarray(jh.history[k], np.float64)
        np.testing.assert_allclose(th.history[k], want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()),
                                   err_msg=k)
    want = np.asarray(jm.predict(x))
    np.testing.assert_allclose(tm.predict(x), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
