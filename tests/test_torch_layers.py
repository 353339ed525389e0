"""The port's XOR tier of the layer library, its activations, initializers,
losses and metrics, held against the JAX package on the same numpy
inputs.

- Every activation name the JAX ``get`` accepts: 1e-6 absolute (the
  same f32 formula; ``exp``/``tanh`` may round by an ulp).
- Every loss of the registry and ``class_weighted``, every metric of the
  registry: 1e-6 absolute plus 1e-6 relative.  ``bitwise_accuracy``
  rounds half to even on both sides (exact ties are in the inputs).
- ``Dense`` (every activation), ``Stack`` and ``serial`` forward on
  weights carried across with ``stack_params_from_jax``: 1e-6 absolute.
  The key naming ("dense", "dense_1", ...), the flat ``<layer>.<param>``
  names, the kernel's ``[in, out]`` layout and ``get_config`` equal the
  JAX package's.
- Initializers cannot match ``jax.random``'s bits: shapes and dtypes,
  bounds (glorot_uniform within ``sqrt(6 / (fan_in + fan_out))``, the
  truncated normals within 2 standard deviations), moments within a few
  standard errors of 40,000 draws, orthogonal columns or rows to 1e-5,
  and determinism per generator.
- ``Dropout``: the identity in eval mode and at rate 0; in training, a
  mask drawn from the generator given (the same generator state gives
  the same mask) that keeps about 1 - rate of the elements, scaled by
  1 / (1 - rate).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.ops import activations as jact
from distributed_tensorflow_tpu.ops import initializers as jinit
from distributed_tensorflow_tpu.ops import layers as jlayers
from distributed_tensorflow_tpu.ops import losses as jloss
from distributed_tensorflow_tpu.ops import metrics as jmet
from distributed_tensorflow_tpu_torch.models.convert import (
    stack_params_from_jax, stack_params_to_jax)
from distributed_tensorflow_tpu_torch.ops import activations as tact
from distributed_tensorflow_tpu_torch.ops import initializers as tinit
from distributed_tensorflow_tpu_torch.ops import layers as tlayers
from distributed_tensorflow_tpu_torch.ops import losses as tloss
from distributed_tensorflow_tpu_torch.ops import metrics as tmet

torch.set_num_threads(1)

TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), atol=tol, rtol=tol)


ACTIVATIONS = sorted(k for k in jact._REGISTRY if k) + [None]


@pytest.mark.parametrize("name", ACTIVATIONS, ids=str)
def test_activation_matches_jax(name):
    assert set(tact._REGISTRY) == set(jact._REGISTRY)
    x = np.random.default_rng(0).standard_normal((6, 9)).astype(np.float32)
    x[0, :5] = [0.0, -2.5, 2.5, 10.0, -10.0]
    _close(tact.get(name)(torch.from_numpy(x)),
           jact.get(name)(jnp.asarray(x)))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        tact.get("nope")


def _preds_targets(shape=(8, 6), seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 0.99, shape).astype(np.float32)
    p[0, :4] = [0.5, 1.5, 2.5, 0.49999997]     # round-half-to-even ties
    t = rng.integers(0, 2, shape).astype(np.float32)
    return p, t


@pytest.mark.parametrize("name", sorted(jloss._REGISTRY))
def test_loss_matches_jax(name):
    assert set(tloss._REGISTRY) == set(jloss._REGISTRY)
    rng = np.random.default_rng(1)
    if name in ("sparse_categorical_crossentropy", "smoothed_cross_entropy"):
        a = rng.standard_normal((8, 5)).astype(np.float32)
        b = rng.integers(0, 5, (8,)).astype(np.int32)
    elif name == "categorical_crossentropy":
        a = rng.standard_normal((8, 5)).astype(np.float32)
        b = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    elif name == "hinge" or name == "squared_hinge":
        a = rng.standard_normal((8, 6)).astype(np.float32)
        b = rng.choice([-1.0, 1.0], (8, 6)).astype(np.float32)
    else:
        a, b = _preds_targets()
    _close(tloss.get(name)(torch.from_numpy(a), torch.from_numpy(b)),
           jloss.get(name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("base", ["sparse_categorical_crossentropy",
                                  "binary_crossentropy"])
def test_class_weighted_loss_matches_jax(base):
    rng = np.random.default_rng(2)
    weights = {0: 0.5, 2: 3.0}
    if base == "binary_crossentropy":
        a, b = _preds_targets()
    else:
        a = rng.standard_normal((9, 4)).astype(np.float32)
        b = rng.integers(0, 4, (9,)).astype(np.int32)
    _close(tloss.class_weighted(base, weights)(torch.from_numpy(a),
                                               torch.from_numpy(b)),
           jloss.class_weighted(base, weights)(jnp.asarray(a),
                                               jnp.asarray(b)))
    with pytest.raises(ValueError, match="class_weight supports"):
        tloss.class_weighted("mse", weights)


@pytest.mark.parametrize("name", sorted(jmet._REGISTRY))
def test_metric_matches_jax(name):
    assert set(tmet._REGISTRY) == set(jmet._REGISTRY)
    rng = np.random.default_rng(3)
    if name in ("accuracy", "categorical_accuracy",
                "sparse_categorical_accuracy", "top_5_accuracy"):
        a = rng.standard_normal((16, 8)).astype(np.float32)
        b = rng.integers(0, 8, (16,)).astype(np.int32)
    else:
        a, b = _preds_targets((16, 6))
    _close(tmet.get(name)(torch.from_numpy(a), torch.from_numpy(b)),
           jmet.get(name)(jnp.asarray(a), jnp.asarray(b)))


def test_bitwise_accuracy_rounds_half_to_even_on_both_sides():
    p = torch.tensor([[0.5, 1.5, 2.5, 0.5]])
    t = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert float(tmet.bitwise_accuracy(p, t)) == 0.75
    assert float(jmet.bitwise_accuracy(jnp.asarray(p.numpy()),
                                       jnp.asarray(t.numpy()))) == 0.75


def _xor_models(rate=0.3):
    def build(lib):
        return lib.serial(lib.Dense(128, activation="relu"),
                          lib.Dropout(rate),
                          lib.Dense(128, activation="relu"),
                          lib.Dropout(rate),
                          lib.Dense(32, activation="sigmoid"))
    return build(jlayers), build(tlayers)


def test_stack_keys_names_layout_and_config_equal_jax():
    jm, tm = _xor_models()
    assert tm.keys == jm.keys == ["dense", "dropout", "dense_1",
                                  "dropout_1", "dense_2"]
    assert tm.get_config() == jm.get_config()
    assert tlayers.layer_spec(tm.layers[0]) == jlayers.layer_spec(
        jm.layers[0])
    params, state = tm.init(torch.Generator().manual_seed(0), (64,))
    jparams, jstate = jm.init(jax.random.PRNGKey(0), (64,))
    assert state == jstate == {}
    assert sorted(params) == sorted(
        f"{k}.{p}" for k, sub in jparams.items() for p in sub)
    for k, sub in jparams.items():
        for p, leaf in sub.items():
            assert tuple(params[f"{k}.{p}"].shape) == leaf.shape
            assert params[f"{k}.{p}"].dtype == torch.float32
            assert params[f"{k}.{p}"].requires_grad
    assert tm.out_shape((64,)) == jm.out_shape((64,)) == (32,)
    with pytest.raises(ValueError, match="callable"):
        tlayers.Dense(4, activation=torch.relu).get_config()


@pytest.mark.parametrize("activation", ACTIVATIONS, ids=str)
def test_dense_forward_matches_jax(activation):
    jd = jlayers.Dense(7, activation=activation)
    td = tlayers.Dense(7, activation=activation)
    jp, _ = jd.init(jax.random.PRNGKey(1), (5,))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    got, _ = td.apply(tp, {}, torch.from_numpy(x))
    want, _ = jd.apply(jp, {}, jnp.asarray(x))
    _close(got, want)
    assert tlayers.Dense(7, use_bias=False).init(None, (5,))[0].keys() \
        == {"kernel"}


@pytest.mark.parametrize("train", [False, True])
def test_stack_and_serial_forward_match_jax(train):
    """Dropout at rate 0 in training (the bits of a mask cannot match);
    in eval mode at the model's 0.3, where it is the identity."""
    jm, tm = _xor_models(0.0 if train else 0.3)
    jparams, _ = jm.init(jax.random.PRNGKey(2), (64,))
    params = stack_params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.default_rng(5).integers(0, 2, (10, 64)).astype(np.float32)
    got, _ = tm.apply(params, {}, torch.from_numpy(x), train=train,
                      rng=torch.Generator().manual_seed(0))
    want, _ = jm.apply(jparams, {}, jnp.asarray(x), train=train,
                       rng=jax.random.PRNGKey(0))
    _close(got, want)
    back = stack_params_to_jax(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


def test_flatten_and_activation_layers():
    x = torch.arange(24.0).reshape(2, 3, 4) - 12
    y, _ = tlayers.Flatten().apply({}, {}, x)
    assert tuple(y.shape) == (2, 12)
    assert tlayers.Flatten().out_shape((3, 4)) == (12,)
    y, _ = tlayers.Activation("relu").apply({}, {}, x)
    _close(y, jlayers.Activation("relu").apply({}, {}, jnp.asarray(
        x.numpy()))[0])
    assert tlayers.Activation("tanh").get_config() == jlayers.Activation(
        "tanh").get_config()


def test_dropout_draws_from_its_generator():
    d = tlayers.Dropout(0.3)
    x = torch.ones(200, 100)
    assert d.apply({}, {}, x, train=False)[0] is x
    assert tlayers.Dropout(0.0).apply({}, {}, x, train=True)[0] is x
    with pytest.raises(ValueError, match="generator"):
        d.apply({}, {}, x, train=True)
    a, _ = d.apply({}, {}, x, train=True,
                   rng=torch.Generator().manual_seed(7))
    b, _ = d.apply({}, {}, x, train=True,
                   rng=torch.Generator().manual_seed(7))
    c, _ = d.apply({}, {}, x, train=True,
                   rng=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(a[kept], torch.tensor(1 / 0.7))
    with pytest.raises(ValueError, match="rate"):
        tlayers.Dropout(1.0)


SHAPES = [(64, 128), (128, 32), (3, 3, 16, 8)]


@pytest.mark.parametrize("name", sorted(jinit._REGISTRY))
def test_initializer_shape_bounds_and_moments(name):
    assert set(tinit._REGISTRY) == set(jinit._REGISTRY)
    init = tinit.get(name)
    for shape in SHAPES:
        a = init(torch.Generator().manual_seed(0), shape)
        b = init(torch.Generator().manual_seed(0), shape)
        assert tuple(a.shape) == shape and a.dtype == torch.float32
        assert torch.equal(a, b)
        assert init(None, shape, torch.bfloat16).dtype == torch.bfloat16 \
            if name in ("zeros", "ones") else True
    fan_in, fan_out = 200, 200
    big = init(torch.Generator().manual_seed(1), (fan_in, fan_out)).double()
    n = big.numel()
    if name in ("zeros", "ones"):
        assert torch.all(big == (0.0 if name == "zeros" else 1.0))
        return
    if name == "orthogonal":
        eye = big.T @ big
        assert torch.allclose(eye, torch.eye(fan_out, dtype=eye.dtype),
                              atol=1e-5)
        wide = init(torch.Generator().manual_seed(2), (16, 40)).double()
        assert torch.allclose(wide @ wide.T, torch.eye(16,
                                                       dtype=wide.dtype),
                              atol=1e-5)
        with pytest.raises(ValueError, match=">= 2 dims"):
            init(None, (5,))
        return
    scale = 2.0 if name.startswith("he") else 1.0
    denom = fan_in if name.startswith(("he", "lecun")) \
        else (fan_in + fan_out) / 2
    std = math.sqrt(scale / denom)
    if name.endswith("uniform"):
        limit = math.sqrt(3.0) * std
        if name == "glorot_uniform":
            assert limit == pytest.approx(math.sqrt(6.0 / (fan_in + fan_out)))
        assert big.abs().max() <= limit
    else:      # truncated normal, rescaled so its stddev is std
        assert big.abs().max() <= 2.0 * std / 0.87962566103423978 + 1e-7
    assert abs(big.mean().item()) < 5 * std / math.sqrt(n)
    assert abs(big.std().item() / std - 1.0) < 0.02


def test_factory_initializers():
    g = torch.Generator().manual_seed(0)
    assert torch.all(tinit.constant(2.5)(g, (3,)) == 2.5)
    u = tinit.uniform(0.1)(g, (10000,))
    assert u.abs().max() <= 0.1 and abs(u.std().item() - 0.1 / math.sqrt(3)) \
        < 2e-3
    n = tinit.normal(0.5)(g, (10000,))
    assert abs(n.std().item() - 0.5) < 0.02
    t = tinit.truncated_normal(0.5)(g, (10000,))
    assert t.abs().max() <= 1.0
    with pytest.raises(ValueError, match="unknown initializer"):
        tinit.get("nope")
