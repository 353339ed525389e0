"""The port's conv, pool, norm, embedding and recurrent layers, held
against the JAX package's.

Each case builds the same layer in both packages, initialises it with the
JAX package (``jax.random.PRNGKey(0)``), carries the parameters across as
numpy arrays and runs one input (numpy, from a seed) through both:

- the output, and the gradients of ``sum(y * r)`` (``r`` a fixed random
  array) with respect to every parameter and to the input, agree within
  ``TOL * max(1, max |want|)`` (TOL 1e-5, f32; summation order only);
- ``out_shape`` and ``get_config`` are the JAX layer's.

Cases: ``Conv2D`` at SAME and VALID, strides 1 and 2, odd and even
kernels, on odd and even sizes; ``Conv1D`` likewise; ``DepthwiseConv2D``
(depth multiplier 2) and ``SeparableConv2D``; ``MaxPool2D`` and
``AvgPool2D`` at SAME on odd sizes and at VALID; ``GlobalAvgPool``;
``BatchNorm`` in train (its new running moments too) and in eval (from
non-trivial moments); ``LayerNorm`` with ``fused`` False, True (the JAX
package's Pallas kernel in interpret mode against the port's plain
route) and ``"auto"`` (plain on both sides on the CPU); ``Embedding``
(gradient on the table) and its ``attend``; ``LSTM`` and ``GRU`` with
``return_sequences`` both ways.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import ops as jops
from distributed_tensorflow_tpu_torch import ops as tops

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _run_both(jlayer, tlayer, in_shape, x, *, train=False, state=None,
              grad_x=True):
    """Forward both layers on ``x`` from the JAX layer's init; compare the
    outputs, the new state and the gradients of sum(y * r)."""
    params, jstate = jlayer.init(jax.random.PRNGKey(0), in_shape)
    if state is not None:
        jstate = state
    y0, _ = jlayer.apply(params, jstate, jnp.asarray(x), train=train)
    r = np.random.default_rng(1).standard_normal(y0.shape).astype(np.float32)

    def jloss(p, xx):
        y, s = jlayer.apply(p, jstate, xx, train=train)
        return jnp.sum(y * r), (y, s)

    argnums = (0, 1) if grad_x else (0,)
    (_, (jy, js)), jgrads = jax.value_and_grad(
        jloss, argnums=argnums, has_aux=True)(params, jnp.asarray(x))

    tparams = jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), params)
    tstate = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jstate)
    xt = torch.tensor(x, requires_grad=grad_x)
    ty, ts = tlayer.apply(tparams, tstate, xt, train=train)
    _close(ty.detach(), jy, "output")
    for path, want in jax.tree_util.tree_leaves_with_path(js):
        got = ts
        for key in path:
            got = got[key.key]
        _close(got.detach(), want, f"state {path}")
    leaves = jax.tree_util.tree_leaves(tparams)
    wants = jax.tree_util.tree_leaves(jgrads[0])
    inputs = leaves + ([xt] if grad_x else [])
    grads = torch.autograd.grad(torch.sum(ty * torch.from_numpy(r)), inputs)
    for g, w, (path, _) in zip(grads, wants,
                               jax.tree_util.tree_leaves_with_path(params)):
        _close(g, w, f"grad {path}")
    if grad_x:
        _close(grads[-1], jgrads[1], "grad x")
    assert tuple(tlayer.out_shape(in_shape)) == tuple(
        jlayer.out_shape(in_shape))
    assert tlayer.get_config() == jlayer.get_config()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CONV2D = [(k, s, pad, hw) for k, s, pad, hw in (
    (3, 1, "SAME", 8), (3, 1, "SAME", 7), (3, 2, "SAME", 8),
    (3, 2, "SAME", 7), (2, 1, "SAME", 7), (2, 2, "SAME", 7),
    (4, 1, "SAME", 8), (4, 3, "SAME", 9), (3, 1, "VALID", 8),
    (3, 2, "VALID", 7), (2, 2, "VALID", 8), (5, 2, "VALID", 9))]


@pytest.mark.parametrize("k,s,pad,hw", CONV2D)
def test_conv2d_equals_jax(k, s, pad, hw):
    cfg = dict(filters=5, kernel_size=k, strides=s, padding=pad,
               activation="relu")
    _run_both(jops.Conv2D(**cfg), tops.Conv2D(**cfg), (hw, hw + 1, 3),
              _x((2, hw, hw + 1, 3)))


@pytest.mark.parametrize("k,s,pad,t", [(3, 1, "SAME", 9), (4, 2, "SAME", 9),
                                       (2, 2, "SAME", 8), (3, 2, "VALID", 9),
                                       (4, 1, "VALID", 8)])
def test_conv1d_equals_jax(k, s, pad, t):
    cfg = dict(filters=6, kernel_size=k, strides=s, padding=pad)
    _run_both(jops.Conv1D(**cfg), tops.Conv1D(**cfg), (t, 4),
              _x((3, t, 4)))


@pytest.mark.parametrize("k,s,pad", [(3, 1, "SAME"), (3, 2, "SAME"),
                                     (2, 1, "VALID")])
def test_depthwise_conv2d_equals_jax(k, s, pad):
    cfg = dict(kernel_size=k, strides=s, padding=pad, depth_multiplier=2,
               activation="tanh")
    _run_both(jops.DepthwiseConv2D(**cfg), tops.DepthwiseConv2D(**cfg),
              (7, 8, 3), _x((2, 7, 8, 3)))


@pytest.mark.parametrize("s,pad", [(1, "SAME"), (2, "SAME"), (1, "VALID")])
def test_separable_conv2d_equals_jax(s, pad):
    cfg = dict(filters=4, kernel_size=3, strides=s, padding=pad,
               depth_multiplier=2)
    _run_both(jops.SeparableConv2D(**cfg), tops.SeparableConv2D(**cfg),
              (7, 7, 3), _x((2, 7, 7, 3)))


POOLS = [(p, s, pad, hw) for p, s, pad, hw in (
    (2, None, "SAME", 7), (3, 2, "SAME", 7), (3, 1, "SAME", 5),
    (2, 2, "SAME", 9), (2, None, "VALID", 7), (3, 2, "VALID", 8))]


@pytest.mark.parametrize("cls", ["MaxPool2D", "AvgPool2D"])
@pytest.mark.parametrize("p,s,pad,hw", POOLS)
def test_pools_equal_jax(cls, p, s, pad, hw):
    cfg = dict(pool_size=p, strides=s, padding=pad)
    _run_both(getattr(jops, cls)(**cfg), getattr(tops, cls)(**cfg),
              (hw, hw, 3), _x((2, hw, hw, 3)))


def test_global_avg_pool_equals_jax():
    _run_both(jops.GlobalAvgPool(), tops.GlobalAvgPool(), (5, 6, 4),
              _x((3, 5, 6, 4)))


@pytest.mark.parametrize("scale,center", [(True, True), (False, True),
                                          (True, False)])
def test_batchnorm_train_equals_jax(scale, center):
    cfg = dict(momentum=0.8, scale=scale, center=center)
    # its running moments move: both packages' new state is compared
    _run_both(jops.BatchNorm(**cfg), tops.BatchNorm(**cfg), (4, 4, 3),
              3.0 + 2.0 * _x((5, 4, 4, 3)), train=True)


def test_batchnorm_eval_equals_jax():
    state = {"mean": jnp.asarray([0.5, -1.0, 2.0]),
             "var": jnp.asarray([0.25, 2.0, 4.0])}
    _run_both(jops.BatchNorm(), tops.BatchNorm(), (4, 4, 3),
              _x((5, 4, 4, 3)), train=False, state=state)


@pytest.mark.parametrize("fused", [False, True, "auto"])
def test_layernorm_equals_jax(fused):
    jl, tl = jops.LayerNorm(fused=fused), tops.LayerNorm(fused=fused)
    _run_both(jl, tl, (37,), 1.5 + _x((6, 37)))
    _run_both(jl, tl, (5, 128), _x((2, 5, 128)))


def test_layernorm_unfused_without_scale_and_center():
    for cfg in (dict(scale=False), dict(center=False)):
        _run_both(jops.LayerNorm(**cfg), tops.LayerNorm(**cfg), (16,),
                  _x((4, 16)))
        with pytest.raises(ValueError, match="fused=True"):
            tops.LayerNorm(fused=True, **cfg)


def test_embedding_equals_jax():
    ids = np.random.default_rng(0).integers(0, 50, (4, 7)).astype(np.int32)
    jl, tl = jops.Embedding(50, 16), tops.Embedding(50, 16)
    _run_both(jl, tl, (7,), ids, grad_x=False)
    params, _ = jl.init(jax.random.PRNGKey(0), (7,))
    x = _x((3, 16))
    _close(tl.attend({"embedding": torch.tensor(
        np.array(params["embedding"]))}, torch.from_numpy(x)),
        jl.attend(params, jnp.asarray(x)), "attend")
    assert "embedding_init" not in tl.get_config()
    cfg = tops.Embedding(50, 16, embedding_init="zeros").get_config()
    assert cfg == jops.Embedding(50, 16, embedding_init="zeros").get_config()


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
@pytest.mark.parametrize("return_sequences", [False, True])
def test_recurrent_equals_jax(cls, return_sequences):
    cfg = dict(units=6, return_sequences=return_sequences)
    _run_both(getattr(jops, cls)(**cfg), getattr(tops, cls)(**cfg), (5, 4),
              _x((3, 5, 4)))


def test_cifar_cnn_flattens_in_nhwc_order():
    """The zoo's CNN on carried weights: the Dense(256) rows are in NHWC
    order, so the logits agree only if the activations stay NHWC."""
    from distributed_tensorflow_tpu import models as jmodels
    from distributed_tensorflow_tpu_torch import models as tmodels
    jm, tm = jmodels.cifar_cnn(), tmodels.cifar_cnn()
    params, state = jm.init(jax.random.PRNGKey(0), (32, 32, 3))
    x = _x((2, 32, 32, 3))
    want, _ = jm.apply(params, state, jnp.asarray(x))
    from distributed_tensorflow_tpu_torch.models.convert import \
        stack_params_from_jax
    got, _ = tm.apply(stack_params_from_jax(jax.tree.map(np.asarray,
                                                         params)),
                      {}, torch.from_numpy(x))
    _close(got.detach(), want, "cifar_cnn logits")
