"""The port's ``ops/moe.py`` against the JAX package's ``ops/moe.py``.

The same numpy inputs and the JAX ``init_moe`` parameters (carried as
numpy) go through both ``apply_moe``s: the JAX package's own MoE cases
(a single expert is the dense FFN, ample capacity drops nothing and the
combine weights are normalised, a tiny capacity drops tokens to zeros,
an explicit ``group_size`` and its refusal, aux 1 under uniform routing,
gradients through the router and both expert matrices), k 1 and 2, bf16
inputs, and ``train=True`` with ``jitter=0``.  The jitter itself draws
from a ``torch.Generator`` (the bits differ from ``jax.random``'s), so it
is held to its range and to its own draws.

Tolerances: f32 outputs, metrics and gradients within 1e-5 relative to
their scale (another summation order); bf16 outputs within 2e-2 of
their scale (the two frameworks round a bf16 product at other places),
with the router's choices identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import moe as jmoe
from distributed_tensorflow_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_tpu_torch.ops.activations import gelu

torch.set_num_threads(1)

D, F = 8, 16
TOL = 1e-5


def _params(e=4, key=0):
    """(JAX tree, port tree) of one ``init_moe`` draw."""
    jp = jmoe.init_moe(jax.random.PRNGKey(key), D, F, num_experts=e)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(b=4, s=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _both(jp, tp, x, **kw):
    jy, jm = jmoe.apply_moe(jp, jnp.asarray(x), **kw)
    ty, tm = tmoe.apply_moe(tp, torch.from_numpy(x), **kw)
    return (ty, tm), (jy, jm)


def _check_metrics(tm, jm):
    assert set(tm) == set(jm)
    for name in jm:
        _close(float(tm[name]), float(jm[name]), what=name)


@pytest.mark.parametrize("k,kw", [
    (1, dict(capacity_factor=1.25)),
    (2, dict(capacity_factor=1.25)),
    (2, dict(capacity_factor=4.0)),
    (1, dict(capacity=1)),
    (2, dict(capacity=2)),
    (2, dict(capacity_factor=2.0, group_size=16)),
])
def test_apply_moe_matches_jax(k, kw):
    jp, tp = _params()
    x = _x(b=4, s=16)
    (ty, tm), (jy, jm) = _both(jp, tp, x, k=k, **kw)
    assert ty.shape == jy.shape
    _close(ty.numpy(), jy)
    _check_metrics(tm, jm)


def test_single_expert_equals_dense_ffn():
    jp, tp = _params(e=1)
    x = _x()
    (ty, tm), (jy, jm) = _both(jp, tp, x, k=1, capacity_factor=2.0)
    ex = tp["experts"]
    xt = torch.from_numpy(x)
    ref = gelu(xt @ ex["w_in"][0] + ex["b_in"][0]) @ ex["w_out"][0] \
        + ex["b_out"][0]
    _close(ty.numpy(), ref.numpy())
    _close(ty.numpy(), jy)
    assert float(tm["aux_loss"]) == 1.0 == float(jm["aux_loss"])
    assert float(tm["dropped_fraction"]) == 0.0


def test_ample_capacity_drops_nothing_and_combine_is_normalised():
    jp, tp = _params()
    x = _x()
    (ty, tm), (jy, jm) = _both(jp, tp, x, k=2, capacity_factor=4.0)
    assert float(tm["dropped_fraction"]) == 0.0 == float(jm["dropped_fraction"])
    _close(ty.numpy(), jy)
    xt = torch.from_numpy(x).reshape(4, 8, D)
    probs = torch.softmax(xt @ tp["router"]["kernel"], -1)
    cap = int(4.0 * 2 * 8 / 4)          # apply_moe's capacity here
    dispatch, combine, _ = tmoe._top_k_dispatch(probs, 2, cap)
    jd, jc, _ = jax.vmap(lambda p: jmoe._top_k_dispatch(p, 2, cap))(
        jnp.asarray(probs.numpy()))
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    _close(combine.numpy(), jc)
    # every token kept twice, its two weights summing to one
    np.testing.assert_array_equal(dispatch.sum((-1, -2)).numpy(), 2.0)
    _close(combine.sum((-1, -2)).numpy(), np.ones((4, 8)))


def test_tiny_capacity_drops_tokens_to_zero():
    jp, tp = _params()
    x = _x(b=2, s=16)
    (ty, tm), (jy, jm) = _both(jp, tp, x, k=1, capacity=1)
    # 2 groups x 16 tokens, 4 experts x 1 slot a group: at most 8 kept
    assert float(tm["dropped_fraction"]) >= 1.0 - 8.0 / 32.0 - 1e-6
    norms = torch.linalg.norm(ty.reshape(-1, D), dim=-1).numpy()
    assert (norms == 0).sum() >= 24
    np.testing.assert_array_equal(
        norms == 0, np.linalg.norm(np.asarray(jy).reshape(-1, D), axis=-1)
        == 0)
    _close(ty.numpy(), jy)
    _check_metrics(tm, jm)


def test_explicit_group_size_and_its_refusal():
    jp, tp = _params()
    x = _x(b=4, s=8)
    xt = torch.from_numpy(x)
    y_default, _ = tmoe.apply_moe(tp, xt, k=2, capacity_factor=2.0)
    y_explicit, _ = tmoe.apply_moe(tp, xt, k=2, capacity_factor=2.0,
                                   group_size=8)
    np.testing.assert_array_equal(y_default.numpy(), y_explicit.numpy())
    # a 2-D input is one group, as in the JAX package
    (ty, _), (jy, _) = _both(jp, tp, x.reshape(-1, D), k=2,
                             capacity_factor=1.25)
    _close(ty.numpy(), jy)
    with pytest.raises(ValueError, match="does not divide"):
        tmoe.apply_moe(tp, xt, group_size=7)


def test_aux_loss_is_one_under_uniform_routing():
    jp, tp = _params()
    jp["router"]["kernel"] = jnp.zeros_like(jp["router"]["kernel"])
    tp["router"]["kernel"] = torch.zeros_like(tp["router"]["kernel"])
    (_, tm), (_, jm) = _both(jp, tp, _x(), k=1, capacity_factor=4.0)
    _close(float(tm["aux_loss"]), 1.0)
    _check_metrics(tm, jm)


@pytest.mark.parametrize("k", [1, 2])
def test_gradients_match_jax(k):
    jp, tp = _params()
    x = _x(b=2, s=8)

    def jloss(p, x):
        y, m = jmoe.apply_moe(p, x, k=k, capacity_factor=1.25)
        return ((y ** 2).mean() + 1e-2 * m["aux_loss"]
                + 1e-3 * m["router_z_loss"])
    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))

    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, m = tmoe.apply_moe(tp, xt, k=k, capacity_factor=1.25)
    tl = ((y ** 2).mean() + 1e-2 * m["aux_loss"]
          + 1e-3 * m["router_z_loss"])
    tl.backward()
    _close(float(tl.detach()), float(jl))
    _close(xt.grad.numpy(), jgx, what="x")
    for path in (("router", "kernel"), ("experts", "w_in"),
                 ("experts", "b_in"), ("experts", "w_out"),
                 ("experts", "b_out")):
        got = tp[path[0]][path[1]].grad
        want = jg[path[0]][path[1]]
        _close(got.numpy(), want, what=".".join(path))
    for leaf in (("router", "kernel"), ("experts", "w_in"),
                 ("experts", "w_out")):
        assert float(tp[leaf[0]][leaf[1]].grad.abs().sum()) > 0


def test_bf16_inputs_route_as_jax():
    jp, tp = _params()
    x = _x(b=4, s=16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    # the router's logits are the same bf16 values, so the choices are
    jl = jnp.einsum("gsd,de->gse", jx,
                    jp["router"]["kernel"].astype(jnp.bfloat16))
    tl = tx @ tp["router"]["kernel"].to(torch.bfloat16)
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl.astype(jnp.float32)))
    for k in (1, 2):
        jy, jm = jmoe.apply_moe(jp, jx, k=k, capacity_factor=1.25)
        ty, tm = tmoe.apply_moe(tp, tx, k=k, capacity_factor=1.25)
        assert ty.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            (ty.float() == 0).all(-1).numpy(),
            np.asarray((jy.astype(jnp.float32) == 0).all(-1)))
        _close(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
               tol=2e-2)
        _close(float(tm["aux_loss"]), float(jm["aux_loss"]))
        _close(float(tm["dropped_fraction"]),
               float(jm["dropped_fraction"]))


def test_train_without_jitter_matches_jax():
    jp, tp = _params()
    x = _x()
    jy, jm = jmoe.apply_moe(jp, jnp.asarray(x), k=2, train=True,
                            rng=jax.random.PRNGKey(5), jitter=0.0)
    ty, tm = tmoe.apply_moe(tp, torch.from_numpy(x), k=2, train=True,
                            generator=torch.Generator().manual_seed(5),
                            jitter=0.0)
    _close(ty.numpy(), jy)
    _check_metrics(tm, jm)


def test_jitter_range_and_draws():
    x = torch.from_numpy(_x(b=4, s=64))
    noise = tmoe._jitter_noise(x, torch.Generator().manual_seed(3), 0.1)
    assert noise.shape == x.shape and noise.dtype == x.dtype
    assert float(noise.min()) >= 0.9 and float(noise.max()) < 1.1
    assert abs(float(noise.mean()) - 1.0) < 0.01
    again = tmoe._jitter_noise(x, torch.Generator().manual_seed(3), 0.1)
    np.testing.assert_array_equal(noise.numpy(), again.numpy())
    # apply_moe multiplies the router input (only) by these draws
    _, tp = _params()
    y1, m1 = tmoe.apply_moe(tp, x, train=True, jitter=0.1,
                            generator=torch.Generator().manual_seed(3))
    y2, m2 = tmoe.apply_moe(tp, x, train=True, jitter=0.1,
                            generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())
    tok = x.reshape(4, 64, D)
    logits = (tok * noise.reshape(4, 64, D)) @ tp["router"]["kernel"]
    z = torch.logsumexp(logits, -1)
    _close(float(m1["router_z_loss"]), float(torch.mean(z ** 2)))
    y0, m0 = tmoe.apply_moe(tp, x, train=False)
    assert float(m0["router_z_loss"]) != float(m1["router_z_loss"])
    # without a generator, train=True draws nothing
    y3, _ = tmoe.apply_moe(tp, x, train=True, jitter=0.1)
    np.testing.assert_array_equal(y3.numpy(), y0.numpy())


def test_init_and_partition_rules():
    g = torch.Generator().manual_seed(0)
    tree = tmoe.init_moe(g, D, F, 4)
    jp, _ = _params()
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    limit = np.sqrt(6.0 / (D + F))
    for name in ("w_in", "w_out"):
        w = tree["experts"][name]
        assert float(w.abs().max()) <= limit
        assert not torch.equal(w[0], w[1])
    assert float(tree["experts"]["b_in"].abs().sum()) == 0.0
    # the JAX table row by row: the same specs, the patterns taking a
    # nested tree's "/" and a model's "." alike
    rows = tmoe.moe_partition_rules()
    jrows = jmoe.moe_partition_rules()
    assert [tuple(spec) for _, spec in rows] == \
        [tuple(spec) for _, spec in jrows]
    for (pat, _), (jpat, _) in zip(rows, jrows):
        assert pat.replace("[./]", "/") == jpat
