"""The port's paged attention (plain version) held against the JAX kernel.

Inputs come from one numpy seed and go through the JAX package's Pallas
``paged_decode_attention`` / ``paged_window_attention`` (interpret mode,
the default off a TPU) and through the port's entries, which take their
plain version (gather + ``dot_product_attention``) for CPU tensors.
Tolerance 1e-5 absolute at f32: the two sum in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tensorflow_tpu.ops.pallas import paged_attention as jpa
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as tpa

torch.set_num_threads(1)

TOL = 1e-5


def _pool(rng, L=2, NP=9, pg=8, kvh=2, hd=16):
    shape = (L, NP, pg, kvh, hd)
    return {"k": rng.standard_normal(shape, dtype=np.float32),
            "v": rng.standard_normal(shape, dtype=np.float32)}


def _both(pool):
    return ({k: jnp.asarray(v) for k, v in pool.items()},
            {k: torch.from_numpy(v) for k, v in pool.items()})


@pytest.mark.parametrize("kvh,group", [(2, 1), (2, 2)], ids=["mha", "gqa"])
def test_decode_matches_pallas_kernel(kvh, group):
    rng = np.random.default_rng(0)
    pg, P, S, hd = 8, 4, 4, 16
    pool = _pool(rng, pg=pg, kvh=kvh, hd=hd)
    jkv, tkv = _both(pool)
    q = rng.standard_normal((S, 1, kvh * group, hd), dtype=np.float32)
    tab = np.array([[3, 1, 7, 0],        # ragged, private pages
                    [2, 5, 0, 0],
                    [0, 0, 0, 0],        # retired: wholly the trash page
                    [4, 6, 8, 1]], np.int32)
    cols = np.arange(P * pg)[None, :]
    start = np.array([0, 3, 0, 0])[:, None]
    stop = np.array([19, 9, 5, 32])[:, None]
    valid = (cols >= start) & (cols < stop)
    valid[2] = False                     # a row with no valid column
    valid[2, 30] = False
    for layer in (0, 1):
        want = jpa.paged_decode_attention(jnp.asarray(q), jkv, layer,
                                          jnp.asarray(tab),
                                          jnp.asarray(valid))
        got = tpa.paged_decode_attention(torch.from_numpy(q), tkv, layer,
                                         torch.from_numpy(tab),
                                         torch.from_numpy(valid))
        assert got.shape == (S, 1, kvh * group, hd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("kvh,group", [(2, 1), (2, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("pos", [0, 5, 13])
def test_window_matches_pallas_kernel(kvh, group, pos):
    rng = np.random.default_rng(1)
    pg, hd, s = 8, 16, 6
    pool = _pool(rng, pg=pg, kvh=kvh, hd=hd)
    jkv, tkv = _both(pool)
    q = rng.standard_normal((1, s, kvh * group, hd), dtype=np.float32)
    row = np.array([4, 2, 0, 7], np.int32)     # page 2 -> trash page 0
    want = jpa.paged_window_attention(jnp.asarray(q), jkv, 1,
                                      jnp.asarray(row), jnp.int32(pos))
    got = tpa.paged_window_attention(torch.from_numpy(q), tkv, 1,
                                     torch.from_numpy(row), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(2)
    tkv = {k: torch.from_numpy(v) for k, v in _pool(rng).items()}
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 16),
                                             dtype=np.float32))
    tab = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0]], dtype=torch.int32)
    valid = torch.arange(32)[None, :] < torch.tensor([[20], [11]])
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_decode_attention(q, tkv, 0, tab, valid)
    want = tpa.paged_decode_attention_plain(q, tkv, 0, tab, valid)
    assert torch.equal(got, want)
    assert dict(tpa.LAUNCHES) == before


def _int8_pool(rng, L=2, NP=9, pg=8, kvh=2, hd=16, written=None):
    """An int8 pool as the serving write leaves it: values in [-127, 127]
    with one positive f32 scale per (token, kv head); cells of the pages
    in ``written`` only, the rest zero (scale 0), as unwritten cells are."""
    shape = (L, NP, pg, kvh, hd)
    pool = {}
    for name in ("k", "v"):
        q = rng.integers(-127, 128, shape).astype(np.int8)
        sc = rng.uniform(0.005, 0.05, shape[:-1] + (1,)).astype(np.float32)
        if written is not None:
            keep = np.zeros(NP, bool)
            keep[list(written)] = True
            q[:, ~keep] = 0
            sc[:, ~keep] = 0.0
        pool[name], pool[name + "_scale"] = q, sc
    return pool


@pytest.mark.parametrize("kvh,group", [(2, 1), (2, 2), (1, 4)],
                         ids=["mha", "gqa", "mqa"])
def test_int8_decode_matches_pallas_kernel(kvh, group):
    rng = np.random.default_rng(5)
    pg, P, S, hd = 8, 4, 4, 16
    pool = _int8_pool(rng, pg=pg, kvh=kvh, hd=hd, written=range(1, 8))
    jkv, tkv = _both(pool)
    q = rng.standard_normal((S, 1, kvh * group, hd), dtype=np.float32)
    tab = np.array([[3, 1, 7, 0], [2, 5, 0, 0], [0, 0, 0, 0],
                    [4, 6, 8, 1]], np.int32)        # page 8 never written
    cols = np.arange(P * pg)[None, :]
    valid = (cols >= np.array([0, 3, 0, 0])[:, None]) \
        & (cols < np.array([19, 9, 5, 28])[:, None])
    valid[2] = False                     # a row with no valid column
    for layer in (0, 1):
        want = jpa.paged_decode_attention(jnp.asarray(q), jkv, layer,
                                          jnp.asarray(tab),
                                          jnp.asarray(valid))
        got = tpa.paged_decode_attention(torch.from_numpy(q), tkv, layer,
                                         torch.from_numpy(tab),
                                         torch.from_numpy(valid))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("pos", [0, 5, 13])
def test_int8_window_matches_pallas_kernel(pos):
    rng = np.random.default_rng(6)
    pg, hd, s, kvh, group = 8, 16, 6, 2, 2
    pool = _int8_pool(rng, pg=pg, kvh=kvh, hd=hd)
    jkv, tkv = _both(pool)
    q = rng.standard_normal((1, s, kvh * group, hd), dtype=np.float32)
    row = np.array([4, 2, 0, 7], np.int32)
    want = jpa.paged_window_attention(jnp.asarray(q), jkv, 1,
                                      jnp.asarray(row), jnp.int32(pos))
    got = tpa.paged_window_attention(torch.from_numpy(q), tkv, 1,
                                     torch.from_numpy(row), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_int8_plain_dequantizes_in_f32_and_returns_q_type():
    """bf16 queries over an int8 pool: dequantized and attended in f32,
    rounded to bf16 once at the end (the Pallas body's arithmetic)."""
    rng = np.random.default_rng(7)
    tkv = {k: torch.from_numpy(v) for k, v in _int8_pool(rng).items()}
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16),
                                             dtype=np.float32))
    tab = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0]], dtype=torch.int32)
    valid = torch.arange(32)[None, :] < torch.tensor([[20], [11]])
    got = tpa.paged_decode_attention(q.to(torch.bfloat16), tkv, 0, tab,
                                     valid)
    want = tpa.paged_decode_attention(q.to(torch.bfloat16).float(), tkv, 0,
                                      tab, valid)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
