"""The port's flash attention (plain versions) held against the JAX kernels.

The same numpy inputs go through the JAX package's ``flash_attention``
(the Pallas forward and its two backward kernels, in interpret mode off
a TPU, with small blocks so the grids have several steps) and the port's
counterparts, which take their plain versions for CPU tensors:
``flash_attention_plain`` under torch autograd, ``flash_forward_plain``
(out and the row logsumexp) and the explicit backward formulas
``flash_backward_dkv_plain`` / ``flash_backward_dq_plain`` that the card
holds the dK/dV and dQ kernels against, and the backward as ``_Flash``
runs it (``flash_backward_plain``: dQ computing D from O, then dK/dV)
against ``_flash_backward``, which computes D itself.

Tolerances: f32 1e-5 absolute on the forward and the logsumexp, 1e-4 on
gradients (another summation order); bf16 2e-2 relative to the output's
scale (both sides compute in f32 from the same bf16 inputs and round
once; the JAX backward also rounds O to bf16 before D = rowsum(dO * O)).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.ops.pallas import flash_attention as jfa
from distributed_tensorflow_tpu.ops.pallas import make_flash_attention_fn \
    as jmake_fn
from distributed_tensorflow_tpu.ops.pallas.flash_attention import \
    _flash_backward, _flash_forward
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)

F32_FWD_TOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def _inputs(seed, b=2, s=64, h=4, hk=None, d=32, masked=False):
    rng = np.random.default_rng(seed)
    hk = hk or h
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hk, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hk, d), dtype=np.float32)
    do = rng.standard_normal((b, s, h, d), dtype=np.float32)
    valid = None
    if masked:
        valid = rng.random((b, s)) < 0.7
        valid[:, 0] = False        # causal row 0 of every batch: no key
        valid[1, :] = False        # batch row 1: every row fully masked
    return q, k, v, do, valid


def _jax_out_and_grads(q, k, v, do, valid, causal, dtype, block):
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)

    def f(q_, k_, v_):
        return jfa(q_, k_, v_, kv_valid=jv, causal=causal, block_q=block,
                   block_k=block)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _torch_out_and_grads(q, k, v, do, valid, causal, dtype):
    leaves = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tv = None if valid is None else torch.from_numpy(valid)
    out = tfa.flash_attention(*leaves, kv_valid=tv, causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do).to(dtype))
    return [x.detach().float().numpy() for x in (out, *grads)]


CASES = {
    "no_mask": dict(kw={}, causal=False, block=32),
    "causal": dict(kw={}, causal=True, block=16),
    "padding_fully_masked_rows": dict(kw=dict(masked=True), causal=True,
                                      block=16),
    "ragged_seq": dict(kw=dict(s=50), causal=True, block=16),
    "gqa_group_2": dict(kw=dict(h=4, hk=2, masked=True), causal=True,
                        block=16),
    # the encoders' route (BERT): bidirectional with key padding, rows
    # with no valid key among them
    "bidirectional_padding": dict(kw=dict(masked=True), causal=False,
                                  block=16),
    # train_vit's shape: 17 tokens (one ragged tile) of head dim 16
    "bidirectional_ragged_s17_hd16": dict(kw=dict(s=17, d=16),
                                          causal=False, block=16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_and_grads_match_jax(name):
    case = CASES[name]
    q, k, v, do, valid = _inputs(1, **case["kw"])
    want = _jax_out_and_grads(q, k, v, do, valid, case["causal"],
                              jnp.float32, case["block"])
    got = _torch_out_and_grads(q, k, v, do, valid, case["causal"],
                               torch.float32)
    np.testing.assert_allclose(got[0], want[0], atol=F32_FWD_TOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=F32_GRAD_TOL, rtol=0)
    if valid is not None:
        # batch row 1 has no valid key: output 0, no gradient into q
        assert np.all(got[0][1] == 0) and np.all(got[1][1] == 0)


@pytest.mark.parametrize("name", ["causal", "padding_fully_masked_rows",
                                  "gqa_group_2"])
def test_kernel_plain_versions_match_jax_kernels(name):
    """Forward (out, lse) against ``_flash_forward``; the explicit dK/dV
    and dQ formulas against the JAX backward."""
    case = CASES[name]
    q, k, v, do, valid = _inputs(2, **case["kw"])
    causal, block = case["causal"], case["block"]
    jvalid = (jnp.ones(q.shape[:2], jnp.float32) if valid is None
              else jnp.asarray(valid, jnp.float32))
    scale = 1.0 / np.sqrt(q.shape[-1])
    jout, jlse = _flash_forward(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                                  for x in (q, k, v)), jvalid, scale, causal,
                                block, block, True)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tvalid = None if valid is None else torch.from_numpy(valid)
    out, lse = tfa.flash_forward(tq, tk, tv, tvalid, causal)
    np.testing.assert_allclose(out.numpy(),
                               np.swapaxes(np.asarray(jout), 1, 2),
                               atol=F32_FWD_TOL, rtol=0)
    jlse = np.asarray(jlse)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()),
                                  np.isfinite(jlse))
    fin = np.isfinite(jlse)
    np.testing.assert_allclose(lse.numpy()[fin], jlse[fin],
                               atol=F32_FWD_TOL, rtol=0)

    dvec = tfa.row_dot(tdo, out)
    dk, dv = tfa.flash_backward_dkv(tq, tk, tv, tvalid, tdo, lse, dvec,
                                    causal)
    dq = tfa.flash_backward_dq(tq, tk, tv, tvalid, tdo, lse, dvec, causal)
    _, jdq, jdk, jdv = _jax_out_and_grads(q, k, v, do, valid, causal,
                                          jnp.float32, block)
    for g, w in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(g.numpy(), w, atol=F32_GRAD_TOL, rtol=0)


@pytest.mark.parametrize("hd", [16, 32])
def test_padded_head_dim_route_matches_jax(hd):
    """Head dims 16 and 32: the card's route zero-pads q, k, v (and dO)
    to 64, runs the kernels with the real head dim's scale and slices
    the results back.  That arithmetic, on the plain versions, equals
    the JAX kernel at the real head dim: out, lse and dq, dk, dv (the
    backward as ``_Flash`` runs it), and the padded columns come out 0."""
    q, k, v, do, valid = _inputs(7, s=40, d=hd, masked=True)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    pq, pk, pv, pdo = tfa._pad_head_dim(tq, tk, tv, tdo)
    assert pq.shape[-1] == 64 and tfa._pad_head_dim(None) == (None,)
    for kept in (64, 128):         # the kernels' own head dims pass as is
        x = torch.zeros(1, 2, 1, kept)
        assert tfa._pad_head_dim(x)[0] is x
    scale = 1.0 / np.sqrt(hd)
    out, lse = tfa.flash_forward_plain(pq, pk, pv, tvalid, False, scale)
    grads = tfa.flash_backward_plain(pq, pk, pv, tvalid, pdo, out, lse,
                                     False, scale)
    for t in (out, *grads):
        assert torch.all(t[..., hd:] == 0)
    want = _jax_out_and_grads(q, k, v, do, valid, False, jnp.float32, 16)
    np.testing.assert_allclose(out[..., :hd].numpy(), want[0],
                               atol=F32_FWD_TOL, rtol=0)
    for g, w in zip(grads, want[1:]):
        np.testing.assert_allclose(g[..., :hd].numpy(), w,
                                   atol=F32_GRAD_TOL, rtol=0)
    _, want_lse = tfa.flash_forward_plain(tq, tk, tv, tvalid, False)
    np.testing.assert_array_equal(lse.numpy(), want_lse.numpy())
    for bad in (8, 48, 96):
        x = torch.zeros(1, 4, 2, bad)
        with pytest.raises(ValueError, match="head_dim"):
            tfa._checked(x, x, x, None)


def test_bfloat16_matches_jax():
    q, k, v, do, _ = _inputs(3, s=48)
    want = _jax_out_and_grads(q, k, v, do, None, True, jnp.bfloat16, 16)
    got = _torch_out_and_grads(q, k, v, do, None, True, torch.bfloat16)
    for g, w in zip(got, want):
        scale = max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= BF16_TOL * scale


def test_padding_adapter_matches_jax():
    """``make_flash_attention_fn`` takes an additive padding mask."""
    q, k, v, _, valid = _inputs(4, masked=True)
    valid[1, 3] = True
    jmask = jnp.where(jnp.asarray(valid), 0.0, -1e9)[:, None, None, :]
    want = jmake_fn(causal=False, block_q=32, block_k=32)(
        *(jnp.asarray(x) for x in (q, k, v)), mask=jmask)
    tmask = torch.where(torch.from_numpy(valid), 0.0,
                        tattn.NEG_INF)[:, None, None, :]
    got = tfa.make_flash_attention_fn(causal=False)(
        *(torch.from_numpy(x) for x in (q, k, v)), mask=tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_FWD_TOL, rtol=0)
    with pytest.raises(ValueError, match="padding"):
        tfa.make_flash_attention_fn()(*(torch.from_numpy(x)
                                        for x in (q, k, v)),
                                      mask=torch.zeros(1, 1, 64, 64))


def test_attention_core_with_flash_matches_dense():
    """``attention_core`` with the flash adapter (causal) equals the dense
    ``dot_product_attention`` under ``causal_mask`` at f32."""
    rng = np.random.default_rng(5)
    d, h, hd = 32, 4, 8
    params = {n: {"kernel": torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32) * 0.2), "bias": torch.from_numpy(
            rng.standard_normal(bshape, dtype=np.float32) * 0.1)}
        for n, shape, bshape in (("query", (d, h, hd), (h, hd)),
                                 ("key", (d, 2, hd), (2, hd)),
                                 ("value", (d, 2, hd), (2, hd)),
                                 ("out", (h, hd, d), (d,)))}
    x = torch.from_numpy(rng.standard_normal((2, 20, d), dtype=np.float32))
    flash = tattn.attention_core(
        params, x, attention_fn=tfa.make_flash_attention_fn(causal=True))
    dense = tattn.attention_core(params, x, mask=tattn.causal_mask(20))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(),
                               atol=F32_FWD_TOL, rtol=0)


def test_cpu_wrappers_launch_nothing():
    q, k, v, do, _ = _inputs(6, s=16)
    before = dict(tfa.LAUNCHES)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves, causal=True).sum().backward()
    tfa.flash_forward(*leaves)
    assert dict(tfa.LAUNCHES) == before


@pytest.mark.parametrize("name,n_ptrs", [("flash_forward", 6),
                                         ("flash_backward_dkv", 9),
                                         ("flash_backward_dq", 9)])
def test_kernel_entries_bound_once_with_their_c_signatures(monkeypatch, name,
                                                           n_ptrs):
    """Each C entry of csrc/flash_attention.cu takes n_ptrs pointers, the
    type flag and six dims as ints, the scale as a float, the causal flag
    and the stream; the wrapper binds it once through ``_build.bind``."""
    import ctypes
    from distributed_tensorflow_tpu_torch.ops.kernels import _build
    calls = []

    def fake_bind(lib, fn_name, argtypes):
        calls.append((lib, fn_name, list(argtypes)))
        return object()
    monkeypatch.setattr(_build, "bind", fake_bind)
    tfa._fn(name, n_ptrs)
    assert calls == [("flash_attention", name,
                      [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])]


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_with_d_from_o_matches_jax_backward(name):
    """dQ computing D from O, then dK/dV reading it (the plain versions),
    against ``_flash_backward`` given the same out and lse and no D;
    D against the reference's own ``rowsum(dO * O)``."""
    case = CASES[name]
    q, k, v, do, valid = _inputs(7, **case["kw"])
    causal, block = case["causal"], case["block"]
    jvalid = (jnp.ones(k.shape[:2], jnp.float32) if valid is None
              else jnp.asarray(valid, jnp.float32))
    scale = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv, jdo = (jnp.swapaxes(jnp.asarray(x), 1, 2)
                       for x in (q, k, v, do))
    jout, jlse = _flash_forward(jq, jk, jv, jvalid, scale, causal, block,
                                block, True)
    want = [np.swapaxes(np.asarray(x), 1, 2) for x in _flash_backward(
        jq, jk, jv, jvalid, jout, jlse, jdo, scale, causal, block, block,
        True)]
    want_d = np.asarray(jnp.sum(jdo * jout, axis=-1))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tvalid = None if valid is None else torch.from_numpy(valid)
    tout = torch.from_numpy(np.swapaxes(np.asarray(jout), 1, 2).copy())
    tlse = torch.from_numpy(np.array(jlse))
    dq, dvec = tfa.flash_backward_dq_d_plain(tq, tk, tv, tvalid, tdo, tout,
                                             tlse, causal)
    np.testing.assert_allclose(dvec.numpy(), want_d, atol=F32_FWD_TOL,
                               rtol=0)
    got = tfa.flash_backward_plain(tq, tk, tv, tvalid, tdo, tout, tlse,
                                   causal)
    np.testing.assert_array_equal(got[0].numpy(), dq.numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=F32_GRAD_TOL, rtol=0)


def test_backward_launches_dq_with_o_then_dkv_with_its_d(monkeypatch):
    """Host side of the card's backward, over a stand-in library: dQ is
    launched first, with O and a fresh D buffer, then dK/dV with that same
    D; ``row_dot`` is not called."""
    from distributed_tensorflow_tpu_torch.ops.kernels import _build
    calls = []

    def fake_bind(lib, fn_name, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((fn_name, args))
            return 0
        return launch

    def no_row_dot(*_):
        raise AssertionError("row_dot called on the kernel route")
    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(tfa, "row_dot", no_row_dot)
    q, k, v, do, _ = _inputs(8, s=16, h=4, hk=2, d=64)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (q, k, v)]
    before = dict(tfa.LAUNCHES)
    out = tfa._Flash.apply(*leaves, None, True, 0.125)
    torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    assert [c[0] for c in calls] == ["flash_forward", "flash_backward_dq",
                                     "flash_backward_dkv"]
    (_, fwd), (_, dq), (_, dkv) = calls
    assert dq[5] == fwd[4] and dq[5] is not None     # O: the forward's out
    assert dq[6] == fwd[5] == dkv[5]                 # lse
    assert dq[7] == dkv[6] and dq[7] not in fwd      # D: dQ's, read by dK/dV
    assert dq[4] == dkv[4]                           # dO
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert tfa.LAUNCHES[name] == before.get(name, 0) + 1
