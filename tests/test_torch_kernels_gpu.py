"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
Tolerances: f32 1e-4 absolute (summation order); bf16 2e-2 absolute for
paged attention (the plain version rounds logits and weights to bf16) and
1e-2 for LayerNorm (about one bf16 ulp at unit scale; held per element
relative to max(1, |want|), one ulp at any magnitude).  Flash attention
is held relative to the output's scale, ``max|got - want| <= tol *
max(1, max|want|)``: f32 1e-4 (summation order), bf16 1e-2 (both sides
compute in f32 from the same bf16 inputs and round once, so they differ
by about one bf16 ulp, 2**-8 relative); D = rowsum(dO * O) computed in
the dQ kernel 1e-5 of its scale (f32 summation order).  Adam: f32 1e-6
absolute plus 1e-5 relative (the kernel may contract a multiply-add).
RMSNorm: f32 1e-4 absolute; bf16 one bf16 ulp an element (and 1e-2
absolute up to 32 x 4096 elements).  Paged attention over an int8 pool
is held relative to the output's scale as flash is: f32 queries 1e-4
(the kernel folds each scale into the logit and the softmax weight
instead of multiplying every element: another f32 rounding order), bf16
queries 1e-2 (both sides dequantize and attend in f32 and round once to
bf16).
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, Engine, TrainState, adamw,
                                              gpt_tiny, llama_tiny,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch.ops.kernels import _build
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(gen, dtype, device, L=2, NP=40, pg=16, kvh=2, hd=64):
    shape = (L, NP, pg, kvh, hd)
    return {k: torch.randn(shape, generator=gen).to(dtype).to(device)
            for k in ("k", "v")}


@pytest.mark.parametrize("dtype,tol,group,hd", [
    (torch.float32, 1e-4, 1, 64), (torch.float32, 1e-4, 2, 64),
    (torch.bfloat16, 2e-2, 1, 64), (torch.bfloat16, 2e-2, 2, 64),
    (torch.bfloat16, 2e-2, 2, 128), (torch.float32, 1e-4, 1, 32),
    (torch.bfloat16, 2e-2, 2, 32)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, tol, group, hd):
    gen = torch.Generator().manual_seed(0)
    kv = _pool(gen, dtype, cuda, hd=hd)
    S, P, pg, kvh = 4, 8, 16, 2
    q = torch.randn(S, 1, kvh * group, hd, generator=gen).to(dtype).to(cuda)
    tab = torch.randint(1, 40, (S, P), generator=gen, dtype=torch.int32)
    tab[2] = 0                                   # wholly the trash page
    cols = torch.arange(P * pg)[None, :]
    valid = (cols >= torch.tensor([[0], [5], [0], [0]])) \
        & (cols < torch.tensor([[37], [70], [9], [128]]))
    valid[3] = False                             # no valid column at all
    tab, valid = tab.to(cuda), valid.to(cuda)
    before = pa.LAUNCHES["paged_decode"]
    got = pa.paged_decode_attention(q, kv, 1, tab, valid)
    want = pa.paged_decode_attention_plain(q, kv, 1, tab, valid)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_paged_kernel_refuses_what_it_cannot_hold(cuda):
    """f32 at head_dim 128 needs more shared memory than a block has;
    head_dim 96 has no instantiation.  Both raise before any launch."""
    gen = torch.Generator().manual_seed(3)
    tab = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    valid = torch.ones(1, 128, dtype=torch.bool, device=cuda)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 96)):
        kv = _pool(gen, dtype, cuda, hd=hd)
        q = torch.randn(1, 1, 2, hd, generator=gen).to(dtype).to(cuda)
        with pytest.raises(ValueError, match="shared memory|head_dim"):
            pa.paged_decode_attention(q, kv, 0, tab, valid)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pos", [0, 40, 97])
def test_paged_window_kernel_matches_plain(cuda, dtype, tol, pos):
    gen = torch.Generator().manual_seed(1)
    kv = _pool(gen, dtype, cuda)
    q = torch.randn(1, 32, 4, 64, generator=gen).to(dtype).to(cuda)
    row = torch.randint(1, 40, (8,), generator=gen,
                        dtype=torch.int32).to(cuda)
    got = pa.paged_window_attention(q, kv, 0, row, pos)
    want = pa.paged_window_attention_plain(q, kv, 0, row, pos)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol


def _norm_close(got, want, tol):
    """Elementwise ``|got - want| <= tol * max(1, |want|)``: at 1e-2 one
    bf16 ulp (2**-7 relative) at any magnitude, since the two sides may
    round f32 results that differ in the last place to neighbouring bf16
    values."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs()
                 <= tol * want.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_layernorm_kernel_matches_plain(cuda, dtype, tol):
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(33, 768, generator=gen) * 2 + 1).to(dtype).to(cuda)
    gamma = torch.randn(768, generator=gen).to(cuda)
    beta = torch.randn(768, generator=gen).to(cuda)
    got = fused.fused_layernorm(x, gamma, beta, 1e-5)
    want = fused.layernorm_plain(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("d", [768, 4096, 1000])
@pytest.mark.parametrize("rows", [1, 8, 33, 256])
def test_layernorm_kernel_shapes_match_plain(cuda, dtype, tol, d, rows):
    """The register path (d 768 and 4096, 16-byte aligned) and the looped
    path (d 1000 in bf16 is 2000 bytes, no multiple of 16)."""
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(rows, d, generator=gen) * 2 + 1).to(dtype).to(cuda)
    gamma = torch.randn(d, generator=gen).to(cuda)
    beta = torch.randn(d, generator=gen).to(cuda)
    before = fused.LAUNCHES["layernorm"]
    got = fused.fused_layernorm(x, gamma, beta, 1e-5)
    want = fused.layernorm_plain(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["layernorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _norm_close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_layernorm_kernel_misaligned_input(cuda, dtype, tol):
    """x at an odd element offset (not 16-byte aligned) takes the looped
    path and agrees as the aligned one does."""
    gen = torch.Generator().manual_seed(13)
    rows, d = 8, 768
    flat = torch.randn(rows * d + 1, generator=gen).to(dtype).to(cuda)
    x = flat[1:].view(rows, d).contiguous()
    assert x.data_ptr() % 16 and x.is_contiguous()
    gamma = torch.randn(d, generator=gen).to(cuda)
    beta = torch.randn(d, generator=gen).to(cuda)
    got = fused.fused_layernorm(x, gamma, beta, 1e-5)
    want = fused.layernorm_plain(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert _norm_close(got, want, tol)


def test_layernorm_kernel_same_output_with_and_without_grad(cuda):
    """Under no_grad the wrapper launches directly; with a gradient it goes
    through the autograd Function: the same kernel, the same bits."""
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(33, 768, generator=gen).to(torch.bfloat16).to(cuda)
    gamma = torch.randn(768, generator=gen).to(cuda).requires_grad_()
    beta = torch.randn(768, generator=gen).to(cuda).requires_grad_()
    before = fused.LAUNCHES["layernorm"]
    with torch.no_grad():
        plain_call = fused.fused_layernorm(x, gamma, beta, 1e-5)
    graph_call = fused.fused_layernorm(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["layernorm"] == before + 2
    assert not plain_call.requires_grad and graph_call.requires_grad
    assert torch.equal(plain_call, graph_call.detach())


def test_engine_on_card_launches_the_kernels(cuda):
    model = GPT(gpt_tiny(), device=cuda)
    for c in (pa.LAUNCHES, fused.LAUNCHES):
        c.clear()
    eng = Engine(model, num_slots=2, max_len=64, prefill_chunk=8,
                 tick_steps=2)
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, 512, n, dtype=np.int32), 5)
          for n in (12, 5, 20)]
    eng.drain()
    assert [len(h.tokens) for h in hs] == [5, 5, 5]
    assert pa.LAUNCHES["paged_decode"] > 0
    assert pa.LAUNCHES["paged_window"] > 0
    assert fused.LAUNCHES["layernorm"] > 0


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


def _same_lse(got, want, tol):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert _rel_err(got[fin], want[fin]) <= tol


# (dtype, tol, hd, group, causal, masked, s): the CPU file's cases plus
# head dim 128; bf16 lengths no 64-row tile divides (1, 63, 65, 129,
# 1000), GQA group 4 at head dim 128, and kv-valid planes with fully
# masked rows, causal and not
_FLASH_CASES = [
    (torch.float32, 1e-4, 64, 1, False, False, 64),
    (torch.float32, 1e-4, 64, 1, True, False, 64),
    (torch.float32, 1e-4, 64, 1, False, True, 64),
    (torch.float32, 1e-4, 64, 1, True, False, 50),
    (torch.float32, 1e-4, 64, 2, True, True, 70),
    (torch.bfloat16, 1e-2, 64, 1, True, False, 256),
    (torch.bfloat16, 1e-2, 64, 2, False, True, 100),
    (torch.bfloat16, 1e-2, 128, 1, True, False, 130),
    (torch.float32, 1e-4, 128, 2, True, True, 96),
    (torch.bfloat16, 1e-2, 64, 1, True, False, 1),
    (torch.bfloat16, 1e-2, 64, 1, True, False, 63),
    (torch.bfloat16, 1e-2, 64, 2, False, False, 65),
    (torch.bfloat16, 1e-2, 128, 1, True, False, 129),
    (torch.bfloat16, 1e-2, 64, 1, True, False, 1000),
    (torch.bfloat16, 1e-2, 128, 4, True, False, 200),
    (torch.bfloat16, 1e-2, 64, 2, True, True, 150),
    (torch.bfloat16, 1e-2, 128, 1, False, True, 77),
]


@pytest.mark.parametrize("dtype,tol,hd,group,causal,masked,s", _FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, tol, hd, group, causal,
                                   masked, s):
    gen = torch.Generator().manual_seed(4)
    b, hk = 2, 2
    h = hk * group

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).to(cuda)
    q, k, v, do = rnd(b, s, h, hd), rnd(b, s, hk, hd), rnd(b, s, hk, hd), \
        rnd(b, s, h, hd)
    valid = None
    if masked:
        valid = torch.rand(b, s, generator=gen) < 0.7
        valid[0, :] = False           # batch row 0: every row fully masked
        valid[1, 0] = True
        valid = valid.to(cuda)
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_forward(q, k, v, valid, causal)
    want_out, want_lse = fa.flash_forward_plain(q, k, v, valid, causal)
    assert _rel_err(out, want_out) <= tol
    _same_lse(lse, want_lse, 1e-5)
    dvec = fa.row_dot(do, out)
    dk, dv = fa.flash_backward_dkv(q, k, v, valid, do, lse, dvec, causal)
    want_dk, want_dv = fa.flash_backward_dkv_plain(q, k, v, valid, do, lse,
                                                   dvec, causal)
    dq = fa.flash_backward_dq(q, k, v, valid, do, lse, dvec, causal)
    want_dq = fa.flash_backward_dq_plain(q, k, v, valid, do, lse, dvec,
                                         causal)
    torch.cuda.synchronize()
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= tol
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        assert fa.LAUNCHES[name] == before.get(name, 0) + 1


# (sq, sk, h, hk, hd, causal, masked): ragged lengths no tile divides,
# Sq != Sk both ways, GQA 12:4, head dims 64 and 128, causal on and off,
# kv-valid planes with fully masked rows
_FLASH_BF16_FWD_CASES = [
    (300, 300, 12, 4, 64, True, False),
    (300, 300, 12, 4, 128, False, False),
    (300, 300, 12, 12, 64, True, True),
    (200, 333, 12, 4, 64, True, True),
    (333, 200, 12, 4, 128, True, True),
    (130, 77, 4, 4, 64, False, True),
    (1, 129, 12, 4, 64, False, False),
]


@pytest.mark.parametrize("sq,sk,h,hk,hd,causal,masked", _FLASH_BF16_FWD_CASES)
def test_flash_forward_bf16_matches_plain(cuda, sq, sk, h, hk, hd, causal,
                                          masked):
    gen = torch.Generator().manual_seed(15)
    b = 3

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16).to(cuda)
    q, k, v = rnd(b, sq, h, hd), rnd(b, sk, hk, hd), rnd(b, sk, hk, hd)
    valid = None
    if masked:
        valid = torch.rand(b, sk, generator=gen) < 0.6
        valid[0, :] = False           # batch row 0: every row fully masked
        valid[1, :3] = False          # causal rows 0-2 of batch row 1 too
        valid = valid.to(cuda)
    before = fa.LAUNCHES["flash_forward"]
    out, lse = fa.flash_forward(q, k, v, valid, causal)
    want_out, want_lse = fa.flash_forward_plain(q, k, v, valid, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_forward"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel_err(out, want_out) <= 1e-2
    _same_lse(lse, want_lse, 1e-5)
    if masked:
        assert torch.equal(out[0].float(), torch.zeros_like(out[0].float()))
        assert bool(torch.isneginf(lse[0]).all())


def _flash_inputs(cuda, dtype, b, s, h, hk, hd, masked, seed):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).to(cuda)
    q, k, v, do = rnd(b, s, h, hd), rnd(b, s, hk, hd), rnd(b, s, hk, hd), \
        rnd(b, s, h, hd)
    valid = None
    if masked:
        valid = torch.rand(b, s, generator=gen) < 0.6
        valid[0, :] = False           # batch row 0: every row fully masked
        valid[1, :3] = False          # causal rows 0-2 of batch row 1 too
        valid = valid.to(cuda)
    return q, k, v, do, valid


# (dtype, hd, s, h, hk, causal, masked)
_FLASH_D_CASES = [
    (torch.bfloat16, 64, 256, 12, 12, True, False),
    (torch.bfloat16, 128, 129, 8, 2, True, True),
    (torch.bfloat16, 64, 65, 4, 2, False, True),
    (torch.float32, 64, 70, 4, 2, True, True),
    (torch.float32, 128, 96, 4, 4, False, False),
]


@pytest.mark.parametrize("dtype,hd,s,h,hk,causal,masked", _FLASH_D_CASES)
def test_flash_dq_computing_d_equals_the_given_d_route(cuda, dtype, hd, s, h,
                                                       hk, causal, masked):
    """The dQ kernel given O writes D = rowsum(dO * O) (within f32
    summation order of ``row_dot``, 1e-5 of its scale) and the dq that the
    given-D route computes from that same D, bit for bit; and dq within the
    flash tolerance of the given-D route fed ``row_dot``'s D."""
    q, k, v, do, valid = _flash_inputs(cuda, dtype, 2, s, h, hk, hd, masked,
                                       17)
    out, lse = fa.flash_forward(q, k, v, valid, causal)
    vb = fa._checked(q, k, v, valid)
    before = fa.LAUNCHES["flash_backward_dq"]
    dq, dvec = fa._launch_dq_d(q, k, v, vb, do, out, lse, causal,
                               hd ** -0.5)
    assert fa.LAUNCHES["flash_backward_dq"] == before + 1
    want_d = fa.row_dot(do, out)
    assert dvec.shape == want_d.shape and dvec.dtype == torch.float32
    assert _rel_err(dvec, want_d) <= 1e-5
    same_d = fa.flash_backward_dq(q, k, v, valid, do, lse, dvec, causal)
    assert torch.equal(dq, same_d)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(dq, fa.flash_backward_dq(q, k, v, valid, do, lse,
                                             want_d, causal)) <= tol


@pytest.mark.parametrize("hd,h,hk,masked", [(64, 12, 12, False),
                                            (128, 8, 2, True)])
def test_flash_backward_is_deterministic(cuda, hd, h, hk, masked):
    """Two backward passes of the same inputs give the same bits (no
    atomics: dQ and dK/dV each own their outputs)."""
    q, k, v, do, valid = _flash_inputs(cuda, torch.bfloat16, 3, 300, h, hk,
                                       hd, masked, 18)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    runs = [torch.autograd.grad(fa.flash_attention(*leaves, valid,
                                                   causal=True), leaves, do)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_forward_and_backward_replay_in_a_cuda_graph(cuda):
    """``_Flash`` forward and backward captured in one CUDA graph replay to
    the eager results, bit for bit (no allocation or synchronisation
    inside a launch)."""
    q, k, v, do, valid = _flash_inputs(cuda, torch.bfloat16, 2, 200, 12, 4,
                                       64, True, 19)
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def step():
        out = fa.flash_attention(*leaves, valid, causal=True)
        return (out.detach(), *torch.autograd.grad(out, leaves, do))
    eager = step()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        captured = step()
    for x in captured:
        x.zero_()
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_flash_attention_bf16_autograd_matches_plain(cuda):
    """The training path's route in bf16 (GQA 12:4, ragged 300, causal):
    gradients through the forward's lse and the dK/dV and dQ kernels, held
    at 2e-2 of the gradient's scale (each side rounds the bf16 output and
    the kernels also round P and dS to bf16 before their products)."""
    gen = torch.Generator().manual_seed(16)
    shape_q, shape_kv = (2, 300, 12, 64), (2, 300, 4, 64)
    leaves = [torch.randn(s, generator=gen).to(torch.bfloat16).to(cuda)
              .requires_grad_() for s in (shape_q, shape_kv, shape_kv)]
    do = torch.randn(shape_q, generator=gen).to(torch.bfloat16).to(cuda)
    got = torch.autograd.grad(fa.flash_attention(*leaves, causal=True),
                              leaves, do)
    want = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, causal=True), leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g, w) <= 2e-2


def test_flash_attention_autograd_matches_plain(cuda):
    gen = torch.Generator().manual_seed(5)
    shape_q, shape_kv = (2, 77, 4, 64), (2, 77, 2, 64)
    leaves = [torch.randn(s, generator=gen).to(cuda).requires_grad_()
              for s in (shape_q, shape_kv, shape_kv)]
    do = torch.randn(shape_q, generator=gen).to(cuda)
    got = torch.autograd.grad(fa.flash_attention(*leaves, causal=True),
                              leaves, do)
    want = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, causal=True), leaves, do)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-4


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa.flash_forward(q, q, q)


@pytest.mark.parametrize("n", [1000, 768 * 3072, 4099])
@pytest.mark.parametrize("tf14,wd,delta", [(True, 0.0, True),
                                           (False, 0.01, False)])
def test_adam_kernel_matches_plain(cuda, n, tf14, wd, delta):
    gen = torch.Generator().manual_seed(6)
    p, g, m = (torch.randn(n, generator=gen).to(cuda) for _ in range(3))
    v = torch.rand(n, generator=gen).to(cuda)
    kw = dict(lr=1e-3, weight_decay=wd, tf14_eps=tf14, return_delta=delta)
    want = fused.adam_plain(p, g, m, v, 3, **kw)
    before = fused.LAUNCHES["adam"]
    got = fused.fused_adam_update(p, g, m, v, 3, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["adam"] == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # in place: the outputs are the inputs' own buffers
    m2, v2 = m.clone(), v.clone()
    out = fused.fused_adam_update(p, g, m2, v2, 3, out=(None, m2, v2), **kw)
    assert out[1] is m2 and out[2] is v2
    torch.testing.assert_close(m2, want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v2, want[2], rtol=1e-5, atol=1e-6)


def test_layernorm_kernel_gradient_matches_plain(cuda):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(5, 7, 128, generator=gen).to(cuda).requires_grad_()
    gamma = torch.randn(128, generator=gen).to(cuda).requires_grad_()
    beta = torch.randn(128, generator=gen).to(cuda).requires_grad_()
    dy = torch.randn(5, 7, 128, generator=gen).to(cuda)
    got = torch.autograd.grad(fused.fused_layernorm(x, gamma, beta, 1e-5),
                              (x, gamma, beta), dy)
    want = torch.autograd.grad(fused.layernorm_plain(x, gamma, beta, 1e-5),
                               (x, gamma, beta), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_training_on_card_matches_cpu_and_launches_the_kernels(cuda):
    """Two f32 gpt_tiny steps: card (kernels) against CPU (plain)."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (4, 33)))
    init = GPT(gpt_tiny(), device="cpu").state_dict()
    runs = []
    for device in ("cuda", "cpu"):
        model = GPT(gpt_tiny(dropout_rate=0.0), device=device)
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        opt = adamw(1e-4)
        state = TrainState.create(params, opt.init(params))
        step = make_custom_train_step(model.lm_loss_fn(), opt,
                                      grad_clip_norm=1.0)
        for c in (fa.LAUNCHES, fused.LAUNCHES):
            c.clear()
        losses = []
        for _ in range(2):
            state, metrics = step(state, {"input_ids": ids})
            losses.append(metrics["loss"].item())
        runs.append((losses, {k: p.detach().cpu() for k, p in
                              params.items()}))
        if device == "cuda":
            assert fa.LAUNCHES["flash_forward"] == 2 * 2
            assert fa.LAUNCHES["flash_backward_dkv"] == 2 * 2
            assert fa.LAUNCHES["flash_backward_dq"] == 2 * 2
            assert fused.LAUNCHES["layernorm"] == 2 * 5
            assert fused.LAUNCHES["adam"] == 2 * len(params)
    (l_gpu, p_gpu), (l_cpu, p_cpu) = runs
    np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-4, rtol=0)
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k], p_cpu[k], rtol=0, atol=1e-3)


def _bf16_ulps(got, want) -> float:
    """max |got - want| over the elements, each in units of its plain
    value's bf16 ulp (2^(e - 8) for |want| in [2^(e-1), 2^e))."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return ((got.float() - want).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,offset", [
    ((32, 4096), 0), ((8, 4096), 0), ((5, 7, 128), 0), ((3, 100), 0),
    ((1, 4096), 0), ((2048, 4096), 0), ((133, 4096), 0), ((2047, 4096), 0),
    ((20000, 4096), 0), ((4, 16384), 0), ((8, 4096), 1)],
    ids=["window", "decode", "3d", "unaligned", "one-row", "prefill",
         "just-many", "uneven", "grid-passes", "above-budget",
         "misaligned-x"])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, tol, shape, offset):
    """Both launch shapes of the register path (one block a row up to the
    SM count, 132 on the H100; above it narrow blocks walking rows: 2047
    rows leave the last block short, 20000 need several rows a block),
    and the looped path (a d above the 16 KB register budget, a d whose
    bytes are no multiple of 16, an x that starts off a 16-byte
    boundary).  Every bf16 element within one bf16 ulp of the plain one;
    up to the window's 32 x 4096 elements every case also within ``tol``
    absolute (over hundreds of rows an f32 round-off in the statistics
    flips some element of |out| >= 2 to the neighbouring bf16 value,
    1.6e-2 or more away)."""
    gen = torch.Generator().manual_seed(8)
    n = int(np.prod(shape))
    flat = (torch.randn(n + offset, generator=gen) * 2 + 1).to(dtype)
    x = flat.to(cuda)[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    gamma = torch.randn(shape[-1], generator=gen).to(cuda)
    before = fused.LAUNCHES["rmsnorm"]
    got = fused.fused_rmsnorm(x, gamma, 1e-5)
    want = fused.rmsnorm_plain(x, gamma, 1e-5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1.0
    if n <= 32 * 4096 or dtype == torch.float32:
        assert err <= tol


@pytest.mark.parametrize("rows", [8, 2048])
def test_rmsnorm_kernel_replays_in_a_cuda_graph(cuda, rows):
    """Captured in a CUDA graph (the launch reads nothing from the card
    and decides its grid from the shapes), the kernel gives the eager
    output bit for bit."""
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(rows, 4096, generator=gen).to(torch.bfloat16).to(cuda)
    gamma = torch.randn(4096, generator=gen).to(cuda)
    eager = fused.fused_rmsnorm(x, gamma, 1e-5)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fused.fused_rmsnorm(x, gamma, 1e-5)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        captured = fused.fused_rmsnorm(x, gamma, 1e-5)
    captured.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_rmsnorm_kernels_do_not_spill(cuda):
    """ptxas keeps every RMSNorm instantiation in registers: no spill
    stores or loads (gamma and two rows of x live in registers on the
    register path)."""
    report = _build.ptxas_report("rmsnorm")
    want = {f"rmsnorm_vec_kernel<{t},{nv}>" for t in ("__nv_bfloat16",
                                                       "float")
            for nv in (1, 2, 4)}
    want |= {"rmsnorm_loop_kernel<__nv_bfloat16>",
             "rmsnorm_loop_kernel<float>"}
    assert set(report) == want
    for name, info in report.items():
        assert info["spill_stores"] == info["spill_loads"] == 0, name


def test_rmsnorm_kernel_gradient_matches_plain(cuda):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(5, 7, 128, generator=gen).to(cuda).requires_grad_()
    gamma = torch.randn(128, generator=gen).to(cuda).requires_grad_()
    dy = torch.randn(5, 7, 128, generator=gen).to(cuda)
    got = torch.autograd.grad(fused.fused_rmsnorm(x, gamma, 1e-5),
                              (x, gamma), dy)
    want = torch.autograd.grad(fused.rmsnorm_plain(x, gamma, 1e-5),
                               (x, gamma), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _int8_pool(gen, device, L=2, NP=40, pg=16, kvh=2, hd=64):
    """int8 values and per-(token, kv head) scales as the serving write
    leaves them (amax / 127 of values of about unit scale); page 39 is
    left unwritten: values and scales 0."""
    shape = (L, NP, pg, kvh, hd)
    kv = {}
    for name in ("k", "v"):
        q = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand(shape[:-1] + (1,), generator=gen)
        q[:, 39] = 0
        sc[:, 39] = 0.0
        kv[name], kv[name + "_scale"] = q.to(device), sc.to(device)
    return kv


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_paged_int8_decode_kernel_matches_plain(cuda, dtype, tol, hd):
    gen = torch.Generator().manual_seed(10)
    S, P, pg, kvh, group = 5, 8, 16, 2, 4
    kv = _int8_pool(gen, cuda, hd=hd)
    q = torch.randn(S, 1, kvh * group, hd, generator=gen).to(dtype).to(cuda)
    tab = torch.randint(1, 40, (S, P), generator=gen, dtype=torch.int32)
    tab[2] = 0                                   # wholly the trash page
    tab[4, 1] = 39                               # an unwritten page
    cols = torch.arange(P * pg)[None, :]
    valid = (cols >= torch.tensor([[0], [5], [0], [0], [3]])) \
        & (cols < torch.tensor([[37], [70], [9], [128], [100]]))
    valid[3] = False                             # no valid column at all
    tab, valid = tab.to(cuda), valid.to(cuda)
    before = dict(pa.LAUNCHES)
    got = pa.paged_decode_attention(q, kv, 1, tab, valid)
    want = pa.paged_decode_attention_plain(q, kv, 1, tab, valid)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode_int8"] \
        == before.get("paged_decode_int8", 0) + 1
    assert pa.LAUNCHES["paged_decode"] == before.get("paged_decode", 0)
    assert got.dtype == dtype
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("pos", [0, 40, 97])
def test_paged_int8_window_kernel_matches_plain(cuda, dtype, tol, hd, pos):
    gen = torch.Generator().manual_seed(11)
    kv = _int8_pool(gen, cuda, hd=hd)
    q = torch.randn(1, 32, 8, hd, generator=gen).to(dtype).to(cuda)
    row = torch.randint(1, 40, (8,), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = pa.LAUNCHES["paged_window_int8"]
    got = pa.paged_window_attention(q, kv, 0, row, pos)
    want = pa.paged_window_attention_plain(q, kv, 0, row, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_window_int8"] == before + 1
    assert _rel_err(got, want) <= tol


def test_paged_kernel_refuses_a_mixed_pool(cuda):
    """An int8 pool needs both f32 scale planes; a pool in q's type takes
    none.  Anything else raises before any launch."""
    gen = torch.Generator().manual_seed(12)
    kv = _int8_pool(gen, cuda)
    q = torch.randn(1, 1, 4, 64, generator=gen).to(cuda)
    tab = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    valid = torch.ones(1, 128, dtype=torch.bool, device=cuda)
    before = dict(pa.LAUNCHES)
    with pytest.raises(ValueError, match="both"):
        pa.paged_decode_attention(q, {k: v for k, v in kv.items()
                                      if k != "v_scale"}, 0, tab, valid)
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_decode_attention(
            q, dict(kv, k_scale=kv["k_scale"].to(torch.bfloat16)), 0, tab,
            valid)
    with pytest.raises(TypeError, match="pool"):
        pa.paged_decode_attention(
            q, dict(kv, k=kv["k"].float(), v=kv["v"].float()), 0, tab,
            valid)
    with pytest.raises(TypeError, match="pool"):
        pa.paged_decode_attention(
            q, {"k": kv["k"], "v": kv["v"]}, 0, tab, valid)
    assert dict(pa.LAUNCHES) == before


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_llama_engine_on_card_matches_cpu(cuda, kv_cache_dtype):
    """An f32 Llama with head_dim 64 (``llama_tiny``'s own 32 runs in
    tests/test_torch_gpt_family_gpu.py) on the card and on the CPU from the same weights: rmsnorm and the paged
    kernels launch, layernorm does not; the greedy tokens agree
    (int8: up to a rounding step flipped by f32 summation order, so the
    comparison there is on the first token of each request)."""
    config = llama_tiny(hidden_size=256, kv_cache_dtype=kv_cache_dtype)
    gpu = GPT(config, device=cuda)
    cpu = GPT(config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 17, 40)]
    for c in (pa.LAUNCHES, fused.LAUNCHES):
        c.clear()
    outs = []
    for model, device in ((gpu, cuda), (cpu, "cpu")):
        eng = Engine(model, device=device, num_slots=2, max_len=128,
                     prefill_chunk=16, tick_steps=4)
        outs.append(eng.generate_batch(prompts, 8))
    suffix = "_int8" if kv_cache_dtype else ""
    assert pa.LAUNCHES["paged_decode" + suffix] > 0
    assert pa.LAUNCHES["paged_window" + suffix] > 0
    assert fused.LAUNCHES["rmsnorm"] > 0 and fused.LAUNCHES["layernorm"] == 0
    if kv_cache_dtype is None:
        assert outs[0] == outs[1]
    else:
        assert [o[0] for o in outs[0]] == [o[0] for o in outs[1]]


# --- split-K paged attention: boundaries, routes, page sizes -------------

def _any_pool(gen, kind, device, hd, pg, NP=48, L=2, kvh=2):
    if kind == "int8":
        return _int8_pool(gen, device, L=L, NP=NP, pg=pg, kvh=kvh, hd=hd)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    return _pool(gen, dtype, device, L=L, NP=NP, pg=pg, kvh=kvh, hd=hd)


def _paged_err(got, want, kind, q_dtype):
    """(error, tol) as the tests above hold each branch: an int8 pool
    relative to the output's scale, a pool in q's type absolutely."""
    if kind == "int8":
        return _rel_err(got, want), (1e-4 if q_dtype == torch.float32
                                     else 1e-2)
    return ((got.float() - want.float()).abs().max().item(),
            1e-4 if q_dtype == torch.float32 else 2e-2)


_SPLIT_CASES = [(kind, hd, group, pg)
                for kind in ("f32", "bf16", "int8") for hd in (32, 64, 128)
                for group in (1, 2, 4) for pg in (1, 8, 16)
                if not (kind == "f32" and hd == 128)]   # over shared memory


@pytest.mark.parametrize("kind,hd,group,pg", _SPLIT_CASES)
def test_paged_decode_split_boundaries(cuda, kind, hd, group, pg):
    """Decode at 1, 2, 3 splits and the planned count, on the body the
    dtypes route to, against the plain version: a row whose later splits are all masked, a
    row whose earlier ones are, a row with no valid column anywhere
    (every column attended, uniformly across splits), a row wholly on the
    trash page, a full row; views of 200 or 208 columns (no multiple of
    32 x splits; 200 also no multiple of 16, the scan's byte path)."""
    gen = torch.Generator().manual_seed(20 + hd + group + pg)
    kvh, S = 2, 5
    P = -(-200 // pg)
    view = P * pg
    kv = _any_pool(gen, kind, cuda, hd, pg)
    tab = torch.randint(1, 48, (S, P), generator=gen, dtype=torch.int32)
    tab[3] = 0                                   # wholly the trash page
    cols = torch.arange(view)[None, :]
    lo = torch.tensor([[0], [150], [0], [0], [0]])
    hi = torch.tensor([[37], [view], [0], [120], [view]])
    valid = (cols >= lo) & (cols < hi)           # row 2: no valid column
    tab, valid = tab.to(cuda), valid.to(cuda)
    q_dtypes = ([torch.float32] if kind == "f32" else
                [torch.bfloat16] if kind == "bf16" else
                [torch.float32, torch.bfloat16])
    for q_dtype in q_dtypes:
        q = torch.randn(S, 1, kvh * group, hd, generator=gen).to(
            q_dtype).to(cuda)
        want = pa.paged_decode_attention_plain(q, kv, 1, tab, valid)
        for splits in (1, 2, 3, None):
            got = pa._launch(q, kv, 1, tab, valid, 0, window=False,
                             scale=None, splits=splits)
            torch.cuda.synchronize()
            err, tol = _paged_err(got, want, kind, q_dtype)
            assert err <= tol, (q_dtype, splits, err)
        got = pa.paged_decode_attention(q, kv, 1, tab, valid)
        err, tol = _paged_err(got, want, kind, q_dtype)
        assert err <= tol


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("pos", [0, 31, 500])
@pytest.mark.parametrize("sq", [1, 16, 32])
def test_paged_window_split_and_routes(cuda, kind, hd, group, pos, sq):
    """The window at pos 0, 31, 500 with 1, 16 or 32 queries a row (up to
    128 query vectors a kv head, a whole tensor-core block): bf16 q on
    the tensor cores (planned and forced splits), f32 q on the CUDA
    cores, against the plain version."""
    gen = torch.Generator().manual_seed(40 + hd + group + pos + sq)
    kvh, pg, P = 2, 16, 36                       # a view of 576 columns
    kv = _any_pool(gen, kind, cuda, hd, pg)
    row = torch.randint(1, 48, (P,), generator=gen,
                        dtype=torch.int32).to(cuda)
    for q_dtype in (torch.bfloat16, torch.float32):
        if q_dtype == torch.float32 and hd == 128 and kind == "bf16":
            continue                             # f32 pool: not this test
        kvq = kv if kind == "int8" or q_dtype == torch.bfloat16 else \
            {k: v.float() for k, v in kv.items()}
        q = torch.randn(1, sq, kvh * group, hd, generator=gen).to(
            q_dtype).to(cuda)
        want = pa.paged_window_attention_plain(q, kvq, 0, row, pos)
        for splits in ((1, 2, None) if q_dtype == torch.bfloat16 else
                       (1, None)):
            got = pa._launch(q, kvq, 0, row[None, :], None, pos, window=True,
                             scale=None, splits=splits)
            torch.cuda.synchronize()
            err, tol = _paged_err(got, want, kind, q_dtype)
            assert err <= tol, (q_dtype, splits, err)


def test_paged_split_tickets_reset_back_to_back_and_in_a_graph(cuda):
    """The merge's ticket counters are left at 0 by every launch: two
    calls back to back, then a CUDA graph of one call replayed twice,
    give the plain version's answer each time."""
    gen = torch.Generator().manual_seed(60)
    kv = _int8_pool(gen, cuda, hd=128, NP=48)
    S, P, pg = 4, 32, 16
    q = torch.randn(S, 1, 8, 128, generator=gen).to(torch.bfloat16).to(cuda)
    tab = torch.randint(1, 48, (S, P), generator=gen,
                        dtype=torch.int32).to(cuda)
    valid = (torch.arange(P * pg)[None, :]
             < torch.tensor([[500], [37], [200], [512]])).to(cuda)
    want = pa.paged_decode_attention_plain(q, kv, 0, tab, valid)
    for _ in range(2):
        got = pa._launch(q, kv, 0, tab, valid, 0, window=False, scale=None,
                         splits=4)
        assert _rel_err(got, want) <= 1e-2
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pa._launch(q, kv, 0, tab, valid, 0, window=False, scale=None,
                   splits=4)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = pa._launch(q, kv, 0, tab, valid, 0, window=False, scale=None,
                         splits=4)
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert _rel_err(out, want) <= 1e-2


def test_paged_graph_replays_after_the_workspace_grows(cuda):
    """A CUDA graph captured at a small split count keeps the workspace and
    tickets it was captured with: a later, larger call grows the stream's
    workspace (and one on another stream gets its own), and the graph
    still replays the plain version's answer, as does the larger call."""
    gen = torch.Generator().manual_seed(61)
    kv = _int8_pool(gen, cuda, hd=128, NP=48)
    S, P, pg = 2, 16, 16
    q = torch.randn(S, 1, 8, 128, generator=gen).to(torch.bfloat16).to(cuda)
    tab = torch.randint(1, 48, (S, P), generator=gen,
                        dtype=torch.int32).to(cuda)
    valid = (torch.arange(P * pg)[None, :]
             < torch.tensor([[200], [256]])).to(cuda)
    want = pa.paged_decode_attention_plain(q, kv, 0, tab, valid)
    s = torch.cuda.Stream()
    key = (q.get_device(), s.cuda_stream)
    torch.cuda.synchronize()
    pa._scratch.pop(key, None)      # this stream starts with no workspace
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pa._launch(q, kv, 0, tab, valid, 0, window=False, scale=None,
                   splits=2)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = pa._launch(q, kv, 0, tab, valid, 0, window=False, scale=None,
                         splits=2)
    ws, tickets, _ = pa._scratch[key]
    captured, sizes = ws.data_ptr(), (ws.numel(), tickets.numel())
    del ws, tickets
    big_q = torch.randn(8, 1, 8, 128, generator=gen).to(torch.bfloat16).to(
        cuda)
    big_tab = torch.randint(1, 48, (8, P), generator=gen,
                            dtype=torch.int32).to(cuda)
    big_valid = torch.ones(8, P * pg, dtype=torch.bool, device=cuda)
    big_want = pa.paged_decode_attention_plain(big_q, kv, 1, big_tab,
                                               big_valid)
    with torch.cuda.stream(s):
        big = pa._launch(big_q, kv, 1, big_tab, big_valid, 0, window=False,
                         scale=None, splits=8)
    other = pa._launch(big_q, kv, 1, big_tab, big_valid, 0, window=False,
                       scale=None, splits=8)
    torch.cuda.synchronize()
    assert pa._scratch[key][0].data_ptr() != captured
    assert _rel_err(big, big_want) <= 1e-2
    assert _rel_err(other, big_want) <= 1e-2
    # what the allocator would hand out again, had the old buffers been
    # freed, filled with values that would break the replay's merge
    junk = [torch.full((n,), 7, dtype=dtype, device=cuda)
            for n, dtype in zip(sizes, (torch.float32, torch.int32))
            for _ in range(4)]
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert _rel_err(out, want) <= 1e-2
    del junk


def test_rmsnorm_kernel_same_output_with_and_without_grad(cuda):
    """Under no_grad the wrapper launches directly; with a gradient it goes
    through the autograd Function: the same kernel, the same bits."""
    gen = torch.Generator().manual_seed(15)
    x = torch.randn(33, 4096, generator=gen).to(torch.bfloat16).to(cuda)
    gamma = torch.randn(4096, generator=gen).to(cuda).requires_grad_()
    before = fused.LAUNCHES["rmsnorm"]
    with torch.no_grad():
        plain_call = fused.fused_rmsnorm(x, gamma, 1e-5)
    graph_call = fused.fused_rmsnorm(x, gamma, 1e-5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rmsnorm"] == before + 2
    assert not plain_call.requires_grad and graph_call.requires_grad
    assert torch.equal(plain_call, graph_call.detach())
