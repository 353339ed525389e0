"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
Tolerances: f32 1e-4 absolute (summation order); bf16 2e-2 absolute for
attention (the plain version rounds logits and weights to bf16) and
1e-2 for LayerNorm (about one bf16 ulp at unit scale).
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
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
    (torch.bfloat16, 2e-2, 2, 128)])
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
