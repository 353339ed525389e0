"""Ring-flash attention on the card: ``chip_smoke.py`` phase 25 (a)'s checks
at small sizes, and the models with ``seq_axis`` on a mesh of one.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_ring_gpu.py``.

- A virtual ring of 4 (``chip_smoke.virtual_ring_flash``: ring_flash's
  step functions driven in lockstep for every rank) against the plain
  whole-sequence flash: causal MHA and GQA (head dims 64 and 128) and
  bidirectional with every row's last shard of keys all padding, bf16
  within phase 3's 1e-2 of the output's scale, f32 within 1e-4; exact
  launches by route (a causal ring of 4: 6 full and 4 diag blocks of each
  of forward, dQ and dK/dV; bidirectional 16 full); nothing NaN.
- ``ring_flash_attention`` on CUDA tensors launches the kernels (a ring
  of one: one diag block), and raises for a type the kernels do not take.
- GPT-2 tiny, Llama tiny and BERT tiny with ``seq_axis`` on
  ``make_mesh({"seq": 1})`` on the card: loss and every gradient equal the
  models without it within 1e-4 of each leaf's scale (f32, TF32 off).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from distributed_tensorflow_tpu_torch import GPT, gpt_tiny, llama_tiny
from distributed_tensorflow_tpu_torch import parallel
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.ops.kernels import \
    flash_attention as fa
from distributed_tensorflow_tpu_torch.parallel import ring_flash as rf

pytestmark = pytest.mark.gpu

RING = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(cuda):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("b,s,h,hk,hd,causal,dtype", [
    (2, 512, 4, 4, 64, True, torch.bfloat16),
    (1, 512, 8, 2, 128, True, torch.bfloat16),
    (4, 256, 4, 4, 64, False, torch.bfloat16),
    (2, 256, 4, 2, 64, True, torch.float32),
    (2, 256, 2, 2, 64, False, torch.float32)],
    ids=["causal_mha_bf16", "causal_gqa_hd128_bf16", "padded_shard_bf16",
         "causal_gqa_f32", "padded_shard_f32"])
def test_virtual_ring_equals_the_plain_flash(cuda, b, s, h, hk, hd, causal,
                                             dtype):
    gen = torch.Generator("cuda").manual_seed(0)

    def rnd(heads):
        return torch.randn(b, s, heads, hd, generator=gen,
                           device=cuda).to(dtype)
    q, k, v, do = rnd(h), rnd(hk), rnd(hk), rnd(h)
    valid = None if causal else chip_smoke._sp_valid(torch, b, s, RING,
                                                     cuda, gen)
    if valid is not None:
        assert not valid[:, -s // RING:].any()   # a whole shard of padding
    rf.LAUNCHES.clear()
    fa.LAUNCHES.clear()
    got = chip_smoke.virtual_ring_flash(torch, q, k, v, valid, do, RING,
                                        causal)
    torch.cuda.synchronize()
    n_full = RING * (RING - 1) // 2 if causal else RING * RING
    n_diag = RING if causal else 0
    want_routes = {f"{p}_{r}": n for p in ("forward", "dq", "dkv")
                   for r, n in (("full", n_full), ("diag", n_diag)) if n}
    assert dict(rf.LAUNCHES) == want_routes
    assert {fa.LAUNCHES[n] for n in ("flash_forward", "flash_backward_dq",
                                     "flash_backward_dkv")} == {
        n_full + n_diag}
    out, lse = fa.flash_forward_plain(q, k, v, valid, causal)
    want = (out, lse, *fa.flash_backward_plain(q, k, v, valid, do, out, lse,
                                               causal))
    rel = (chip_smoke.FLASH_BF16_TOL if dtype == torch.bfloat16
           else chip_smoke.FLASH_F32_TOL)
    for part, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert not torch.isnan(g).any(), part
        err, scale = chip_smoke._err_and_scale(torch, g, w)
        assert err <= rel * scale, (part, err, rel * scale)


def test_cuda_tensors_launch_the_kernels_or_raise(cuda):
    q = torch.randn(2, 64, 4, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    fa.LAUNCHES.clear()
    rf.LAUNCHES.clear()
    out = rf.ring_flash_attention(q, q, q, None, causal=True)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert dict(rf.LAUNCHES) == {"forward_diag": 1, "dq_diag": 1,
                                 "dkv_diag": 1}
    assert fa.LAUNCHES["flash_forward"] == 1
    assert fa.LAUNCHES["flash_backward_dq"] == 1
    assert fa.LAUNCHES["flash_backward_dkv"] == 1
    with pytest.raises(TypeError, match="bf16 or f32"):
        rf.ring_flash_attention(q.detach().half(), q.detach().half(),
                                q.detach().half(), None, causal=True)


def _close(got, want, what):
    want = want.detach().float().cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got.detach().float().cpu() - want).abs().max())
    assert err <= 1e-4 * scale, (what, err)


@pytest.mark.parametrize("make", [gpt_tiny, llama_tiny],
                         ids=["gpt2_tiny", "llama_tiny"])
def test_gpt_seq_axis_on_a_mesh_of_one_equals_no_seq_axis(no_tf32, make):
    mesh = parallel.make_mesh({"seq": 1})
    dense = GPT(make(dropout_rate=0.0), device="cuda",
                generator=torch.Generator("cuda").manual_seed(1))
    sp = GPT(make(dropout_rate=0.0, seq_axis="seq"), device="cuda",
             mesh=mesh)
    sp.load_state_dict(dense.state_dict())
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 65))).to(no_tf32)
    runs = []
    for model in (dense, sp):
        params = dict(model.named_parameters())
        loss, _ = model.lm_loss_fn()(params, (), {"input_ids": ids}, None,
                                     True)
        runs.append((loss, torch.autograd.grad(loss,
                                               list(params.values()))))
    _close(runs[1][0], runs[0][0], "loss")
    for name, a, b in zip(dict(dense.named_parameters()), runs[1][1],
                          runs[0][1]):
        _close(a, b, name)


def test_bert_seq_axis_on_a_mesh_of_one_equals_no_seq_axis(no_tf32):
    mesh = parallel.make_mesh({"seq": 1})
    kw = dict(dropout_rate=0.0, hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=256, vocab_size=300, max_position=128)
    dense = tbert.Bert(tbert.BertConfig(**kw))
    sp = tbert.Bert(tbert.BertConfig(seq_axis="seq", **kw), mesh=mesh)
    params = dense.init(torch.Generator("cuda").manual_seed(3))
    rng = np.random.default_rng(4)
    lengths = np.array([64, 40, 17])
    batch = {"input_ids": rng.integers(0, 300, (3, 64)),
             "labels": rng.integers(0, 300, (3, 64)),
             "mlm_mask": (rng.random((3, 64)) < 0.3).astype(np.float32),
             "attention_mask": (np.arange(64)[None]
                                < lengths[:, None]).astype(np.int32)}
    batch = {k: torch.from_numpy(v).to(no_tf32) for k, v in batch.items()}
    runs = []
    for model in (dense, sp):
        # dropout 0 draws nothing; train=True still wants a generator
        loss, _ = model.mlm_loss_fn()(params, (), batch,
                                      torch.Generator("cuda"), True)
        runs.append((loss, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
    _close(runs[1][0], runs[0][0], "loss")
    for name, a, b in zip(params, runs[1][1], runs[0][1]):
        if b is None:
            assert a is None, name
            continue
        _close(a, b, name)
