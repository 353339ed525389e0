"""The GPT family's last configurations on the card: the paged kernel at
head dim 32, a MoE model and a Llama model, card against CPU.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu
tests/test_torch_gpt_family_gpu.py``.  (The paged kernel's head-dim-32
branches at every split count, page size and group are also cases of
``tests/test_torch_kernels_gpu.py``.)

Tolerances: the paged kernel as ``tests/test_torch_kernels_gpu.py``
holds it (a pool in q's type: f32 1e-4, bf16 2e-2 absolute; int8 pools
relative to the output's scale, f32 q 1e-4, bf16 q 1e-2); the models in
f32 with TF32 off, losses and ``moe_aux`` within 1e-4, each gradient
within 1e-4 of its leaf's scale, parameters after 3 ``adamw`` steps
within 1e-3 (an element whose gradient is ~0 may step by up to 2 lr
differently a step), greedy tokens exactly.
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, Engine, TrainState, adamw,
                                              gpt_tiny, llama_tiny,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu


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


def _pool(gen, kind, device, L=2, NP=80, pg=16, kvh=2, hd=32):
    shape = (L, NP, pg, kvh, hd)
    kv = {}
    for name in ("k", "v"):
        if kind == "int8":
            kv[name] = torch.randint(-127, 128, shape, generator=gen,
                                     dtype=torch.int8).to(device)
            kv[name + "_scale"] = (0.01 + 0.02 * torch.rand(
                shape[:-1] + (1,), generator=gen)).to(device)
        else:
            dtype = torch.float32 if kind == "f32" else torch.bfloat16
            kv[name] = torch.randn(shape, generator=gen).to(dtype).to(device)
    return kv


def _err(got, want, kind, q_dtype):
    """(error, tol) of one branch."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if kind == "int8":
        scale = max(1.0, want.abs().max().item())
        return err, (1e-4 if q_dtype == torch.float32 else 1e-2) * scale
    return err, 1e-4 if q_dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_hd32_window_merges_sixteen_splits_of_a_full_block(cuda, kind):
    """The tensor-core window block at its largest: 64 queries x group 2
    = 128 query vectors of a kv head, split 16 ways over a view of 1,280
    columns.  At head dim 32 the merge's scratch (2 floats a query a
    split, 16 KB) is larger than the block's three-stage ring, which the
    kernel's shared memory now covers."""
    gen = torch.Generator().manual_seed(7)
    kv = _pool(gen, kind, cuda)
    row = torch.randint(1, 80, (80,), generator=gen,
                        dtype=torch.int32).to(cuda)
    q = torch.randn(1, 64, 4, 32, generator=gen).to(torch.bfloat16).to(cuda)
    for pos in (0, 600, 1200):
        want = pa.paged_window_attention_plain(q, kv, 1, row, pos)
        for splits in (1, 16, None):
            got = pa._launch(q, kv, 1, row[None, :], None, pos, window=True,
                             scale=None, splits=splits)
            torch.cuda.synchronize()
            err, tol = _err(got, want, kind, q.dtype)
            assert err <= tol, (pos, splits, err)


def test_hd32_decode_counts_launches_as_hd64_does(cuda):
    gen = torch.Generator().manual_seed(8)
    kv = _pool(gen, "f32", cuda)
    tab = torch.randint(1, 80, (3, 5), generator=gen,
                        dtype=torch.int32).to(cuda)
    valid = torch.ones(3, 80, dtype=torch.bool, device=cuda)
    q = torch.randn(3, 1, 4, 32, generator=gen).to(cuda)
    before = dict(pa.LAUNCHES)
    pa.paged_decode_attention(q, kv, 0, tab, valid)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == before.get("paged_decode", 0) + 1
    with pytest.raises(ValueError, match="head_dim 48 unsupported"):
        pa.paged_decode_attention(
            torch.randn(3, 1, 4, 48, generator=gen).to(cuda),
            _pool(gen, "f32", cuda, hd=48), 0, tab, valid)


def _card_and_cpu(config, seed, scale=1.0):
    cpu = GPT(config, device="cpu",
              generator=torch.Generator().manual_seed(seed))
    if scale != 1.0:
        with torch.no_grad():
            for p in cpu.parameters():
                if p.dim() >= 2:
                    p.mul_(scale)
    gpu = GPT(config, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return gpu, cpu


def test_moe_loss_grads_and_engine_on_card_match_cpu(no_tf32):
    gpu, cpu = _card_and_cpu(gpt_tiny(moe_experts=4, dropout_rate=0.0), 5,
                             scale=5.0)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (4, 65)).astype(np.int32))
    runs = []
    for model in (gpu, cpu):
        params = dict(model.named_parameters())
        loss, (m, _) = model.lm_loss_fn()(
            params, None, {"input_ids": ids.to(model.device)}, None, False)
        grads = torch.autograd.grad(loss, list(params.values()))
        runs.append((loss.item(), m["moe_aux"].item(),
                     {k: g.cpu() for k, g in zip(params, grads)}))
    (gl, ga, gg), (cl, ca, cg) = runs
    assert abs(gl - cl) <= 1e-4 and abs(ga - ca) <= 1e-4 and ca > 0
    for k in cg:
        scale = max(1.0, cg[k].abs().max().item())
        assert (gg[k] - cg[k]).abs().max().item() <= 1e-4 * scale, k
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 17, 40)]
    pa.LAUNCHES.clear()
    toks = [Engine(model, device=model.device, num_slots=2, max_len=128,
                   prefill_chunk=16, tick_steps=4).generate_batch(prompts, 12)
            for model in (gpu, cpu)]
    assert toks[0] == toks[1]
    assert pa.LAUNCHES["paged_decode"] > 0 and pa.LAUNCHES["paged_window"] > 0


def test_llama_tiny_steps_on_card_match_cpu(no_tf32):
    """``llama_tiny`` at its own head dim 32: 3 adamw steps (RMSNorm's
    kernel forward, the padded flash kernels) against the CPU's, then
    its paged engine (head dim 32) against the CPU's engine."""
    gpu, cpu = _card_and_cpu(llama_tiny(), 3)
    ids = np.random.default_rng(4).integers(0, 512, (4, 65)).astype(np.int32)
    runs = []
    fused.LAUNCHES.clear()
    for model in (gpu, cpu):
        params = dict(model.named_parameters())
        opt = adamw(1e-4)
        state = TrainState.create(params, opt.init(params))
        step = make_custom_train_step(model.lm_loss_fn(), opt,
                                      grad_clip_norm=1.0)
        batch = {"input_ids": torch.from_numpy(ids).to(model.device)}
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        runs.append((losses, {k: p.detach().cpu()
                              for k, p in state.params.items()}))
    (gl, gp), (cl, cp) = runs
    assert max(abs(a - b) for a, b in zip(gl, cl)) <= 1e-4
    assert max((gp[k] - cp[k]).abs().max().item() for k in cp) <= 1e-3
    assert fused.LAUNCHES["rmsnorm"] == 3 * (2 * 2 + 1)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 30)]
    toks = [Engine(model, device=model.device, num_slots=2, max_len=128,
                   prefill_chunk=16, tick_steps=4).generate_batch(prompts, 8)
            for model in (gpu, cpu)]
    assert toks[0] == toks[1]
