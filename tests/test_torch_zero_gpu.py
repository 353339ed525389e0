"""ZeRO over ``fsdp`` on the card: the Adam kernel on blocks, the step over
a ZeRO state, and a sharded checkpoint of CUDA tensors.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_zero_gpu.py``.

- The Adam kernel, called as ``adamw`` calls it, on each block of a leaf
  cut over a virtual ``fsdp`` line (along dim 0, dim 1 and the last dim,
  each block made contiguous): deltas and moments joined along the dim
  equal the whole leaf's launch to the bit, one launch a block.
- GPT-2 tiny (f32, TF32 off) placed by ``partition_rules(fsdp=True)`` on a
  mesh of one: two steps of ``with_ema(adamw)`` with clip 1.0 equal the
  plain state's to the bit, with the same launches and no collective.
- A ZeRO state of 2 virtual ranks saved by both as pids 0 and 1 restores
  on the card in place onto 1 rank's layout, to the bit.
"""
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, TrainState, gpt_tiny,
                                              optim, parallel, train)
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.parallel import data_parallel, sharding
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint as sc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _virtual(n, r):
    return parallel.Mesh(n, r, None, axes={"fsdp": n}, lines={})


@pytest.mark.parametrize("shape,spec", [
    ((768, 12, 64), ("fsdp", None, None)),
    ((50257, 768), (None, "fsdp")),
    ((12, 64, 768), (None, None, "fsdp")),
    ((3072, 768), (None, "fsdp")),
])
@pytest.mark.parametrize("n", [2, 4])
def test_adam_on_blocks_equals_the_whole_leaf(cuda, shape, spec, n):
    gen = torch.Generator("cuda").manual_seed(0)
    p, g, m = (torch.randn(shape, generator=gen, device=cuda)
               for _ in range(3))
    v = torch.rand(shape, generator=gen, device=cuda)
    kw = dict(lr=1e-4, weight_decay=0.01, tf14_eps=True, return_delta=True)
    m0, v0 = m.clone(), v.clone()
    want = fused.fused_adam_update(p, g, m0, v0, 3, out=(None, m0, v0), **kw)
    before = fused.LAUNCHES["adam"]
    parts = []
    for r in range(n):
        s = sharding.zero_shard(shape, spec, _virtual(n, r))
        pb, gb, mb, vb = (s.take(t) for t in (p, g, m, v))
        assert pb.is_contiguous() and pb.numel() * n == p.numel()
        parts.append((fused.fused_adam_update(pb, gb, mb, vb, 3,
                                              out=(None, mb, vb), **kw)[0],
                      mb, vb, s.dim))
    torch.cuda.synchronize()
    assert fused.LAUNCHES["adam"] - before == n
    dim = parts[0][3]
    for i, whole in enumerate((want[0], m0, v0)):
        assert torch.equal(torch.cat([x[i] for x in parts], dim), whole)


def _arm(cuda, zero):
    model = GPT(gpt_tiny(dropout_rate=0.0), device=cuda,
                generator=torch.Generator(cuda).manual_seed(0))
    params = dict(model.named_parameters())
    opt = optim.with_ema(optim.adamw(1e-3), 0.99)
    state = TrainState.create(params, opt.init(params))
    mesh = parallel.make_mesh({"data": 1, "fsdp": 1})
    if zero:
        state = train.shard_train_state(state, mesh,
                                        model.partition_rules(fsdp=True))
    step = train.make_custom_train_step(model.lm_loss_fn(), opt, mesh=mesh,
                                        grad_clip_norm=1.0)
    return model, state, step


def test_zero_step_on_a_line_of_one_is_the_plain_step(cuda):
    ids = torch.randint(0, 512, (4, 65), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    runs = []
    for zero in (True, False):
        model, state, step = _arm(cuda, zero)
        fused.LAUNCHES.clear()
        data_parallel.LAUNCHES.clear()
        losses = []
        for _ in range(2):
            state, m = step(state, {"input_ids": ids})
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        assert not data_parallel.LAUNCHES
        runs.append((losses, dict(fused.LAUNCHES),
                     {k: p.detach().clone()
                      for k, p in model.named_parameters()},
                     optim.ema_params(state.opt_state)))
    (l0, c0, p0, e0), (l1, c1, p1, e1) = runs
    assert l0 == l1 and c0 == c1 and c0["adam"] == 2 * len(p0)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(e0[k], e1[k]), k


def test_sharded_checkpoint_of_cuda_blocks(cuda, tmp_path):
    model, state, step = _arm(cuda, False)
    ids = torch.randint(0, 512, (4, 33), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2))
    state, _ = step(state, {"input_ids": ids})
    rules = model.partition_rules(fsdp=True)
    for r in range(2):
        sc.save_sharded(str(tmp_path), state.step, train.shard_train_state(
            state, _virtual(2, r), rules), process_index=r, process_count=2)
    path, = sc.all_sharded_checkpoints(str(tmp_path))
    assert sc.verify_sharded(path) == (True, "")
    target_model, target, _ = _arm(cuda, False)
    restored = sc.restore_sharded(target, path)
    assert restored.step == 1
    for k, p in target_model.named_parameters():
        assert p.is_cuda and torch.equal(p, state.params[k]), k
    got = optim.ema_params(restored.opt_state)
    want = optim.ema_params(state.opt_state)
    for k in want:
        assert torch.equal(got[k], want[k]), k
