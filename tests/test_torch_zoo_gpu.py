"""The encoder zoo on the card: the flash kernel's new routes, BERT and ViT
card logits against the CPU, and one BERT step's exact launches.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_zoo_gpu.py``.

- Flash attention at head dims 16 and 32 (the wrapper zero-pads to 64),
  bidirectional with key padding including a row with no valid key, bf16
  and f32: the output and dq, dk, dv against the plain version on the
  same inputs (1e-2 of the scale in bf16, 1e-4 in f32: ``chip_smoke.py``'s
  flash tolerances), launching the three kernels once each; head dim 48
  raises.
- ``bert_tiny`` (ragged ``attention_mask``) and ``vit_tiny`` in f32 with
  TF32 off: card logits within 1e-4 of the CPU's (relative to their
  scale: summation order).
- One ``bert_tiny`` MLM step (gathered head, remat "dots"): the flash
  forward twice a layer, dK/dV and dQ once, LayerNorm 2 a layer (4 under
  remat) plus the embeddings' and the head's, Adam once a leaf.
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch.models import bert, vit
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops.kernels import fused

pytestmark = pytest.mark.gpu

TOLS = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LOGIT_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max().item(),
            max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd,s", [(16, 17), (32, 32), (64, 197)])
def test_padded_head_dims_and_empty_rows_match_plain(cuda, hd, s, dtype):
    g = torch.Generator(cuda).manual_seed(hd)
    b, h = 3, 4
    q, k, v, do = (torch.randn(b, s, h, hd, generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    valid = torch.rand(b, s, generator=g, device=cuda) < 0.7
    valid[1] = False                       # a row with no valid key
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.LAUNCHES.clear()
    out = fa.flash_attention(*leaves, kv_valid=valid)
    got = (out, *torch.autograd.grad(out, leaves, do))
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == {"flash_forward": 1,
                                 "flash_backward_dq": 1,
                                 "flash_backward_dkv": 1}
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = fa.flash_attention_plain(*plain, kv_valid=valid)
    want = (want_out, *torch.autograd.grad(want_out, plain, do))
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        err, scale = _err(a, w)
        assert err <= TOLS[dtype] * scale, (name, err)
    assert torch.all(got[0][1] == 0) and torch.all(got[1][1] == 0)


def test_other_head_dims_raise(cuda):
    x = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)


def _bert_pair(device, **kw):
    model = bert.bert_tiny(dropout_rate=0.0, **kw)
    params = model.init(torch.Generator().manual_seed(0))
    if device.type == "cuda":
        params = {k: v.detach().to(device).requires_grad_()
                  for k, v in params.items()}
    return model, params


def _bert_batch(device, b=4, s=40):
    rng = np.random.default_rng(1)
    lengths = np.array([40, 23, 7, 1])
    batch = {"input_ids": rng.integers(0, 1000, (b, s)),
             "labels": rng.integers(0, 1000, (b, s)),
             "mlm_mask": (rng.random((b, s)) < 0.3).astype(np.float32),
             "attention_mask": (np.arange(s)[None] < lengths[:, None])
             .astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def test_bert_tiny_card_logits_match_cpu(cuda):
    outs = []
    for device in (cuda, torch.device("cpu")):
        model, params = _bert_pair(device)
        batch = _bert_batch(device)
        with torch.no_grad():
            seq = model.apply(params, batch["input_ids"],
                              attention_mask=batch["attention_mask"])
            outs.append(model.mlm_logits(params, seq).cpu())
    err, scale = _err(*outs)
    assert err <= LOGIT_TOL * scale, err


def test_vit_tiny_card_logits_match_cpu(cuda):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    model = vit.vit_tiny()
    cpu = model.init(torch.Generator().manual_seed(0))
    cpu["head.kernel"] = torch.randn(cpu["head.kernel"].shape,
                                     generator=torch.Generator()
                                     .manual_seed(3)) * 0.1
    card = {k: v.detach().to(cuda) for k, v in cpu.items()}
    with torch.no_grad():
        want = model.apply(cpu, x, return_features=True)
        got = model.apply(card, x.to(cuda), return_features=True).cpu()
        logits = model.apply(card, x.to(cuda)).cpu()
    err, scale = _err(got, want)
    assert err <= LOGIT_TOL * scale, err
    err, scale = _err(logits, model.apply(cpu, x).detach())
    assert err <= LOGIT_TOL * scale, err


def test_one_bert_step_launches_exactly(cuda):
    model, params = _bert_pair(cuda, mlm_predictions_per_seq=6, remat=True,
                               remat_policy="dots")
    opt = adamw(1e-4, mask=model.decay_mask)
    state = TrainState.create(params, opt.init(params))
    step = make_custom_train_step(model.mlm_loss_fn(), opt,
                                  grad_clip_norm=1.0)
    batch = _bert_batch(cuda)
    fa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    L = model.config.num_layers
    assert dict(fa.LAUNCHES) == {"flash_forward": 2 * L,
                                 "flash_backward_dq": L,
                                 "flash_backward_dkv": L}
    assert fused.LAUNCHES["layernorm"] == 4 * L + 2
    assert fused.LAUNCHES["adam"] == len(params)
    assert np.isfinite(metrics["loss"].item())
