"""The rest of GPT training on the card: remat, the chunked loss,
accumulation, loss scaling and a resumed session.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py``.

A 2-layer f32 GPT-2-shaped model (head dim 64, the flash and norm
kernels' shapes):
- remat (all three policies, dropout 0.1) against no remat on the card:
  equal losses and gradients within 1e-6 (the same kernels on the same
  values; the recomputation redraws the forward's masks), with the flash
  forward launched twice a layer and LayerNorm 4 a layer plus one;
- the chunked loss against the unchunked one on the card (1e-5 relative
  on the loss, 2e-5 absolute on the gradients) and against the CPU;
- accumulation over 2 microbatches with a mask on the card against the
  CPU (the card-vs-CPU tolerances of ``chip_smoke.py`` phase 7);
- a session resumed from its checkpoint directory equals an
  uninterrupted one bit for bit (dropout 0.1, loss scaling, EMA);
- ``mixed_float16`` on the card raises ``TypeError`` from the kernel
  wrappers (bf16 and f32 only): nothing falls back.
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, TrainSession, TrainState,
                                              adamw, gpt_tiny,
                                              make_custom_train_step,
                                              with_ema)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.train import precision

pytestmark = pytest.mark.gpu

LOSS_TOL = 1e-4       # card vs CPU, f32 losses: summation order
PARAM_TOL = 1e-3      # card vs CPU, f32 params after Adam steps at 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(device, **kw):
    """gpt_tiny weights made on the CPU (seed 0), placed on ``device``."""
    kw.setdefault("dropout_rate", 0.0)
    cpu = GPT(gpt_tiny(**kw), device="cpu")
    if torch.device(device).type == "cpu":
        return cpu
    model = GPT(gpt_tiny(**kw), device=device)
    model.load_state_dict(cpu.state_dict())
    return model


def _ids(seed, b=4, s=33):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (b, s)))


def _loss_and_grads(model, mask=None, gen_seed=3):
    params = dict(model.named_parameters())
    batch = {"input_ids": _ids(0).to(model.device)}
    if mask is not None:
        batch["loss_mask"] = mask.to(model.device)
    gen = torch.Generator(model.device).manual_seed(gen_seed)
    loss, _ = model.lm_loss_fn()(params, (), batch, gen, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.cpu() for k, g in zip(params, grads)}


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_equals_no_remat_on_the_card(cuda, policy):
    want = _loss_and_grads(_model(cuda, dropout_rate=0.1))
    fa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    got = _loss_and_grads(_model(cuda, dropout_rate=0.1, remat=True,
                                 remat_policy=policy))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_forward"] == 2 * 2
    assert fa.LAUNCHES["flash_backward_dq"] == 2
    assert fused.LAUNCHES["layernorm"] == 4 * 2 + 1
    assert abs(got[0] - want[0]) <= 1e-6
    for k, g in want[1].items():
        torch.testing.assert_close(got[1][k], g, atol=1e-6, rtol=0,
                                   msg=k)


def test_chunked_loss_on_the_card(cuda):
    mask = (torch.from_numpy(np.random.default_rng(1).random((4, 32)))
            < 0.7).float()
    plain = _loss_and_grads(_model(cuda), mask)
    for chunk in (16, 7, 1000):
        got = _loss_and_grads(_model(cuda, loss_seq_chunk=chunk), mask)
        cpu = _loss_and_grads(_model("cpu", loss_seq_chunk=chunk), mask)
        assert abs(got[0] - plain[0]) <= 1e-5 * abs(plain[0])
        assert abs(got[0] - cpu[0]) <= LOSS_TOL
        for k, g in plain[1].items():
            torch.testing.assert_close(got[1][k], g, atol=2e-5, rtol=0,
                                       msg=k)


def _train(device, steps=3, **opts):
    model = _model(device)
    params = dict(model.named_parameters())
    opt = adamw(1e-4)
    step = make_custom_train_step(model.lm_loss_fn(), opt,
                                  grad_clip_norm=1.0, **opts)
    state = TrainState.create(params, opt.init(params))
    mask = (torch.from_numpy(np.random.default_rng(2).random((4, 32)))
            < torch.tensor([[0.2], [0.5], [0.8], [1.0]], dtype=torch.float64)
            ).float()
    losses = []
    for i in range(steps):
        state, m = step(state, {"input_ids": _ids(10 + i).to(device),
                                "loss_mask": mask.to(device)})
        losses.append(m["loss"].item())
    return losses, {k: p.detach().cpu() for k, p in params.items()}


def test_accumulation_on_the_card_matches_the_cpu(cuda):
    (card_l, card_p), (cpu_l, cpu_p) = (_train(d, accum_steps=2)
                                        for d in (cuda, "cpu"))
    assert max(abs(a - b) for a, b in zip(card_l, cpu_l)) <= LOSS_TOL
    assert max((card_p[k] - cpu_p[k]).abs().max().item()
               for k in cpu_p) <= PARAM_TOL


def _session(device, ckpt_dir, last_step):
    model = _model(device, dropout_rate=0.1, remat=True, loss_seq_chunk=16)
    params = dict(model.named_parameters())
    opt = with_ema(adamw(1e-4), decay=0.9)
    state = precision.attach_loss_scale(
        TrainState.create(params, opt.init(params)),
        precision.DynamicLossScale.create(2.0 ** 127, device=device))
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=5,
                                  grad_clip_norm=1.0, accum_steps=2,
                                  policy="float32", loss_scale=True)
    with TrainSession(state, step, checkpoint_dir=ckpt_dir,
                      hooks=[ttrain.StopAtStepHook(last_step=last_step),
                             ttrain.CheckpointHook(every_steps=2,
                                                   every_secs=None)]) as sess:
        while not sess.should_stop():
            sess.run_step({"input_ids": _ids(20 + sess.step).to(device)})
        return sess.state


def test_a_resumed_session_equals_an_uninterrupted_one(cuda, tmp_path):
    whole = _session(cuda, str(tmp_path / "whole"), 6)
    _session(cuda, str(tmp_path / "split"), 4)
    resumed = _session(cuda, str(tmp_path / "split"), 6)
    assert resumed.step == whole.step == 6
    assert resumed.opt_state.count == whole.opt_state.count
    for k, p in whole.params.items():
        assert torch.equal(resumed.params[k], p), k
    for k, s in whole.opt_state.inner["ema"].shadow.items():
        assert torch.equal(resumed.opt_state.inner["ema"].shadow[k], s), k
    assert float(resumed.model_state.loss_scale.value) == \
        float(whole.model_state.loss_scale.value)


def test_float16_raises_from_the_kernel_wrappers(cuda):
    q = torch.zeros(1, 16, 2, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa.flash_attention(q, q, q, causal=True)
    model = _model(cuda, dtype=torch.float16)
    params = dict(model.named_parameters())
    opt = adamw(1e-4)
    step = make_custom_train_step(model.lm_loss_fn(), opt,
                                  policy="mixed_float16")
    with pytest.raises(TypeError, match="bf16 or f32"):
        step(TrainState.create(params, opt.init(params)),
             {"input_ids": _ids(0).to(cuda)})
