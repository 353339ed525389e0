"""Pipeline parallelism on the card: the checks of ``chip_smoke.py`` phase
28 at small width.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_pipeline_gpu.py``.

Two ranks share the card over gloo with CUDA tensors, ``{"pipe": 2}``
(worker ``tests/torch_pp_worker.py run_card_rank``): GPT tiny at 4 layers
(2 a stage), 4 microbatches, f32 with TF32 off, dropout 0, a ragged
``loss_mask``.

- 1F1B (``lm_1f1b_value_and_grad``) equals GPipe (autograd through
  ``lm_loss_fn``) on each rank, and both equal the plain model on the
  card: losses rtol 1e-5, every gradient a rank holds atol 1e-5.
- The exchanges a pass are exact (GPipe 2M ``batch_isend_irecv`` a rank,
  1F1B M + 1, three broadcasts each), every P2P tensor is staged through
  a pinned host buffer and counted (2M a rank: gloo's send and recv take
  CPU tensors), and the kernels launched on the card as the schedules
  say (a stage's flash forward once a microbatch, twice on 1F1B's first
  stage, which recomputes).
"""
import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import GPT, gpt_tiny

import torch_pp_worker
import torch_sp_worker

pytestmark = pytest.mark.gpu

LOSS_RTOL, ATOL = 1e-5, 1e-5
LAYERS, STAGES, MICRO = 4, 2, 4


def _spec():
    config = gpt_tiny(num_layers=LAYERS, dropout_rate=0.0,
                      pipeline_stages=STAGES, pipeline_microbatches=MICRO)
    plain = dataclasses.replace(config, pipeline_stages=0,
                                pipeline_microbatches=0)
    model = GPT(plain, device="cpu", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    mask = (rng.random((8, 16)) < 0.6).astype(np.float32)
    mask[:2] = 1.0
    return {"config": dataclasses.asdict(config),
            "plain": dataclasses.asdict(plain),
            "state": {k: v.detach().numpy() for k, v in
                      model.state_dict().items()},
            "batch": {"input_ids": rng.integers(
                0, config.vocab_size, (8, 17)).astype(np.int32),
                "loss_mask": mask}}


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = _spec()
    return spec, torch_sp_worker.spawn_ranks(
        tmp_path_factory.mktemp("pp_card"), torch_pp_worker.run_card_rank,
        (spec,), world=2)


def _plain(spec):
    """(loss, {name: gradient}) of the plain model on the card."""
    from distributed_tensorflow_tpu_torch import GPTConfig
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = GPT(GPTConfig(**spec["plain"]), device="cuda")
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(torch.from_numpy(spec["state"][k]))
        params = dict(model.named_parameters())
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in spec["batch"].items()}
        loss, _ = model.lm_loss_fn()(params, (), batch, None, True)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return float(loss), {k: g.cpu().numpy() for k, g in zip(params, grads)}


def test_1f1b_equals_gpipe_and_the_plain_model(card_ranks):
    spec, outs = card_ranks
    loss, grads = _plain(spec)
    for res in outs:
        for schedule in ("gpipe", "1f1b"):
            np.testing.assert_allclose(float(res[f"{schedule}/loss"]), loss,
                                       rtol=LOSS_RTOL)
            held = {k[len(schedule) + 3:]: v for k, v in res.items()
                    if k.startswith(f"{schedule}/g/")}
            assert held
            for k, g in held.items():
                np.testing.assert_allclose(g, grads[k], atol=ATOL, rtol=0,
                                           err_msg=f"{schedule} {k}")
                np.testing.assert_allclose(g, res[f"gpipe/g/{k}"],
                                           atol=ATOL, rtol=0)


def test_exchanges_and_staged_copies_are_counted(card_ranks):
    _, outs = card_ranks
    M = MICRO
    for res in outs:
        for schedule, p2p in (("gpipe", 2 * M), ("1f1b", M + 1)):
            counts = {k.split("/")[-1]: int(v) for k, v in res.items()
                      if k.startswith(f"{schedule}/counts/")}
            assert counts["p2p"] == p2p
            assert counts["p2p_host"] == 2 * M
            assert counts["broadcast"] == 3


def test_kernels_launch_as_the_schedules_say(card_ranks):
    _, outs = card_ranks
    per = LAYERS // STAGES
    for res in outs:
        last = int(res["pipe_index"]) == STAGES - 1
        for schedule in ("gpipe", "1f1b"):
            forwards = (MICRO if schedule == "gpipe" or last
                        else 2 * MICRO)
            counts = {k.split("/")[-1]: int(v) for k, v in res.items()
                      if k.startswith(f"{schedule}/counts/")}
            assert counts["flash_forward"] == per * forwards
            assert counts["flash_backward_dq"] == per * MICRO
            assert counts["flash_backward_dkv"] == per * MICRO
            ln_f = 1 if schedule == "gpipe" else (MICRO if last else 0)
            assert counts["layernorm"] == 2 * per * forwards + ln_f
