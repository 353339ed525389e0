"""The port's telemetry and resilience on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_obs_gpu.py``.

- ``obs.live_arrays_bytes`` is the caching allocator's
  ``memory_allocated``: it rises by a new tensor's bytes.
- A ``gpt_tiny`` ``TrainSession`` on the card under ``Telemetry`` with
  ``TraceHook`` and ``MetricsExportHook``: the scraped ``/metrics``
  counts its steps, its live bytes are above 0, its trace holds the
  step, data_load, dispatch and checkpoint spans, and the flash, norm and
  Adam kernels ran.
- A ``fail_decode`` fault fails one request of a card engine; the other
  requests' tokens equal an unfaulted run's, the paged kernels ran, and
  ``dttpu_serve_failed_total`` reads 1.
- A supervised ``gpt_tiny`` session on the card recovers from a failed
  save, a corrupt checkpoint, a NaN streak and a killed prefetch to its
  last step, with three restarts, and ends with the parameters of an
  unfaulted session from the same restored checkpoint, bit for bit.
"""
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, Engine, TrainState,
                                              adamw, gpt_tiny,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch import data as tdata
from distributed_tensorflow_tpu_torch import obs, resilience, train
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.ops.kernels import \
    paged_attention as pa
from distributed_tensorflow_tpu_torch.train import checkpoint as ckpt

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(scale=1.0):
    model = GPT(gpt_tiny(dropout_rate=0.0), device="cuda",
                generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.mul_(scale)
    return model


def _batches(n):
    rng = np.random.default_rng(2)
    return [(rng.integers(0, 512, (4, 33)).astype(np.int32),
             np.ones((4, 32), np.float32)) for _ in range(n)]


def _loop(sess, batches):
    for ids, mask in tdata.prefetch_to_device(iter(batches[sess.step:]),
                                              device="cuda"):
        if sess.should_stop():
            break
        sess.run_step({"input_ids": ids, "loss_mask": mask})
    return sess


def test_live_arrays_bytes_reads_the_allocator(cuda):
    torch.cuda.synchronize()
    before = obs.live_arrays_bytes()
    x = torch.empty(1 << 20, dtype=torch.float32, device=cuda)
    assert obs.live_arrays_bytes() - before >= x.numel() * 4
    assert obs.live_arrays_bytes() == torch.cuda.memory_allocated()


def test_session_telemetry_on_the_card(cuda, tmp_path):
    model = _model()
    params = dict(model.named_parameters())
    opt = adamw(1e-3)
    step = make_custom_train_step(model.lm_loss_fn(), opt,
                                  device_health=True)
    tele = obs.Telemetry(trace_dir=str(tmp_path / "trace"),
                         metrics_port=0, registry=obs.Registry())
    for counter in (fa.LAUNCHES, fused.LAUNCHES):
        counter.clear()
    with train.TrainSession(
            TrainState.create(params, opt.init(params)), step,
            checkpoint_dir=str(tmp_path / "ckpt"), telemetry=tele,
            hooks=[train.StopAtStepHook(last_step=4),
                   train.CheckpointHook(every_steps=2, every_secs=None),
                   train.TraceHook(tele),
                   train.MetricsExportHook(tele, every_steps=2)]) as sess:
        _loop(sess, _batches(4))
        with urllib.request.urlopen(tele.metrics_url(), timeout=30) as r:
            fams = obs.parse_exposition(r.read().decode())
    tele.close()
    assert fams["dttpu_steps_total"]["samples"][
        ("dttpu_steps_total", ())] == 4
    assert fams["dttpu_live_arrays_bytes"]["samples"][
        ("dttpu_live_arrays_bytes", ())] > 0
    with open(tele.trace_path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"step", "data_load", "dispatch", "checkpoint"} <= names
    assert fa.LAUNCHES["flash_forward"] > 0 and fused.LAUNCHES["adam"] > 0
    assert fused.LAUNCHES["layernorm"] > 0


def test_fail_decode_fails_one_request_on_the_card(cuda):
    model = _model(scale=5.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 9, 13)]

    def serve(plan):
        eng = Engine(model, num_slots=2, max_len=64, prefill_chunk=8,
                     tick_steps=4, registry=obs.Registry())
        with resilience.faults.activated(plan):
            hs = [eng.submit(p, 8) for p in prompts]
            eng.drain()
        return eng, hs

    _, clean = serve(resilience.FaultPlan([], registry=obs.Registry()))
    pa.LAUNCHES.clear()
    plan = resilience.FaultPlan([{"kind": "fail_decode", "at": 1}],
                                registry=obs.Registry())
    eng, hs = serve(plan)
    assert [h.status for h in hs] == ["ok", "failed", "ok"]
    assert [hs[i].tokens for i in (0, 2)] == [clean[i].tokens
                                              for i in (0, 2)]
    assert eng.metrics.failed.value == 1
    assert pa.LAUNCHES["paged_decode"] > 0 and pa.LAUNCHES["paged_window"] > 0


def test_supervised_session_recovers_on_the_card(cuda, tmp_path):
    model = _model()
    params = dict(model.named_parameters())
    init = {k: p.detach().clone() for k, p in params.items()}
    opt = adamw(1e-3)
    step = make_custom_train_step(model.lm_loss_fn(), opt,
                                  device_health=True, skip_nonfinite=True)
    batches = _batches(20)
    ckpt_dir = str(tmp_path / "ckpt")

    def fresh():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(init[k])
        return TrainState.create(params, opt.init(params))

    def build():
        return train.TrainSession(
            fresh(), step, checkpoint_dir=ckpt_dir,
            hooks=[train.StopAtStepHook(last_step=20),
                   train.CheckpointHook(every_steps=5, every_secs=None),
                   resilience.NonfiniteGuardHook(3)])

    plan = resilience.FaultPlan(
        [{"kind": "save_oserror", "at": 0},
         {"kind": "corrupt_checkpoint", "at": 2},
         *({"kind": "nan_grads", "at": 10 + i} for i in range(3)),
         {"kind": "kill_prefetch", "at": 25}], registry=obs.Registry())
    sup = resilience.Supervisor(max_restarts=5, sleep=lambda s: None,
                                registry=obs.Registry())
    with resilience.faults.activated(plan):
        sess = sup.run(build, lambda s: _loop(s, batches))
    assert sess.step == 20 and len(sup.restart_log) == 3
    assert "corrupt-ckpt-0000000010" in os.listdir(ckpt_dir)
    final = {k: p.detach().clone() for k, p in params.items()}
    st = ckpt.restore(fresh(), ckpt.ckpt_path(ckpt_dir, 5))
    with train.TrainSession(st, step, hooks=[
            train.StopAtStepHook(last_step=20)]) as ref:
        _loop(ref, batches)
    for k, p in params.items():
        assert torch.equal(final[k], p), k
