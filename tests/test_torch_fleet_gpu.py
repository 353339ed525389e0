"""The serving fleet on the card against the CPU.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_fleet_gpu.py``.

A 2-layer f32 GPT-2-shaped model (head dim 64, the paged and norm
kernels' shapes; weight matrices scaled 5x so that greedy tokens vary)
on the card and the same weights on the CPU:

* a 2-replica ``Router`` places the same requests on the same replicas
  and every request ends with the same tokens and stream on the card as
  on the CPU, with the paged and LayerNorm kernels launched;
* the pump heartbeat, read from a second thread while a card engine's
  tick is held, shows that tick started and not completed;
* a fleet with a ``PageWire`` drains a replica mid-decode: the pages
  land in the survivor's pool bit-equal to the source's, and the request
  ends with the CPU's tokens, its stream exact.
"""
import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import GPT, Engine, fleet, gpt_tiny
from distributed_tensorflow_tpu_torch.obs import Registry
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as pa
from distributed_tensorflow_tpu_torch.resilience import FaultPlan, faults

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(cuda):
    """The same weights on the card and the CPU, made on the CPU."""
    cpu = GPT(gpt_tiny(), device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(5.0)
    gpu = GPT(gpt_tiny(), device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return gpu, cpu


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, n, dtype=np.int32)
            for n in (5, 19, 40, 33, 12, 27)]


def _engine(model, **kw):
    return Engine(model, device=model.device, num_slots=2, max_len=128,
                  prefill_chunk=16, tick_steps=4, registry=Registry(), **kw)


def test_two_replica_fleet_card_equals_cpu(cuda):
    outs = []
    for model in _pair(cuda):
        pa.LAUNCHES.clear()
        fused.LAUNCHES.clear()
        router = fleet.Router([_engine(model) for _ in range(2)],
                              registry=Registry())
        streams = [[] for _ in _prompts()]
        hs = []
        for i, p in enumerate(_prompts()):
            hs.append(router.submit(p, 12, on_token=streams[i].extend))
            if i % 2:
                router.step()
        router.drain()
        assert all(h.status == "ok" for h in hs)
        assert streams == [h.tokens for h in hs]
        outs.append((router.placements, [h.tokens for h in hs]))
        if model.device.type == "cuda":
            assert pa.LAUNCHES["paged_decode"] > 0
            assert pa.LAUNCHES["paged_window"] > 0
            assert fused.LAUNCHES["layernorm"] > 0
    assert outs[0] == outs[1]
    assert {r for _, r in outs[0][0]} == {0, 1}


def test_heartbeat_read_from_another_thread_during_a_tick(cuda):
    gpu, _ = _pair(cuda)
    eng = _engine(gpu)
    eng.generate_batch(_prompts()[:1], 2)          # a first tick off the clock
    plan = FaultPlan([{"kind": "wedge_replica", "at": 0, "seconds": 30.0}],
                     registry=Registry())
    with faults.activated(plan):
        eng.submit(_prompts()[1], 8)
        before = eng.stats()
        pump = threading.Thread(target=eng.step, name="dttpu-test-pump")
        pump.start()
        deadline = time.perf_counter() + 30
        while not plan.log:
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        mid = eng.stats()
        plan.release_wedges()
        pump.join(timeout=30)
    eng.drain()
    after = eng.stats()
    assert mid.ticks_started == before.ticks_started + 1
    assert mid.ticks_completed == before.ticks_completed
    assert mid.last_tick_start_s > before.last_tick_end_s
    assert after.ticks_started == after.ticks_completed
    assert after.last_tick_duration_s > 0


def test_wire_migration_between_card_engines_bit_equal(cuda):
    gpu, cpu = _pair(cuda)
    p = _prompts()[2]
    want = _engine(cpu).generate_batch([p], 16)[0]
    reg = Registry()
    engines = [_engine(gpu) for _ in range(2)]
    shipped = []
    for eng in engines:
        def recording(snap, records, timeout_s=5.0,
                      _eng=eng, _imp=eng.import_wire_pages):
            n = _imp(snap, records, timeout_s=timeout_s)
            shipped.append((_eng, snap, records, n))
            return n
        eng.import_wire_pages = recording
    router = fleet.Router(engines, registry=reg, page_wire=fleet.PageWire(
        chunk_pages=2, registry=reg))
    stream = []
    h = router.submit(p, 16, on_token=stream.extend)
    while len(h.tokens) < 6:
        router.step()
    victim = h.replica_id
    assert router.drain_replica(victim, timeout_s=60) is True
    router.drain()
    assert h.status == "ok" and h.tokens == want and stream == want
    (dst, snap, records, n), = shipped
    assert dst is engines[1 - victim] and n == len(records) >= 2
    kv = dst.scheduler._cache["kv"]
    for (_, page, _), rec in zip(dst.scheduler.pages.chain_pages(
            snap.context), records):
        for name, leaf in rec.payload.items():
            assert torch.equal(kv[name][:, page].cpu(), leaf)
    assert reg.get("dttpu_router_wire_migrations_total").value == 1
    assert dst.stats().prefill_windows_skipped_total >= n
