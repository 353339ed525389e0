"""The engine's request surface on the card against the CPU.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py``.

A 2-layer f32 GPT-2-shaped model (head dim 64, the paged and norm
kernels' shapes; weight matrices scaled 5x so that greedy tokens vary)
on the card and the same weights on the CPU:

* a mixed batch of adapter and ``adapter_id=None`` requests gives equal
  tokens on both layouts;
* pages shipped through the wire (export -> frames -> import) land
  bit-equal in another card engine, which resumes to the CPU's tokens;
* a hot update of a resident adapter racing a pumping thread never
  changes the table a tick reads while the tick runs: every tick sees
  one whole version of the adapter.
"""
import threading

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
from distributed_tensorflow_tpu_torch.fleet import pagewire as wire
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu

RANK = 4


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


def _adapter(model, seed, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    L = model.config.num_layers
    return {name: {"a": scale * torch.randn((L,) + a, generator=g),
                   "b": scale * torch.randn((L,) + b, generator=g)}
            for name, (a, b) in model.lora_shapes(RANK).items()}


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 19, 40, 33)]


def _engine(model, **kw):
    return Engine(model, device=model.device, num_slots=2, max_len=128,
                  prefill_chunk=16, tick_steps=4, **kw)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_adapter_and_none_tokens_card_equal_cpu(cuda, paged):
    outs = []
    for model in _pair(cuda):
        eng = _engine(model, paged=paged, adapter_capacity=2,
                      adapter_rank=RANK)
        eng.load_adapter("x", _adapter(model, 1))
        eng.load_adapter("y", _adapter(model, 2))
        hs = [eng.submit(p, 12, adapter_id=a)
              for p, a in zip(_prompts(), ["x", None, "y", None])]
        eng.drain()
        assert all(h.status == "ok" for h in hs)
        outs.append([h.tokens for h in hs])
        base = _engine(model, paged=paged).generate_batch(_prompts(), 12)
        assert outs[-1][1] == base[1] and outs[-1][3] == base[3]
        assert outs[-1][0] != base[0] and outs[-1][2] != base[2]
    assert outs[0] == outs[1]


def test_wire_splice_bit_equal_and_resumes(cuda):
    gpu, cpu = _pair(cuda)
    p = _prompts()[2]
    want = _engine(cpu).generate_batch([p], 16)[0]
    src, dst = _engine(gpu), _engine(gpu)
    h = src.submit(p, 16)
    while len(h.tokens) < 6:
        src.step()
    snap = src.export_request(h)
    records = src.export_wire_pages(snap)
    assert len(records) == len(snap.shipped_pages) >= 2
    got = []
    for i, chain, payload in records:
        frame = wire.frame_chunk(i, [wire.PageRecord(i, chain, 0, payload)])
        got += wire.parse_frame(frame)[1]
    pa.LAUNCHES.clear()
    assert dst.import_wire_pages(snap, got) == len(records)
    kv = dst.scheduler._cache["kv"]
    for (_, page, _), rec in zip(dst.scheduler.pages.chain_pages(
            snap.context), got):
        for name, leaf in rec.payload.items():
            assert torch.equal(kv[name][:, page].cpu(), leaf)
    h2 = dst.import_request(snap)
    dst.drain()
    assert h2.tokens == want
    assert dst.stats().prefill_windows_skipped_total >= len(records)
    assert pa.LAUNCHES["paged_decode"] > 0 and pa.LAUNCHES["paged_window"] > 0


def test_hot_update_racing_the_pump_never_mixes_versions(cuda):
    gpu, _ = _pair(cuda)
    versions = [_adapter(gpu, 5), _adapter(gpu, 6)]
    eng = Engine(gpu, device=cuda, num_slots=2, max_len=128,
                 prefill_chunk=16, tick_steps=8, adapter_capacity=2,
                 adapter_rank=RANK)
    eng.load_adapter("x", versions[0])
    sched = eng.scheduler
    tick = sched._tick
    seen, bad = [], []

    def watched(tab, ad):
        """Snapshot the adapter's row before the tick, check it after."""
        row = int(sched._adapter_rows.max())
        before = {(n, ab): t[row].clone() for n, leaves
                  in ad["adapters"].items() for ab, t in leaves.items()}
        out = tick(tab, ad)
        torch.cuda.synchronize()
        host = {k: v.cpu() for k, v in before.items()}
        which = [all(torch.equal(host[(n, ab)], v[n][ab])
                     for n in v for ab in ("a", "b")) for v in versions]
        if row and not any(which):
            bad.append("a mix of both versions")
        for (n, ab), t in before.items():
            if not torch.equal(ad["adapters"][n][ab][row], t):
                bad.append("the table changed during the tick")
        seen.append(which.index(True) if any(which) else -1)
        return out

    sched._tick = watched
    stop = threading.Event()

    def updater():
        i = 0
        while not stop.is_set():
            i += 1
            eng.load_adapter("x", versions[i % 2])

    t = threading.Thread(target=updater, daemon=True)
    t.start()
    try:
        hs = [eng.submit(p, 48, adapter_id="x") for p in _prompts()]
        eng.drain()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert all(h.status == "ok" and len(h.tokens) == 48 for h in hs)
    assert not bad, bad[:3]
    assert len(seen) >= 10 and {0, 1} <= set(seen)   # the race happened
