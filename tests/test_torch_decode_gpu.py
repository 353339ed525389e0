"""The port's contiguous-cache decoding on the card against the CPU.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_decode_gpu.py``.

A 2-layer f32 GPT-2-shaped model (head dim 64, the flash and norm
kernels' shapes) on the card and the same weights on the CPU (plain
versions) emit EQUAL greedy tokens through ``generate`` (plain, ragged,
chunked, EOS), ``beam_search``, ``generate_speculative`` (with the
model's first layer as the draft, so that rounds accept part of the
drafts and roll back) and ``Engine(paged=False)``.  The flash forward
launches once a layer for every one-block prefill and never on the
chunked or ragged routes, and no paged kernel launches on the
contiguous paths.
"""
import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, Engine,
                                              generate_speculative, gpt_tiny)
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(cuda, **kw):
    """The same weights on the card and the CPU, made on the CPU (from its
    seed-0 generator, so that they do not depend on the card's)."""
    cpu = GPT(gpt_tiny(**kw), device="cpu")
    gpu = GPT(gpt_tiny(**kw), device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return gpu, cpu


def _first_layer(model):
    """The model's first layer under its embeddings, final norm and head,
    as a 1-layer draft."""
    draft = GPT(dataclasses.replace(model.config, num_layers=1),
                device=model.device)
    draft.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("blocks.")
                           or k.startswith("blocks.0.")})
    return draft


def _ids(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, shape, dtype=np.int32))


def test_card_tokens_equal_cpu_on_every_entry_point(cuda):
    gpu, cpu = _pair(cuda)
    ids = _ids((3, 20), 0)
    valid = torch.ones((3, 20), dtype=torch.bool)
    valid[0, :7] = False
    eos = int(cpu.generate(ids, 12)[1, 26])

    def spec(m):
        return generate_speculative(m, _first_layer(m), ids[:1], 12, gamma=3)
    runs = {
        "plain": lambda m: m.generate(ids, 12),
        "ragged": lambda m: m.generate(ids, 12, prompt_valid=valid),
        "chunked": lambda m: m.generate(ids, 12, prefill_chunk=8),
        "eos": lambda m: m.generate(ids, 12, eos_id=eos),
        "beam": lambda m: m.beam_search(ids[:2], 8, beam_size=4, eos_id=eos),
        "speculative": lambda m: spec(m)[0],
    }
    for name, run in runs.items():
        got, want = run(gpu).cpu(), run(cpu)
        assert torch.equal(got, want), name
    # the first-layer draft accepts part of the drafts: rounds roll back
    assert 0.0 < spec(gpu)[1] < 1.0
    prompts = [ids[r, :n].numpy() for r, n in ((0, 9), (1, 20), (2, 4))]
    outs = [Engine(m, device=m.device, num_slots=2, max_len=64,
                   prefill_chunk=8, tick_steps=3,
                   paged=False).generate_batch(prompts, 10)
            for m in (gpu, cpu)]
    assert outs[0] == outs[1]


def test_flash_launches_once_a_layer_per_one_block_prefill(cuda):
    gpu, _ = _pair(cuda)
    L = gpu.config.num_layers
    ids = _ids((2, 33), 1).to(cuda)
    valid = torch.ones((2, 33), dtype=torch.bool, device=cuda)
    valid[1, :5] = False
    counts = {}
    for name, run in (
            ("block", lambda: gpu.generate(ids, 4)),
            ("beam", lambda: gpu.beam_search(ids, 4, beam_size=2)),
            ("chunked", lambda: gpu.generate(ids, 4, prefill_chunk=16)),
            ("ragged", lambda: gpu.generate(ids, 4, prompt_valid=valid)),
            ("speculative", lambda: generate_speculative(
                gpu, gpu, ids[:1], 4, gamma=2))):
        fa.LAUNCHES.clear()
        pa.LAUNCHES.clear()
        fused.LAUNCHES.clear()
        run()
        torch.cuda.synchronize()
        counts[name] = fa.LAUNCHES["flash_forward"]
        assert not any(pa.LAUNCHES.values()), name
        assert fused.LAUNCHES["layernorm"] > 0, name
    assert counts == {"block": L, "beam": L, "chunked": 0, "ragged": 0,
                      "speculative": 2 * L}


def test_contiguous_engine_drains_with_no_paged_launch(cuda):
    gpu, _ = _pair(cuda)
    pa.LAUNCHES.clear()
    fa.LAUNCHES.clear()
    eng = Engine(gpu, device=cuda, num_slots=3, max_len=64, prefill_chunk=8,
                 tick_steps=4, paged=False)
    hs = [eng.submit(_ids((n,), n).numpy(), 6) for n in (5, 17, 30, 9)]
    eng.drain()
    assert all(h.status == "ok" and len(h.tokens) == 6 for h in hs)
    assert not any(pa.LAUNCHES.values())
    assert fa.LAUNCHES["flash_forward"] == 0      # windows read the cache
    assert eng.stats().pages_total == 0
