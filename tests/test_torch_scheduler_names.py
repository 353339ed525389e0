"""The scheduler's load readers against the JAX package's.

``SlotScheduler.queued``, ``tenant_inflight(tenant)``,
``tenant_tokens_inflight(tenant)`` and ``EngineStats.free_slots`` read
the same numbers as the JAX scheduler's at every tick of one scenario:
two tenants under a fair-share policy submit six requests to a 2-slot
paged engine of ``gpt_tiny`` (the JAX weights carried across), which is
stepped tick by tick until it drains.  One scenario feeds the four
cases.
"""
import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.fleet import tenancy as jtenancy
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch.fleet import tenancy as ttenancy

torch.set_num_threads(1)


READERS = {
    "queued": lambda eng: eng.scheduler.queued,
    "free_slots": lambda eng: eng.stats().free_slots,
    "tenant_inflight": lambda eng: {
        t: eng.scheduler.tenant_inflight(t)
        for t in ("free", "pro", "absent")},
    "tenant_tokens_inflight": lambda eng: {
        t: eng.scheduler.tenant_tokens_inflight(t)
        for t in ("free", "pro", "absent")},
}


@pytest.fixture(scope="module")
def readings():
    """{reader: [(port, jax) at each tick]} of one scenario."""
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    model = load_jax_params(
        GPT(GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                      num_layers=c.num_layers, num_heads=c.num_heads,
                      intermediate_size=c.intermediate_size,
                      max_position=c.max_position, dropout_rate=0.0),
            device="cpu"),
        jax.tree.map(np.asarray, jparams))
    kw = dict(num_slots=2, max_len=64, prefill_chunk=4, tick_steps=2)
    eng = Engine(model, device="cpu", tenancy=ttenancy.TenantPolicy(
        quantum=8), **kw)
    jeng = jserve.Engine(jmodel, jparams, registry=metrics_lib.Registry(),
                         tenancy=jtenancy.TenantPolicy(quantum=8), **kw)
    rng = np.random.default_rng(0)
    for i in range(6):
        prompt = rng.integers(0, 512, 3 + 2 * i).astype(np.int32)
        tenant = "pro" if i % 3 == 0 else "free"
        eng.submit(prompt, 4 + i, tenant=tenant)
        jeng.submit(prompt, 4 + i, tenant=tenant)
    seen = {name: [] for name in READERS}
    for _ in range(200):
        for name, read in READERS.items():
            seen[name].append((read(eng), read(jeng)))
        more, jmore = eng.scheduler.step(), jeng.scheduler.step()
        assert more == jmore
        if not more:
            break
    assert not eng.scheduler.busy and not jeng.scheduler.busy
    return seen


@pytest.mark.parametrize("name", list(READERS))
def test_load_reader_matches_the_jax_scheduler(readings, name):
    ticks = readings[name]
    for got, want in ticks:
        assert got == want
    first, last = ticks[0][0], ticks[-1][0]
    if name == "queued":
        assert first == 6 and last == 0
    elif name == "free_slots":
        assert first == 2 and last == 2
        assert any(got == 0 for got, _ in ticks)   # both slots taken
    elif name == "tenant_inflight":
        assert first == {"free": 4, "pro": 2, "absent": 0}
        assert last == {"free": 0, "pro": 0, "absent": 0}
    else:
        assert first["pro"] > 0 and last == {"free": 0, "pro": 0,
                                             "absent": 0}
