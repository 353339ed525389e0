"""The port's tenancy (``fleet/tenancy.py``) and engine admission held
against the JAX package.

* ``DeficitFairQueue``: the same random sequences of appends, pops,
  requeues and removes give the reference's pop order exactly.
* ``TenantPolicy.check_admission``: the same rejections at every quota
  boundary.
* The engine: ``max_inflight`` and ``max_tokens_inflight`` reject
  exactly the overflow and recover; ``max_queue_depth`` raises
  ``QueueFullError``; ``stats()`` counts each tenant's requests and
  tokens; a per-tenant block burst is admitted in the reference engine's
  fair order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import fleet as jfleet
from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              QueueFullError,
                                              QuotaExceededError,
                                              TenantPolicy, TenantQuota,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch.fleet import tenancy as ttenancy

torch.set_num_threads(1)


@dataclasses.dataclass(eq=False)
class _Req:
    tenant: str
    max_new_tokens: int
    n: int


def _policies(quotas, quantum):
    """The same policy in both packages."""
    return (TenantPolicy({t: TenantQuota(**q) for t, q in quotas.items()},
                         quantum=quantum),
            jfleet.TenantPolicy({t: jfleet.TenantQuota(**q)
                                 for t, q in quotas.items()},
                                quantum=quantum))


@pytest.mark.parametrize("seed", range(4))
def test_fair_queue_pop_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    quotas = {"a": {"weight": 2.0}, "b": {}, "c": {"weight": 0.5}}
    queues = [p.make_queue() for p in _policies(quotas, int(rng.integers(
        1, 9)))]
    assert isinstance(queues[0], ttenancy.DeficitFairQueue)
    pending = [[], []]
    order = [[], []]
    for n in range(300):
        op = rng.random()
        tenant = str(rng.choice(list("abcd")))
        cost = int(rng.integers(1, 12))
        for q, pend, out in zip(queues, pending, order):
            if op < 0.5 or not len(q):
                r = _Req(tenant, cost, n)
                q.append(r)
                pend.append(r)
            elif op < 0.8:
                r = q.popleft()
                out.append(r.n)
                if cost % 3 == 0:            # bounced: back to the front
                    q.requeue(r)
            else:
                r = pend[int(cost) % len(pend)]
                if r in q:
                    q.remove(r)
                    out.append(-r.n)
            assert len(q) == len(queues[0])
    for q, out in zip(queues, order):
        while len(q):
            out.append(q.popleft().n)
    assert order[0] == order[1]
    assert [r.n for r in queues[0]] == [r.n for r in queues[1]] == []


def test_quota_boundaries_match_jax():
    quotas = {"a": {"max_inflight": 3}, "b": {"max_tokens_inflight": 20},
              "c": {"max_inflight": 2, "max_tokens_inflight": 9}}
    ours, theirs = _policies(quotas, 4)
    for tenant in "abcd":
        for inflight in range(5):
            for tokens in range(0, 25, 3):
                for new in (1, 5, 9):
                    got = want = None
                    try:
                        ours.check_admission(tenant, new, inflight=inflight,
                                             tokens_inflight=tokens)
                    except QuotaExceededError as e:
                        got = str(e)
                    try:
                        theirs.check_admission(tenant, new,
                                               inflight=inflight,
                                               tokens_inflight=tokens)
                    except jfleet.QuotaExceededError as e:
                        want = str(e)
                    assert got == want
    with pytest.raises(ValueError):
        TenantQuota(max_inflight=0)
    with pytest.raises(ValueError):
        TenantPolicy(quantum=0)


def _model():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position, dropout_rate=0.0)
    return jmodel, jparams, load_jax_params(GPT(config, device="cpu"),
                                            jax.tree.map(np.asarray, jparams))


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen, dtype=np.int32)


def _engine(model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("tick_steps", 2)
    return Engine(model, device="cpu", **kw)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_quota_rejects_exactly_and_recovers(paged):
    _, _, model = _model()
    policy = TenantPolicy({"a": TenantQuota(max_inflight=2),
                           "t": TenantQuota(max_tokens_inflight=10)})
    eng = _engine(model, tenancy=policy, paged=paged)
    ok, rejected = [], 0
    for i in range(5):
        try:
            ok.append(eng.submit(_prompt(4, i), 4, tenant="a"))
        except QuotaExceededError:
            rejected += 1
    assert len(ok) == 2 and rejected == 3
    other = eng.submit(_prompt(4, 9), 4, tenant="b")
    eng.submit(_prompt(4, 1), 6, tenant="t")             # 6 in flight
    with pytest.raises(QuotaExceededError):
        eng.submit(_prompt(4, 2), 5, tenant="t")         # 11 > 10
    last = eng.submit(_prompt(4, 3), 4, tenant="t")      # exactly 10
    st = eng.stats()
    assert st.inflight_per_tenant == {"a": 2, "b": 1, "t": 2}
    assert st.tokens_inflight_per_tenant == {"a": 8, "b": 4, "t": 10}
    assert st.inflight == 5 and last.tenant == "t"
    eng.drain()
    assert all(h.status == "ok" for h in ok) and other.status == "ok"
    st = eng.stats()
    assert st.inflight_per_tenant == {} == st.tokens_inflight_per_tenant
    h = eng.submit(_prompt(4, 7), 4, tenant="a")          # recovered
    eng.drain()
    assert h.status == "ok"


def test_queue_depth_rejects_at_the_door():
    _, _, model = _model()
    eng = _engine(model, max_queue_depth=2)
    hs = [eng.submit(_prompt(4, i), 3) for i in range(2)]
    with pytest.raises(QueueFullError):
        eng.submit(_prompt(4, 5), 3)
    assert eng.stats().queued == 2
    eng.step()                            # both start prefilling
    hs.append(eng.submit(_prompt(4, 5), 3))
    eng.drain()
    assert all(h.status == "ok" and len(h.tokens) == 3 for h in hs)
    with pytest.raises(ValueError, match="max_queue_depth"):
        _engine(model, max_queue_depth=0)


def test_fair_share_admission_order_matches_jax():
    """A per-tenant block burst (all of A, then all of B) through one
    engine: the port admits in the reference engine's order, and B is
    not starved behind A's block."""
    jmodel, jparams, model = _model()
    ours, theirs = _policies({}, 4)
    orders = []
    for eng in (_engine(model, tenancy=ours),
                jserve.Engine(jmodel, jparams, num_slots=2, max_len=64,
                              prefill_chunk=4, tick_steps=2,
                              registry=metrics_lib.Registry(),
                              tenancy=theirs)):
        first = []

        def cb(i):
            return lambda toks: first.append(i) if i not in first else None
        for i in range(10):
            eng.submit(_prompt(3, i), 2, tenant="a", on_token=cb(i))
        for i in range(5):
            eng.submit(_prompt(3, 20 + i), 4, tenant="b",
                       on_token=cb(10 + i))
        eng.drain()
        orders.append(first)
    assert orders[0] == orders[1]
    assert any(i >= 10 for i in orders[0][:3])
