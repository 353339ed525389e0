"""The port's fleet router (``fleet/router.py``) held against the JAX
package's on the same prompts and fault plans.

Each scenario runs once against the reference's ``Router`` over its
engines and once against the port's over the port's (``gpt_tiny``, the
same weights carried across by ``load_jax_params``, weight matrices
scaled 5x so that greedy tokens vary), and the two must agree on:
``router.placements``, every request's status, tokens and ``on_token``
stream, the fault plan's audit trail, and the values of the
``dttpu_router_*`` and ``dttpu_migrations_total`` series.

* placement: least-loaded, prefix-affine and blind (``affinity_weight=0``);
* retry of a submit rejected by a full queue, and of a failed handle;
* drain, remove, resume and add;
* ``kill_replica``, ``correlated_kill``, and the last replica killed;
* an adapter broadcast by ``Router.load_adapter``;
* the one deliberate difference: an adapter request is scored under its
  adapter's radix namespace, so it is never credited with pages cached
  for no adapter (the reference credits them).
"""
import types

import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import fleet as jfleet
from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as jmetrics
from distributed_tensorflow_tpu.resilience import faults as jfaults
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              load_jax_params, lora_from_jax)
from distributed_tensorflow_tpu_torch import fleet as tfleet
from distributed_tensorflow_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_tpu_torch.resilience import faults as tfaults

torch.set_num_threads(1)

_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "kv_cache_dtype")
RANK = 4


def _models():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jax.tree.map(lambda x: x * 5.0 if x.ndim >= 2 else x,
                           jmodel.init(jax.random.PRNGKey(0)))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    return jmodel, jparams, load_jax_params(GPT(config, device="cpu"),
                                            jax.tree.map(np.asarray, jparams))


JMODEL, JPARAMS, TMODEL = _models()


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen, dtype=np.int32)


def _adapter(seed, scale=0.5):
    """A JAX-layout adapter (numpy leaves) strong enough to move tokens."""
    rng = np.random.default_rng(seed)
    L = TMODEL.config.num_layers
    return {name: {"a": (scale * rng.standard_normal((L,) + a)).astype(
                       np.float32),
                   "b": (scale * rng.standard_normal((L,) + b)).astype(
                       np.float32)}
            for name, (a, b) in TMODEL.lora_shapes(RANK).items()}


class Side:
    """One package's fleet: its router, fault plans, registry and
    engines over the shared weights."""

    def __init__(self, name):
        self.name = name
        self.fleet = jfleet if name == "jax" else tfleet
        self.faults = jfaults if name == "jax" else tfaults
        self.metrics = jmetrics if name == "jax" else tmetrics

    def engine(self, reg, **kw):
        for k, v in dict(num_slots=2, max_len=32, prefill_chunk=4,
                         tick_steps=2).items():
            kw.setdefault(k, v)
        if self.name == "jax":
            return jserve.Engine(JMODEL, JPARAMS, registry=reg, **kw)
        return Engine(TMODEL, device="cpu", registry=reg, **kw)

    def router(self, n, reg=None, engine_kw=None, **kw):
        reg = reg if reg is not None else self.metrics.Registry()
        engines = [self.engine(reg, **(engine_kw or {})) for _ in range(n)]
        return self.fleet.Router(engines, registry=reg, **kw), reg

    def adapter(self, ad):
        return ad if self.name == "jax" else lora_from_jax(ad)

    def plan(self, *faults):
        return self.faults.FaultPlan(list(faults),
                                     registry=self.metrics.Registry())


SIDES = (Side("jax"), Side("torch"))


def series(side, reg):
    """The fleet tier's counter and gauge values (timings excluded)."""
    fams = side.metrics.parse_exposition(reg.expose())
    return {(s, lbls): v for name, fam in fams.items()
            if name.startswith(("dttpu_router_", "dttpu_migrations",
                                "dttpu_wire_", "dttpu_watchdog",
                                "dttpu_autoscaler_"))
            and "seconds" not in name
            for (s, lbls), v in fam["samples"].items()}


def outcome(side, router, reg, hs, streams, **extra):
    return dict(placements=list(router.placements),
                status=[h.status for h in hs],
                tokens=[list(h.tokens) for h in hs],
                streams=streams, series=series(side, reg), **extra)


def both(scenario):
    """The scenario's outcome in each package; they must be equal."""
    got = [scenario(side) for side in SIDES]
    assert got[1] == got[0]
    return got[1]


def _fleet_trace(side, weight):
    """The affinity trace: junk parks replica 0, a system prompt seeds
    replica 1, then four followers share the system prompt."""
    router, reg = side.router(2, engine_kw=dict(page_size=8),
                              affinity_weight=weight)
    sys_prompt = _prompt(16, 3)
    hs, streams = [], []
    for p in ([_prompt(8, 99), sys_prompt]
              + [np.concatenate([sys_prompt, _prompt(3, 10 + i)])
                 for i in range(4)]):
        streams.append([])
        hs.append(router.submit(p, 4, on_token=streams[-1].extend))
        if len(hs) >= 2:
            router.drain()
    return outcome(side, router, reg, hs, streams)


def _least_loaded(side):
    router, reg = side.router(2)
    hs, streams = [], []
    for i in range(6):
        streams.append([])
        hs.append(router.submit(_prompt(4 + i % 3, i), 5,
                                on_token=streams[-1].extend))
        if i % 2:
            router.step()
    router.drain()
    return outcome(side, router, reg, hs, streams)


@pytest.mark.parametrize("mode", ["least_loaded", "affinity", "blind"])
def test_placement_streams_and_series_equal_the_reference(mode):
    if mode == "least_loaded":
        out = both(_least_loaded)
        assert out["placements"][:2] == [(0, 0), (1, 1)]
    else:
        weight = 1.0 if mode == "affinity" else 0.0
        out = both(lambda side: _fleet_trace(side, weight))
        # idle at each follower's submit: the holder (replica 1) wins
        # only through affinity; blind, the id tie picks replica 0
        want = 1 if mode == "affinity" else 0
        assert [r for _, r in out["placements"][2:]] == [want] * 4
        hits = out["series"][("dttpu_router_affinity_hits_total", ())]
        assert hits == (4 if mode == "affinity" else 0)
    assert all(s == "ok" for s in out["status"])
    assert out["streams"] == out["tokens"]
    assert len({tuple(t) for t in out["tokens"]}) > 1


def test_rejected_submit_retries_on_another_replica():
    def run(side):
        router, reg = side.router(
            2, engine_kw=dict(num_slots=1, max_queue_depth=1))
        hs = [router.submit(_prompt(4, i), 4) for i in range(2)]
        router.replica(1).step()      # r0 queue full, r1 active: a tie
        hs.append(router.submit(_prompt(4, 2), 4))
        try:
            router.submit(_prompt(4, 9), 4)
            raised = None
        except Exception as e:        # every queue full
            raised = type(e).__name__
        router.drain()
        return outcome(side, router, reg, hs, [], raised=raised,
                       third=hs[-1].replica_id)

    out = both(run)
    assert out["third"] == 1 and out["raised"] == "QueueFullError"
    assert out["series"][("dttpu_router_rejected_total", ())] == 1


def test_failed_handle_retries_and_completes():
    def run(side):
        router, reg = side.router(2)
        fails = [1]

        def flaky(toks):
            if fails[0]:
                fails[0] -= 1
                raise RuntimeError("transient consumer failure")

        h = router.submit(_prompt(5, 3), 6, on_token=flaky)
        router.drain()
        return outcome(side, router, reg, [h], [], attempts=h.attempts)

    out = both(run)
    assert out["attempts"] == 2 and out["status"] == ["ok"]
    assert out["series"][("dttpu_router_retries_total", ())] == 1


def test_drain_remove_resume_and_add():
    def run(side):
        router, reg = side.router(2)
        streams = [[] for _ in range(4)]
        hs = [router.submit(_prompt(4 + i, i), 10, on_token=streams[i].extend)
              for i in range(4)]
        router.step()
        drained = router.drain_replica(0, timeout_s=60)
        streams.append([])
        hs.append(router.submit(_prompt(4, 9), 4,
                                on_token=streams[-1].extend))
        landed = hs[-1].replica_id
        router.resume_replica(0)
        router.step()
        removed = router.remove_replica(1)
        ids = router.replica_ids
        router.drain()
        rid = router.add_replica(removed)
        streams.append([])
        hs.append(router.submit(_prompt(6, 11), 4,
                                on_token=streams[-1].extend))
        router.drain()
        return outcome(side, router, reg, hs, streams, drained=drained,
                       landed=landed, ids_after_remove=ids, added=rid,
                       migrations=[h.migrations for h in hs],
                       preserved=[h.tokens_preserved for h in hs])

    out = both(run)
    assert out["drained"] is True and out["ids_after_remove"] == (0,)
    assert out["landed"] == 1 and out["added"] == 2
    assert all(s == "ok" for s in out["status"])
    assert out["streams"] == out["tokens"]
    assert sum(out["migrations"]) >= 2 and sum(out["preserved"]) > 0


@pytest.mark.parametrize("kind", ["kill_replica", "correlated_kill"])
def test_kills_migrate_to_survivors(kind):
    fault = ({"kind": "kill_replica", "at": 2, "replica": 1}
             if kind == "kill_replica" else
             {"kind": "correlated_kill", "at": 3, "k": 2, "window": 8})
    n = 2 if kind == "kill_replica" else 3

    def run(side):
        router, reg = side.router(n, engine_kw=dict(max_len=64))
        plan = side.plan(fault)
        streams = [[] for _ in range(8)]
        with side.faults.activated(plan):
            hs = [router.submit(_prompt(3 + i % 4, i), 8, deadline_s=120.0,
                                on_token=streams[i].extend)
                  for i in range(8)]
            router.step()
            assert router.drain(timeout_s=120)
        return outcome(side, router, reg, hs, streams,
                       log=[dict(e) for e in plan.log],
                       ids=router.replica_ids)

    out = both(run)
    assert len(out["log"]) == (1 if kind == "kill_replica" else 2)
    assert len(out["ids"]) == 1
    assert all(s == "ok" for s in out["status"])
    assert out["streams"] == out["tokens"]
    assert out["series"][("dttpu_router_replica_down_total", ())] == n - 1
    assert out["series"][("dttpu_migrations_total", ())] >= 1


def test_last_replica_killed_fails_loudly():
    def run(side):
        router, reg = side.router(1)
        plan = side.plan({"kind": "kill_replica", "at": 0, "replica": 0})
        with side.faults.activated(plan):
            h = router.submit(_prompt(4, 1), 6)
            router.drain(timeout_s=30)
        return outcome(side, router, reg, [h], [],
                       error=type(h.error).__name__)

    out = both(run)
    assert out["status"] == ["failed"] and out["error"] == "ConnectionError"


def test_adapter_broadcast_equals_the_reference():
    ad = _adapter(4)

    def run(side):
        router, reg = side.router(2, engine_kw=dict(adapter_capacity=2,
                                                    adapter_rank=RANK))
        router.load_adapter("tuned", side.adapter(ad))
        streams = [[] for _ in range(6)]
        hs = [router.submit(_prompt(4 + i, i), 6,
                            adapter_id="tuned" if i < 4 else None,
                            on_token=streams[i].extend)
              for i in range(6)]
        router.drain()
        return outcome(side, router, reg, hs, streams)

    out = both(run)
    assert {r for _, r in out["placements"]} == {0, 1}
    assert out["streams"] == out["tokens"]
    base = _plain_tokens(SIDES[1], 4)
    assert all(a != b for a, b in zip(out["tokens"][:4], base))


def _plain_tokens(side, n):
    router, _ = side.router(1)
    hs = [router.submit(_prompt(4 + i, i), 6) for i in range(n)]
    router.drain()
    return [list(h.tokens) for h in hs]


def test_adapter_request_is_never_credited_with_another_namespace():
    """Replica 1 caches a system prompt with no adapter.  An adapter
    request sharing it scores 0 there in the port (those pages hold K/V
    computed without the adapter), so the id tie sends it to replica 0;
    the next adapter request scores its own namespace's chain on replica
    0 and goes there.  The reference keys every prompt in the default
    namespace and credits replica 1 both times."""
    ad = _adapter(5)

    def run(side):
        router, reg = side.router(2, engine_kw=dict(
            page_size=8, adapter_capacity=2, adapter_rank=RANK))
        router.load_adapter("tuned", side.adapter(ad))
        sys_prompt = _prompt(16, 3)
        router.submit(_prompt(8, 99), 4)
        router.submit(sys_prompt, 4)
        router.drain()
        for i in range(2):
            router.submit(np.concatenate([sys_prompt, _prompt(3, 20 + i)]),
                          4, adapter_id="tuned")
            router.drain()
        return ([r for _, r in router.placements],
                series(side, reg)[("dttpu_router_affinity_hits_total", ())])

    ref, port = (run(side) for side in SIDES)
    assert ref == ([0, 1, 1, 1], 2)
    assert port == ([0, 1, 0, 0], 1)


def test_request_chain_keys_and_scores_match_the_reference():
    from distributed_tensorflow_tpu.fleet import router as jrouter
    from distributed_tensorflow_tpu_torch.fleet import router as trouter
    p = _prompt(37, 1)
    for page in (4, 8, 16):
        assert trouter.request_chain_keys(p, page) \
            == jrouter.request_chain_keys(p, page)
    for prompt in ((40, 7, 32, 0.0), (40, 0, 0, 0.0), 5, None):
        assert trouter.request_chain_keys(prompt, 8) \
            == jrouter.request_chain_keys(prompt, 8)
    keys = trouter.request_chain_keys(p, 8)
    stats = types.SimpleNamespace(page_size=8, prefix_fingerprint={
        keys[1][0]: 16, keys[3][0]: 20})
    for manifest in (None, keys[:1]):
        assert trouter.expected_pages_reused(p, stats, manifest) \
            == jrouter.expected_pages_reused(p, stats, manifest) \
            == (2 if manifest is None else 0)
    other = trouter.request_chain_keys(p, 8, namespace=b"tuned")
    assert not set(k for k, _ in other) & set(k for k, _ in keys)
    assert trouter.expected_pages_reused(p, stats, namespace=b"tuned") == 0


def test_router_refuses_a_non_engine_and_needs_a_replica():
    router = tfleet.Router(registry=tmetrics.Registry())
    with pytest.raises(tfleet.NoReplicaError):
        router.submit(_prompt(4, 1), 4)
    with pytest.raises(TypeError, match="EngineProtocol"):
        router.add_replica(object())
    assert isinstance(SIDES[1].engine(tmetrics.Registry()),
                      tfleet.EngineProtocol)
