"""The port's workload traces (``fleet/workload.py``), autoscaler
(``fleet/autoscaler.py``) and metrics federation (``obs/federate.py``)
held against the JAX package's.

* ``synthesize`` returns bit-equal columns (values and dtypes), equal
  events and the same ``fingerprint`` for several seeds and arguments, and
  so do ``subset`` and ``prefix_popularity``.
* The autoscaler's decisions and ``dttpu_autoscaler_*`` values equal the
  reference's over one scripted sequence of evaluations (stub replicas):
  heal below the floor, scale-out on missed attainment and on backlog,
  the cooldown, scale-in of the sole holder's neighbour, the ceiling.
* A real fleet of ``gpt_tiny`` engines: a backlog burst scales out (1 ->
  2), the lull scales in by migration (2 -> 1), and every request's
  tokens equal the reference fleet's (after
  ``tests/test_fleet_sim.py::test_autoscaler_real_fleet_scale_out_in_token_identical``).
* ``FederatedMetrics.expose()`` equals the reference's byte for byte for
  equal registries, a scraped loopback peer and equal SLO ingests, and it
  is served by the port's ``MetricsServer``; ``fleet_fingerprints``
  recovers a replica's fingerprint.
"""
import urllib.request

import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import fleet as jfleet
from distributed_tensorflow_tpu import obs as jobs
from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch import fleet as tfleet
from distributed_tensorflow_tpu_torch import obs as tobs
from distributed_tensorflow_tpu_torch.fleet import router as trouter
from distributed_tensorflow_tpu_torch.serve.scheduler import EngineStats

torch.set_num_threads(1)

_COLUMNS = ("arrival_s", "plen", "new_tokens", "tenant", "prefix_id",
            "prefix_len", "adapter")


@pytest.mark.parametrize("kw", [
    dict(n_requests=500, seed=0, horizon_s=30.0),
    dict(n_requests=3000, seed=7, horizon_s=90.0, failures=3),
    dict(n_requests=64, seed=11, horizon_s=600.0, bursts=1,
         burst_magnitude=8.0, burst_width_s=20.0, adapters=0,
         prefix_populations=4, prefix_fraction=0.9),
    dict(n_requests=1000, seed=3, tenants=(("free", 1.0), ("pro", 2.0)),
         diurnal_amplitude=0.0, bursts=0, plen_max=256,
         new_tokens_max=32, adapter_fraction=0.5, adapter_churn=1.0),
], ids=["default", "failures", "burst", "tenants"])
def test_synthesize_is_bit_equal_to_the_reference(kw):
    ref = jfleet.synthesize(**kw)
    got = tfleet.synthesize(**kw)
    for col in _COLUMNS:
        a, b = getattr(ref, col), getattr(got, col)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), col
    assert repr(got.events) == repr(ref.events)
    assert got.tenants == ref.tenants and got.horizon_s == ref.horizon_s
    assert got.fingerprint() == ref.fingerprint()
    assert got.prefix_popularity() == ref.prefix_popularity()
    assert got.total_tokens == ref.total_tokens
    half = len(got) // 2
    assert got.subset(half).fingerprint() == ref.subset(half).fingerprint()
    assert tfleet.synthesize(**dict(kw, seed=kw["seed"] + 1)).fingerprint() \
        != got.fingerprint()
    with pytest.raises(ValueError, match="positive"):
        tfleet.synthesize(0)


class _Stub:
    """A replica with scripted stats: what the autoscaler reads of a
    fleet, nothing it does not."""

    def __init__(self, stats_cls, fingerprint=None):
        self.cls = stats_cls
        self.queued = self.active = 0
        self.fingerprint = fingerprint or {}
        self.chaos_tag = 0

    def stats(self):
        return self.cls(queued=self.queued, prefilling=0,
                        active=self.active, num_slots=4,
                        inflight_per_tenant={},
                        tokens_inflight_per_tenant={}, page_size=8,
                        prefix_fingerprint=dict(self.fingerprint))

    busy = False

    def submit(self, *a, **k):
        raise AssertionError("no traffic in this test")

    def step(self):
        return False

    def drain(self, timeout_s=None):
        return True

    def cancel(self, handle):
        return False

    def export_request(self, handle, timeout_s=None):
        raise KeyError(handle)

    def import_request(self, snap, on_token=None):
        raise KeyError(snap)

    def load_adapter(self, adapter_id, adapter):
        pass


def _policy_run(pkg, stats_cls):
    reg = pkg.obs_registry()
    made = []

    def factory():
        made.append(_Stub(stats_cls))
        return made[-1]

    router = pkg.fleet.Router([factory()], registry=reg)
    auto = pkg.fleet.Autoscaler(
        router, factory, pkg.fleet.SLO(ttft_s=1.0, itl_s=0.1),
        min_replicas=2, max_replicas=4, cooldown_s=10.0, backlog_high=1.0,
        util_low=0.5, registry=reg)
    out = [auto.evaluate(0.0)]                     # heal to the floor
    auto.record(ttft_ok=False)
    auto.record(ttft_ok=True, itl_ok=True)
    out.append(auto.evaluate(1.0))                 # attainment 0.5: out
    made[0].queued = 20
    out.append(auto.evaluate(2.0))                 # backlog: out
    made[0].queued = 0
    out.append(auto.evaluate(3.0))                 # cooldown: nothing
    made[0].fingerprint = {b"sole": 16}
    made[3].fingerprint = {b"sole3": 16}
    made[1].fingerprint = made[2].fingerprint = {b"shared": 16}
    out.append(auto.evaluate(20.0))                # scale in: not sole
    out.append(auto.evaluate(21.0))                # cooldown again
    for s in made:
        s.queued = 30
    out.append(auto.evaluate(22.0))
    out.append(auto.evaluate(23.0))
    out.append(auto.evaluate(24.0))                # at the ceiling
    auto.charge(2.5, 3)
    fams = pkg.parse(reg.expose())
    series = {k: v for name, fam in fams.items()
              if name.startswith("dttpu_autoscaler_")
              for k, v in fam["samples"].items()}
    return out, auto.history, router.replica_ids, series


class _Pkg:
    def __init__(self, fleet, obs):
        self.fleet = fleet
        self.obs_registry = obs.Registry
        self.parse = obs.parse_exposition


def test_autoscaler_policy_equals_the_reference():
    ref = _policy_run(_Pkg(jfleet, jobs), jserve.EngineStats)
    got = _policy_run(_Pkg(tfleet, tobs), EngineStats)
    assert got == ref
    actions = got[0]
    assert actions[:3] == [("scale_out", 1), ("scale_out", 2),
                           ("scale_out", 3)]
    assert actions[3] is None and actions[4] == ("scale_in", 2)
    assert actions[-1] is None and len(got[2]) == 4


_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "kv_cache_dtype")


def _models():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jax.tree.map(lambda x: x * 5.0 if x.ndim >= 2 else x,
                           jmodel.init(jax.random.PRNGKey(0)))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    return jmodel, jparams, load_jax_params(GPT(config, device="cpu"),
                                            jax.tree.map(np.asarray, jparams))


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen, dtype=np.int32)


def _scaling_run(pkg, make_engine):
    reg = pkg.obs_registry()

    def factory():
        return make_engine(reg)

    router = pkg.fleet.Router([factory()], registry=reg)
    auto = pkg.fleet.Autoscaler(
        router, factory, pkg.fleet.SLO(ttft_s=2.0, itl_s=1.0),
        min_replicas=1, max_replicas=2, backlog_high=0.5, util_low=0.8,
        eval_interval_s=1.0, cooldown_s=30.0, drain_timeout_s=60.0,
        registry=reg)
    streams = [[] for _ in range(7)]
    hs = [router.submit(_prompt(3 + i % 4, i), 6, on_token=streams[i].extend)
          for i in range(5)]
    actions = [auto.evaluate(now=0.0)]      # 5 queued on 4 slots: out
    ids_out = router.replica_ids
    router.drain()
    hs += [router.submit(_prompt(4 + j, 10 + j), 8,
                         on_token=streams[5 + j].extend) for j in range(2)]
    router.step()
    spread = sorted(h.replica_id for h in hs[5:])
    actions.append(auto.evaluate(now=60.0))  # lull: in, by migration
    ids_in = router.replica_ids
    router.drain()
    fams = pkg.parse(reg.expose())
    series = {k: v for name, fam in fams.items()
              if name.startswith(("dttpu_autoscaler_", "dttpu_router_",
                                  "dttpu_migrations"))
              and "seconds" not in name
              for k, v in fam["samples"].items()}
    return dict(actions=actions, ids_out=ids_out, ids_in=ids_in,
                spread=spread, status=[h.status for h in hs],
                tokens=[h.tokens for h in hs], streams=streams,
                migrations=[h.migrations for h in hs], series=series)


def test_real_fleet_scale_out_and_in_token_identical():
    jmodel, jparams, tmodel = _models()
    kw = dict(num_slots=4, max_len=32, prefill_chunk=4, tick_steps=2)
    ref = _scaling_run(_Pkg(jfleet, jobs), lambda reg: jserve.Engine(
        jmodel, jparams, registry=reg, **kw))
    got = _scaling_run(_Pkg(tfleet, tobs), lambda reg: Engine(
        tmodel, device="cpu", registry=reg, **kw))
    assert got == ref
    assert got["actions"] == [("scale_out", 1), ("scale_in", 1)]
    assert got["ids_out"] == (0, 1) and got["ids_in"] == (0,)
    assert got["spread"] == [0, 1] and sum(got["migrations"]) >= 1
    assert all(s == "ok" for s in got["status"])
    assert got["streams"] == got["tokens"]
    assert [len(t) for t in got["tokens"]] == [6] * 5 + [8] * 2


def _registries(pkg):
    """Two replicas' registries and a peer's, filled alike."""
    regs = []
    for i in range(2):
        reg = pkg.Registry()
        reg.counter("dttpu_serve_tokens_total", "Tokens.").inc(10 * (i + 1))
        reg.gauge("dttpu_serve_queue_depth", "Depth.").set(i)
        h = reg.histogram("dttpu_serve_ttft_seconds", "TTFT.",
                          buckets=(0.1, 1.0))
        for v in (0.05, 0.5 * (i + 1), 3.0):
            h.observe(v)
        reg.counter("dttpu_tenant_tokens_total", "By tenant.",
                    labels={"tenant": 'a"b\\c'}).inc(7)
        regs.append(reg)
    return regs


def _ingest(fed):
    for i in range(100):
        fed.ingest("pro", ttft_s=0.01 * (i + 1), tpot_s=0.001,
                   ttft_ok=i < 90, itl_ok=True)
    fed.ingest("free", ttft_s=0.3, ttft_ok=False)


def test_federated_exposition_equals_the_reference():
    peer = tobs.Registry()
    peer.gauge("dttpu_serve_queue_depth", "Depth.").set(5)
    server = tobs.MetricsServer(peer, port=0).start()
    texts = []
    try:
        for pkg in (jobs, tobs):
            fed = pkg.FederatedMetrics()
            for i, reg in enumerate(_registries(pkg)):
                fed.add_registry(reg, replica=str(i))
            fed.add_scrape(server.url + "/metrics", host="peer0")
            _ingest(fed)
            texts.append(fed.expose())
    finally:
        server.stop()
    assert texts[1] == texts[0]
    parsed = tobs.parse_exposition(texts[1])
    s = parsed["dttpu_serve_tokens_total"]["samples"]
    assert s[("dttpu_serve_tokens_total", (("replica", "1"),))] == 20.0
    assert parsed["dttpu_serve_queue_depth"]["samples"][
        ("dttpu_serve_queue_depth", (("host", "peer0"),))] == 5.0
    pro = (("tenant", "pro"),)
    assert parsed["dttpu_slo_attainment"]["samples"][
        ("dttpu_slo_attainment", pro)] == pytest.approx(0.95)
    # the peer is gone: skipped and counted, in both packages alike
    dead = []
    for pkg in (jobs, tobs):
        fed = pkg.FederatedMetrics()
        fed.add_scrape(server.url + "/metrics", host="peer0")
        dead.append(fed.expose())
    assert dead[1] == dead[0]
    assert "dttpu_federation_scrape_errors_total 1" in dead[1]


def test_federation_served_and_fingerprints_recovered():
    reg = tobs.Registry()
    fed = tobs.FederatedMetrics()
    for i, r in enumerate(_registries(tobs)):
        fed.add_registry(r, replica=str(i))
    _ingest(fed)
    server = fed.serve(port=0)
    try:
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
    finally:
        server.stop()
    assert text == fed.expose()
    assert fed.source_count() == 3
    # a paged engine's chain gauges federate into a scoreable affinity
    _, _, tmodel = _models()
    eng = Engine(tmodel, device="cpu", registry=reg, num_slots=2,
                 max_len=32, prefill_chunk=4, tick_steps=2, page_size=8)
    p = _prompt(16, 21)
    eng.submit(p, 4)
    eng.drain()
    fed = tobs.FederatedMetrics().add_registry(reg, replica="7")
    (src, aff), = fed.fleet_fingerprints().items()
    assert ("replica", "7") in src and aff.page_size == 8
    assert aff.prefix_fingerprint == eng.stats().prefix_fingerprint
    assert trouter.expected_pages_reused(p, aff) \
        == trouter.expected_pages_reused(p, eng.stats()) == 2
