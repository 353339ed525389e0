"""The port's pump heartbeat (``EngineStats``) and fleet watchdog
(``fleet/watchdog.py``) held against the JAX package's.

* ``Watchdog.verdict`` returns the reference's reason, word for word, on
  the same heartbeat values: never ticked, healthy, wedged, a fresh tick
  in progress, stalled.
* The heartbeat: ``ticks_started``/``ticks_completed`` and the stamps of
  the latest tick bracket every tick; ``stall_tick`` and
  ``wedge_replica`` fire at their tick index on both packages alike, and
  a stats read from a second thread during a wedged tick sees it in
  progress.
* A three-replica fleet loses replica 1 to ``kill_replica`` and stalls
  replica 2 (``stall_tick``): the watchdog quarantines replica 2 only,
  and the quarantine list, the plan's audit trail, every request's tokens
  and stream and the router/watchdog series equal the reference's.
* A wedged pump on a pump thread is caught from the main thread: the
  replica is quarantined ``wedged``, its requests are exported past the
  held pump (``clean=False``) and finish on the survivor with the
  reference's tokens, and each victim has a forensic dump.

Engines are the ``gpt_tiny`` of ``test_torch_fleet.py`` (weights scaled
5x so that tokens vary), warmed before any tick-indexed fault is armed.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import fleet as jfleet
from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as jmetrics
from distributed_tensorflow_tpu.obs import reqtrace as jreqtrace
from distributed_tensorflow_tpu.obs import trace as jtrace
from distributed_tensorflow_tpu.resilience import faults as jfaults
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch import fleet as tfleet
from distributed_tensorflow_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_tpu_torch.obs import reqtrace as treqtrace
from distributed_tensorflow_tpu_torch.obs import trace as ttrace
from distributed_tensorflow_tpu_torch.resilience import faults as tfaults
from distributed_tensorflow_tpu_torch.serve.scheduler import EngineStats

torch.set_num_threads(1)

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


JMODEL, JPARAMS, TMODEL = _models()


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen, dtype=np.int32)


class Side:
    def __init__(self, name):
        jx = name == "jax"
        self.name = name
        self.fleet = jfleet if jx else tfleet
        self.faults = jfaults if jx else tfaults
        self.metrics = jmetrics if jx else tmetrics
        self.trace = jtrace if jx else ttrace
        self.reqtrace = jreqtrace if jx else treqtrace
        self.stats = jserve.EngineStats if jx else EngineStats

    def engine(self, reg):
        kw = dict(num_slots=2, max_len=64, prefill_chunk=4, tick_steps=2,
                  registry=reg)
        if self.name == "jax":
            return jserve.Engine(JMODEL, JPARAMS, **kw)
        return Engine(TMODEL, device="cpu", **kw)

    def plan(self, *faults):
        return self.faults.FaultPlan(list(faults),
                                     registry=self.metrics.Registry())


SIDES = (Side("jax"), Side("torch"))


def _warm(engines, steps=8):
    """Run every engine once before tick-indexed faults or a deadline
    (a JAX engine's first ticks compile)."""
    hs = [eng.submit(_prompt(6, 50 + j), 3) for j, eng in enumerate(engines)]
    for _ in range(steps):
        for eng in engines:
            eng.step()
    assert all(h.done for h in hs)


def _streamer(streams, i):
    streams[i] = []
    return streams[i].extend


def _series(side, reg):
    fams = side.metrics.parse_exposition(reg.expose())
    return {(s, lbls): v for name, fam in fams.items()
            if name.startswith(("dttpu_router_", "dttpu_migrations",
                                "dttpu_watchdog"))
            for (s, lbls), v in fam["samples"].items()}


_HEARTBEATS = {
    "never_ticked": {},
    "healthy": dict(ticks_started=5, ticks_completed=5,
                    last_tick_start_s=99.0, last_tick_end_s=99.1,
                    last_tick_duration_s=0.1),
    "wedged": dict(ticks_started=6, ticks_completed=5,
                   last_tick_start_s=98.0),
    "in_progress_fresh": dict(ticks_started=6, ticks_completed=5,
                              last_tick_start_s=99.9),
    "stalled": dict(ticks_started=5, ticks_completed=5,
                    last_tick_duration_s=2.5),
}


@pytest.mark.parametrize("case", sorted(_HEARTBEATS))
def test_verdict_equals_the_reference(case):
    got = []
    for side in SIDES:
        wd = side.fleet.Watchdog(
            side.fleet.Router(registry=side.metrics.Registry()),
            tick_deadline_s=1.0, registry=side.metrics.Registry())
        stats = side.stats(queued=0, prefilling=0, active=1, num_slots=2,
                           inflight_per_tenant={},
                           tokens_inflight_per_tenant={},
                           **_HEARTBEATS[case])
        got.append(wd.verdict(stats, 100.0))
    assert got[1] == got[0]
    word = case.split("_")[0]
    assert (got[1] is None) == (word not in ("wedged", "stalled"))
    if got[1] is not None:
        assert got[1].startswith(word)
    with pytest.raises(ValueError, match="tick_deadline_s"):
        tfleet.Watchdog(tfleet.Router(registry=tmetrics.Registry()),
                        tick_deadline_s=0.0)


def test_heartbeat_brackets_ticks_and_faults_fire_as_the_reference():
    logs = []
    for side in SIDES:
        eng = side.engine(side.metrics.Registry())
        _warm([eng])
        s0 = eng.stats()
        plan = side.plan({"kind": "stall_tick", "at": 1, "seconds": 0.15},
                         {"kind": "wedge_replica", "at": 3, "seconds": 0.15})
        with side.faults.activated(plan):
            h = eng.submit(_prompt(4, 1), 8)
            durations = []
            while eng.busy:
                t0 = time.perf_counter()
                eng.step()
                durations.append(time.perf_counter() - t0)
        assert h.status == "ok"
        s = eng.stats()
        n = len(durations)
        assert s.ticks_started == s.ticks_completed == s0.ticks_started + n
        assert s.last_tick_end_s >= s.last_tick_start_s > s0.last_tick_end_s
        assert s.last_tick_duration_s == pytest.approx(
            s.last_tick_end_s - s.last_tick_start_s)
        assert [i for i, d in enumerate(durations) if d >= 0.1] == [1, 3]
        logs.append(plan.log)
    assert logs[1] == logs[0]


def test_heartbeat_seen_in_progress_from_another_thread():
    eng = SIDES[1].engine(tmetrics.Registry())
    _warm([eng])
    plan = SIDES[1].plan({"kind": "wedge_replica", "at": 0,
                          "seconds": 10.0})
    with tfaults.activated(plan):
        eng.submit(_prompt(4, 2), 4)
        before = eng.stats()
        pump = threading.Thread(target=eng.step, name="dttpu-test-pump")
        pump.start()
        deadline = time.perf_counter() + 10
        while not plan.log:
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        mid = eng.stats()               # read while the pump is held
        plan.release_wedges()
        pump.join(timeout=10)
    after = eng.stats()
    assert mid.ticks_started == before.ticks_started + 1
    assert mid.ticks_completed == before.ticks_completed
    assert mid.last_tick_start_s > before.last_tick_end_s
    assert after.ticks_completed == after.ticks_started


def test_stall_and_kill_quarantine_equal_the_reference():
    def run(side):
        reg = side.metrics.Registry()
        engines = [side.engine(reg) for _ in range(3)]
        router = side.fleet.Router(engines, registry=reg)
        _warm(engines)
        wd = side.fleet.Watchdog(router, tick_deadline_s=0.25,
                                 export_timeout_s=0.1, registry=reg)
        page = engines[0].scheduler.page_size
        sys_prefix = _prompt(page, 99)
        prompts = [np.concatenate([sys_prefix, _prompt(3 + i % 3, i)])
                   for i in range(8)]
        plan = side.plan(
            {"kind": "kill_replica", "at": 5, "replica": 1},
            {"kind": "stall_tick", "at": 6, "replica": 2, "seconds": 0.6})
        streams, quarantined = {}, []
        with side.faults.activated(plan):
            hs = [router.submit(p, 8, deadline_s=120.0,
                                on_token=_streamer(streams, i))
                  for i, p in enumerate(prompts)]
            deadline = time.perf_counter() + 120
            while router.busy:
                assert time.perf_counter() < deadline, "chaos run hung"
                router.step()
                quarantined.extend(rid for rid, _ in wd.check())
        return dict(kinds=sorted(e["kind"] for e in plan.log),
                    quarantined=quarantined, ids=router.replica_ids,
                    held=sorted(router.quarantined),
                    status=[h.status for h in hs],
                    tokens=[h.tokens for h in hs],
                    streams=[streams[i] for i in range(len(hs))],
                    series=_series(side, reg))

    ref, port = (run(side) for side in SIDES)
    assert port == ref
    assert port["kinds"] == ["kill_replica", "stall_tick"]
    assert port["quarantined"] == [2] and port["ids"] == (0,)
    assert all(s == "ok" for s in port["status"])
    assert port["streams"] == port["tokens"]
    assert port["series"][("dttpu_watchdog_unhealthy_total", ())] == 1


def test_wedged_pump_thread_forced_export_and_forensics():
    def run(side):
        reg = side.metrics.Registry()
        engines = [side.engine(reg) for _ in range(2)]
        router = side.fleet.Router(engines, registry=reg)
        _warm(engines)
        side.reqtrace.reset()
        tracer = side.trace.activate(side.trace.Tracer(enabled=True))
        wd = side.fleet.Watchdog(router, tick_deadline_s=0.2,
                                 export_timeout_s=0.1, registry=reg)
        clean = []
        export = engines[0].export_request

        def recording(handle, timeout_s=None):
            snap = export(handle, timeout_s=timeout_s)
            clean.append(snap.clean)
            return snap

        engines[0].export_request = recording
        prompts = [_prompt(5, 90 + i) for i in range(4)]
        plan = side.plan({"kind": "wedge_replica", "at": 3, "replica": 0,
                          "seconds": 30.0})
        stop = threading.Event()

        def pump_fleet():
            while not stop.is_set() and router.busy:
                router.step()

        pump = threading.Thread(target=pump_fleet, name="dttpu-test-pump",
                                daemon=True)
        try:
            with side.faults.activated(plan):
                streams = {}
                hs = [router.submit(p, 8, on_token=_streamer(streams, i))
                      for i, p in enumerate(prompts)]
                pump.start()
                hits = []
                deadline = time.perf_counter() + 60
                while not hits:
                    assert time.perf_counter() < deadline, "never detected"
                    time.sleep(0.02)
                    victims = set(engines[0].inflight_trace_ids())
                    hits.extend(wd.check())
                deadline = time.perf_counter() + 120
                while any(not h.done for h in hs):
                    assert time.perf_counter() < deadline, "migration hung"
                    router.step()
        finally:
            plan.release_wedges()
            stop.set()
            pump.join(timeout=30)
            side.trace.deactivate(tracer)
        dumps = [d for d in side.reqtrace.forensics_log()
                 if d["reason"] == "watchdog_quarantine"]
        side.reqtrace.reset()
        assert not pump.is_alive()
        return dict(hit=(hits[0][0], hits[0][1].split(":")[0]),
                    held=sorted(router.quarantined),
                    status=[h.status for h in hs],
                    tokens=[h.tokens for h in hs],
                    streams=[streams[i] for i in range(len(hs))],
                    clean=clean, victims=len(victims),
                    dumped={d["trace_id"] for d in dumps} == victims)

    ref, port = (run(side) for side in SIDES)
    assert port == ref
    assert port["hit"] == (0, "wedged") and port["held"] == [0]
    assert all(s == "ok" for s in port["status"])
    assert port["streams"] == port["tokens"]
    assert port["clean"] and not any(port["clean"])
    assert port["victims"] >= 1 and port["dumped"]
