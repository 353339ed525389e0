"""Request tracing (``obs.reqtrace``), the critical path (``obs.critpath``),
``ServeMetrics`` and the serving fault sites of the port's engine, held
against the JAX package's engine on ``gpt_tiny`` (weights scaled 5x so
that tokens vary; the JAX engine's kernels run through their plain
reference on the CPU, as its own tests run them).

- The same requests on both engines give, per request, the same
  sequence of lane events (``request``/``queued``/``prefill``/``decode``
  stages, ``prefill_window``/``admitted``/``first_token`` marks,
  retirement with its status), the same span tree shape, the same
  critical-path keys, with the phases summing to ``e2e_s``; the ledger
  saw every request; ``inflight_trace_ids``/``inflight_critpath`` list
  the queued requests.
- The engines' registries hold the same series, with the same values
  where they are not times, and the ``ServeMetrics`` counters equal
  ``EngineStats``.
- ``fail_decode`` on one rid fails exactly that request in both (status
  ``failed``, ``dttpu_serve_failed_total`` 1); every other request's
  tokens equal an unfaulted run's.  ``stall_tick`` on the engine's
  ``chaos_tag`` stalls one tick and changes no token.
- Export mid-decode and import on a second engine: the snapshot carries
  the ``trace_id`` and the critical path, the lane continues with the
  same events as the JAX package's, and the finished breakdown charges
  ``migration``.  A deadline's expiry dumps the victim's tree.
"""
import numpy as np
import pytest
import torch

import jax

from distributed_tensorflow_tpu import obs as jobs
from distributed_tensorflow_tpu import resilience as jres
from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch import obs as tobs
from distributed_tensorflow_tpu_torch import resilience as tres

torch.set_num_threads(1)

PROMPTS = [(5, 6), (9, 4), (13, 8), (3, 5)]      # (prompt length, budget)


def _models():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jax.tree.map(lambda x: x * 5.0 if x.ndim >= 2 else x,
                           jmodel.init(jax.random.PRNGKey(0)))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position, dropout_rate=0.0)
    return jmodel, jparams, load_jax_params(GPT(config, device="cpu"),
                                            jax.tree.map(np.asarray, jparams))


_MODELS = _models()

_KW = dict(num_slots=2, max_len=64, prefill_chunk=4, tick_steps=2)


def _engine(obs):
    if obs is tobs:
        return Engine(_MODELS[2], device="cpu", registry=obs.Registry(),
                      **_KW)
    return jserve.Engine(_MODELS[0], _MODELS[1], registry=obs.Registry(),
                         **_KW)


def _prompts():
    rng = np.random.default_rng(6)
    return [(rng.integers(0, 512, n, dtype=np.int32), b)
            for n, b in PROMPTS]


def _lane(obs, trace_id):
    rec = obs.reqtrace.lookup(trace_id)
    return [(e["ph"], e["name"], e.get("args", {}).get("status"))
            for e in rec["events"]]


def _shape(spans):
    return [(s["name"], [m["name"] for m in s["marks"]],
             _shape(s["children"])) for s in spans]


def _serve(obs, plan=None, export_after=None):
    """Serve the prompts with a tracer and a ledger active: (handles,
    lanes, tree shapes, ledger report, the engine, queued trace ids,
    in-flight critical paths)."""
    obs.reqtrace.reset()
    tracer = obs.Tracer(enabled=True)
    ledger = obs.CritpathLedger(registry=obs.Registry())
    res = tres if obs is tobs else jres
    with obs.trace.activated(tracer), obs.critpath.activated(ledger), \
            res.faults.activated(plan or res.FaultPlan([], seed=0)):
        eng = _engine(obs)
        hs = [eng.submit(p, b) for p, b in _prompts()]
        queued = eng.inflight_trace_ids()
        live = sorted(eng.inflight_critpath())
        if export_after is not None:
            h = hs[0]
            while len(h.tokens) < export_after:
                eng.step()
            snap = eng.export_request(h)
            dst = _engine(obs)
            hs[0] = dst.import_request(snap)
            hs[0].snap = snap
            dst.drain()
        eng.drain()
    ids = [h.trace_id if obs is tobs else h._req.trace_id for h in hs]
    lanes = [_lane(obs, t) for t in ids]
    trees = [_shape(obs.reqtrace.tree(t)["spans"]) for t in ids]
    return hs, lanes, trees, ledger.report(), eng, queued, live


@pytest.fixture(scope="module")
def served():
    return _serve(tobs), _serve(jobs)


def test_lanes_trees_and_critpath_equal_jax(served):
    got, want = served
    hs, lanes, trees, report, eng, queued, live = got
    assert lanes == want[1]
    assert trees == want[2]
    assert [h.tokens for h in hs] == [h.tokens for h in want[0]]
    assert [h.status for h in hs] == ["ok"] * len(PROMPTS)
    for lane in lanes:
        names = [n for ph, n, _ in lane]
        assert names[:2] == ["request", "queued"]
        for stage in ("prefill", "decode", "prefill_window", "admitted",
                      "first_token"):
            assert stage in names
        assert lane[-1] == ("e", "request", "ok")
    for tree in trees:
        assert [c[0] for c in tree[0][2]] == ["queued", "prefill",
                                              "decode"]
    for h, jh in zip(hs, want[0]):
        assert set(h.critpath) == set(jh.critpath)
        phases = sum(v for k, v in h.critpath.items()
                     if k not in ("e2e_s", "interference_share"))
        assert phases == pytest.approx(h.critpath["e2e_s"], rel=1e-9)
    assert report["requests"] == want[3]["requests"] == len(PROMPTS)
    assert len(queued) == len(live) == len(PROMPTS)
    assert sorted(queued) == live and want[5] and len(want[6]) == 4


def test_serve_metrics_equal_jax_and_engine_stats(served):
    got, want = served
    fams = tobs.parse_exposition(got[4].metrics.registry.expose())
    jfams = jobs.parse_exposition(want[4].metrics.registry.expose())
    assert set(fams) == set(jfams)
    timed = ("_seconds", "_seconds_bucket", "_seconds_sum")
    for fam, entry in fams.items():
        assert entry["type"] == jfams[fam]["type"], fam
        for key, v in entry["samples"].items():
            if not key[0].endswith(timed):
                assert v == jfams[fam]["samples"][key], key
    st = got[4].stats()
    value = got[4].metrics.registry.get
    assert value("dttpu_serve_tokens_total").value == \
        sum(len(h.tokens) for h in got[0])
    assert value("dttpu_serve_requests_total").value == len(PROMPTS)
    assert value("dttpu_serve_prefix_hits_total").value == \
        st.prefix_hits_total
    assert value("dttpu_serve_pages_free").value == st.pages_free
    assert value("dttpu_serve_queue_depth").value == st.queued == 0
    assert value("dttpu_serve_ttft_seconds").count == len(PROMPTS)


def test_fail_decode_fails_that_request_only(served):
    clean = [h.tokens for h in served[0][0]]
    out = {}
    for obs, res in ((tobs, tres), (jobs, jres)):
        plan = res.FaultPlan([{"kind": "fail_decode", "at": 1},
                              {"kind": "stall_tick", "at": 2,
                               "seconds": 0.01}],
                             seed=0, registry=obs.Registry())
        hs, lanes, _, _, eng, _, _ = _serve(obs, plan)
        out[obs] = ([h.status for h in hs], lanes[1][-1],
                    eng.metrics.failed.value,
                    sorted(e["kind"] for e in plan.log))
        assert [h.tokens for i, h in enumerate(hs) if i != 1] == \
            [t for i, t in enumerate(clean) if i != 1]
        assert type(hs[1].error).__name__ == "InjectedFault"
    assert out[tobs] == out[jobs]
    assert out[tobs] == (["ok", "failed", "ok", "ok"],
                         ("e", "request", "failed"), 1.0,
                         ["fail_decode", "stall_tick"])


def test_migration_carries_trace_and_critpath():
    out = {}
    for obs in (tobs, jobs):
        hs, lanes, _, _, _, _, _ = _serve(obs, export_after=3)
        snap, h = hs[0].snap, hs[0]
        tid = h.trace_id if obs is tobs else h._req.trace_id
        assert snap.trace_id == tid and snap.critpath is not None
        assert set(snap.critpath) == {"phases", "elapsed_s", "exported_at"}
        assert h.status == "ok" and h.critpath["migration"] >= 0.0
        assert obs.reqtrace.lookup(tid)["hops"] == 1
        out[obs] = (lanes[0], h.tokens)
    assert out[tobs] == out[jobs]
    names = [n for _, n, _ in out[tobs][0]]
    i = names.index("exported")
    assert names[i:i + 4] == ["exported", "migrate", "migrate", "imported"]


def test_deadline_expiry_dumps_the_victim():
    for obs in (tobs, jobs):
        obs.reqtrace.reset()
        with obs.trace.activated(obs.Tracer(enabled=True)):
            eng = _engine(obs)
            h = eng.submit(_prompts()[0][0], 4, deadline_s=0.0)
            eng.drain()
        assert h.status == "deadline_exceeded"
        (dump,) = obs.reqtrace.forensics_log()
        assert dump["reason"] == "deadline_expired" and \
            dump["status"] == "deadline_exceeded"
