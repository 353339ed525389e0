"""The port's telemetry (``obs.metrics``, ``obs.trace``, ``obs.http``,
``obs.Telemetry``, ``TraceHook``, ``MetricsExportHook``), held against the
JAX package's.

- The same sequence of counter, gauge and histogram operations (labels
  with escapes, custom buckets, +Inf) on both registries renders
  byte-identical exposition text; ``parse_exposition`` of it and
  ``render_exposition`` back round-trip in both packages, and each
  package parses the other's text to the same families.
- The same spans, nested spans, instants, retroactive spans and raw
  events on both tracers give the same events by name, phase, args and
  nesting (timestamps and thread ids aside); the saved Chrome trace
  loads as JSON; the module-level active tracer routes and restores.
- ``MetricsServer`` serves ``/metrics`` (the registry's text, the same
  bytes as the JAX server's for the same operations), ``/healthz``
  (503 when the health function fails), ``/statusz`` and a 404 on
  loopback.
- ``TrainSession(telemetry=)`` with ``TraceHook`` and
  ``MetricsExportHook`` on ``gpt_tiny`` gives the same series as the JAX
  session over the same batches, with the same values where they are not
  times (steps, step-time count, checkpoint-save count, retraces 0,
  loss, gradient norm, non-finite count), and the same spans
  (``data_load``, ``step``, ``dispatch``, ``checkpoint``) and instants.
  ``dttpu_live_arrays_bytes`` differs on purpose: the port reads the
  card's allocator (0 on the CPU), the JAX package totals its arrays.
"""
import collections
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import obs as jobs
from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, adamw,
                                              load_jax_params,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch import obs as tobs
from distributed_tensorflow_tpu_torch import train as ttrain

torch.set_num_threads(1)

TOL = 1e-5


def _registry_ops(lib):
    """One fixed sequence of operations on a fresh registry of ``lib``."""
    reg = lib.metrics.Registry()
    c = reg.counter("dttpu_things_total", "Things.\nWith a second line.")
    c.inc()
    c.inc(2.5)
    reg.counter("dttpu_things_total", labels={"kind": 'a"b\\c\nd'}).inc(7)
    g = reg.gauge("dttpu_level", "A level.")
    g.set(3)
    g.inc(-0.25)
    reg.gauge("dttpu_zero", "Never set.")
    h = reg.histogram("dttpu_latency_seconds", "Latency.")
    for v in (0.0004, 0.003, 0.003, 0.7, 12.0, 1e6):
        h.observe(v)
    hc = reg.histogram("dttpu_sizes", "Sizes.", labels={"path": "x"},
                       buckets=(1, 10, 100))
    for v in (1, 5, 50, 500):
        hc.observe(v)
    assert reg.get("dttpu_level").value == 2.75
    assert h.count == 6 and hc.quantile(0.5) == 10.0
    with pytest.raises(ValueError):
        reg.gauge("dttpu_things_total")       # registered as a counter
    with pytest.raises(ValueError):
        c.inc(-1)
    return reg


def test_exposition_is_byte_identical_and_round_trips():
    jtext = _registry_ops(jobs).expose()
    ttext = _registry_ops(tobs).expose()
    assert ttext == jtext
    assert 'kind="a\\"b\\\\c\\nd"' in ttext and 'le="+Inf"' in ttext
    for lib in (jobs, tobs):
        fams = lib.metrics.parse_exposition(ttext)
        assert fams["dttpu_latency_seconds"]["type"] == "histogram"
        assert fams["dttpu_things_total"]["help"] == \
            "Things.\nWith a second line."
        assert lib.metrics.parse_exposition(
            lib.metrics.render_exposition(fams)) == fams
    assert tobs.parse_exposition(jtext) == jobs.parse_exposition(ttext)
    relabelled = tobs.render_exposition(tobs.parse_exposition(ttext),
                                        extra_labels={"host": "h0"})
    assert relabelled == jobs.render_exposition(
        jobs.parse_exposition(jtext), extra_labels={"host": "h0"})


def _trace_ops(lib):
    """Fixed spans, instants and raw events on an enabled tracer; also
    through the module-level active tracer."""
    tr = lib.trace.Tracer(enabled=True, pid=3)
    with tr.span("outer", step=1):
        with tr.span("inner", k="v"):
            tr.instant("mark", n=2)
        with tr.span("inner2"):
            pass
    t0 = lib.trace.now_us()
    tr.add_span("retro", t0, t0 + 5.0, step=4)
    tr.add_event({"name": "lane", "ph": "b", "cat": "request", "id": "r1",
                  "ts": lib.trace.now_us()})
    assert lib.trace.active_tracer() is None
    with lib.trace.activated(tr):
        lib.trace.instant("routed", x=1)
        with lib.trace.span("routed_span"):
            pass
    assert lib.trace.active_tracer() is None
    lib.trace.instant("dropped")        # nothing active: a no-op
    off = lib.trace.Tracer(enabled=False)
    with off.span("nothing"):
        off.instant("nothing")
    assert off.events() == [e for e in off.events() if e["ph"] == "M"]
    return tr


def _shape(events):
    """Events without times and thread ids, each X event with the name
    of the innermost X event containing it."""
    xs = [e for e in events if e["ph"] == "X"]

    def parent(e):
        inside = [o for o in xs if o is not e and o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(inside, key=lambda o: o["dur"])["name"] if inside \
            else None

    out = []
    for e in events:
        row = {k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
        if e["ph"] == "X":
            row["parent"] = parent(e)
        out.append(row)
    return out


def test_trace_events_match_by_name_args_and_nesting(tmp_path):
    jtr, ttr = _trace_ops(jobs), _trace_ops(tobs)
    assert _shape(ttr.events()) == _shape(jtr.events())
    shape = {e["name"]: e.get("parent") for e in _shape(ttr.events())
             if e["ph"] == "X"}
    assert shape == {"inner": "outer", "inner2": "outer", "outer": None,
                     "retro": None, "routed_span": None}
    assert ttr.instant_counts == jtr.instant_counts == {"mark": 1,
                                                        "routed": 1}
    path = ttr.save(str(tmp_path / "t" / "trace.json"))
    doc = json.loads(open(path).read())
    assert doc["displayTimeUnit"] == "ms"
    assert [e["name"] for e in doc["traceEvents"]] == \
        [e["name"] for e in ttr.events()]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_metrics_server_serves_metrics_healthz_statusz():
    jreg, treg = _registry_ops(jobs), _registry_ops(tobs)
    healthy = [True]

    def health():
        if not healthy[0]:
            raise RuntimeError("card lost")
        return {"status": "ok", "slots": 8}

    tsrv = tobs.MetricsServer(treg, port=0, health_fn=health,
                              statusz_fn=lambda: {"engine": "idle"}).start()
    jsrv = jobs.MetricsServer(jreg, port=0).start()
    try:
        assert tsrv.host == "127.0.0.1" and tsrv.port > 0
        code, ctype, body = _get(tsrv.url + "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body == _get(jsrv.url + "/metrics")[2] == \
            treg.expose().encode()
        code, _, body = _get(tsrv.url + "/healthz")
        assert code == 200 and json.loads(body) == {"status": "ok",
                                                    "slots": 8}
        healthy[0] = False
        code, _, body = _get(tsrv.url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "error"
        code, _, body = _get(tsrv.url + "/statusz")
        doc = json.loads(body)
        assert code == 200 and doc["engine"] == "idle"
        assert set(doc["reqtrace"]) == {"enabled", "live", "completed_ring",
                                        "forensics"}
        assert _get(tsrv.url + "/nothing")[0] == 404
    finally:
        tsrv.stop()
        jsrv.stop()
    assert tsrv._thread is None


def _models():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position, dropout_rate=0.0)
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _batches(n=6):
    rng = np.random.default_rng(4)
    return [rng.integers(0, 512, (2, 17)).astype(np.int32) for _ in range(n)]


def _telemetry_session(obs, train, state, step, to_batch, tmp):
    tele = obs.Telemetry(trace_dir=str(tmp / "trace"), metrics_port=0,
                         registry=obs.Registry())
    hooks = [train.StopAtStepHook(last_step=6),
             train.CheckpointHook(every_steps=3, every_secs=None),
             train.TraceHook(tele),
             train.MetricsExportHook(tele, every_steps=2,
                                     tokens_per_step=32)]
    with train.TrainSession(state, step, checkpoint_dir=str(tmp / "ckpt"),
                            telemetry=tele, hooks=hooks) as sess:
        for ids in _batches():
            if sess.should_stop():
                break
            sess.run_step({"input_ids": to_batch(ids)})
        assert _get(tele.metrics_url())[2].decode() == \
            tele.registry.expose()
    scraped = _get(tele.metrics_url())[2].decode()     # after end()
    tele.close()
    with open(tele.trace_path) as f:
        events = json.load(f)["traceEvents"]
    return obs.parse_exposition(scraped), events


def test_session_telemetry_equals_the_jax_session(tmp_path):
    jmodel, jparams, model = _models()
    params = dict(model.named_parameters())
    opt = adamw(1e-3)
    got, tevents = _telemetry_session(
        tobs, ttrain, ttrain.TrainState.create(params, opt.init(params)),
        make_custom_train_step(model.lm_loss_fn(), opt, grad_clip_norm=1.0,
                               device_health=True),
        torch.from_numpy, tmp_path / "port")
    jo = jopt.adamw(1e-3)
    want, jevents = _telemetry_session(
        jobs, jtrain, jtrain.TrainState.create(jparams, jo.init(jparams)),
        jtrain.make_custom_train_step(jmodel.lm_loss_fn(), jo,
                                      grad_clip_norm=1.0,
                                      device_health=True),
        jnp.asarray, tmp_path / "jax")

    assert set(got) == set(want)
    assert {k: v["type"] for k, v in got.items()} == \
        {k: v["type"] for k, v in want.items()}
    for fam in got:
        assert set(got[fam]["samples"]) == set(want[fam]["samples"]), fam

    def value(fams, name, suffix=""):
        return fams[name]["samples"][(name + suffix, ())]

    for name, suffix in (("dttpu_steps_total", ""),
                         ("dttpu_step_time_seconds", "_count"),
                         ("dttpu_checkpoint_save_seconds", "_count"),
                         ("dttpu_retraces_total", ""),
                         ("dttpu_nonfinite_grads", "")):
        assert value(got, name, suffix) == value(want, name, suffix), name
    assert value(got, "dttpu_steps_total") == 6
    assert value(got, "dttpu_checkpoint_save_seconds", "_count") == 2
    assert value(got, "dttpu_retraces_total") == 0
    for name in ("dttpu_loss", "dttpu_grad_norm"):
        np.testing.assert_allclose(value(got, name), value(want, name),
                                   atol=TOL, rtol=TOL, err_msg=name)
    assert value(got, "dttpu_live_arrays_bytes") == 0     # no card here
    assert value(want, "dttpu_live_arrays_bytes") > 0

    def spans(events):
        return collections.Counter(e["name"] for e in events
                                   if e["ph"] in ("X", "i"))

    assert spans(tevents) == spans(jevents)
    assert spans(tevents) == {"data_load": 6, "step": 6, "dispatch": 6,
                              "checkpoint": 2, "session_begin": 1,
                              "session_end": 1}
    steps = [e["args"]["step"] for e in tevents
             if e["ph"] == "X" and e["name"] == "step"]
    assert steps == [1, 2, 3, 4, 5, 6]
