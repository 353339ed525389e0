"""The port's fleet simulator (``fleet/sim.py``) held against the JAX
package's, and the contracts of ``tests/test_fleet_sim.py`` on the port.

* The same seeded ``workload.synthesize`` traces through both packages'
  ``FleetSim``, with the same explicit ``HardwarePoint`` and analytic
  ``CostModel``: the report dicts, the event logs, the router placements
  and the fleet series are EQUAL, on traces with and without adapters
  (the sim's prefix cache has one namespace, so the port's router scores
  an adapter request as the reference's does), under the autoscaler, the
  watchdog, a correlated kill, a wedge, a fair-share policy, blind
  placement and a tight SLO.
* The sampled request lanes on virtual time equal the reference's, event
  for event.
* The cost side: ``Cost`` and ``CostModel.analytic``/``calibrate`` equal
  the reference's, ``from_targets`` raises, the calibration's good fit
  and its ill-conditioned fallback.
* Each contract of ``tests/test_fleet_sim.py``: seed determinism, a new
  seed changes arrivals, ``EngineProtocol`` for ``SimEngine`` and for the
  port's real ``Engine`` (on the CPU), the router's refusal of a
  non-engine, the correlated kill healed by the autoscaler floor, the
  wedged replica quarantined on virtual time, and the two lane tests.

The lane tests configure the request-trace ring themselves: it is
process-global, and a test that shrinks it (a ring-bound test) would
otherwise leave a small ring to whatever runs next in the process.
"""
import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import fleet as jfleet
from distributed_tensorflow_tpu.analysis import graph as jgraph
from distributed_tensorflow_tpu.fleet import sim as jsim
from distributed_tensorflow_tpu.obs import metrics as jmetrics
from distributed_tensorflow_tpu.obs import reqtrace as jreqtrace
from distributed_tensorflow_tpu.obs import trace as jtrace
from distributed_tensorflow_tpu_torch import Engine, GPT, gpt_tiny
from distributed_tensorflow_tpu_torch import fleet as tfleet
from distributed_tensorflow_tpu_torch.fleet import sim as tsim
from distributed_tensorflow_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_tpu_torch.obs import reqtrace as treqtrace
from distributed_tensorflow_tpu_torch.obs import trace as ttrace

torch.set_num_threads(1)

# the reference's default point, passed explicitly to both packages (the
# port's default is the H100's)
_HW = dict(peak_flops=180e12, peak_bw=820e9, overhead_s=50e-6)
_H100 = dict(peak_flops=989e12, peak_bw=3.35e12, overhead_s=50e-6)
_ENGINE = dict(num_slots=4, prefill_chunk=16, tick_steps=4)
_PKGS = {"jax": (jfleet, jsim, jmetrics), "torch": (tfleet, tsim, tmetrics)}


def _cost_model(sim, hw=_HW):
    return sim.CostModel.analytic(n_params=1.0e8, prefill_chunk=16,
                                  num_slots=4, tick_steps=4,
                                  hw=sim.HardwarePoint(**hw))


def _sim(pkg, trace_kw, events=None, hw=_HW, policy=None, slo=(2.0, 0.05),
         sim_cls=None, **kw):
    fleet, sim, _ = _PKGS[pkg]
    trace = fleet.synthesize(**trace_kw)
    if events is not None:
        trace = dataclasses.replace(trace, events=tuple(
            fleet.FleetEvent(**e) for e in events))
    kw.setdefault("replicas", 2)
    kw.setdefault("engine", dict(_ENGINE))
    if policy is not None:
        kw["policy"] = fleet.TenantPolicy(
            {name: fleet.TenantQuota(weight=w) for name, w in policy.items()},
            quantum=8)
    return trace, (sim_cls or sim.FleetSim)(
        trace, _cost_model(sim, hw),
        slo=fleet.SLO(ttft_s=slo[0], itl_s=slo[1]), **kw)


def _series(pkg, reg):
    """The fleet's counters and gauges (timings excluded)."""
    metrics = _PKGS[pkg][2]
    fams = metrics.parse_exposition(reg.expose())
    return {(s, lbls): v for name, fam in fams.items()
            if name.startswith(("dttpu_router_", "dttpu_migrations",
                                "dttpu_watchdog", "dttpu_autoscaler_",
                                "dttpu_faults_"))
            and "seconds" not in name
            for (s, lbls), v in fam["samples"].items()}


def _run(pkg, trace_kw, **kw):
    trace, fs = _sim(pkg, trace_kw, **kw)
    rep = fs.run()
    return dict(report=rep, log=list(fs.event_log),
                placements=list(fs.router.placements),
                series=_series(pkg, fs.registry),
                fingerprint=trace.fingerprint())


_AUTO = dict(min_replicas=2, max_replicas=4, eval_interval_s=5.0,
             cooldown_s=10.0)
_BURSTY = dict(n_requests=2000, seed=7, horizon_s=90.0, bursts=2,
               burst_magnitude=4.0, failures=1, failure_k=1)
_WEDGE = [dict(at_s=5.0, kind="wedge_replica", seconds=30.0)]
_CASES = {
    "autoscaler_watchdog_no_adapters": dict(
        trace_kw=dict(_BURSTY, adapter_fraction=0.0), autoscaler=_AUTO,
        watchdog=dict(tick_deadline_s=2.0), seed=3),
    "autoscaler_watchdog_adapters": dict(
        trace_kw=dict(_BURSTY), autoscaler=_AUTO,
        watchdog=dict(tick_deadline_s=2.0), seed=3),
    "correlated_kill": dict(
        trace_kw=dict(n_requests=1500, seed=5, horizon_s=60.0, bursts=0,
                      failures=1, failure_k=2),
        autoscaler=dict(min_replicas=2, max_replicas=3, eval_interval_s=2.0,
                        cooldown_s=5.0), seed=1),
    "wedge_quarantine": dict(
        trace_kw=dict(n_requests=600, seed=2, horizon_s=40.0, bursts=0,
                      failures=0, adapter_fraction=0.0),
        events=_WEDGE, watchdog=dict(tick_deadline_s=1.0), seed=4),
    "fair_share_tight_slo_h100": dict(
        trace_kw=dict(n_requests=2000, seed=11, horizon_s=20.0, bursts=1,
                      burst_magnitude=6.0, adapter_fraction=0.0),
        hw=_H100, policy={"interactive": 2.0, "batch": 1.0, "free": 0.5},
        slo=(0.05, 0.002), replicas=1, inflight_cap_per_replica=12,
        quantum_s=0.01),
    "blind_static_dead_fleet": dict(
        trace_kw=dict(n_requests=800, seed=9, horizon_s=30.0, failures=1,
                      failure_k=2), affinity_weight=0.0, seed=2),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fleet_sim_equals_the_reference(case):
    """Reports, event logs, placements and series: equal, exactly."""
    kw = _CASES[case]
    ref = _run("jax", **kw)
    got = _run("torch", **kw)
    assert got["fingerprint"] == ref["fingerprint"]
    assert got["report"] == ref["report"]
    assert got["log"] == ref["log"]
    assert got["placements"] == ref["placements"]
    assert got["series"] == ref["series"]
    assert got["report"]["simulated_requests"] > 0


def test_adapter_traces_score_adapter_requests_as_the_reference():
    """On a trace with adapters an adapter request gets the affinity
    credit the reference gives it (the sim's cache has one namespace):
    the placements equal the reference's, and differ from those of
    engines that scored adapters in namespaces of their own, so the
    credit is what decides them."""
    kw = _CASES["autoscaler_watchdog_adapters"]
    trace, fs = _sim("torch", **kw)
    assert (trace.adapter >= 0).any() and (trace.prefix_id > 0).any()
    assert fs.make_engine().prefix_namespace("ad0") == b""

    class OwnNamespace(tsim.SimEngine):
        def prefix_namespace(self, adapter_id):
            return b"" if adapter_id is None else None

    class OwnNamespaceSim(tsim.FleetSim):
        def make_engine(self):
            eng = super().make_engine()
            eng.__class__ = OwnNamespace
            return eng

    ref = _run("jax", **kw)
    _, own = _sim("torch", sim_cls=OwnNamespaceSim, **kw)
    own.run()
    assert _run("torch", **kw)["placements"] == ref["placements"]
    assert list(own.router.placements) != ref["placements"]


def test_cost_side_equals_the_reference():
    for kw in (dict(n_params=1e8, prefill_chunk=16, num_slots=4,
                    tick_steps=4),
               dict(n_params=124e6, prefill_chunk=32, num_slots=8,
                    tick_steps=8, dtype_bytes=2)):
        for hw in (_HW, _H100):
            a = jsim.CostModel.analytic(hw=jsim.HardwarePoint(**hw), **kw)
            b = tsim.CostModel.analytic(hw=tsim.HardwarePoint(**hw), **kw)
            assert (b.prefill_window_s, b.decode_tick_s, b.overhead_s,
                    b.provenance) == (a.prefill_window_s, a.decode_tick_s,
                                      a.overhead_s, a.provenance)
    for f in ((1e9, 4e9, 2e-3, 5e-3), (1e9, 1.01e9, 1e-3, 3e-3),
              (2e9, 1e9, 1e-3, 3e-3), (1e9, 4e9, 5e-3, 5e-3)):
        a = jsim.CostModel.calibrate(jgraph.Cost(f[0], 0.0, 0.0),
                                     jgraph.Cost(f[1], 0.0, 0.0), *f[2:])
        b = tsim.CostModel.calibrate(tsim.Cost(f[0], 0.0, 0.0),
                                     tsim.Cost(f[1], 0.0, 0.0), *f[2:])
        assert repr(b) == repr(a)
        assert (b.prefill_window_s, b.decode_tick_s) == (
            a.prefill_window_s, a.decode_tick_s)
    c, j = tsim.Cost(3e9, 2e8, 1e6), jgraph.Cost(3e9, 2e8, 1e6)
    assert c.intensity == j.intensity
    assert c.time_s(1e12, 1e11, 1e-5) == j.time_s(1e12, 1e11, 1e-5)
    hw = tsim.HardwarePoint()
    assert (hw.peak_flops, hw.peak_bw) == (989e12, 3.35e12)


def test_tick_order():
    """One request of two windows behind one of one window, 10 tokens
    each, 8 steps a tick: each first token at the end of the tick of its
    last window, decoding from the next tick (the reference's order)."""
    cm = tsim.CostModel(prefill_window_s=0.01, decode_tick_s=0.1,
                        overhead_s=0.001)
    eng = tsim.SimEngine(cm, num_slots=2, prefill_chunk=16, tick_steps=8)
    other = eng.submit(16, 10)
    r = eng.submit(32, 10)
    got = []
    while eng.busy:
        eng.step()
        got.append((round(eng.vt, 6), r.emitted, other.emitted))
    assert got == [(0.021, 0, 1), (0.132, 1, 9), (0.233, 9, 10),
                   (0.334, 10, 10)]
    assert other.ttft_s == pytest.approx(0.021)
    assert r.ttft_s == pytest.approx(0.132)
    assert eng.stats().inflight == 0 and eng.stats().active == 0
    ref = jsim.SimEngine(jsim.CostModel(0.01, 0.1, overhead_s=0.001),
                         num_slots=2, prefill_chunk=16, tick_steps=8)
    hs = [ref.submit(16, 10), ref.submit(32, 10)]
    ref.drain()
    assert [h.ttft_s for h in hs] == [other.ttft_s, r.ttft_s]


def test_from_targets_refuses():
    with pytest.raises(NotImplementedError, match="graph tier"):
        tsim.CostModel.from_targets([])


# ---------------------------------------------------------------------------
# the contracts of tests/test_fleet_sim.py, on the port


def test_same_seeds_reproduce_run_bit_identically():
    kw = _CASES["autoscaler_watchdog_adapters"]
    a, b = _run("torch", **kw), _run("torch", **kw)
    assert a == b
    assert a["report"]["completed"] > 0


def test_different_trace_seed_changes_arrivals():
    a = tfleet.synthesize(500, seed=0, horizon_s=30.0)
    b = tfleet.synthesize(500, seed=1, horizon_s=30.0)
    c = tfleet.synthesize(500, seed=0, horizon_s=30.0)
    assert a.fingerprint() != b.fingerprint()
    assert a.fingerprint() == c.fingerprint()
    assert not np.array_equal(a.arrival_s, b.arrival_s)


def test_sim_engine_satisfies_engine_protocol():
    eng = tsim.SimEngine(_cost_model(tsim), num_slots=2)
    assert isinstance(eng, tfleet.EngineProtocol)
    for name in ("export_inflight", "export_wire_pages", "import_wire_pages",
                 "inflight_trace_ids", "wedge", "prefix_namespace"):
        assert callable(getattr(eng, name))


def test_real_engine_satisfies_engine_protocol():
    eng = Engine(GPT(gpt_tiny(), device="cpu"), device="cpu", num_slots=2,
                 max_len=32, prefill_chunk=4, tick_steps=2)
    assert isinstance(eng, tfleet.EngineProtocol)


def test_router_rejects_non_engine():
    class Bogus:
        def submit(self, *a, **k):
            pass

    router = tfleet.Router(registry=tmetrics.Registry())
    with pytest.raises(TypeError, match="EngineProtocol"):
        router.add_replica(Bogus())


def test_correlated_kill_healed_by_autoscaler_floor():
    trace, fs = _sim("torch", **_CASES["correlated_kill"])
    assert any(e.kind == "correlated_kill" for e in trace.events)
    rep = fs.run()
    assert rep["correlated_kills_armed"] == 1
    assert rep["replicas_final"] >= 2
    assert rep["scale_outs"] >= 1
    assert (rep["completed"] + rep["deadline_exceeded"] + rep["lost"]
            == rep["simulated_requests"] == len(trace))
    assert any(e[0] == "correlated_kill" for e in fs.event_log)


def test_wedged_replica_quarantined_on_virtual_time():
    trace, fs = _sim("torch", **_CASES["wedge_quarantine"])
    rep = fs.run()
    assert rep["quarantines"] >= 1
    assert any(e[0] == "wedge" for e in fs.event_log)
    assert any(e[0] == "quarantine" for e in fs.event_log)
    assert rep["completed"] + rep["deadline_exceeded"] == len(trace)
    assert rep["migrations"] >= 1


def test_calibrate_good_fit_reproduces_measured_points():
    cm = tsim.CostModel.calibrate(tsim.Cost(1.0e9, 0.0, 0.0),
                                  tsim.Cost(4.0e9, 0.0, 0.0),
                                  measured_window_s=0.002,
                                  measured_tick_s=0.005)
    assert cm.provenance == "calibrated"
    assert cm.prefill_window_s == pytest.approx(0.002)
    assert cm.decode_tick_s == pytest.approx(0.005)


def test_calibrate_rejects_ill_conditioned_fit():
    cm = tsim.CostModel.calibrate(tsim.Cost(1.00e9, 0.0, 0.0),
                                  tsim.Cost(1.01e9, 0.0, 0.0),
                                  measured_window_s=0.001,
                                  measured_tick_s=0.003)
    assert cm.provenance == "measured"
    assert cm.prefill_window_s == pytest.approx(0.001)
    assert cm.decode_tick_s == pytest.approx(0.003)


# ---------------------------------------------------------------------------
# sampled request lanes on virtual time


class _Lanes:
    """A package's request tracing, isolated: its ring reset to 1024
    entries, a fresh tracer active; the previous tracer put back after."""

    def __init__(self, reqtrace, trace):
        self.reqtrace, self.trace = reqtrace, trace

    def __enter__(self):
        self.reqtrace.reset()
        self.reqtrace.configure(ring=1024, forensics=64)
        self.prev = self.trace.active_tracer()
        self.tracer = self.trace.activate(self.trace.Tracer(enabled=True))
        return self.reqtrace

    def __exit__(self, *exc):
        self.trace.deactivate(self.tracer)
        if self.prev is not None:
            self.trace.activate(self.prev)
        self.reqtrace.reset()
        self.reqtrace.configure(ring=256)


_LANES = {"jax": (jreqtrace, jtrace), "torch": (treqtrace, ttrace)}
_LANE_CASES = {
    "sampled": dict(trace_kw=dict(n_requests=400, seed=3, horizon_s=30.0,
                                  bursts=0, failures=0),
                    engine=dict(_ENGINE, trace_sample=8), seed=1),
    "migrated": dict(trace_kw=dict(n_requests=600, seed=2, horizon_s=40.0,
                                   bursts=0, failures=0),
                     events=_WEDGE, engine=dict(_ENGINE, trace_sample=4),
                     watchdog=dict(tick_deadline_s=1.0), seed=4),
}


def _lanes(pkg, case):
    """(trace, report, completed lanes, the first lanes' trees) of one
    lane case, with the package's request tracing isolated."""
    with _Lanes(*_LANES[pkg]) as reqtrace:
        trace, fs = _sim(pkg, **_LANE_CASES[case])
        rep = fs.run()
        lanes = reqtrace.completed()
        trees = [reqtrace.tree(r["trace_id"]) for r in lanes[:10]]
        return trace, rep, lanes, trees


def test_sim_emits_sampled_request_lanes_on_virtual_time():
    """Router-minted ids are kept 1-in-``trace_sample``; a kept lane
    carries the lifecycle vocabulary on VIRTUAL timestamps (the run spans
    ~30 virtual seconds)."""
    trace, rep, lanes, trees = _lanes("torch", "sampled")
    assert rep["completed"] == len(trace)
    assert 20 <= len(lanes) <= 80
    for rec, t in zip(lanes[:10], trees):
        names = [e["name"] for e in rec["events"]]
        assert names[0] == "request" and "prefill" in names
        assert all(0 <= e["ts"] < 300e6 for e in rec["events"])
        (root,) = t["spans"]
        assert root["args"]["status"] == "ok"


def test_sim_migrated_lane_survives_hop_without_resampling():
    """A wedge-driven migration: every sampled victim lane continues on
    the survivor under the SAME id, never re-rolled by its sampler."""
    _, rep, lanes, _ = _lanes("torch", "migrated")
    assert rep["migrations"] >= 1
    migrated = [r for r in lanes if r["hops"] >= 1]
    assert migrated, "no sampled lane crossed the hop"
    for rec in migrated:
        flow = [e["ph"] for e in rec["events"]
                if e["cat"] == treqtrace.FLOW_CAT]
        assert flow == ["s", "f"] * rec["hops"]
        assert rec["status"] in ("ok", "deadline_exceeded")


@pytest.mark.parametrize("case", sorted(_LANE_CASES))
def test_lanes_equal_the_reference(case):
    """Every sampled lane, event for event, equals the reference's (the
    trace ids embed this process's id and each package's own sequence)."""
    ref = _lanes("jax", case)
    got = _lanes("torch", case)
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    assert got[3] == ref[3]
    assert len(got[2]) > 0
