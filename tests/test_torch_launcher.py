"""The port's supervised launcher (``fleet/launcher.py``) held against the
JAX package's.

* Both packages' ``Launcher`` run under the same scripted fake ``popen``,
  ``clock`` and ``sleep`` (the harness of ``tests/test_launcher.py``), and
  report the same: ``report()``, spawn counts, backoff due times (seeded
  jitter included), chief elections, the fault plan's log and the values
  of the ``dttpu_launcher_*`` series, after every pass, over: a clean
  completion, a legacy ps exit, an unknown code, a listed transient code,
  a signal death with backoff, the restart budget running out, the chief
  re-elected on host 0's loss, a restarting chief keeping its title, a
  stale heartbeat, a missing heartbeat file's grace, and a ``kill_host``
  chaos kill.
* ``local_topology``'s env, the refusals of empty and duplicate hosts and
  the heartbeat helper equal the reference's.
* The wire cut plus the host kill, one fault plan driving both sites: a
  request migrated over the port's ``PageWire`` while its wire is cut
  ends with the tokens of an unmigrated run, while the launcher's poll
  SIGKILLs and restarts the host.
* Real ``subprocess.Popen``, with a ``jax`` on the children's path that
  refuses to import: the entry point ``examples.launch_multihost_smoke``
  brings up a two-host gloo group on the CPU that completes, and a child
  that kills itself with a signal is restarted.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import fleet as jfleet
from distributed_tensorflow_tpu.fleet import launcher as jlauncher
from distributed_tensorflow_tpu.obs import metrics as jmetrics
from distributed_tensorflow_tpu.parallel import cluster as jcluster
from distributed_tensorflow_tpu.resilience import faults as jfaults
from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
from distributed_tensorflow_tpu_torch import fleet as tfleet
from distributed_tensorflow_tpu_torch.fleet import launcher as tlauncher
from distributed_tensorflow_tpu_torch.fleet import pagewire as twire
from distributed_tensorflow_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_tpu_torch.parallel import cluster as tcluster
from distributed_tensorflow_tpu_torch.resilience import faults as tfaults

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKGS = {"jax": (jfleet, jlauncher, jmetrics, jfaults, jcluster),
         "torch": (tfleet, tlauncher, tmetrics, tfaults, tcluster)}
_FOREVER = 10 ** 9


class _FakeProc:
    """One fake child: None for ``polls_alive`` polls, then its exit code;
    ``kill()`` forces a signal death at once."""

    def __init__(self, rc=0, polls_alive=0):
        self._rc = rc
        self._alive = polls_alive
        self.killed = False

    def poll(self):
        if self.killed:
            return self._rc
        if self._alive > 0:
            self._alive -= 1
            return None
        return self._rc

    def kill(self):
        self.killed = True
        self._rc = -9

    def wait(self, timeout=None):
        return self.poll()


class _Backend:
    """Injectable popen: a list of (rc, polls alive) a host, one consumed a
    spawn (past the list a child runs forever)."""

    def __init__(self, script):
        self.script = {hid: list(procs) for hid, procs in script.items()}
        self.spawns = {hid: 0 for hid in script}

    def __call__(self, spec):
        hid = spec.host_id
        self.spawns[hid] = self.spawns.get(hid, 0) + 1
        seq = self.script.get(hid, [])
        if self.spawns[hid] <= len(seq):
            return _FakeProc(*seq[self.spawns[hid] - 1])
        return _FakeProc(0, _FOREVER)


class _FakeTime:
    def __init__(self):
        self.now = 0.0
        self.slept = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s


class _Case:
    """One package's launcher under a script, and what it reports."""

    def __init__(self, pkg, script, hosts=None, faults=None, **kw):
        fleet, _, metrics, faults_lib, _ = _PKGS[pkg]
        self.pkg = pkg
        self.ft = _FakeTime()
        self.backend = _Backend(script)
        self.reg = metrics.Registry()
        kw.setdefault("jitter", 0.0)
        kw.setdefault("backoff_base_s", 0.01)
        kw.setdefault("poll_interval_s", 0.01)
        hosts = hosts if hosts is not None else [
            dict(host_id=i, argv=("true",), env={}) for i in range(2)]
        self.lc = fleet.Launcher([fleet.HostSpec(**h) for h in hosts],
                                 registry=self.reg, popen=self.backend,
                                 sleep=self.ft.sleep, clock=self.ft.clock,
                                 **kw)
        self.plan = (None if faults is None else faults_lib.FaultPlan(
            faults, registry=metrics.Registry()))
        self.trail = []

    def note(self, what):
        lc = self.lc
        self.trail.append((
            what, self.ft.now, lc.chief_id, list(lc.elections),
            {k: (v["status"], v["restarts"]) for k, v in
             lc.report().items() if k >= 0},
            {hid: h.due_at for hid, h in lc._hosts.items()},
            dict(self.backend.spawns)))

    def observed(self):
        fams = _PKGS[self.pkg][2].parse_exposition(self.reg.expose())
        series = {s: v for name, fam in fams.items()
                  if name.startswith("dttpu_launcher_")
                  for (s, _), v in fam["samples"].items()}
        return dict(report=self.lc.report(), trail=self.trail,
                    spawns=dict(self.backend.spawns), slept=self.ft.slept,
                    succeeded=self.lc.succeeded, series=series,
                    plan_log=None if self.plan is None else self.plan.log)


def _wait(c):
    c.lc.start()
    c.note("start")
    assert c.lc.wait(timeout_s=60.0) is True
    c.note("wait")


def _polls(*steps):
    """start, then each step: "poll", a float (advance the clock), "wait"
    or "stop"; the state noted after each."""
    def drive(c):
        c.lc.start()
        c.note("start")
        for s in steps:
            if s == "poll":
                c.lc.poll()
            elif s == "wait":
                assert c.lc.wait(timeout_s=60.0) is True
            elif s == "stop":
                c.lc.stop()
            else:
                c.ft.now += s
            c.note(s)
    return drive


def _stale_heartbeat(hb_dir):
    hb = os.path.join(hb_dir, "host0.hb")
    open(hb, "w").close()
    stale = time.time() - 100.0
    os.utime(hb, (stale, stale))

    def drive(c):
        c.lc.start()
        c.lc.poll()                          # stale -> kill -> backoff
        c.note("stale")
        os.utime(hb, None)                   # the child ticks again
        c.lc._hosts[0].due_at = 0.0          # backoff due at once
        c.lc.poll()                          # respawn
        c.note("respawn")
        c.lc.poll()                          # fresh heartbeat: healthy
        c.note("healthy")
        c.lc.stop()
        c.note("stop")
    return hb, drive


_PS = 64
_SCRIPTS = {
    "clean": (dict(script={0: [(0, 0)], 1: [(0, 0)]}), _wait),
    "legacy_ps": (dict(script={0: [(0, 0)], 1: [(_PS, 0)]}), _wait),
    "unknown_code": (dict(script={0: [(3, 0)], 1: [(0, 0)]}), _wait),
    "listed_transient": (dict(script={0: [(75, 0), (0, 0)], 1: [(0, 0)]},
                              transient_exit_codes=(75,)), _wait),
    "signal_backoff_jitter": (
        dict(script={0: [(-9, 0), (-15, 0), (0, 0)], 1: [(0, 0)]},
             backoff_base_s=1.0, backoff_factor=2.0, jitter=0.5, seed=7),
        _polls("poll", "poll", 1.5, "poll", "wait")),
    "budget_exhausted": (dict(script={0: [(-9, 0), (-9, 0)], 1: [(0, 0)]},
                              max_restarts=1), _wait),
    "chief_reelection": (dict(script={0: [(1, 0)], 1: [(0, _FOREVER)]}),
                         _polls("poll", "stop")),
    "restarting_chief": (dict(script={0: [(-9, 0), (0, _FOREVER)],
                                      1: [(0, _FOREVER)]}),
                         _polls("poll", "stop")),
    "kill_host": (dict(script={0: [(0, _FOREVER), (0, _FOREVER)],
                               1: [(0, _FOREVER)]},
                       faults=[{"kind": "kill_host", "at": 2,
                                "replica": 0}]),
                  _polls("poll", "poll", "poll", 1.0, "poll", "stop")),
}


def _scripted(pkg, case, tmp):
    if case == "stale_heartbeat":
        hb, drive = _stale_heartbeat(tmp)
        kw = dict(script={0: [(0, _FOREVER), (0, _FOREVER)]},
                  hosts=[dict(host_id=0, argv=("true",),
                              env={"DTTPU_HEARTBEAT_FILE": hb})],
                  heartbeat_timeout_s=5.0)
    elif case == "missing_heartbeat_grace":
        kw = dict(script={0: [(0, _FOREVER)]},
                  hosts=[dict(host_id=0, argv=("true",), env={
                      "DTTPU_HEARTBEAT_FILE": os.path.join(tmp, "never")})],
                  heartbeat_timeout_s=1.0, heartbeat_grace_s=5.0)
        drive = _polls("poll", 10.0, "poll", "stop")
    else:
        kw, drive = _SCRIPTS[case]
        kw = dict(kw)
    c = _Case(pkg, **kw)
    if c.plan is not None:
        with _PKGS[pkg][3].activated(c.plan):
            drive(c)
    else:
        drive(c)
    return c.observed()


@pytest.mark.parametrize("case", sorted(_SCRIPTS) + [
    "stale_heartbeat", "missing_heartbeat_grace"])
def test_scripted_supervision_equals_the_reference(case, tmp_path):
    for pkg in _PKGS:
        (tmp_path / pkg).mkdir()
    ref = _scripted("jax", case, str(tmp_path / "jax"))
    got = _scripted("torch", case, str(tmp_path / "torch"))
    assert got == ref
    rep = got["report"]
    # each case's own verdict, as tests/test_launcher.py pins it
    if case == "clean":
        assert got["succeeded"] and rep[0]["reason"] == "completed"
        assert rep[-1]["elections"] == []
    elif case == "legacy_ps":
        assert rep[1]["status"] == "fatal" and rep[1]["restarts"] == 0
        assert "JOB_NAME=ps" in rep[1]["reason"]
        assert rep[1]["exit_history"] == [tcluster.LEGACY_PS_EXIT_CODE]
    elif case == "unknown_code":
        assert "exit code 3" in rep[0]["reason"]
    elif case == "listed_transient":
        assert got["succeeded"] and rep[0]["exit_history"] == [75, 0]
    elif case == "signal_backoff_jitter":
        assert rep[0]["exit_history"] == [-9, -15, 0]
        # spawns after start, two polls in backoff, the clock past the
        # due time, the poll that respawns
        assert [t[6][0] for t in got["trail"][:5]] == [1, 1, 1, 1, 2]
        due = got["trail"][1][5][0]
        assert 1.0 <= due < 1.5               # base 1.0, jitter up to 0.5
    elif case == "budget_exhausted":
        assert "restart budget exhausted" in rep[0]["reason"]
    elif case == "chief_reelection":
        assert rep[-1]["elections"] == [(0, 1)]
        assert got["series"]["dttpu_launcher_chief_elections_total"] == 1
    elif case == "restarting_chief":
        assert got["trail"][1][2] == 0 and got["trail"][1][3] == []
    elif case == "kill_host":
        assert got["plan_log"] == [{"kind": "kill_host", "at": 2, "host": 0,
                                    "poll": 2}]
        assert got["spawns"] == {0: 2, 1: 1}
        assert all(d["status"] == "done"
                   for h, d in rep.items() if h >= 0)
    elif case == "stale_heartbeat":
        assert got["series"]["dttpu_launcher_heartbeat_missed_total"] == 1
        assert rep[0]["exit_history"] == [-9] and got["spawns"] == {0: 2}
    elif case == "missing_heartbeat_grace":
        assert [t[4][0][1] for t in got["trail"][:4]] == [0, 0, 0, 1]


def test_local_topology_and_refusals_equal_the_reference(tmp_path):
    args = (2, [sys.executable, "-c", "pass"], 12345)
    kw = dict(extra_env={"X": "1"}, heartbeat_dir=str(tmp_path))
    ref = jlauncher.local_topology(*args, **kw)
    got = tlauncher.local_topology(*args, **kw)
    assert [(s.host_id, tuple(s.argv), s.env) for s in got] == \
        [(s.host_id, tuple(s.argv), s.env) for s in ref]
    assert got[1].env["DTTPU_HEARTBEAT_FILE"].endswith("host1.hb")
    cfg = tcluster.cluster_from_env(environ=got[1].env)
    assert cfg.process_id == 1 and cfg.num_processes == 2
    for bad, match in (([], "at least one"),
                       ([0, 0], "duplicate host ids")):
        for fleet in (jfleet, tfleet):
            with pytest.raises(ValueError, match=match):
                fleet.Launcher([fleet.HostSpec(h, ("true",)) for h in bad])


def test_heartbeat_helper_touches_file(tmp_path):
    hb = tmp_path / "h.hb"
    tlauncher.heartbeat(environ={})
    assert not hb.exists()
    tlauncher.heartbeat(environ={"DTTPU_HEARTBEAT_FILE": str(hb)})
    assert hb.exists()
    old = time.time() - 50.0
    os.utime(hb, (old, old))
    tlauncher.heartbeat(environ={"DTTPU_HEARTBEAT_FILE": str(hb)})
    assert time.time() - os.path.getmtime(hb) < 10.0


# ---------------------------------------------------------------------------
# the wire cut and the host kill, one fault plan (tests/test_pagewire.py)


def _tiny_model():
    """``gpt_tiny`` with its weight matrices scaled 5x, so that greedy
    tokens vary."""
    model = GPT(gpt_tiny(dropout_rate=0.0), device="cpu",
                generator=torch.Generator().manual_seed(0))
    model.load_state_dict({k: v * 5.0 if v.ndim >= 2 else v
                           for k, v in model.state_dict().items()})
    return model


def test_kill_host_mid_transfer_launcher_restarts_request_survives():
    """The wire cut (``wire:0``) degrades the migration to a re-prefill:
    the request ends on the survivor with the tokens of an unmigrated run
    and a stream without a gap or a repeat, while the launcher's liveness
    poll (``host:0``) SIGKILLs and restarts the host process."""
    model = _tiny_model()
    kw = dict(num_slots=2, max_len=64, prefill_chunk=4, tick_steps=2)
    reg = tmetrics.Registry()
    engines = [Engine(model, device="cpu", registry=reg, **kw)
               for _ in range(2)]
    sender = twire.PageWire(chunk_pages=1, timeout_s=0.05,
                            backoff_base_s=1e-4, backoff_max_s=1e-3,
                            registry=reg)
    router = tfleet.Router(engines, registry=reg, page_wire=sender)
    page = engines[0].scheduler.page_size
    p = np.random.default_rng(321).integers(0, 512, 2 * page - 2,
                                            dtype=np.int32)
    solo = Engine(model, device="cpu", **kw)
    want = solo.submit(p, 8)
    solo.drain()

    class _Proc:
        def __init__(self):
            self.rc = None

        def poll(self):
            return self.rc

        def kill(self):
            self.rc = -9

        def wait(self, timeout=None):
            return self.rc

    t = {"now": 0.0}
    launcher = tfleet.Launcher(
        tlauncher.local_topology(1, ["true"], 9999),
        registry=reg, jitter=0.0, backoff_base_s=0.01,
        popen=lambda spec: _Proc(),
        sleep=lambda s: t.__setitem__("now", t["now"] + s),
        clock=lambda: t["now"])
    # the wire dies at its frame 1 (mid-transfer); the host fault is armed
    # at a poll index only the launcher's site reaches (the sites count
    # apart but share the pool, so the indices must not collide)
    plan = tfaults.FaultPlan(
        [{"kind": "kill_host", "at": 1, "replica": 0},
         {"kind": "kill_host", "at": 5, "replica": 0}],
        registry=tmetrics.Registry())
    stream = []
    with tfaults.activated(plan):
        launcher.start()
        h = router.submit(p, 8, on_token=stream.extend)
        while len(h.tokens) < 5:
            router.step()
        victim = h.replica_id
        assert router.drain_replica(victim, timeout_s=60) is True
        while not h.done:
            router.step()
        for _ in range(8):                   # host:0 poll 5 kills
            launcher.poll()
            t["now"] += 0.05
    router.resume_replica(victim)
    launcher.stop()
    assert {(e["kind"], "wire" in e) for e in plan.log} == \
        {("kill_host", True), ("kill_host", False)}, plan.log
    assert len(set(want.tokens)) > 1
    assert h.status == "ok" and h.tokens == want.tokens
    assert stream == want.tokens
    assert reg.get("dttpu_router_wire_degraded_total").value == 1
    rep = launcher.report()
    assert rep[0]["restarts"] == 1
    assert rep[0]["exit_history"][0] == -9


# ---------------------------------------------------------------------------
# real subprocesses: port children, no jax


@pytest.fixture
def no_jax_children(tmp_path, monkeypatch):
    """A ``PYTHONPATH`` whose ``jax`` refuses to import, for the children
    of the launcher: a port child that imported JAX, or the JAX package,
    would fail."""
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('jax refused in a port child')\n")
    monkeypatch.setenv("PYTHONPATH", str(poison.parent))
    return str(poison.parent)


def test_entry_point_two_host_tree_completes(no_jax_children, capfd):
    """``examples.launch_multihost_smoke`` on the CPU: the launcher brings
    up two children over gloo, each all-reduces its id + 1 to the exact
    sum, host 0 is the chief, and every host completes with 0 restarts."""
    from distributed_tensorflow_tpu_torch.examples import \
        launch_multihost_smoke as smoke
    assert smoke.main(["--device=cpu"]) == 0
    out = capfd.readouterr().out.splitlines()
    rep = json.loads(out[-1])
    assert rep["succeeded"] and rep["chief_at_start"] == 0
    for hid in ("0", "1"):
        assert rep["report"][hid]["status"] == "done"
        assert rep["report"][hid]["restarts"] == 0
    smokes = sorted(line.split() for line in out if line.startswith("SMOKE"))
    assert smokes == [
        ["SMOKE", "proc=0", "chief=True", "sum=3.0", "backend=gloo",
         "device=cpu"],
        ["SMOKE", "proc=1", "chief=False", "sum=3.0", "backend=gloo",
         "device=cpu"]]


def test_real_child_killed_by_signal_restarts(no_jax_children):
    """A child that SIGKILLs itself is a transient death under real
    ``Popen``; the respawned incarnation completes."""
    # the first incarnation dies at once; the second runs the port's
    # heartbeat and exits 0
    child = (
        "import os, sys, signal; "
        "d = os.environ['DTTPU_TEST_MARKER_DIR']; "
        "p = os.path.join(d, 'spawned' + os.environ['PROCESS_ID']); "
        "n = int(open(p).read()) if os.path.exists(p) else 0; "
        "open(p, 'w').write(str(n + 1)); "
        "os.kill(os.getpid(), signal.SIGKILL) if n == 0 else None; "
        "sys.path.insert(0, os.environ['DTTPU_REPO']); "
        "from distributed_tensorflow_tpu_torch.fleet import launcher; "
        "assert 'jax' not in sys.modules; launcher.heartbeat()")
    with tempfile.TemporaryDirectory() as d:
        specs = tlauncher.local_topology(
            1, [sys.executable, "-c", child], 34568,
            extra_env={"DTTPU_REPO": _REPO, "DTTPU_TEST_MARKER_DIR": d},
            heartbeat_dir=d)
        reg = tmetrics.Registry()
        lc = tfleet.Launcher(specs, registry=reg, backoff_base_s=0.02,
                             heartbeat_timeout_s=60.0, poll_interval_s=0.02)
        lc.start()
        try:
            assert lc.wait(timeout_s=120.0) is True
        finally:
            lc.stop()
        assert lc.succeeded, lc.report()
        assert lc.report()[0]["restarts"] == 1
        assert lc.report()[0]["exit_history"] == [-9, 0]
        assert open(os.path.join(d, "spawned0")).read() == "2"
        assert os.path.exists(os.path.join(d, "host0.hb"))
        assert reg.get("dttpu_launcher_restarts_total").value == 1
