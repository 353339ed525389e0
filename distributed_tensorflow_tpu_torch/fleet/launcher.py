"""Supervised multi-process launcher: spawn, watch, restart, re-elect.

Counterpart of ``distributed_tensorflow_tpu/fleet/launcher.py``, the same
supervisor over the port's processes.  ``parallel/cluster.py`` reads an
env-var topology (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID``) and ``torch.distributed`` is started from it; ``Launcher``
spawns one child for each ``HostSpec``, polls liveness, and applies
``resilience.Supervisor``'s restart discipline (transient or fatal, a
bounded number of restarts with seeded exponential backoff, an audit
trail) to PROCESSES instead of in-process sessions.

Classification of an exit code:

* ``None``: running;
* ``0``: clean completion (terminal, success);
* ``cluster.LEGACY_PS_EXIT_CODE``: **fatal with reason**, a legacy
  ``JOB_NAME=ps`` role refused to start (parallel/cluster.py); the report
  names the misconfiguration instead of counting a silent no-op as done;
* ``< 0`` (killed by a signal) or listed in ``transient_exit_codes``:
  transient, restarted with backoff until ``max_restarts`` is spent, then
  fatal ("restart budget exhausted");
* anything else: fatal (a crash a restart cannot fix).

Liveness beyond exit codes: each child gets ``DTTPU_HEARTBEAT_FILE`` and
is expected to touch it (``launcher.heartbeat()`` in its loop); a file
stale past ``heartbeat_timeout_s`` means alive-but-stuck, and the launcher
kills the child, a kill classified as a transient signal exit (restart).
``heartbeat_timeout_s=None`` (the default) trusts exit codes alone.

Chief re-election: the chief is the lowest-id LIVE host (the coordinator
convention of ``parallel/cluster.py``).  When the chief dies for good the
title moves to the next live host, and the election is counted and
logged.

Chaos: an armed ``kill_host`` fault (resilience/faults.py) matching a
host's poll (``plan.on_host_poll``) SIGKILLs the child, so the restart
path is driven by the same fault plan as the page wire's.

Threadless by design: every state change happens inside ``poll()`` on the
caller's thread (``wait()`` is a poll-sleep loop), so there is no lock to
leak and no watcher thread to join.

Series: ``dttpu_launcher_hosts``, ``dttpu_launcher_restarts_total``,
``dttpu_launcher_heartbeat_missed_total``,
``dttpu_launcher_chief_elections_total``, ``dttpu_launcher_fatal_total``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..obs import metrics as metrics_lib
from ..parallel import cluster as cluster_lib
from ..resilience import faults as faults_lib

log = logging.getLogger(__name__)

__all__ = ["HostSpec", "Launcher", "heartbeat", "local_topology"]

# exit-code classifications (Launcher._classify)
_RUNNING, _DONE, _TRANSIENT, _FATAL = "running", "done", "transient", \
    "fatal"


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One supervised host process: its integer id (== the topology's
    ``PROCESS_ID``), the argv to exec, and the env vars to merge over
    the parent's (the topology: coordinator address, process count,
    plus ``DTTPU_LAUNCHER=1`` so children know a supervisor is
    classifying their exits)."""
    host_id: int
    argv: Sequence[str]
    env: Dict[str, str] = dataclasses.field(default_factory=dict)


def heartbeat(environ=None) -> None:
    """Child-side liveness tick: touch ``DTTPU_HEARTBEAT_FILE`` (no-op
    when unset — the same child runs unsupervised).  Call it from the
    host process's main loop; the launcher reads the mtime."""
    env = os.environ if environ is None else environ
    path = env.get("DTTPU_HEARTBEAT_FILE")
    if not path:
        return
    with open(path, "a"):
        os.utime(path, None)


def local_topology(num_hosts: int, argv: Sequence[str], port: int,
                   extra_env: Optional[Dict[str, str]] = None,
                   heartbeat_dir: Optional[str] = None
                   ) -> List[HostSpec]:
    """``HostSpec``s for an N-process single-machine bring-up: the
    env-var topology ``parallel/cluster.py`` resolves (host 0 is the
    coordinator — the chief convention), one heartbeat file per host
    under ``heartbeat_dir`` when liveness polling is wanted."""
    specs = []
    for hid in range(num_hosts):
        env = {
            "COORDINATOR_ADDRESS": f"localhost:{int(port)}",
            "NUM_PROCESSES": str(int(num_hosts)),
            "PROCESS_ID": str(hid),
            "DTTPU_LAUNCHER": "1",
        }
        if heartbeat_dir is not None:
            env["DTTPU_HEARTBEAT_FILE"] = os.path.join(
                heartbeat_dir, f"host{hid}.hb")
        if extra_env:
            env.update(extra_env)
        specs.append(HostSpec(host_id=hid, argv=tuple(argv), env=env))
    return specs


class _Host:
    """Mutable supervision state for one HostSpec (launcher-internal)."""

    __slots__ = ("spec", "proc", "status", "reason", "restarts",
                 "due_at", "exit_history", "last_hb")

    def __init__(self, spec: HostSpec):
        self.spec = spec
        self.proc: Any = None
        self.status = _RUNNING          # running|backoff|done|fatal
        self.reason: Optional[str] = None
        self.restarts = 0
        self.due_at: Optional[float] = None   # backoff: restart time
        self.exit_history: List[int] = []
        self.last_hb: Optional[float] = None


def _default_popen(spec: HostSpec):
    env = dict(os.environ)
    env.update(spec.env)
    return subprocess.Popen(list(spec.argv), env=env)


class Launcher:
    """Spawn/monitor/restart the fleet's host processes (module doc).

    ``popen`` is the injectable process backend — ``spec ->`` an object
    with ``poll() -> Optional[int]``, ``kill()``, ``wait(timeout=)`` —
    defaulting to ``subprocess.Popen`` with the spec's env merged over
    the parent's.  ``sleep``/``clock`` are injectable the same way
    (tests drive fake time; ``resilience.Supervisor`` idiom).

    Lifecycle: ``start()`` spawns everyone, ``poll()`` runs ONE
    supervision pass (liveness + classification + due restarts + chief
    election) and returns True while any host is running or pending
    restart, ``wait()`` loops poll/sleep until the fleet is terminal,
    ``report()`` returns the per-host verdicts, ``stop()`` kills
    whatever still runs (terminal state ``done``, reason "stopped")."""

    def __init__(self, hosts: Sequence[HostSpec], *,
                 max_restarts: int = 3,
                 backoff_base_s: float = 0.1,
                 backoff_factor: float = 2.0,
                 backoff_max_s: float = 5.0,
                 jitter: float = 0.5,
                 seed: int = 0,
                 transient_exit_codes: Sequence[int] = (),
                 heartbeat_timeout_s: Optional[float] = None,
                 heartbeat_grace_s: float = 5.0,
                 poll_interval_s: float = 0.05,
                 registry: Optional[metrics_lib.Registry] = None,
                 popen: Callable[[HostSpec], Any] = _default_popen,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if not hosts:
            raise ValueError("Launcher needs at least one HostSpec")
        ids = [int(s.host_id) for s in hosts]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids: {sorted(ids)}")
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.transient_exit_codes = frozenset(
            int(c) for c in transient_exit_codes)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.heartbeat_grace_s = float(heartbeat_grace_s)
        self.poll_interval_s = float(poll_interval_s)
        self.popen = popen
        self.sleep = sleep
        self.clock = clock
        self._rng = np.random.default_rng(seed)
        self._hosts: Dict[int, _Host] = {
            int(s.host_id): _Host(s) for s in hosts}
        self.chief_id: Optional[int] = None
        self.elections: List[tuple] = []     # (old chief, new chief)
        self.restart_log: List[tuple] = []   # (host, attempt, reason)
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self._m_hosts = reg.gauge(
            "dttpu_launcher_hosts",
            "Host processes currently live under the launcher.")
        self._m_restarts = reg.counter(
            "dttpu_launcher_restarts_total",
            "Host processes restarted after a transient exit (signal "
            "kill, missed heartbeat, or a listed transient code).")
        self._m_hb_missed = reg.counter(
            "dttpu_launcher_heartbeat_missed_total",
            "Host processes killed for a heartbeat stale past the "
            "liveness timeout (alive-but-stuck).")
        self._m_elections = reg.counter(
            "dttpu_launcher_chief_elections_total",
            "Chief re-elections after the lowest-id live host "
            "changed.")
        self._m_fatal = reg.counter(
            "dttpu_launcher_fatal_total",
            "Host processes declared fatal (unrecoverable exit code, "
            "refused role, or restart budget exhausted).")

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        for h in self._hosts.values():
            self._spawn(h)
        self._elect()
        self._m_hosts.set(self._live_count())

    def _spawn(self, h: _Host) -> None:
        h.proc = self.popen(h.spec)
        h.status = _RUNNING
        h.due_at = None
        h.last_hb = self.clock()      # grace starts at spawn

    def _delay(self, attempt: int) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s
                   * self.backoff_factor ** (attempt - 1))
        return base * (1.0 + self.jitter * float(self._rng.random()))

    # ------------------------------------------------------ supervision

    def _classify(self, h: _Host, rc: Optional[int]) -> str:
        if rc is None:
            return _RUNNING
        if rc == 0:
            return _DONE
        if rc == cluster_lib.LEGACY_PS_EXIT_CODE:
            h.reason = ("legacy JOB_NAME=ps role refused to start "
                        "(no parameter-server role exists; "
                        "parallel/cluster.py) — fix the topology env")
            return _FATAL
        if rc < 0 or rc in self.transient_exit_codes:
            return _TRANSIENT
        h.reason = f"unrecoverable exit code {rc}"
        return _FATAL

    def _heartbeat_stale(self, h: _Host, now: float) -> bool:
        if self.heartbeat_timeout_s is None:
            return False
        path = h.spec.env.get("DTTPU_HEARTBEAT_FILE")
        if not path:
            return False
        # mtime lives on the wall clock (children touch the file with
        # utime); staleness is judged there.  Before the first touch
        # the spawn instant (launcher clock) anchors a grace window so
        # a slow-starting child is not killed for being slow.
        try:
            age = time.time() - os.path.getmtime(path)
        except OSError:
            started_ago = now - (h.last_hb if h.last_hb is not None
                                 else now)
            return started_ago > (self.heartbeat_timeout_s
                                  + self.heartbeat_grace_s)
        return age > self.heartbeat_timeout_s

    def poll(self) -> bool:
        """One supervision pass; True while any host is running or due
        a restart.  All classification and restart work happens here,
        on the caller's thread."""
        now = self.clock()
        plan = faults_lib.active()
        for hid, h in sorted(self._hosts.items()):
            if h.status == "backoff":
                if h.due_at is not None and now >= h.due_at:
                    self._spawn(h)
                continue
            if h.status in (_DONE, _FATAL) or h.proc is None:
                continue
            # chaos: an armed kill_host matching this host's poll
            # SIGKILLs the child; the kill is classified below like
            # any real signal death (restart path)
            if plan is not None and h.proc.poll() is None \
                    and plan.on_host_poll(hid) is not None:
                h.proc.kill()
                h.proc.wait(timeout=10)
            rc = h.proc.poll()
            verdict = self._classify(h, rc)
            if verdict == _RUNNING and self._heartbeat_stale(h, now):
                self._m_hb_missed.inc()
                log.warning("host %d heartbeat stale past %.1fs — "
                            "killing for restart", hid,
                            self.heartbeat_timeout_s)
                h.proc.kill()
                h.proc.wait(timeout=10)
                verdict = self._classify(h, h.proc.poll())
            if verdict == _RUNNING:
                continue
            h.exit_history.append(int(rc if rc is not None else -9))
            if verdict == _DONE:
                h.status = _DONE
                h.reason = "completed"
            elif verdict == _FATAL:
                h.status = _FATAL
                self._m_fatal.inc()
                log.error("host %d fatal: %s", hid, h.reason)
            else:                                   # transient
                if h.restarts >= self.max_restarts:
                    h.status = _FATAL
                    h.reason = (f"restart budget exhausted "
                                f"({self.max_restarts}) after exit "
                                f"{rc}")
                    self._m_fatal.inc()
                    log.error("host %d fatal: %s", hid, h.reason)
                else:
                    h.restarts += 1
                    h.status = "backoff"
                    delay = self._delay(h.restarts)
                    h.due_at = now + delay
                    h.reason = f"transient exit {rc}"
                    self.restart_log.append((hid, h.restarts,
                                             h.reason))
                    self._m_restarts.inc()
                    log.warning(
                        "host %d transient exit %s — restart %d/%d "
                        "in %.2fs", hid, rc, h.restarts,
                        self.max_restarts, delay)
        self._elect()
        self._m_hosts.set(self._live_count())
        return any(h.status in (_RUNNING, "backoff")
                   for h in self._hosts.values())

    def _live_count(self) -> int:
        return sum(1 for h in self._hosts.values()
                   if h.status == _RUNNING)

    def _elect(self) -> None:
        """Chief = lowest-id host still running or pending restart (a
        restarting chief keeps the title — topology env pins process
        ids, so the restarted process IS the same participant)."""
        live = [hid for hid, h in sorted(self._hosts.items())
                if h.status in (_RUNNING, "backoff")]
        new = live[0] if live else None
        if new != self.chief_id:
            # a fleet draining to zero live hosts is completion (or
            # total failure), not an election — only a live successor
            # counts as the title moving
            if self.chief_id is not None and new is not None:
                self.elections.append((self.chief_id, new))
                self._m_elections.inc()
                log.warning("chief re-election: host %s -> %s",
                            self.chief_id, new)
            self.chief_id = new

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Poll until every host is terminal (True) or the budget runs
        out (False — the fleet keeps whatever state it has; call
        ``stop()`` to tear down)."""
        deadline = (None if timeout_s is None
                    else self.clock() + timeout_s)
        while self.poll():
            if deadline is not None and self.clock() >= deadline:
                return False
            self.sleep(self.poll_interval_s)
        return True

    def stop(self) -> None:
        """Kill every still-running child (terminal ``done``, reason
        "stopped" — an operator teardown is not a failure)."""
        for h in self._hosts.values():
            if h.status in (_RUNNING, "backoff") and h.proc is not None:
                if h.proc.poll() is None:
                    h.proc.kill()
                    try:
                        h.proc.wait(timeout=10)
                    except Exception:
                        pass
            if h.status in (_RUNNING, "backoff"):
                h.status = _DONE
                h.reason = "stopped"
        self._elect()
        self._m_hosts.set(self._live_count())

    # --------------------------------------------------------- reporting

    def report(self) -> Dict[int, dict]:
        """Per-host verdicts: ``{host_id: {status, reason, restarts,
        exit_history}}`` plus chief/election history under the
        launcher-wide key ``-1``."""
        out: Dict[int, dict] = {
            hid: {"status": h.status, "reason": h.reason,
                  "restarts": h.restarts,
                  "exit_history": list(h.exit_history)}
            for hid, h in sorted(self._hosts.items())}
        out[-1] = {"chief": self.chief_id,
                   "elections": list(self.elections),
                   "restart_log": list(self.restart_log)}
        return out

    @property
    def succeeded(self) -> bool:
        """True when every host completed cleanly (status ``done``)."""
        return all(h.status == _DONE for h in self._hosts.values())
