"""obs — the port's telemetry layer (tracing, metrics, device health).

Counterpart of ``distributed_tensorflow_tpu/obs`` (its pure-stdlib
modules are copied, never imported), shared by training and serving:

* **tracing** (``obs.trace``) — a Chrome-trace-event/Perfetto JSON span
  recorder for the host timeline: ``span("data_load")`` /
  ``span("dispatch")`` / ``span("checkpoint")`` plus instant events;
  request lanes (``obs.reqtrace``) ride the same tracer.
* **metrics** (``obs.metrics`` + ``obs.http``) — a Prometheus-style
  counter/gauge/histogram registry with text exposition, served at
  ``/metrics`` (+ ``/healthz``, ``/statusz``) by a daemon-thread stdlib
  HTTP server on loopback.
* **accounting** (``obs.goodput``, ``obs.critpath``) — exclusive wall
  clock buckets of a supervised run, and per-request phase breakdowns of
  the serving engine.
* **device health** (``obs.device``) — gradient-health reductions that
  ride the step's metrics (no extra host syncs) and the caching
  allocator's live bytes.

``Telemetry`` wires the pillars together and plugs into
``train.TrainSession(telemetry=...)`` with the ``TraceHook`` /
``MetricsExportHook`` pair (train/hooks.py)::

    from distributed_tensorflow_tpu_torch import obs, train

    tele = obs.Telemetry(trace_dir=logdir, metrics_port=9100)
    with train.TrainSession(state, step, telemetry=tele,
                            hooks=[train.TraceHook(tele),
                                   train.MetricsExportHook(tele),
                                   train.StopAtStepHook(1000)]) as sess:
        ...
    tele.close()     # writes trace-host0.json, stops the endpoint

``obs.federate.FederatedMetrics`` merges the replicas' registries of a
fleet into one ``/metrics``.  The JAX package's ``ledger`` and
``sentinel`` are not ported yet.  Disabled telemetry costs one attribute
check per step.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from . import (critpath, device, federate, goodput, http, metrics,
               reqtrace, trace)
from .critpath import CritpathLedger
from .device import (GRAD_NORM_KEY, NONFINITE_KEY, grad_health,
                     live_arrays_bytes, tree_bytes)
from .federate import FederatedMetrics
from .goodput import GoodputAccountant
from .http import MetricsServer
from .metrics import (Counter, Gauge, Histogram, Registry, REGISTRY,
                      parse_exposition, render_exposition)
from .trace import Tracer

__all__ = ["Telemetry", "Tracer", "MetricsServer", "Registry", "REGISTRY",
           "Counter", "Gauge", "Histogram", "CritpathLedger",
           "FederatedMetrics", "GoodputAccountant", "parse_exposition",
           "render_exposition",
           "GRAD_NORM_KEY", "NONFINITE_KEY", "grad_health",
           "live_arrays_bytes", "tree_bytes", "critpath", "device",
           "federate", "goodput", "http", "metrics", "reqtrace", "trace"]


class Telemetry:
    """Bundle of one Tracer + one metrics Registry + one HTTP endpoint.

    Args:
      trace_dir: where to write the per-host Chrome trace JSON
        (``trace-host{i}.json``); ``None`` disables tracing (the tracer
        stays wired but records nothing).
      metrics_port: serve ``/metrics`` + ``/healthz`` + ``/statusz`` on
        this loopback port (``0`` = ephemeral, read
        ``telemetry.server.port`` after ``start()``); ``None`` disables
        the endpoint (the registry still collects).
      registry: share an existing Registry (default: a fresh one, so two
        Telemetry objects in one process never mix series).
      host_index: the process index used as the trace "pid" and the
        trace filename suffix.  Default reads the ``PROCESS_ID`` env var
        (the cluster-bootstrap convention, ``parallel/cluster.py``).
      service: label reported by ``/healthz`` ("train", "serve", ...).
      health_fn: extra health fields merged into the ``/healthz`` doc.
      statusz_fn: extra debug fields merged into the ``/statusz``
        snapshot (a serving replica passes ``Engine.stats()`` here).
    """

    def __init__(self, trace_dir: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 registry: Optional[Registry] = None,
                 host_index: Optional[int] = None,
                 service: str = "train",
                 health_fn: Optional[Callable[[], Dict]] = None,
                 statusz_fn: Optional[Callable[[], Dict]] = None):
        if host_index is None:
            try:
                host_index = int(os.environ.get("PROCESS_ID", "0"))
            except ValueError:
                host_index = 0
        self.host_index = host_index
        self.trace_dir = trace_dir
        self.service = service
        self.health_fn = health_fn
        self.statusz_fn = statusz_fn
        self.tracer = Tracer(enabled=trace_dir is not None, pid=host_index)
        self.registry = registry if registry is not None else Registry()
        self.server: Optional[MetricsServer] = None
        if metrics_port is not None:
            self.server = MetricsServer(self.registry, port=metrics_port,
                                        health_fn=self._health,
                                        statusz_fn=self._statusz)
        self._started = False
        self._closed = False

    # ------------------------------------------------------------ health

    def _health(self) -> Dict:
        doc: Dict = {"status": "ok", "service": self.service,
                     "host_index": self.host_index}
        steps = self.registry.get("dttpu_steps_total")
        if steps is not None:
            doc["steps_total"] = steps.value
        if self.health_fn is not None:
            doc.update(self.health_fn())
        return doc

    def _statusz(self) -> Dict:
        """Identity fields + the caller's extras; merged over
        ``http.default_statusz()`` by the endpoint."""
        doc: Dict = {"service": self.service,
                     "host_index": self.host_index}
        if self.statusz_fn is not None:
            doc.update(self.statusz_fn())
        return doc

    # --------------------------------------------------------- lifecycle

    def start(self) -> "Telemetry":
        """Idempotent: activate the tracer as the process-wide sink and
        bring up the HTTP endpoint.  Hooks call this from ``begin``."""
        if self._started:
            return self
        self._started = True
        if self.tracer.enabled:
            trace.activate(self.tracer)
        if self.server is not None:
            self.server.start()
        return self

    @property
    def trace_path(self) -> Optional[str]:
        if self.trace_dir is None:
            return None
        return os.path.join(self.trace_dir,
                            f"trace-host{self.host_index}.json")

    def save_trace(self) -> Optional[str]:
        """Write the trace file (rewritten whole each time)."""
        path = self.trace_path
        if path is None or not self.tracer.enabled:
            return None
        return self.tracer.save(path)

    def close(self) -> None:
        """Write the trace, deactivate the tracer, stop the endpoint."""
        if self._closed:
            return
        self._closed = True
        self.save_trace()
        trace.deactivate(self.tracer)
        if self.server is not None:
            self.server.stop()

    def __enter__(self) -> "Telemetry":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------- shared instruments

    def checkpoint_seconds(self) -> Histogram:
        return self.registry.histogram(
            "dttpu_checkpoint_save_seconds",
            "Wall-clock duration of TrainSession.save() calls.")

    def metrics_url(self) -> Optional[str]:
        if self.server is None:
            return None
        return self.server.url + "/metrics"
