"""Fleet metrics federation: N registries, one ``/metrics``.

Counterpart of ``distributed_tensorflow_tpu/obs/federate.py``, the
port's own copy: the same merge, labels and ``dttpu_slo_*`` series, so
equal sources and ingests expose equal bytes.

Each replica's ``Registry`` is its own scrape target, and nothing in it
names the replica.  :class:`FederatedMetrics` is the aggregation point,
with two kinds of source:

* **in-process registries** (``add_registry(reg, replica="3")``), read
  directly;
* **scraped peers** (``add_scrape(url, host="1")``), other processes'
  ``/metrics`` endpoints fetched at expose time and decoded with
  ``obs.metrics.parse_exposition`` (lossless: escapes and ``+Inf`` round
  trip exactly).

``expose()`` merges every source into one exposition, stamping each
source's labels onto its samples (the Prometheus federation convention),
and appends the federation's own series: per-tenant TTFT/TPOT percentile
gauges and SLO attainment (``dttpu_slo_*``) from :meth:`ingest`.

Serve it with ``MetricsServer``, which needs only an object with
``expose()``::

    fed = FederatedMetrics()
    fed.add_registry(replica_reg, replica="0")
    server = fed.serve(port=0)          # loopback, one scrape target

Thread-safe: sources and SLO state change under one lock; the scrape
fan-out runs outside it, a peer gets ``timeout_s``, and a failed scrape
counts ``dttpu_federation_scrape_errors_total`` instead of failing the
exposition.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as metrics_lib
from .http import MetricsServer

__all__ = ["FederatedMetrics", "RemoteAffinity"]


@dataclasses.dataclass(frozen=True)
class RemoteAffinity:
    """One remote engine's prefix-affinity inputs, recovered from its
    federated metrics: the radix chain fingerprint (chain hash ->
    cached tokens) and the page size it chunks prompts by.  Shaped so
    ``fleet.router.expected_pages_reused(prompt, remote)`` scores it
    exactly like a local ``EngineStats`` — cross-HOST routers read
    affinity from the scrape plane instead of in-process stats."""
    page_size: int
    prefix_fingerprint: Dict[bytes, int]

# Streaming percentile state is a bounded reservoir per tenant: serving
# percentiles care about the recent tail, and an unbounded list over a
# long run is a leak, not a statistic.
_RESERVOIR = 4096


def _pct(xs: List[float], q: float) -> float:
    return xs[int(q * (len(xs) - 1))]


class FederatedMetrics:
    """See the module docstring."""

    def __init__(self, registry: Optional[metrics_lib.Registry] = None,
                 timeout_s: float = 2.0):
        self._lock = threading.Lock()
        self._registries: List[Tuple[Dict[str, str],
                                     metrics_lib.Registry]] = []
        self._scrapes: List[Tuple[Dict[str, str], str]] = []
        self.timeout_s = float(timeout_s)
        # the federation's own series (dttpu_slo_* + scrape health) live
        # in a normal Registry so they render/parse like everything else
        self.registry = (registry if registry is not None
                         else metrics_lib.Registry())
        self._slo: Dict[str, Dict[str, Any]] = {}
        self._g_sources = self.registry.gauge(
            "dttpu_federation_sources",
            "Registries plus scrape targets behind this federation "
            "endpoint.")
        self._c_scrape_errors = self.registry.counter(
            "dttpu_federation_scrape_errors_total",
            "Peer scrapes that failed (timeout, refused, unparsable) "
            "and were skipped in the merged exposition.")
        self._gauges: Dict[Tuple[str, str], metrics_lib.Gauge] = {}

    # ---------------------------------------------------------- sources

    def add_registry(self, registry: metrics_lib.Registry,
                     **labels: str) -> "FederatedMetrics":
        """Aggregate an in-process registry; ``labels`` (conventionally
        ``replica=``) stamp every one of its samples."""
        with self._lock:
            self._registries.append(
                ({k: str(v) for k, v in labels.items()}, registry))
        return self

    def add_scrape(self, url: str, **labels: str) -> "FederatedMetrics":
        """Aggregate a peer ``/metrics`` endpoint by URL; ``labels``
        (conventionally ``host=``) stamp its samples."""
        with self._lock:
            self._scrapes.append(
                ({k: str(v) for k, v in labels.items()}, url))
        return self

    def source_count(self) -> int:
        """Sources behind this endpoint: registries + scrape targets
        + the federation's own registry."""
        with self._lock:
            return len(self._registries) + len(self._scrapes) + 1

    # ------------------------------------------------------- SLO intake

    def ingest(self, tenant: str, ttft_s: Optional[float] = None,
               tpot_s: Optional[float] = None,
               ttft_ok: Optional[bool] = None,
               itl_ok: Optional[bool] = None) -> None:
        """One request's streaming SLO evidence, per tenant — the same
        verdicts the autoscaler's ``record`` consumes, plus the raw
        latencies the percentile gauges need."""
        with self._lock:
            st = self._slo.get(tenant)
            if st is None:
                st = {"ttft": collections.deque(maxlen=_RESERVOIR),
                      "tpot": collections.deque(maxlen=_RESERVOIR),
                      "ok": 0, "n": 0}
                self._slo[tenant] = st
            if ttft_s is not None:
                st["ttft"].append(float(ttft_s))
            if tpot_s is not None:
                st["tpot"].append(float(tpot_s))
            for verdict in (ttft_ok, itl_ok):
                if verdict is not None:
                    st["n"] += 1
                    if verdict:
                        st["ok"] += 1

    def _slo_gauge(self, name: str, help_text: str,
                   tenant: str) -> metrics_lib.Gauge:
        # under _lock: expose() and fleet_fingerprints() both land here
        key = (name, tenant)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self.registry.gauge(name, help_text,
                                        labels={"tenant": tenant})
                self._gauges[key] = g
        return g

    def _refresh_slo(self) -> None:
        with self._lock:
            snap = {t: (sorted(st["ttft"]), sorted(st["tpot"]),
                        st["ok"], st["n"])
                    for t, st in self._slo.items()}
        for tenant, (ttft, tpot, ok, n) in snap.items():
            if ttft:
                self._slo_gauge(
                    "dttpu_slo_ttft_p50_seconds",
                    "Per-tenant TTFT p50 over the federation's "
                    "streaming reservoir.", tenant).set(_pct(ttft, 0.50))
                self._slo_gauge(
                    "dttpu_slo_ttft_p99_seconds",
                    "Per-tenant TTFT p99 over the federation's "
                    "streaming reservoir.", tenant).set(_pct(ttft, 0.99))
            if tpot:
                self._slo_gauge(
                    "dttpu_slo_tpot_p50_seconds",
                    "Per-tenant mean inter-token gap p50 (per request) "
                    "over the streaming reservoir.",
                    tenant).set(_pct(tpot, 0.50))
                self._slo_gauge(
                    "dttpu_slo_tpot_p99_seconds",
                    "Per-tenant mean inter-token gap p99 (per request) "
                    "over the streaming reservoir.",
                    tenant).set(_pct(tpot, 0.99))
            if n:
                self._slo_gauge(
                    "dttpu_slo_attainment",
                    "Per-tenant fraction of SLO verdicts met (TTFT and "
                    "inter-token pooled).", tenant).set(ok / n)

    # ----------------------------------------------------------- expose

    def _fetch(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8")

    @staticmethod
    def _merge(merged: Dict[str, Dict], families: Dict[str, Dict],
               labels: Dict[str, str]) -> None:
        extra = tuple(labels.items())
        for name, fam in families.items():
            tgt = merged.setdefault(
                name, {"type": "untyped", "help": "", "samples": {}})
            if tgt["type"] == "untyped":
                tgt["type"] = fam["type"]
            if not tgt["help"]:
                tgt["help"] = fam["help"]
            for (sname, lbls), value in fam["samples"].items():
                if extra:
                    lbls = tuple((k, v) for k, v in lbls
                                 if k not in labels) + extra
                tgt["samples"][(sname, lbls)] = value

    def expose(self) -> str:
        """One exposition for the whole fleet: every source's families
        merged (source labels stamped per sample, one HELP/TYPE header
        per family) plus the federation's own ``dttpu_slo_*`` and
        scrape-health series.  Duck-types ``Registry.expose`` so
        ``MetricsServer`` serves it unmodified."""
        self._refresh_slo()
        with self._lock:
            registries = list(self._registries)
            scrapes = list(self._scrapes)
        self._g_sources.set(len(registries) + len(scrapes) + 1)
        merged: Dict[str, Dict] = {}
        for labels, reg in registries:
            self._merge(merged,
                        metrics_lib.parse_exposition(reg.expose()),
                        labels)
        for labels, url in scrapes:
            try:
                text = self._fetch(url)
                families = metrics_lib.parse_exposition(text)
            except Exception:
                self._c_scrape_errors.inc()
                continue
            self._merge(merged, families, labels)
        # own registry LAST: the scrape-health counters must reflect
        # THIS pass's failures, not lag one exposition behind
        self._merge(merged,
                    metrics_lib.parse_exposition(self.registry.expose()),
                    {})
        return metrics_lib.render_exposition(merged)

    def fleet_fingerprints(self) -> Dict[Tuple[Tuple[str, str], ...],
                                         RemoteAffinity]:
        """Recover every source engine's prefix fingerprint from the
        merged exposition: ``dttpu_serve_prefix_chain_tokens{chain=..}``
        samples grouped by their non-``chain`` labels (the source
        stamp — ``host=``/``replica=`` — plus any tenant labels), with
        ``dttpu_serve_page_size`` matched on the same key.  Returns
        ``{source label tuple: RemoteAffinity}``; chains rendered 0
        (evicted on the engine) are dropped, and sources publishing no
        page size (contiguous engines) score affinity 0 downstream.

        This is the cross-host half of prefix-affinity routing
        (fleet/router.py): the serve tier renders the pool fingerprint
        as labeled gauges (serve/engine.py ``ServeMetrics``), the
        federation merges them across hosts, and a router on ANY host
        scores placements from this one scrape surface."""
        families = metrics_lib.parse_exposition(self.expose())
        fps: Dict[Tuple[Tuple[str, str], ...], Dict[bytes, int]] = {}
        sizes: Dict[Tuple[Tuple[str, str], ...], int] = {}
        fam = families.get("dttpu_serve_prefix_chain_tokens")
        for (_sname, lbls), value in ((fam or {}).get("samples")
                                      or {}).items():
            chain_hex = dict(lbls).get("chain")
            if not chain_hex or value <= 0:
                continue          # evicted chain renders 0: not cached
            try:
                chain = bytes.fromhex(chain_hex)
            except ValueError:
                continue
            src = tuple(sorted((k, v) for k, v in lbls
                               if k != "chain"))
            fps.setdefault(src, {})[chain] = int(value)
        fam = families.get("dttpu_serve_page_size")
        for (_sname, lbls), value in ((fam or {}).get("samples")
                                      or {}).items():
            src = tuple(sorted(lbls))
            sizes[src] = int(value)
        return {src: RemoteAffinity(page_size=sizes.get(src, 0),
                                    prefix_fingerprint=fp)
                for src, fp in fps.items()}

    def serve(self, port: int = 0, host: str = "127.0.0.1",
              health_fn=None) -> MetricsServer:
        """Start a ``MetricsServer`` over this federation (``port=0``
        binds an ephemeral port; the caller owns ``stop()``)."""
        return MetricsServer(self, port=port, host=host,
                             health_fn=health_fn).start()
