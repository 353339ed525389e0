"""Seeded synthetic fleet workloads.

Counterpart of ``distributed_tensorflow_tpu/fleet/workload.py``, the
port's own copy (pure numpy): for the same seed and arguments
``synthesize`` returns bit-equal arrays and the same ``fingerprint``.

A :class:`Trace` is a column-oriented request schedule (numpy arrays, one
row per request) plus a sparse list of fleet-level :class:`FleetEvent`\\ s
(correlated replica failures).  :func:`synthesize` draws one from a seed:

* **arrivals**: an inhomogeneous Poisson process over ``horizon_s``
  seconds, a diurnal sinusoid (amplitude ``diurnal_amplitude`` around the
  mean rate) plus ``bursts`` Gaussian bumps of ``burst_magnitude`` times
  the base rate at seeded times; exactly ``n_requests`` arrivals (a
  multinomial split over time bins, then uniform jitter in each bin);
* **tenant mix**: categorical over ``tenants`` ``(name, share)`` pairs;
* **shared prefixes**: ``prefix_populations`` populations with Zipf-like
  popularity; a ``prefix_fraction`` of requests carry a ``(prefix_id,
  prefix_len)`` pair whose length is drawn once per population;
* **adapter churn**: which of ``adapters`` LoRA adapters are hot drifts
  across the horizon (``adapter_churn`` rotations);
* **correlated failures**: ``failures`` scheduled ``correlated_kill``
  events (the fault plan's vocabulary) in the middle 80% of the horizon.

A Trace is read-only downstream; ``fingerprint()`` hashes the whole
schedule, the determinism pin.  ``chip_smoke.py`` maps a trace's rows to
seeded token prompts for a fleet on the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np

__all__ = ["FleetEvent", "Trace", "synthesize"]


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One scheduled fleet-level incident in virtual time."""
    at_s: float
    kind: str = "correlated_kill"   # resilience.faults vocabulary
    k: int = 2                      # correlated_kill: victim count
    window: int = 64                # correlated_kill: pump window
    seconds: float = 5.0            # wedge-style events: stuck duration


@dataclasses.dataclass
class Trace:
    """A column-oriented request schedule (see module docstring)."""
    arrival_s: np.ndarray           # f8, sorted ascending
    plen: np.ndarray                # i4, prompt length in tokens
    new_tokens: np.ndarray          # i4, decode budget
    tenant: np.ndarray              # i2, index into ``tenants``
    prefix_id: np.ndarray           # i4, 0 = no shared prefix
    prefix_len: np.ndarray          # i4, 0 when prefix_id == 0
    adapter: np.ndarray             # i2, -1 = base model
    tenants: Tuple[Tuple[str, float], ...]
    events: Tuple[FleetEvent, ...]
    horizon_s: float
    seed: int

    def __len__(self) -> int:
        return int(self.arrival_s.shape[0])

    def subset(self, n: int) -> "Trace":
        """First ``n`` arrivals (arrival order), horizon truncated to the
        last kept arrival; events past the new horizon drop out."""
        n = min(int(n), len(self))
        horizon = float(self.arrival_s[n - 1]) if n else 0.0
        return Trace(
            arrival_s=self.arrival_s[:n], plen=self.plen[:n],
            new_tokens=self.new_tokens[:n], tenant=self.tenant[:n],
            prefix_id=self.prefix_id[:n], prefix_len=self.prefix_len[:n],
            adapter=self.adapter[:n], tenants=self.tenants,
            events=tuple(e for e in self.events if e.at_s <= horizon),
            horizon_s=horizon, seed=self.seed)

    def prefix_popularity(self) -> Tuple[Tuple[int, int], ...]:
        """Per-prefix popularity histogram: ``(prefix_id, count)``
        sorted by id, prefix-free requests excluded.  The Zipf
        structure the affinity ablation's win depends on, in a form
        two arms can compare directly."""
        ids, counts = np.unique(self.prefix_id[self.prefix_id > 0],
                                return_counts=True)
        return tuple((int(i), int(c)) for i, c in zip(ids, counts))

    def fingerprint(self) -> str:
        """SHA-256 over every column, event, and the per-prefix
        popularity histogram — the determinism pin.  Folding the
        histogram in makes fingerprint equality a direct proof that
        two ablation arms replay the identical prefix-sharing
        workload, not just identical per-request columns."""
        h = hashlib.sha256()
        for col in (self.arrival_s, self.plen, self.new_tokens,
                    self.tenant, self.prefix_id, self.prefix_len,
                    self.adapter):
            h.update(np.ascontiguousarray(col).tobytes())
        h.update(repr(self.events).encode())
        h.update(repr(self.tenants).encode())
        h.update(repr(self.prefix_popularity()).encode())
        return h.hexdigest()

    @property
    def total_tokens(self) -> int:
        return int(self.new_tokens.sum())


def synthesize(n_requests: int, *, seed: int = 0,
               horizon_s: float = 3600.0,
               tenants: Tuple[Tuple[str, float], ...] = (
                   ("interactive", 0.6), ("batch", 0.3), ("free", 0.1)),
               diurnal_amplitude: float = 0.6,
               bursts: int = 3, burst_magnitude: float = 5.0,
               burst_width_s: float = 0.0,
               plen_mean: float = 96.0, plen_sigma: float = 0.6,
               plen_max: int = 2048,
               new_tokens_mean: float = 48.0, new_tokens_sigma: float = 0.7,
               new_tokens_max: int = 512,
               prefix_populations: int = 32, prefix_fraction: float = 0.35,
               adapters: int = 8, adapter_fraction: float = 0.25,
               adapter_churn: float = 4.0,
               failures: int = 0, failure_k: int = 2,
               failure_window: int = 64) -> Trace:
    """Generate a seeded :class:`Trace` (see module docstring)."""
    if n_requests <= 0:
        raise ValueError("n_requests must be positive")
    rng = np.random.default_rng(seed)
    nbins = max(64, min(4096, n_requests // 8))
    edges = np.linspace(0.0, horizon_s, nbins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    dt = horizon_s / nbins

    # -- arrival intensity: diurnal sinusoid + burst storms -------------
    phase = rng.uniform(0.0, 2.0 * np.pi)
    rate = 1.0 + diurnal_amplitude * np.sin(
        2.0 * np.pi * centers / horizon_s + phase)
    rate = np.maximum(rate, 0.05)
    width = burst_width_s if burst_width_s > 0 else horizon_s / 60.0
    burst_at = rng.uniform(0.1 * horizon_s, 0.9 * horizon_s, size=bursts)
    for t0 in burst_at:
        rate = rate + burst_magnitude * np.exp(
            -0.5 * ((centers - t0) / width) ** 2)
    counts = rng.multinomial(n_requests, rate / rate.sum())
    arrival = np.repeat(edges[:-1], counts) + rng.random(n_requests) * dt
    arrival.sort(kind="stable")

    # -- per-request columns -------------------------------------------
    plen = np.clip(rng.lognormal(np.log(plen_mean), plen_sigma,
                                 size=n_requests), 4, plen_max)
    plen = plen.astype(np.int32)
    new_tokens = np.clip(rng.lognormal(np.log(new_tokens_mean),
                                       new_tokens_sigma, size=n_requests),
                         1, new_tokens_max).astype(np.int32)
    shares = np.array([s for _, s in tenants], dtype=np.float64)
    tenant = rng.choice(len(tenants), p=shares / shares.sum(),
                        size=n_requests).astype(np.int16)

    # -- shared-prefix populations (Zipf popularity, fixed lengths) ----
    prefix_id = np.zeros(n_requests, dtype=np.int32)
    prefix_len = np.zeros(n_requests, dtype=np.int32)
    if prefix_populations > 0 and prefix_fraction > 0:
        pop_len = np.clip(rng.lognormal(np.log(64.0), 0.5,
                                        size=prefix_populations),
                          8, plen_max // 2).astype(np.int32)
        ranks = np.arange(1, prefix_populations + 1, dtype=np.float64)
        pop_p = (1.0 / ranks) / (1.0 / ranks).sum()
        mask = rng.random(n_requests) < prefix_fraction
        picked = rng.choice(prefix_populations, p=pop_p,
                            size=int(mask.sum()))
        prefix_id[mask] = picked.astype(np.int32) + 1   # 0 = none
        # prefixed prompts = population prefix + their own suffix
        plen = np.where(
            mask, np.minimum(plen + pop_len[np.maximum(prefix_id - 1, 0)],
                             plen_max), plen).astype(np.int32)
        prefix_len[mask] = np.minimum(pop_len[picked], plen[mask] - 1)

    # -- adapter churn: the hot set drifts across the horizon ----------
    adapter = np.full(n_requests, -1, dtype=np.int16)
    if adapters > 0 and adapter_fraction > 0:
        amask = rng.random(n_requests) < adapter_fraction
        drift = (arrival[amask] / horizon_s) * adapter_churn * adapters
        local = rng.integers(0, max(1, adapters // 4), size=int(amask.sum()))
        adapter[amask] = ((drift.astype(np.int64) + local)
                          % adapters).astype(np.int16)

    # -- correlated failure schedule -----------------------------------
    events = tuple(
        FleetEvent(at_s=float(t), kind="correlated_kill", k=failure_k,
                   window=failure_window)
        for t in np.sort(rng.uniform(0.1 * horizon_s, 0.9 * horizon_s,
                                     size=failures)))

    return Trace(arrival_s=arrival, plen=plen, new_tokens=new_tokens,
                 tenant=tenant, prefix_id=prefix_id,
                 prefix_len=prefix_len, adapter=adapter,
                 tenants=tuple(tenants), events=events,
                 horizon_s=float(horizon_s), seed=int(seed))
