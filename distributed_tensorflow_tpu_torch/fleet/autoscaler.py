"""SLO-driven fleet autoscaling.

Counterpart of ``distributed_tensorflow_tpu/fleet/autoscaler.py``: the
same policy and series, over a ``Router`` of the port's engines, whose
``engine_factory`` builds engines on the card (or on the CPU when the
caller asks for it).  The caller feeds two inputs: per-request SLO
verdicts (``record``) and the router's ``stats()``, read at
``evaluate(now)``.

Policy (deterministic and auditable):

* **scale-out** when the window's SLO attainment is below
  ``target_attainment`` OR the fleet's queue exceeds ``backlog_high``
  times its slots: ``router.add_replica(engine_factory())``;
* **scale-in** when the window met the target, nothing is queued and the
  in-flight load would fit in ``util_low`` of the remaining capacity:
  the replica whose hot prefix chains are cheapest to lose (then the
  least loaded, then the newest) is drained with ``migrate=True`` (its
  requests move with their progress) and removed;
* stabilisation is asymmetric: scale-out may fire at every evaluation,
  scale-in waits ``cooldown_s`` after the last action of either kind;
  ``min_replicas``/``max_replicas`` rail both, and a fleet below its
  floor (a kill, a quarantine) is healed one replica an evaluation.

A removed replica's page pool stays on the card until the caller drops
the engine (the router hands it back from ``remove_replica``; the
autoscaler keeps no reference).

Metrics (``dttpu_autoscaler_*``): the ``replicas`` and ``attainment``
gauges, ``scale_out_total`` / ``scale_in_total`` and
``replica_seconds_total`` counters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from ..obs import metrics as metrics_lib
from .router import Router

__all__ = ["SLO", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """p99 service-level targets: submit-to-first-token and mean
    inter-token gap (TPOT) per request."""
    ttft_s: float = 2.0
    itl_s: float = 0.1

    def __post_init__(self):
        if not self.ttft_s > 0 or not self.itl_s > 0:
            raise ValueError("SLO targets must be positive")


class Autoscaler:
    """See the module docstring.  The caller owns the cadence: feed
    ``record`` as requests finish, ``charge`` as time passes, and call
    ``evaluate(now)`` every ``eval_interval_s`` seconds of its clock."""

    def __init__(self, router: Router,
                 engine_factory: Callable[[], Any],
                 slo: SLO, *,
                 min_replicas: int = 1, max_replicas: int = 8,
                 target_attainment: float = 0.99,
                 eval_interval_s: float = 15.0,
                 cooldown_s: float = 60.0,
                 backlog_high: float = 2.0,
                 util_low: float = 0.40,
                 drain_timeout_s: Optional[float] = 30.0,
                 registry: Optional[metrics_lib.Registry] = None):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"{min_replicas}..{max_replicas}")
        self.router = router
        self.engine_factory = engine_factory
        self.slo = slo
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.target_attainment = float(target_attainment)
        self.eval_interval_s = float(eval_interval_s)
        self.cooldown_s = float(cooldown_s)
        self.backlog_high = float(backlog_high)
        self.util_low = float(util_low)
        self.drain_timeout_s = drain_timeout_s
        self.scale_outs = 0
        self.scale_ins = 0
        self.replica_seconds = 0.0
        self.history: List[tuple] = []
        self._last_action_at: Optional[float] = None
        self._w_ttft_ok = 0
        self._w_ttft_n = 0
        self._w_itl_ok = 0
        self._w_itl_n = 0
        reg = registry if registry is not None else metrics_lib.REGISTRY
        self._m_replicas = reg.gauge(
            "dttpu_autoscaler_replicas",
            "Replicas behind the router at the last evaluation.")
        self._m_attainment = reg.gauge(
            "dttpu_autoscaler_attainment",
            "Sliding-window SLO attainment (min of TTFT and "
            "inter-token) at the last evaluation.")
        self._m_out = reg.counter(
            "dttpu_autoscaler_scale_out_total",
            "Replicas added by the autoscaler.")
        self._m_in = reg.counter(
            "dttpu_autoscaler_scale_in_total",
            "Replicas drained (migrate=True) and removed by the "
            "autoscaler.")
        self._m_seconds = reg.counter(
            "dttpu_autoscaler_replica_seconds_total",
            "Provisioned replica-time integrated by the caller "
            "(virtual seconds under the simulator).")

    # ---------------------------------------------------------- inputs

    def record(self, ttft_ok: Optional[bool] = None,
               itl_ok: Optional[bool] = None) -> None:
        """One request's SLO verdicts into the current window (either
        half may arrive alone — TTFT lands at first token, the
        inter-token verdict at retirement)."""
        if ttft_ok is not None:
            self._w_ttft_n += 1
            if ttft_ok:
                self._w_ttft_ok += 1
        if itl_ok is not None:
            self._w_itl_n += 1
            if itl_ok:
                self._w_itl_ok += 1

    def charge(self, dt_s: float, replicas: int) -> None:
        """Integrate provisioned replica-time (the cost denominator)."""
        amount = dt_s * replicas
        self.replica_seconds += amount
        self._m_seconds.inc(amount)

    def window_attainment(self) -> float:
        """min(TTFT, inter-token) attainment over the current window;
        an empty window counts as attained (no evidence of trouble)."""
        a = (self._w_ttft_ok / self._w_ttft_n if self._w_ttft_n
             else 1.0)
        b = self._w_itl_ok / self._w_itl_n if self._w_itl_n else 1.0
        return min(a, b)

    # --------------------------------------------------------- decide

    def evaluate(self, now: float) -> Optional[Tuple[str, int]]:
        """One policy evaluation at time ``now`` (the caller's clock —
        wall or virtual).  Returns ``("scale_out", rid)`` /
        ``("scale_in", rid)`` when an action was taken, else None.
        The window counters reset every evaluation."""
        stats = self.router.stats()
        replicas = len(stats)
        slots = sum(s.num_slots for s in stats.values())
        queued = sum(s.queued for s in stats.values())
        inflight = sum(s.inflight for s in stats.values())
        att = self.window_attainment()
        self._w_ttft_ok = self._w_ttft_n = 0
        self._w_itl_ok = self._w_itl_n = 0
        self._m_attainment.set(att)
        action: Optional[Tuple[str, int]] = None
        cooled = (self._last_action_at is None
                  or now - self._last_action_at >= self.cooldown_s)
        if replicas < self.min_replicas:
            # heal: the fleet fell below its floor (correlated kill,
            # quarantine) — restore capacity regardless of cooldown or
            # window attainment, one replica per evaluation.
            rid = self.router.add_replica(self.engine_factory())
            self.scale_outs += 1
            self._m_out.inc()
            action = ("scale_out", rid)
            self._last_action_at = now
            self.history.append((round(now, 9), action[0], action[1]))
        elif replicas > 0:
            # scale-out is NOT gated on cooldown: a burst ramps faster
            # than any flap-guard, and an extra replica is the cheap
            # mistake.  Scale-in is the risky direction — it waits.
            if replicas < self.max_replicas and (
                    att < self.target_attainment
                    or queued > self.backlog_high * slots):
                rid = self.router.add_replica(self.engine_factory())
                self.scale_outs += 1
                self._m_out.inc()
                action = ("scale_out", rid)
            elif (cooled
                  and replicas > self.min_replicas
                  and att >= self.target_attainment
                  and queued == 0
                  and inflight < self.util_low * slots
                  * (replicas - 1) / replicas):
                victim = self._scale_in_victim(stats)
                if victim is not None:
                    action = ("scale_in", victim)
            if action is not None:
                self._last_action_at = now
                self.history.append(
                    (round(now, 9), action[0], action[1]))
        self._m_replicas.set(len(self.router.replica_ids))
        return action

    def _scale_in_victim(self, stats) -> Optional[int]:
        """Drain-and-remove the replica whose hot prefix chains are
        cheapest to lose: primary key is the cached tokens of
        fingerprint chains held by NO other replica (migrate-based
        scale-in preserves in-flight requests but evicts the pool, so
        removing the fleet's only copy of a hot prefix re-prefills it
        from scratch for every follower), then least inflight, ties by
        highest id — retire the newest capacity first.  Fleets without
        fingerprints (contiguous engines, cold pools) score 0
        everywhere and keep the original least-loaded choice exactly.
        A drain that times out is rolled back with ``resume_replica``
        instead of failing requests."""
        holders: dict = {}
        for s in stats.values():
            for key, tokens in getattr(s, "prefix_fingerprint",
                                       {}).items():
                holders[key] = holders.get(key, 0) + 1

        def sole_hot_tokens(rid) -> int:
            fp = getattr(stats[rid], "prefix_fingerprint", {})
            return sum(tokens for key, tokens in fp.items()
                       if holders.get(key, 0) <= 1)

        victim = min(stats, key=lambda rid: (
            sole_hot_tokens(rid), stats[rid].inflight, -rid))
        ok = self.router.drain_replica(
            victim, timeout_s=self.drain_timeout_s, migrate=True)
        if not ok:
            self.router.resume_replica(victim)
            return None
        self.router.remove_replica(victim)
        self.scale_ins += 1
        self._m_in.inc()
        return victim
