"""Per-tenant admission policy: quotas and deficit-weighted fair share.

A copy of ``distributed_tensorflow_tpu/fleet/tenancy.py`` (pure host
code; the port keeps its own so that it imports nothing of the JAX
package).  Two controls the serving engine enforces at admission:

* **Quotas** (``TenantQuota``): per-tenant ceilings checked at
  ``Engine.submit``/``import_request``: ``max_inflight`` bounds a
  tenant's queued + prefilling + active requests, ``max_tokens_inflight``
  the sum of their token budgets.  Exceeding either raises
  ``QuotaExceededError`` for that tenant only.
* **Deficit-weighted fair share** (``DeficitFairQueue``): the admission
  queue becomes per-tenant FIFOs drained by deficit round robin with the
  request's token budget as its cost, so a tenant's burst cannot starve
  the others; decisions depend only on arrival order and the static
  config, so a replayed trace admits in the same order.

One ``TenantPolicy`` is static config shared by every engine; each
engine builds its own queue from it (``make_queue``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterator, Optional

__all__ = ["DeficitFairQueue", "QuotaExceededError", "TenantPolicy",
           "TenantQuota"]


class QuotaExceededError(RuntimeError):
    """``submit`` rejected: the tenant is at a quota ceiling.
    Backpressure for ONE tenant, not failure — retry after that
    tenant's in-flight work retires."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant ceilings and fair-share weight.

    ``max_inflight``: queued+prefilling+active requests (None = no cap);
    ``max_tokens_inflight``: sum of in-flight ``max_new_tokens`` budgets
    (None = no cap); ``weight``: relative fair-share — a weight-2 tenant
    sustains twice the token throughput of a weight-1 tenant while both
    are backlogged."""
    max_inflight: Optional[int] = None
    max_tokens_inflight: Optional[int] = None
    weight: float = 1.0

    def __post_init__(self):
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1; got {self.max_inflight}")
        if self.max_tokens_inflight is not None \
                and self.max_tokens_inflight < 1:
            raise ValueError(f"max_tokens_inflight must be >= 1; "
                             f"got {self.max_tokens_inflight}")
        if not self.weight > 0:
            raise ValueError(f"weight must be > 0; got {self.weight}")


class TenantPolicy:
    """Static tenancy config: per-tenant quotas + the DRR quantum.

    ``quotas`` maps tenant -> ``TenantQuota``; unlisted tenants get
    ``default``.  ``quantum`` is the DRR refill in TOKENS per round
    visit — it trades scheduling granularity (small = finer
    interleaving) against rounds spent banking deficit for a long
    request (it never affects the CONVERGED share, only the burst
    granularity)."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 default: TenantQuota = TenantQuota(),
                 quantum: int = 32):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1; got {quantum}")
        self.quotas = dict(quotas or {})
        self.default = default
        self.quantum = int(quantum)

    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default)

    def check_admission(self, tenant: str, new_tokens: int, *,
                        inflight: int, tokens_inflight: int) -> None:
        """Raise ``QuotaExceededError`` if admitting a ``new_tokens``-
        budget request would push ``tenant`` past a ceiling.  Called by
        ``Engine.submit`` with the scheduler's live counters."""
        q = self.quota(tenant)
        if q.max_inflight is not None and inflight >= q.max_inflight:
            raise QuotaExceededError(
                f"tenant {tenant!r} at max_inflight={q.max_inflight}")
        if q.max_tokens_inflight is not None \
                and tokens_inflight + new_tokens > q.max_tokens_inflight:
            raise QuotaExceededError(
                f"tenant {tenant!r} over max_tokens_inflight="
                f"{q.max_tokens_inflight} ({tokens_inflight} in flight "
                f"+ {new_tokens} requested)")

    def make_queue(self) -> "DeficitFairQueue":
        """A fresh fair-share admission queue for ONE scheduler."""
        return DeficitFairQueue(self)


class DeficitFairQueue:
    """Deficit-round-robin admission queue over per-tenant FIFOs.

    Implements the scheduler's queue protocol (append / popleft /
    remove / requeue / __len__ / __iter__ / __contains__) so it drops
    into ``SlotScheduler`` in place of the default deque.  ``popleft``
    serves the round-robin ring of backlogged tenants: each visit banks
    ``quantum x weight`` deficit tokens; a tenant whose head request's
    ``max_new_tokens`` fits its deficit pays and admits, otherwise the
    ring rotates.  A tenant leaving the backlog forfeits its deficit
    (standard DRR — an idle tenant cannot bank credit), which is what
    makes the schedule depend only on arrival order."""

    def __init__(self, policy: TenantPolicy):
        self.policy = policy
        self._fifos: Dict[str, collections.deque] = {}
        self._ring: collections.deque = collections.deque()   # tenants
        self._deficit: Dict[str, float] = {}
        self._len = 0
        # True while ring[0] is mid-visit (already granted this visit's
        # quantum); cleared whenever the pointer advances
        self._visited = False

    # ------------------------------------------------- queue protocol

    def append(self, req) -> None:
        fifo = self._fifos.get(req.tenant)
        if fifo is None:
            fifo = self._fifos[req.tenant] = collections.deque()
        if not fifo:
            self._ring.append(req.tenant)
            self._deficit.setdefault(req.tenant, 0.0)
        fifo.append(req)
        self._len += 1

    def popleft(self):
        """The next admissible request under DRR.  Raises IndexError on
        an empty queue (deque semantics — the scheduler len-guards).

        Pointer-based DRR: arriving at a tenant grants its quantum ONCE
        for the visit; the visit serves head requests while the banked
        deficit covers their token cost, then the pointer advances (the
        unspent remainder stays banked).  A cheap-request tenant can
        therefore never monopolize the ring — it spends its visit budget
        and waits for its next turn like everyone else."""
        if not self._len:
            raise IndexError("pop from an empty DeficitFairQueue")
        while True:
            tenant = self._ring[0]
            fifo = self._fifos[tenant]
            if not self._visited:
                self._deficit[tenant] += (
                    self.policy.quantum
                    * self.policy.quota(tenant).weight)
                self._visited = True
            if self._deficit[tenant] >= fifo[0].max_new_tokens:
                req = fifo.popleft()
                self._deficit[tenant] -= req.max_new_tokens
                self._len -= 1
                self._retire_if_idle(tenant)
                return req
            self._ring.rotate(-1)
            self._visited = False

    def requeue(self, req) -> None:
        """Put a popped-but-unstartable request back at the FRONT of its
        tenant's FIFO and refund its deficit charge — the replayed
        admission order stays deterministic."""
        fifo = self._fifos.get(req.tenant)
        if fifo is None:
            fifo = self._fifos[req.tenant] = collections.deque()
        if not fifo and req.tenant not in self._ring:
            self._ring.appendleft(req.tenant)
        self._deficit[req.tenant] = (self._deficit.get(req.tenant, 0.0)
                                     + req.max_new_tokens)
        fifo.appendleft(req)
        self._len += 1

    def remove(self, req) -> None:
        fifo = self._fifos.get(req.tenant)
        if fifo is None or req not in fifo:
            raise ValueError("request not in queue")
        fifo.remove(req)
        self._len -= 1
        self._retire_if_idle(req.tenant)

    def release(self, req) -> None:
        """Scheduler hook at request retirement — nothing to do here
        (deficits settle at pop time), kept for protocol symmetry."""

    def _retire_if_idle(self, tenant: str) -> None:
        if not self._fifos[tenant]:
            if self._ring and self._ring[0] == tenant:
                self._visited = False
            del self._fifos[tenant]
            self._ring.remove(tenant)
            # idle tenants forfeit deficit: no banking credit while away
            self._deficit.pop(tenant, None)

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator:
        for tenant in list(self._ring):
            yield from list(self._fifos.get(tenant, ()))

    def __contains__(self, req) -> bool:
        fifo = self._fifos.get(getattr(req, "tenant", None))
        return fifo is not None and req in fifo
