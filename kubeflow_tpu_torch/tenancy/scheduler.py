"""Priority + weighted fair-share admission queue.

Drop-in replacement for the `ContinuousBatcher`'s FIFO `_pending`
deque (same `append` / `appendleft` / `popleft` / `__len__` surface)
that routes each request into a per-tenant sub-queue and picks the
next admission by:

1. strict priority class (`interactive` > `standard` > `batch`) —
   a lower class is served only when every higher class has nothing
   runnable;
2. within a class, weighted virtual time (start-time fair queuing):
   each pop charges its tenant `cost / weight` of virtual time and the
   tenant with the LOWEST virtual time goes next, so over time each
   tenant's completed-token share converges to its weight share;
3. a tenant whose generated-tokens/s bucket is in debt is not
   runnable — its queue is skipped (paced) until the ledger refills.

`popleft` returns None (instead of an item) when requests are queued
but every queued tenant is paced — the worker treats that as "nothing
admittable right now", not as empty.

Queue items are the batcher's pending requests; this module only
touches two attributes: `item.fut` (the request future — cancelled
requests don't count as waiting work) and `item.meta` (the `ReqMeta`
below, which the batcher attaches at enqueue). (A copy of
kubeflow_tpu/tenancy/scheduler.py, whose items are the reference
batcher's tuples, read at indices 3 and 7.)
"""

from __future__ import annotations

import collections

from kubeflow_tpu_torch.tenancy.config import PRIORITIES, TenancyConfig
from kubeflow_tpu_torch.tenancy.ledger import TenantLedger


class ReqMeta:
    """Per-request scheduling record riding the pending request (always
    present, tenant-blind or not — it also carries the enqueue
    timestamp the server's dynamic Retry-After is computed from)."""

    __slots__ = ("tenant", "priority", "weight", "cost", "t_enqueue",
                 "seq", "ns", "resume", "charged", "request_id",
                 "timeline", "restored")

    def __init__(self, tenant: str = "", priority: str = "standard",
                 weight: float = 1.0, cost: float = 1.0,
                 t_enqueue: float = 0.0, seq: int = 0, ns: str = "",
                 request_id: str = "", timeline=None):
        self.tenant = tenant
        self.priority = priority
        self.weight = weight
        self.cost = cost          # fair-share charge (≈ tokens asked)
        self.t_enqueue = t_enqueue
        self.seq = seq            # admission order; preemption evicts max
        self.ns = ns              # radix-cache namespace (prefix_isolation)
        self.resume = None        # preemption carry-over: {out, lps, max_new}
        self.charged = 0.0        # virtual time charged by the last pop
        self.request_id = request_id
        # obs.timeline.RequestTimeline — rides the meta so the record
        # survives preemption's re-enqueue round trip
        self.timeline = timeline
        # prompt cells whose radix hit came from spill-tier restores
        # (host->device copy, not a device-resident cache hit); the
        # batcher stamps it at admission so on_prefix can split the
        # reused count into `reused` vs `restored` metric sources
        self.restored = 0


class FairShareQueue:
    def __init__(self, config: TenancyConfig, ledger: TenantLedger):
        self.config = config
        self.ledger = ledger
        self._queues: dict[str, collections.deque] = {}
        self._vt: dict[str, float] = {}
        self._vclock = 0.0  # high-water virtual time across pops
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def _q(self, tenant: str) -> collections.deque:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
        if not q:
            # tenant going idle->busy: catch its virtual time up to the
            # high-water mark so idling doesn't bank credit it can
            # spend starving everyone later (standard start-time FQ)
            self._vt[tenant] = max(self._vt.get(tenant, 0.0),
                                   self._vclock)
        return q

    def append(self, item) -> None:
        self._q(item.meta.tenant).append(item)
        self._len += 1

    def appendleft(self, item) -> None:
        """Head re-insert — the deferral/preemption path. Refunds the
        virtual time the pop charged: a request the batcher could not
        actually admit must not cost its tenant fair share."""
        meta = item.meta
        self._q(meta.tenant).appendleft(item)
        self._len += 1
        if meta.charged:
            self._vt[meta.tenant] -= meta.charged
            meta.charged = 0.0

    def popleft(self):
        """Next admission, or None when items exist but every queued
        tenant is token-paced. Raises IndexError when truly empty
        (deque parity)."""
        if self._len == 0:
            raise IndexError("pop from an empty FairShareQueue")
        for pri in PRIORITIES:
            best = None
            for tenant in sorted(self._queues):
                q = self._queues[tenant]
                if not q:
                    continue
                if self.config.resolve(tenant).priority != pri:
                    continue
                if self.ledger is not None \
                        and not self.ledger.runnable(tenant):
                    continue
                vt = self._vt.get(tenant, 0.0)
                if best is None or vt < best[1]:
                    best = (tenant, vt)
            if best is None:
                continue
            tenant, vt = best
            item = self._queues[tenant].popleft()
            self._len -= 1
            meta = item.meta
            charge = max(1.0, float(meta.cost)) / max(1e-9, meta.weight)
            self._vt[tenant] = vt + charge
            meta.charged = charge
            self._vclock = max(self._vclock, self._vt[tenant])
            return item
        return None

    def has_waiting(self, priority: str) -> bool:
        """Any live (non-cancelled) request of this class queued? The
        batcher's preemption trigger."""
        for tenant, q in self._queues.items():
            if not q:
                continue
            if self.config.resolve(tenant).priority != priority:
                continue
            if any(not it.fut.done() for it in q):
                return True
        return False

    def pacing_delay(self) -> float:
        """Shortest token-debt refill among queued tenants (0.0 when
        someone is runnable) — how long the worker may nap when
        popleft returned None."""
        best = None
        for tenant, q in self._queues.items():
            if not q:
                continue
            d = (self.ledger.pacing_delay(tenant)
                 if self.ledger is not None else 0.0)
            if best is None or d < best:
                best = d
        return best or 0.0

    def depths(self) -> dict[str, int]:
        """Queue depth per tenant, zero-seeded for every configured
        tenant (the `serving_tenant_queue_depth` gauge)."""
        out = dict.fromkeys(self.config.names(), 0)
        for tenant, q in self._queues.items():
            out[tenant] = len(q)
        return out

    def items(self) -> list:
        """Non-destructive snapshot of every queued item, in tenant
        order (the checkpoint/migration export paths read this; pops
        and pacing state are untouched)."""
        out = []
        for tenant in sorted(self._queues):
            out.extend(self._queues[tenant])
        return out

    def drain_all(self) -> list:
        """Remove and return every queued item (shutdown path)."""
        items = []
        for tenant in sorted(self._queues):
            items.extend(self._queues[tenant])
            self._queues[tenant].clear()
        self._len = 0
        return items
