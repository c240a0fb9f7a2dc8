"""Replica registry: heartbeat-driven health states and the rendezvous
hash (a copy of what kubeflow_tpu/fleet/registry.py gives the elastic
trainer fleet; the port imports nothing of the JAX package).

The elastic coordinator (train/elastic.py) registers each trainer
replica once, refreshes it on every heartbeat, sweeps staleness before
it decides the world, and deregisters a replica it evicts.

Health state machine (per replica):

    register ──> ready ──(no heartbeat > degraded_after_s)──> degraded
                   ^            │
                   │            └──(no heartbeat > dead_after_s)──> dead
                   └──(heartbeat)── degraded / dead        (recovery)

Left out, being the serving router's side: draining (`drain`, a
heartbeat's `draining`; the state stays in STATES, which the
coordinator's gauge zero-seeds), the per-replica routing and autoscale
stats (queue depth, slots, KV blocks, pool role, model version, phase
seconds, prefix-heat digests), the router's own accounting (in-flight
requests, failures, the circuit breaker and `note_failure` /
`note_success`), and routing (`routable`, `pick`, `digest_carriers`,
`disaggregated`, `pool_counts`).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

READY = "ready"
DEGRADED = "degraded"
DRAINING = "draining"
DEAD = "dead"
STATES = (READY, DEGRADED, DRAINING, DEAD)


def rendezvous(key: bytes, ids: Iterable[str]) -> str | None:
    """Highest-random-weight winner for `key` among `ids` (stable:
    independent per-(key, id) scores, so membership changes move only
    the keys whose winner joined or left)."""
    best, best_score = None, b""
    for rid in ids:
        score = hashlib.sha256(rid.encode() + b"\x00" + key).digest()
        if best is None or score > best_score:
            best, best_score = rid, score
    return best


@dataclass
class Replica:
    """One replica as the registry sees it."""

    id: str
    url: str
    models: list[str] = field(default_factory=list)
    state: str = READY
    registered_at: float = 0.0
    last_heartbeat: float = 0.0


class ReplicaRegistry:
    """Replica table; `clock` is injectable so tests drive the staleness
    transitions deterministically. Not thread-safe: the coordinator
    holds its own lock around every call."""

    def __init__(self, *, degraded_after_s: float = 6.0,
                 dead_after_s: float = 20.0,
                 clock: Callable[[], float] = time.monotonic):
        if not degraded_after_s < dead_after_s:
            raise ValueError(
                f"degraded_after_s ({degraded_after_s}) must be < "
                f"dead_after_s ({dead_after_s})")
        self.degraded_after_s = degraded_after_s
        self.dead_after_s = dead_after_s
        self.clock = clock
        self._replicas: dict[str, Replica] = {}

    # -- membership -------------------------------------------------------

    def register(self, url: str, *, replica_id: str = "",
                 models: Iterable[str] = ()) -> Replica:
        """Idempotent: re-registration (a replica or coordinator restart)
        refreshes the record and returns it ready."""
        rid = replica_id or url
        now = self.clock()
        rep = self._replicas.get(rid)
        if rep is None:
            rep = Replica(id=rid, url=url, registered_at=now)
            self._replicas[rid] = rep
        rep.url = url
        rep.models = sorted(models)
        rep.state = READY
        rep.last_heartbeat = now
        return rep

    def deregister(self, replica_id: str) -> bool:
        return self._replicas.pop(replica_id, None) is not None

    def replicas(self) -> list[Replica]:
        return list(self._replicas.values())

    # -- health signals ---------------------------------------------------

    def heartbeat(self, replica_id: str) -> bool:
        """Refresh liveness. False for an unknown id: the replica should
        re-register (the coordinator restarted)."""
        rep = self._replicas.get(replica_id)
        if rep is None:
            return False
        rep.last_heartbeat = self.clock()
        if rep.state in (DEGRADED, DEAD):
            rep.state = READY      # recovery
        return True

    def sweep(self) -> None:
        """Apply heartbeat-staleness transitions; dead is sticky (only a
        fresh heartbeat resurrects it)."""
        now = self.clock()
        for rep in self._replicas.values():
            if rep.state in (DRAINING, DEAD):
                continue
            age = now - rep.last_heartbeat
            if age > self.dead_after_s:
                rep.state = DEAD
            elif age > self.degraded_after_s:
                rep.state = DEGRADED

    def counts(self) -> dict[str, int]:
        """State -> replica count, zero-filled (a state gauge carries all
        four series from the first render)."""
        out = {s: 0 for s in STATES}
        for rep in self._replicas.values():
            out[rep.state] += 1
        return out
