"""KV-cache block lifecycle ledger and bounded prefix hashing
(counterpart: kubeflow_tpu/obs/cachestats.py).

- `CacheLedger`: a host-side sidecar the `BlockPool` notifies on every
  block birth and death. Every death is booked to a CAUSE from a closed
  set (`EVICTION_CAUSES`); a `pool.free()` that does not say why lands
  in `unattributed`, which must stay zero. The ledger also keeps reuse
  distances (admissions between touches of the same block), block age
  at death, admission-defer causes, and the host spill tier's content
  lifecycle.
- `prefix_hash`: the name of a prefix (its first KV block of tokens):
  16 hex chars of blake2b over `canonical_prefix`, salted by namespace.

The ledger is metric-free: the server binds its `on_*` hooks to the
`serving_kv_*` families (the `PhaseProfiler.on_phase` idiom), and its
Chrome counter track (cumulative frees per cause) rides `/debug/traces`.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from typing import Callable, Iterable

from kubeflow_tpu_torch.obs.metrics import sample_quantile

# Closed set of reasons a KV block dies:
#   lru        — radix prefix-cache LRU eviction (cold prefix displaced)
#   pressure   — slot preemption under pool pressure
#   refdrop    — normal retirement: request finished/cancelled/failed
#                and its non-cached blocks dropped their last reference
#   divergence — copy-on-write/import duplicate: a block whose contents
#                already exist under another id (freed immediately)
#   migration  — blocks handed to / rolled back from a peer replica
#   spill      — LRU victim DEMOTED to the host-RAM spill tier: the
#                device block is freed but its content survives on the
#                host (restorable)
EVICTION_CAUSES = ("lru", "pressure", "refdrop", "divergence",
                   "migration", "spill")
# where a `pool.free()` with no stated cause is booked; must stay zero
UNATTRIBUTED = "unattributed"
# why an admission was deferred: a tenant's KV quota, or the pool being
# empty even after LRU eviction
DEFER_CAUSES = ("kv_quota", "pool_exhausted")
# where an admitted prompt's tokens came from (`serving_prefill_tokens
# {source}`): computed on the device, reused from cached KV, restored
# from the host spill tier, fetched from a peer replica
PREFILL_SOURCES = ("computed", "reused", "restored", "peer_fetched")
# outcome of one peer block fetch (`fleet_peer_fetch_total{outcome}`)
PEER_FETCH_OUTCOMES = ("ok", "miss", "failed")
# reuse-distance and block-age buckets, in admissions (one tick per
# admitted request): powers of two past any pool's residency
REUSE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 4096.0)

_WINDOW = 512   # raw samples kept for the reuse / age quantiles
_MAX_COUNTER_EVENTS = 2048


def canonical_prefix(tokens: Iterable[int], ns: str = "") -> str:
    """Canonical string form of a token prefix: space-joined decimal
    ints, NUL-salted by namespace when namespaced. The string a hashed
    `LabelGuard` digests."""
    joined = " ".join(str(int(t)) for t in tokens)
    return f"{ns}\x00{joined}" if ns else joined


def prefix_hash(tokens: Iterable[int], ns: str = "") -> str:
    """16-hex name for a token prefix: blake2b-64 of `canonical_prefix`,
    byte-identical to what a hashed LabelGuard returns for it."""
    return hashlib.blake2b(
        canonical_prefix(tokens, ns).encode("utf-8", "replace"),
        digest_size=8).hexdigest()


class CacheLedger:
    """Block lifecycle accounting for one BlockPool.

    Attach with `pool.attach_ledger(ledger)`; the pool then calls
    `note_alloc` / `note_free` inline. The batcher calls
    `note_admission` once per admitted request (the logical clock),
    `note_reuse` for radix-hit blocks, `note_defer` when admission is
    pushed back, and `note_restore` / `note_spill_drop` for the host
    spill tier.

    Conservation, both equalities of `snapshot()["conserved"]`:
        births - frees_total == live_blocks      (device blocks)
        (births - restores) - (frees_total - frees["spill"] + drops)
            == live_blocks + spilled             (content)
    and `frees[UNATTRIBUTED] == 0`: content born minus content dead
    equals content on the device plus content parked on the host.

    Hooks, each optional and never allowed to kill the caller (their
    exceptions are swallowed): `on_free(cause, n)`, `on_reuse(distance)`,
    `on_age(age)`, `on_defer(cause)`, `on_spill(kind, n)` with kind
    "demote", "restore" or "drop". `wall` stamps the counter events on
    the tracer's clock.
    """

    def __init__(self, *, wall: Callable[[], float] = time.time):
        self._wall = wall
        self._tick = 0                       # admissions so far
        self.births = 0
        self.frees = {c: 0 for c in (*EVICTION_CAUSES, UNATTRIBUTED)}
        self.defers = {c: 0 for c in DEFER_CAUSES}
        # block contents parked on the host, and the transitions
        self.spilled = 0
        self.spill_demotions = 0
        self.spill_restores = 0
        self.spill_drops = 0
        # live block id -> [birth_tick, last_use_tick]
        self._live: dict[int, list[int]] = {}
        self._reuse = deque(maxlen=_WINDOW)  # distances, in admissions
        self._ages = deque(maxlen=_WINDOW)   # age at death, admissions
        # Chrome "C" events: an all-zero seed, so the track exists in
        # every trace, then a point per free
        self._events: deque = deque(maxlen=_MAX_COUNTER_EVENTS)
        self._emit_event()
        self.on_free: Callable[[str, int], None] | None = None
        self.on_reuse: Callable[[int], None] | None = None
        self.on_age: Callable[[int], None] | None = None
        self.on_defer: Callable[[str], None] | None = None
        self.on_spill: Callable[[str, int], None] | None = None

    @staticmethod
    def _call(hook, *args) -> None:
        if hook is not None:
            try:
                hook(*args)
            except Exception:  # noqa: BLE001 — a metrics hook never
                pass           # kills the pool or the batcher

    # -- pool-side hooks ---------------------------------------------------

    def note_alloc(self, blocks: Iterable[int]) -> None:
        t = self._tick
        for b in blocks:
            self._live[int(b)] = [t, t]
            self.births += 1

    def note_free(self, blocks: Iterable[int], cause: str | None) -> None:
        cause = cause if cause in self.frees else UNATTRIBUTED
        n = 0
        ages = []
        for b in blocks:
            n += 1
            meta = self._live.pop(int(b), None)
            if meta is not None:
                ages.append(self._tick - meta[0])
        self._ages.extend(ages)
        if not n:
            return
        self.frees[cause] += n
        if cause == "spill":
            # the device block died but its content moved to the host
            self.spill_demotions += n
            self.spilled += n
        self._emit_event()
        self._call(self.on_free, cause, n)
        if cause == "spill":
            self._call(self.on_spill, "demote", n)
        for age in ages:
            self._call(self.on_age, age)

    # -- batcher-side hooks ------------------------------------------------

    def note_admission(self) -> None:
        """Advance the logical clock: one tick per admitted request."""
        self._tick += 1

    def note_reuse(self, blocks: Iterable[int]) -> None:
        """Radix-hit blocks of the request being admitted: records each
        one's reuse distance (admissions since its last touch)."""
        t = self._tick
        for b in blocks:
            meta = self._live.get(int(b))
            if meta is not None:
                self._reuse.append(t - meta[1])
                self._call(self.on_reuse, t - meta[1])
                meta[1] = t

    def note_restore(self, n: int) -> None:
        """`n` spilled contents copied back into freshly allocated
        device blocks (whose births `note_alloc` booked already)."""
        if n > 0:
            self.spill_restores += n
            self.spilled -= n
            self._call(self.on_spill, "restore", n)

    def note_spill_drop(self, n: int) -> None:
        """`n` host-tier entries evicted by the tier's byte budget (or
        lost to a failed restore): the content is dead now."""
        if n > 0:
            self.spill_drops += n
            self.spilled -= n
            self._call(self.on_spill, "drop", n)

    def note_defer(self, cause: str) -> None:
        if cause not in self.defers:
            cause = "pool_exhausted"
        self.defers[cause] += 1
        self._call(self.on_defer, cause)

    # -- read side ---------------------------------------------------------

    def frees_total(self) -> int:
        return sum(self.frees.values())

    def live_blocks(self) -> int:
        """Blocks alive per the ledger: the pool's `in_use` when the
        ledger was attached before the pool's first alloc."""
        return len(self._live)

    def snapshot(self) -> dict:
        """Cause totals, recent-window reuse / age quantiles, defers,
        the spill tier's books and the conservation verdict."""
        frees = dict(self.frees)
        reuse, ages = list(self._reuse), list(self._ages)
        out = {
            "admissions": self._tick,
            "births": self.births,
            "frees": frees,
            "frees_total": sum(frees.values()),
            "live_blocks": len(self._live),
            "defers": dict(self.defers),
            "spill": {
                "spilled": self.spilled,
                "demotions": self.spill_demotions,
                "restores": self.spill_restores,
                "drops": self.spill_drops,
            },
            "reuse_distance": {
                "count": len(reuse),
                "p50": sample_quantile(reuse, 0.50),
                "p95": sample_quantile(reuse, 0.95),
            },
            "block_age": {
                "count": len(ages),
                "p50": sample_quantile(ages, 0.50),
                "p95": sample_quantile(ages, 0.95),
            },
        }
        sp = out["spill"]
        content_alive = (
            (out["births"] - sp["restores"])
            - (out["frees_total"] - frees["spill"] + sp["drops"]))
        out["conserved"] = (out["births"] - out["frees_total"]
                            == out["live_blocks"]
                            and content_alive
                            == out["live_blocks"] + sp["spilled"]
                            and frees[UNATTRIBUTED] == 0)
        return out

    # -- chrome counter track -----------------------------------------------

    def _emit_event(self) -> None:
        self._events.append({
            "name": "kv_evictions", "ph": "C",
            "ts": round(self._wall() * 1e6, 1), "pid": 1, "tid": 0,
            "args": {c: self.frees[c] for c in EVICTION_CAUSES}})

    def counter_events(self, *, prefix: str = "") -> list[dict]:
        """Chrome "C" events for `/debug/traces` (cumulative frees per
        cause over time), named per model as `PhaseProfiler`'s are."""
        evs = [dict(e) for e in self._events]
        if prefix:
            for e in evs:
                e["name"] = f"{prefix}.{e['name']}"
        return evs
