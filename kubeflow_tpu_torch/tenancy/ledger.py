"""Per-tenant ledger: token buckets + live usage accounting.

Two buckets per tenant: requests/s (enforced at the admission door —
an empty bucket is a `Throttled`, HTTP 429 with a computed
Retry-After) and generated-tokens/s (enforced by PACING, not
rejection: `charge_tokens` may drive the bucket negative as tokens
stream out, and the fair-share scheduler simply stops popping for a
tenant in debt until it refills — mid-generation rejection isn't a
thing). The clock is injectable so refill math is unit-testable
without sleeping. (A copy of kubeflow_tpu/tenancy/ledger.py.)

The ledger is also the single source of truth the serving metrics
render from (`serving_tenant_*` — a scrape-time collector reads
`stats()`), which is why every counter lives here instead of being
scattered through the batcher.
"""

from __future__ import annotations

import time

from kubeflow_tpu_torch.tenancy.config import TenancyConfig

# Throttle reasons, zero-seeded into serving_tenant_throttled_total:
# `rate` = request bucket empty at the door, `kv_quota` = admission
# deferred because the tenant's concurrent KV-block share is spent.
THROTTLE_REASONS = ("rate", "kv_quota")


class Throttled(RuntimeError):
    """Tenant over its rate limit — shed load (HTTP 429). Carries the
    bucket's refill time so the 429 can say WHEN to come back instead
    of a hardcoded Retry-After."""

    def __init__(self, tenant: str, reason: str, retry_after: float):
        super().__init__(
            f"tenant {tenant!r} throttled ({reason}); "
            f"retry in {retry_after:.2f}s")
        self.tenant = tenant
        self.reason = reason
        self.retry_after = retry_after


class TokenBucket:
    """Classic token bucket. rate <= 0 disables the limit entirely;
    burst <= 0 defaults to max(1, rate) (one second of headroom)."""

    __slots__ = ("rate", "burst", "level", "_t", "_clock")

    def __init__(self, rate: float, burst: float = 0.0, *,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate)
        self.level = self.burst
        self._clock = clock
        self._t = clock()

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0

    def _refill(self) -> None:
        now = self._clock()
        if now > self._t:
            self.level = min(self.burst,
                             self.level + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        """Take n tokens iff available now (the admission door)."""
        if self.unlimited:
            return True
        self._refill()
        if self.level >= n:
            self.level -= n
            return True
        return False

    def take(self, n: float = 1.0) -> None:
        """Unconditional charge; the level may go NEGATIVE (debt).
        Used for generated tokens, which exist whether or not the
        tenant had budget — debt pauses the tenant instead."""
        if self.unlimited:
            return
        self._refill()
        self.level -= n

    def delay_until(self, n: float = 1.0) -> float:
        """Seconds until n tokens are available (0.0 = now)."""
        if self.unlimited:
            return 0.0
        self._refill()
        return max(0.0, (n - self.level) / self.rate)

    def debt_delay(self) -> float:
        """Seconds until the bucket is back to >= 0 (0.0 = solvent)."""
        if self.unlimited:
            return 0.0
        self._refill()
        return max(0.0, -self.level / self.rate)


class TenantUsage:
    """Live + cumulative accounting for one tenant."""

    __slots__ = ("admitted", "completed", "tokens", "slots_held",
                 "blocks_held", "preempted", "throttled")

    def __init__(self):
        self.admitted = 0      # requests past the rate-limit door
        self.completed = 0     # requests finished (any way)
        self.tokens = 0        # tokens generated, cumulative
        self.slots_held = 0    # decode slots held right now
        self.blocks_held = 0   # exclusively-owned KV blocks right now
        self.preempted = 0     # times a decode was evicted, cumulative
        self.throttled = dict.fromkeys(THROTTLE_REASONS, 0)

    def as_dict(self) -> dict:
        return {
            "admitted": self.admitted,
            "completed": self.completed,
            "tokens": self.tokens,
            "slots_held": self.slots_held,
            "blocks_held": self.blocks_held,
            "preempted": self.preempted,
            "throttled": dict(self.throttled),
        }


class TenantLedger:
    """Rate limits + usage for every tenant in a TenancyConfig. All
    identities are RESOLVED through the config first, so the key space
    is bounded by configuration (unknown names account as `default`)."""

    def __init__(self, config: TenancyConfig, *, clock=time.monotonic):
        self.config = config
        self._clock = clock
        self._req: dict[str, TokenBucket] = {}
        self._tok: dict[str, TokenBucket] = {}
        # zero-seed: every configured tenant has a row before traffic,
        # so /metrics exposes the full series set from the first scrape
        self._usage: dict[str, TenantUsage] = {
            name: TenantUsage() for name in config.names()}

    def _key(self, tenant: str) -> str:
        return self.config.resolve(tenant).name

    def usage(self, tenant: str) -> TenantUsage:
        return self._usage.setdefault(self._key(tenant), TenantUsage())

    def _request_bucket(self, tenant: str) -> TokenBucket:
        key = self._key(tenant)
        b = self._req.get(key)
        if b is None:
            spec = self.config.resolve(key)
            b = self._req[key] = TokenBucket(
                spec.requests_per_s, spec.request_burst,
                clock=self._clock)
        return b

    def _token_bucket(self, tenant: str) -> TokenBucket:
        key = self._key(tenant)
        b = self._tok.get(key)
        if b is None:
            spec = self.config.resolve(key)
            b = self._tok[key] = TokenBucket(
                spec.tokens_per_s, spec.token_burst, clock=self._clock)
        return b

    # -- admission door ----------------------------------------------------

    def check_request(self, tenant: str) -> None:
        """Charge one request against the tenant's bucket, or raise
        Throttled with the refill time. Call BEFORE spending anything
        on the request."""
        key = self._key(tenant)
        b = self._request_bucket(key)
        if not b.try_take(1.0):
            self.note_throttled(key, "rate")
            raise Throttled(key, "rate", b.delay_until(1.0))
        self.usage(key).admitted += 1

    # -- pacing (generated tokens/s) ---------------------------------------

    def charge_tokens(self, tenant: str, n: int = 1) -> None:
        u = self.usage(tenant)
        u.tokens += n
        self._token_bucket(tenant).take(float(n))

    def runnable(self, tenant: str) -> bool:
        """False while the tenant's token bucket is in debt — the
        scheduler skips its queue until the debt refills."""
        return self._token_bucket(tenant).debt_delay() == 0.0

    def pacing_delay(self, tenant: str) -> float:
        return self._token_bucket(tenant).debt_delay()

    # -- KV share ----------------------------------------------------------

    def block_limit(self, tenant: str, capacity: int) -> int | None:
        """Max pool blocks this tenant may hold concurrently, or None
        when uncapped."""
        share = self.config.resolve(tenant).kv_block_share
        if share >= 1.0:
            return None
        return max(1, int(share * capacity))

    def blocks_held(self, tenant: str) -> int:
        return self.usage(tenant).blocks_held

    # -- bookkeeping hooks (the batcher calls these) -----------------------

    def note_slot_taken(self, tenant: str, blocks: int) -> None:
        u = self.usage(tenant)
        u.slots_held += 1
        u.blocks_held += blocks

    def note_slot_released(self, tenant: str, blocks: int) -> None:
        u = self.usage(tenant)
        u.slots_held -= 1
        u.blocks_held -= blocks

    def note_completed(self, tenant: str) -> None:
        self.usage(tenant).completed += 1

    def note_preempted(self, tenant: str) -> None:
        self.usage(tenant).preempted += 1

    def note_throttled(self, tenant: str, reason: str) -> None:
        u = self.usage(tenant)
        u.throttled[reason] = u.throttled.get(reason, 0) + 1

    def stats(self) -> dict[str, dict]:
        return {name: u.as_dict() for name, u in self._usage.items()}
