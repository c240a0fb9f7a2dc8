"""Label-cardinality guard for the metrics layer (a copy of
kubeflow_tpu/obs/cardinality.py: the port imports nothing of the JAX
package).

Per-tenant labels are bounded by tenant CONFIG on the serving side
(unknown identities resolve to `default` before they reach a metric),
but anywhere a raw client-supplied value becomes a label — the router's
per-tenant counters, span attributes echoing an `X-Tenant` header — an
attacker sending a fresh value per request would mint a fresh
timeseries per request. `LabelGuard` caps the distinct values a label
may take: known (seeded) values pass through, novel values pass until
the cap, and everything past the cap collapses into one overflow
bucket (`other`)."""

from __future__ import annotations

import hashlib
import threading

OVERFLOW_LABEL = "other"


class LabelGuard:
    """Bounded admission of label values. Thread-safe: counters are
    bumped from handler threads and rendered from scrape time."""

    def __init__(self, max_values: int = 32,
                 overflow: str = OVERFLOW_LABEL, seed=(),
                 closed: bool = False, hashed: bool = False):
        if max_values < 1:
            raise ValueError(f"max_values must be >= 1, got {max_values}")
        self.max_values = int(max_values)
        self.overflow = overflow
        # closed guards admit ONLY the seeded set — the right mode for
        # label values that enumerate code (phase names, watched fn
        # names), where a novel value is a bug, not a new tenant
        self.closed = bool(closed)
        # hashed guards never grow state at all: admit() maps every
        # value to 16 hex chars of blake2b, so the FORMAT is bounded by
        # construction and the VALUE never leaks raw client data into a
        # label. The series count is bounded by the caller (e.g. a
        # top-K prefix-heat digest), not by this guard — there is no
        # overflow bucket and nothing to seed.
        self.hashed = bool(hashed)
        if self.hashed and self.closed:
            raise ValueError("hashed and closed modes are exclusive")
        self._lock = threading.Lock()
        self._values: set[str] = set()
        self.overflowed = 0  # values that hit the cap, cumulative
        for v in seed:
            with self._lock:
                self._values.add(v or self.overflow)

    def admit(self, value: str) -> str:
        """The label value to actually use for `value`: itself while
        seeded (closed mode) or under the cap (open mode), the overflow
        bucket after; hashed mode returns the 16-hex digest of any
        value. The overflow bucket itself never counts against the
        cap."""
        value = value or self.overflow
        if self.hashed:
            return hashlib.blake2b(
                value.encode("utf-8", "replace"),
                digest_size=8).hexdigest()
        if value == self.overflow:
            return self.overflow
        with self._lock:
            if value in self._values:
                return value
            if not self.closed and len(self._values) < self.max_values:
                self._values.add(value)
                return value
            self.overflowed += 1
            return self.overflow

    def known(self) -> set[str]:
        with self._lock:
            return set(self._values)
