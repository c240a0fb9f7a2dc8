"""Per-request token timelines: where did this request's time go?
(A copy of kubeflow_tpu/obs/timeline.py: the port imports nothing of
the JAX package.)

Histograms answer "how is the fleet doing"; a timeline answers the
next question an operator asks — "what happened to THIS request". The
`ContinuousBatcher` stamps one `RequestTimeline` per request with its
structural events (enqueue, admit with prefill split, preempt/resume,
finish) plus the timestamp of EVERY emitted token, and the serving app
exposes the result at `/v1/requests/{id}/timeline`.

Token timestamps are kept as a flat float list, not event dicts: a
4k-token generation costs one list of floats, and inter-token latency
(ITL) falls out as consecutive differences. Derived numbers:

- `queue_wait_s` — enqueue -> admit (the scheduling delay),
- `ttft_s`      — enqueue -> first token,
- ITL stats     — gaps between consecutive tokens, EXCLUDING gaps that
  span a preempt/resume hole (those measure scheduling, not decode;
  they are visible as events instead).

Everything takes an injectable clock so tests can assert exact math.
`TimelineStore` is the bounded keep — finished or not, oldest request
evicted first — that the debug endpoint reads from.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable

# Structural events per timeline are bounded: a pathological
# preempt/resume flap must not grow one request without limit.
MAX_EVENTS = 256
# Token timestamps are bounded by max_new upstream, but cap anyway.
MAX_TOKENS = 65536


class RequestTimeline:
    """Event + token-timestamp record for one request."""

    __slots__ = ("request_id", "model", "tenant", "prompt_tokens",
                 "max_new", "events", "tokens", "_clock", "_itl_break",
                 "done")

    def __init__(self, request_id: str, *, model: str = "",
                 tenant: str = "", prompt_tokens: int = 0,
                 max_new: int = 0,
                 clock: Callable[[], float] | None = None):
        self.request_id = request_id
        self.model = model
        self.tenant = tenant
        # workload shape, stamped by the batcher at enqueue; together
        # with the enqueue instant this makes any stored timeline
        # replayable (the scenario recorder reads exactly these)
        self.prompt_tokens = prompt_tokens
        self.max_new = max_new
        self._clock = clock or time.monotonic
        self.events: list[tuple[float, str, dict]] = []
        self.tokens: list[float] = []
        # next token gap spans a preempt/resume hole -> not an ITL
        self._itl_break = True  # first token has no predecessor
        self.done = False

    def event(self, kind: str, **detail: Any) -> None:
        if len(self.events) < MAX_EVENTS:
            self.events.append((self._clock(), kind, detail))
        if kind in ("preempt", "resume"):
            self._itl_break = True
        if kind == "finish":
            self.done = True

    def token(self) -> float | None:
        """Record one emitted token. Returns the inter-token gap in
        seconds, or None when the gap is not an ITL (first token, or
        first token after a preempt/resume hole)."""
        t = self._clock()
        gap = None
        if self.tokens and not self._itl_break:
            gap = t - self.tokens[-1]
        self._itl_break = False
        if len(self.tokens) < MAX_TOKENS:
            self.tokens.append(t)
        return gap

    # -- derived -----------------------------------------------------------

    def _first(self, kind: str) -> float | None:
        for t, k, _ in self.events:
            if k == kind:
                return t
        return None

    @property
    def queue_wait_s(self) -> float | None:
        t0, t1 = self._first("enqueue"), self._first("admit")
        return (t1 - t0) if t0 is not None and t1 is not None else None

    @property
    def ttft_s(self) -> float | None:
        t0 = self._first("enqueue")
        return (self.tokens[0] - t0) \
            if t0 is not None and self.tokens else None

    def itls(self) -> list[float]:
        """Inter-token gaps, excluding gaps across preempt/resume
        holes (recomputed from events, so it works on stored
        timelines too)."""
        holes = sorted(t for t, k, _ in self.events
                       if k in ("preempt", "resume"))
        out = []
        for a, b in zip(self.tokens, self.tokens[1:]):
            if any(a <= h <= b for h in holes):
                continue
            out.append(b - a)
        return out

    def to_dict(self) -> dict[str, Any]:
        """JSON shape for `/v1/requests/{id}/timeline`. Times are
        seconds RELATIVE to enqueue (monotonic clock — absolute values
        mean nothing to a client)."""
        t0 = self._first("enqueue")
        if t0 is None:
            t0 = self.events[0][0] if self.events else 0.0
        itls = self.itls()
        itls_sorted = sorted(itls)

        def pct(p: float) -> float | None:
            if not itls_sorted:
                return None
            return itls_sorted[min(len(itls_sorted) - 1,
                                   int(p * len(itls_sorted)))]

        return {
            "request_id": self.request_id,
            "model": self.model,
            "tenant": self.tenant,
            "prompt_tokens": self.prompt_tokens,
            "max_new": self.max_new,
            "output_tokens": len(self.tokens),
            # absolute arrival on the timeline's own clock: relative
            # times suffice for debugging ONE request, but recording a
            # replayable trace needs cross-request ordering
            "enqueue_monotonic_s": round(t0, 6),
            "done": self.done,
            "events": [
                {"t": round(t - t0, 6), "kind": k, **detail}
                for t, k, detail in self.events
            ],
            "tokens": len(self.tokens),
            "token_times": [round(t - t0, 6) for t in self.tokens],
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": self.ttft_s,
            "itl": {
                "count": len(itls),
                "mean_s": (sum(itls) / len(itls)) if itls else None,
                "p50_s": pct(0.50),
                "p95_s": pct(0.95),
                "max_s": max(itls) if itls else None,
            },
        }


class TimelineStore:
    """Bounded, thread-safe keep of recent timelines by request id.

    Both live and finished requests stay queryable; the oldest entry
    is evicted first. Duplicate ids (client-chosen) overwrite — last
    writer wins, matching what an operator would want to inspect."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._items: "collections.OrderedDict[str, RequestTimeline]" = \
            collections.OrderedDict()

    def add(self, tl: RequestTimeline) -> None:
        with self._lock:
            self._items.pop(tl.request_id, None)
            self._items[tl.request_id] = tl
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)

    def get(self, request_id: str) -> RequestTimeline | None:
        with self._lock:
            return self._items.get(request_id)

    def ids(self) -> list[str]:
        """Request ids currently stored, oldest first."""
        with self._lock:
            return list(self._items)

    def snapshot(self) -> list[RequestTimeline]:
        """Stored timelines, oldest first (the scenario recorder's
        enumeration surface)."""
        with self._lock:
            return list(self._items.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
