"""Record a live run into a replayable trace.

The serving app already keeps a bounded `TimelineStore` of per-request
`RequestTimeline`s and serves them at
`/v1/requests/{id}/timeline` (ids enumerable at `/v1/requests/
timelines`). A timeline carries everything a faithful replay needs —
the enqueue stamp (arrival), tenant, prompt length, the max_new ask,
and whether the request finished — so ANY live run can be captured
after the fact: no recording flag, no second code path on the hot
side.

Offsets are re-based to the earliest enqueue in the capture, so a
recorded trace always starts at 0. A timeline that never reached
`finish` records as an abandoned arrival (abandon_at = its last
observed activity): replaying the capture reproduces the hang-up, not
an idealized patient client.

Prefix-group structure is NOT recoverable from timelines (the radix
tree sees token ids; the timeline, by design, stores none), so
recorded traces have empty groups — `meta.recorded_from` says so.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Iterable

from kubeflow_tpu_torch.scenarios.trace import Trace, TraceRequest


def trace_from_timeline_payloads(
        payloads: Iterable[dict[str, Any]], *, name: str = "recorded",
        expect: dict | None = None,
        meta: dict | None = None) -> Trace:
    """Build a trace from `/v1/requests/{id}/timeline` response
    bodies. Payloads missing the recorder fields (`enqueue_monotonic_s`
    etc. — pre-extension servers) are rejected by name, not guessed
    around."""
    rows = []
    for p in payloads:
        missing = [k for k in ("request_id", "enqueue_monotonic_s",
                               "prompt_tokens", "max_new") if
                   p.get(k) in (None, "") and p.get(k) != 0]
        if missing:
            raise ValueError(
                f"timeline {p.get('request_id')!r} lacks recorder "
                f"fields {missing} — server predates the scenario "
                "recorder?")
        if p["prompt_tokens"] < 1 or p["max_new"] < 1:
            # warmup probes and degenerate asks are not replayable
            # arrivals; skip rather than invent lengths
            continue
        rows.append(p)
    if not rows:
        raise ValueError("no replayable timelines in the capture")
    t0 = min(p["enqueue_monotonic_s"] for p in rows)
    reqs = []
    for p in rows:
        at = p["enqueue_monotonic_s"] - t0
        abandon_at = None
        if not p.get("done"):
            # last observed activity relative to trace start; a
            # timeline with no tokens/events abandons at arrival
            last = max([p["enqueue_monotonic_s"]]
                       + [p["enqueue_monotonic_s"] + t
                          for t in p.get("token_times", [])]
                       + [p["enqueue_monotonic_s"] + e["t"]
                          for e in p.get("events", [])])
            abandon_at = last - t0
        reqs.append(TraceRequest(
            id=p["request_id"], at=at,
            prompt_tokens=int(p["prompt_tokens"]),
            max_new=int(p["max_new"]),
            tenant=p.get("tenant", ""),
            abandon_at=abandon_at))
    return Trace(name=name, requests=reqs, seed=0,
                 generator="recorded",
                 expect=expect or {"client_failures": {"max": 0}},
                 meta=dict(meta or {}, recorded_from="timeline_store",
                           prefix_groups_recovered=False))


def trace_from_store(store, *, name: str = "recorded",
                     expect: dict | None = None,
                     meta: dict | None = None) -> Trace:
    """In-process capture straight off a `TimelineStore`."""
    return trace_from_timeline_payloads(
        (tl.to_dict() for tl in store.snapshot()),
        name=name, expect=expect, meta=meta)


def fetch_timelines(base_url: str, ids: Iterable[str] | None = None,
                    *, timeout: float = 10.0) -> list[dict[str, Any]]:
    """Pull timelines over HTTP. With ids=None, enumerate the server's
    store via `/v1/requests/timelines`. Evicted ids (bounded store)
    404 and are skipped — the capture is best-effort by design."""
    base = base_url.rstrip("/")
    if ids is None:
        with urllib.request.urlopen(f"{base}/v1/requests/timelines",
                                    timeout=timeout) as r:
            ids = json.loads(r.read())["requests"]
    out = []
    for rid in ids:
        try:
            with urllib.request.urlopen(
                    f"{base}/v1/requests/{rid}/timeline",
                    timeout=timeout) as r:
                out.append(json.loads(r.read()))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
            e.close()
    return out


def record_from_server(base_url: str, *,
                       ids: Iterable[str] | None = None,
                       name: str = "recorded",
                       expect: dict | None = None,
                       meta: dict | None = None) -> Trace:
    """One-call capture: enumerate (or take) request ids, fetch their
    timelines, and fold them into a trace."""
    payloads = fetch_timelines(base_url, ids)
    return trace_from_timeline_payloads(
        payloads, name=name, expect=expect,
        meta=dict(meta or {}, source_url=base_url))
