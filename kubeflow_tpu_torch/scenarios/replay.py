"""Open-loop trace replay: fire arrivals at recorded offsets, judge
the outcome against the trace's `expect` block.

Open-loop is the property that matters: a closed-loop harness (next
request waits for the last response) silently sheds load exactly when
the system degrades — the worst moment to look away. Here every
arrival fires at `at / speed` seconds after start whether or not the
target is keeping up, so queue meltdown shows up as TTFT, not as a
politely thinned workload (the coordinated-omission trap).

The engine is dependency-injected end to end: `clock`, `sleep`, and
the per-request `submit` callable are parameters, so tests drive a
fake clock and assert exact arrival fidelity, while the real
`HttpTarget` drives any serving endpoint (single replica or the fleet
router — same generate surface) with streamed SSE requests, measuring
TTFT at the first token frame and hanging up at `abandon_at` like the
impatient client the trace describes.

Prompt token ids are derived deterministically from (trace seed,
prefix_group, request id): requests in a group share their first
`prefix_tokens` ids, reproducing the radix-reuse structure without
shipping content.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable

from kubeflow_tpu_torch.scenarios.trace import Trace, TraceRequest

# Derived prompt token ids stay in a small band well inside every
# tiny-model vocab (and matching the loadtests' idiom) so one trace
# replays against any family.
_VOCAB_BAND = 480
_TOKEN_BASE = 5


def prompt_ids_for(req: TraceRequest, seed: int) -> list[int]:
    """Deterministic prompt for a trace request. Same group -> same
    first `prefix_tokens` ids; the remainder is unique per request id.
    Uses a hand-rolled LCG over a stable string hash (not `random`) so
    the mapping is frozen independent of stdlib implementation."""
    def stream(key: str, n: int) -> list[int]:
        # FNV-1a over the key seeds a 64-bit LCG
        h = 0xcbf29ce484222325
        for b in key.encode():
            h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
        out = []
        for _ in range(n):
            h = (h * 6364136223846793005 + 1442695040888963407) \
                & 0xFFFFFFFFFFFFFFFF
            out.append(_TOKEN_BASE + (h >> 33) % _VOCAB_BAND)
        return out

    shared = stream(f"{seed}:{req.prefix_group}", req.prefix_tokens) \
        if req.prefix_group else []
    rest = stream(f"{seed}:{req.prefix_group}:{req.id}",
                  req.prompt_tokens - len(shared))
    return shared + rest


def replay(trace: Trace,
           submit: Callable[[TraceRequest, float], dict[str, Any]], *,
           speed: float = 1.0,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           max_workers: int = 64) -> list[dict[str, Any]]:
    """Drive every trace request through `submit` at its arrival
    offset. `submit(req, t0)` runs on a worker thread and returns the
    per-request record; the engine stamps scheduling fidelity on top
    (`scheduled_at`, `dispatched_at` — both in trace-time seconds,
    i.e. already multiplied back by speed)."""
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    records: list[dict[str, Any]] = []
    lock = threading.Lock()

    def worker(req: TraceRequest, t0: float) -> None:
        dispatched = (clock() - t0) * speed
        try:
            rec = submit(req, t0)
        except Exception as e:  # a submit that raises is a failure,
            rec = {"ok": False,  # not a harness crash
                   "abandoned": False, "tokens": 0, "ttft_s": None,
                   "error": f"{type(e).__name__}: {e}"}
        rec.update(id=req.id, scheduled_at=req.at,
                   dispatched_at=round(dispatched, 6))
        with lock:
            records.append(rec)

    t0 = clock()
    with concurrent.futures.ThreadPoolExecutor(max_workers) as ex:
        futs = []
        for req in trace.requests:  # sorted by (at, id)
            target = req.at / speed
            while True:
                delta = target - (clock() - t0)
                if delta <= 0:
                    break
                sleep(delta)
            futs.append(ex.submit(worker, req, t0))
        for f in futs:
            f.result()  # surface harness bugs, not request failures
    records.sort(key=lambda r: (r["scheduled_at"], r["id"]))
    return records


class HttpTarget:
    """Submit callable for a live serving endpoint (replica or fleet
    router — the generate surface is identical). Streams SSE so TTFT
    is measured at the first token frame on the wire, and closes the
    connection at `abandon_at` to exercise the cancellation path."""

    def __init__(self, base_url: str, *, model: str = "tiny",
                 seed: int = 0, speed: float = 1.0,
                 timeout_s: float = 180.0,
                 clock: Callable[[], float] = time.monotonic):
        self.base = base_url.rstrip("/")
        self.model = model
        self.seed = seed
        self.speed = speed
        self.timeout_s = timeout_s
        self.clock = clock

    def __call__(self, req: TraceRequest, t0: float) -> dict[str, Any]:
        body = json.dumps({
            "tokens": [prompt_ids_for(req, self.seed)],
            "max_new": req.max_new, "stream": True}).encode()
        headers = {"Content-Type": "application/json",
                   "X-Request-Id": req.id}
        if req.tenant:
            headers["X-Tenant"] = req.tenant
        hreq = urllib.request.Request(
            f"{self.base}/v1/models/{self.model}:generate",
            data=body, headers=headers)
        # abandon deadline in REPLAY time (trace offsets scale by speed)
        deadline = (t0 + req.abandon_at / self.speed
                    if req.abandon_at is not None else None)
        sent = self.clock()
        ttft = None
        tokens = 0
        timer = None

        def hung_up() -> bool:
            return deadline is not None and self.clock() >= deadline

        try:
            with urllib.request.urlopen(
                    hreq, timeout=self.timeout_s) as r:
                if deadline is not None:
                    # the hang-up must fire even while BLOCKED waiting
                    # for the next frame (a queued request emits
                    # nothing to react to): a timer closes the
                    # response out from under the reader, which then
                    # raises and is booked abandoned below
                    timer = threading.Timer(
                        max(0.0, deadline - self.clock()), r.close)
                    timer.daemon = True
                    timer.start()
                for line in r:
                    if hung_up():
                        return {"ok": True, "abandoned": True,
                                "tokens": tokens, "ttft_s": ttft,
                                "wall_s": round(
                                    self.clock() - sent, 6)}
                    if not line.startswith(b"data: "):
                        continue
                    ev = json.loads(line[len(b"data: "):])
                    if ev.get("error"):
                        return {"ok": False, "abandoned": False,
                                "tokens": tokens, "ttft_s": ttft,
                                "error": str(ev["error"])}
                    if ev.get("done"):
                        break
                    got = ev.get("tokens")
                    if got:
                        if ttft is None:
                            ttft = self.clock() - sent
                        tokens += len(got[0])
        except (urllib.error.URLError, OSError, ValueError,
                AttributeError, http.client.HTTPException) as e:
            # AttributeError is http.client's artifact of close() from
            # the abandon timer landing mid-read (self.fp becomes
            # None); it IS the hang-up, not a harness bug
            if hung_up():
                return {"ok": True, "abandoned": True,
                        "tokens": tokens, "ttft_s": ttft,
                        "wall_s": round(self.clock() - sent, 6)}
            return {"ok": False, "abandoned": False, "tokens": tokens,
                    "ttft_s": ttft, "error": f"{type(e).__name__}: {e}"}
        finally:
            if timer is not None:
                timer.cancel()
        if deadline is not None and self.clock() >= deadline:
            # finished at/after the hang-up instant: the trace said
            # this client never saw the end — book it abandoned
            return {"ok": True, "abandoned": True, "tokens": tokens,
                    "ttft_s": ttft,
                    "wall_s": round(self.clock() - sent, 6)}
        return {"ok": True, "abandoned": False, "tokens": tokens,
                "ttft_s": ttft, "wall_s": round(self.clock() - sent, 6)}


def percentile(xs: list[float], q: float) -> float | None:
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def summarize(trace: Trace, records: list[dict[str, Any]], *,
              speed: float = 1.0) -> dict[str, Any]:
    """Fold per-request records into the result dict the `expect`
    block is evaluated against. Keys here ARE the expect vocabulary —
    add a key, and scenarios can gate on it."""
    completed = [r for r in records if r["ok"] and not r["abandoned"]]
    abandoned = [r for r in records if r["abandoned"]]
    failed = [r for r in records if not r["ok"]]
    ttfts = sorted(r["ttft_s"] for r in records
                   if r.get("ttft_s") is not None)
    skews = sorted(r["dispatched_at"] - r["scheduled_at"]
                   for r in records)
    offered = len(trace.requests)
    out = {
        "scenario": trace.name,
        "seed": trace.seed,
        "speed": speed,
        "offered": offered,
        "completed": len(completed),
        "completed_frac": round(len(completed) / offered, 4)
        if offered else 0.0,
        "abandoned": len(abandoned),
        "client_failures": len(failed),
        "tokens_out": sum(r["tokens"] for r in records),
        "ttft_p50_s": (round(percentile(ttfts, 0.50), 6)
                       if ttfts else None),
        "ttft_p95_s": (round(percentile(ttfts, 0.95), 6)
                       if ttfts else None),
        "ttft_max_s": round(ttfts[-1], 6) if ttfts else None,
        "arrival_skew_p95_s": (round(percentile(skews, 0.95), 6)
                               if skews else None),
        "duration_s": round(trace.duration_s / speed, 6),
    }
    if failed:
        out["first_error"] = failed[0].get("error")
    return out


def check_expect(expect: dict[str, dict[str, float]],
                 result: dict[str, Any]) -> list[str]:
    """Evaluate a trace's declarative expect block against a replay
    result. Returns human-readable violations (empty == pass). A bound
    on a key the result lacks — or that is None (e.g. p95 of zero
    observations) — is itself a violation: a scenario asserting on a
    metric that never materialized must fail, not vacuously pass."""
    failures = []
    for key, bounds in expect.items():
        v = result.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            failures.append(
                f"expect[{key}]: result has no numeric value "
                f"(got {v!r})")
            continue
        lo, hi = bounds.get("min"), bounds.get("max")
        if lo is not None and v < lo:
            failures.append(f"expect[{key}]: {v} < min {lo}")
        if hi is not None and v > hi:
            failures.append(f"expect[{key}]: {v} > max {hi}")
    return failures


def assert_expect(trace: Trace, result: dict[str, Any]) -> None:
    failures = check_expect(trace.expect, result)
    if failures:
        raise AssertionError(
            f"scenario {trace.name!r} violated its expect block: "
            + "; ".join(failures))
