"""In-process span tracer: contextvar parent propagation, a bounded ring
of traces, Chrome-trace JSON export (a copy of kubeflow_tpu/obs/
tracing.py: the port imports nothing of the JAX package).

The serving app's requests and the trainer's steps open spans through
one Tracer, so `/debug/traces` shows a request's child spans (admission,
the stream, the device calls dispatched to the executor) under its root.
No OpenTelemetry dependency: traces stay in a process-local ring and
export as Chrome trace events (`chrome://tracing` and Perfetto load
them directly).

Propagation is `contextvars`, so spans nest across asyncio tasks (each
request handler is its own context) and plain call stacks. A span
opened with no current parent starts a new trace; finishing a root span
commits the whole trace to the ring (oldest trace evicted first).

A span is HOST time: nothing here synchronizes the device.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import secrets
import threading
import time
from typing import Any, Callable, Iterator

# Spans per trace are bounded too: a runaway loop opening child spans
# must not grow one trace without limit while it stays unfinished.
MAX_SPANS_PER_TRACE = 512


def _valid_span_id(raw: str) -> bool:
    """Remote trace/span ids arrive in HTTP headers; accept only what
    `secrets.token_hex` could have minted (lowercase hex, sane length)
    so a hostile header cannot smuggle junk into trace exports."""
    return (isinstance(raw, str) and 8 <= len(raw) <= 64
            and all(c in "0123456789abcdef" for c in raw))


class Span:
    """One timed operation. `start`/`end` are epoch seconds."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "attrs", "thread", "_trace")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, start: float,
                 attrs: dict[str, Any], trace: "_Trace"):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: float | None = None
        self.attrs = attrs
        self.thread = threading.get_ident()
        self._trace = trace

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "start": self.start,
            "durationMs": round(self.duration * 1e3, 3),
            "attrs": dict(self.attrs),
        }


class _Trace:
    """Finished-span collector for one trace id (root + descendants)."""

    __slots__ = ("trace_id", "spans", "root", "seq")

    def __init__(self, trace_id: str, seq: int):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.root: Span | None = None
        self.seq = seq  # monotonic commit order (newest-first sorting)

    def add(self, span: Span) -> None:
        if len(self.spans) < MAX_SPANS_PER_TRACE:
            self.spans.append(span)


class Tracer:
    """`with tracer.span("name", key=value): ...`

    Thread-safe; each Tracer owns its ring so tests and independently
    deployed apps stay isolated. `max_traces` bounds memory — the ring
    evicts the OLDEST finished trace first.
    """

    def __init__(self, max_traces: int = 256,
                 clock: Callable[[], float] | None = None):
        import collections

        self.max_traces = max_traces
        self._clock = clock or time.time
        self._traces: "collections.deque[_Trace]" = collections.deque(
            maxlen=max_traces)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._current: contextvars.ContextVar[Span | None] = \
            contextvars.ContextVar(f"obs_span_{id(self)}", default=None)

    # -- span lifecycle ----------------------------------------------------

    def current_span(self) -> Span | None:
        return self._current.get()

    def current_trace_id(self) -> str | None:
        s = self._current.get()
        return s.trace_id if s is not None else None

    @contextlib.contextmanager
    def span(self, name: str, /, **attrs: Any) -> Iterator[Span]:
        # positional-only `name`: attrs are arbitrary key=value pairs
        # and "name" is a natural attr key (reconcile object names).
        parent = self._current.get()
        if parent is None:
            trace = _Trace(secrets.token_hex(16), next(self._seq))
            trace_id, parent_id = trace.trace_id, None
        else:
            trace = parent._trace
            trace_id, parent_id = parent.trace_id, parent.span_id
        s = Span(name, trace_id, secrets.token_hex(8), parent_id,
                 self._clock(), dict(attrs), trace)
        token = self._current.set(s)
        try:
            yield s
        except BaseException as e:
            s.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            s.end = self._clock()
            self._current.reset(token)
            trace.add(s)
            if parent is None:
                trace.root = s
                with self._lock:
                    self._traces.append(trace)

    @contextlib.contextmanager
    def span_from_remote(self, name: str, trace_id: str,
                         parent_span_id: str, /,
                         **attrs: Any) -> Iterator[Span]:
        """Open a root span that ADOPTS a remote parent context — the
        receiving half of cross-process propagation (`X-Trace-Id` +
        `X-Parent-Span` injected by the fleet router). The local trace
        commits under the REMOTE trace id with the remote span as
        parent, so both processes' rings hold joinable segments of one
        logical trace and a merger can reassemble the full tree.

        Malformed ids (propagation is an open HTTP header — never
        trust it) or an already-open local parent fall back to a
        normal `span()`: a bad header must not corrupt local nesting.
        """
        if (self._current.get() is not None
                or not _valid_span_id(trace_id)
                or not _valid_span_id(parent_span_id)):
            with self.span(name, **attrs) as s:
                yield s
            return
        trace = _Trace(trace_id, next(self._seq))
        s = Span(name, trace_id, secrets.token_hex(8), parent_span_id,
                 self._clock(), dict(attrs), trace)
        token = self._current.set(s)
        try:
            yield s
        except BaseException as e:
            s.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            s.end = self._clock()
            self._current.reset(token)
            trace.add(s)
            # This span is the local root: it commits the trace even
            # though its parent_id points at the remote caller's span.
            trace.root = s
            with self._lock:
                self._traces.append(trace)

    def wrap(self, fn: Callable, name: str, /, **attrs: Any) -> Callable:
        """Propagate the CURRENT context into a thread-pool callable
        (run_in_executor does not copy contextvars): the returned
        closure re-enters this context and opens `name` inside it, so
        device work dispatched to an executor still nests under the
        request's root span."""
        ctx = contextvars.copy_context()

        def run(*args, **kwargs):
            def inner():
                with self.span(name, **attrs):
                    return fn(*args, **kwargs)

            return ctx.run(inner)

        return run

    # -- read side ---------------------------------------------------------

    def traces(self, name: str | None = None,
               limit: int | None = None,
               trace_id: str | None = None) -> list[dict[str, Any]]:
        """Finished traces, NEWEST first, optionally filtered by root
        span name and/or exact trace id. Each entry: trace summary +
        its spans."""
        with self._lock:
            snap = list(self._traces)
        snap.sort(key=lambda t: t.seq, reverse=True)
        out = []
        for t in snap:
            root = t.root
            if root is None:
                continue
            if name is not None and root.name != name:
                continue
            if trace_id is not None and t.trace_id != trace_id:
                continue
            out.append({
                "traceId": t.trace_id,
                "name": root.name,
                "start": root.start,
                "durationMs": round(root.duration * 1e3, 3),
                "spans": [s.to_dict() for s in t.spans],
            })
            if limit is not None and len(out) >= limit:
                break
        return out

    def chrome_trace(self, name: str | None = None,
                     limit: int | None = None,
                     trace_id: str | None = None) -> dict[str, Any]:
        """Chrome trace-event JSON (the `chrome://tracing` / Perfetto
        load format): one complete ("ph": "X") event per span, ts/dur
        in microseconds, traces ordered newest first. `args` carries
        the span attrs plus trace/span ids so events remain joinable
        back to `X-Trace-Id` response headers."""
        events = []
        for t in self.traces(name=name, limit=limit, trace_id=trace_id):
            for s in t["spans"]:
                events.append({
                    "name": s["name"],
                    "cat": "obs",
                    "ph": "X",
                    "ts": round(s["start"] * 1e6, 1),
                    "dur": round(s["durationMs"] * 1e3, 1),
                    "pid": 1,
                    "tid": 1,
                    "args": {
                        "trace_id": s["traceId"],
                        "span_id": s["spanId"],
                        "parent_id": s["parentId"],
                        **s["attrs"],
                    },
                })
        return {"displayTimeUnit": "ms", "traceEvents": events}


def traces_response_payload(tracer: Tracer, query) -> dict[str, Any]:
    """Shared `/debug/traces` handler body for the dashboard and
    serving apps: `?name=` filters by root span name, `?limit=` caps
    trace count (default 100), `?format=summary` returns the span-tree
    summaries instead of Chrome events, `?trace_id=` selects one
    trace exactly (the id from an `X-Trace-Id` response header)."""
    name = query.get("name") or None
    trace_id = query.get("trace_id") or None
    try:
        limit = int(query.get("limit", "100"))
    except ValueError as e:
        raise ValueError(f"limit must be an integer: {e}") from None
    if query.get("format") == "summary":
        return {"traces": tracer.traces(name=name, limit=limit,
                                        trace_id=trace_id)}
    return tracer.chrome_trace(name=name, limit=limit, trace_id=trace_id)


def merge_chrome_traces(
        segments: list[tuple[str, dict[str, Any]]]) -> dict[str, Any]:
    """Merge per-process Chrome-trace payloads into one document — the
    cross-process half of distributed tracing. Each segment gets its
    own `pid` plus a `process_name` metadata event, so Perfetto shows
    "router" and each replica as separate process tracks while spans
    stay joinable through the shared `args.trace_id`/`parent_id`."""
    events: list[dict[str, Any]] = []
    for pid, (source, payload) in enumerate(segments, start=1):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 1, "args": {"name": source}})
        for e in payload.get("traceEvents", []):
            if e.get("ph") == "M":
                continue  # sources' own metadata is superseded
            events.append({**e, "pid": pid})
    return {"displayTimeUnit": "ms", "traceEvents": events}
