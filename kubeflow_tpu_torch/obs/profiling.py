"""Step anatomy, goodput and the compile watch (counterpart:
kubeflow_tpu/obs/profiling.py).

Every worker iteration decomposes into named phases with their wall
time, token counts and occupancy, aggregated into totals, rolling
percentiles and a goodput ledger. The server binds the
`serving_step_phase_seconds` and `serving_step_tokens` histograms
through `on_phase` and derives `serving_goodput_ratio`,
`serving_bubble_fraction` and `serving_kv_blocks_high_water` from
`goodput()` at scrape time; the fleet heartbeat folds `totals()` into
its prefill and decode seconds; `/debug/traces` merges the Chrome
counter tracks (`counter_events`: phase budgets, pool fill, occupancy)
into the span events. The trainer runs one with `TRAIN_PHASES`.

Phases of the continuous batcher:

  admit          queue pop, block planning, slot recycling, adoption
  prefill        a monolithic admission group's prefill (its tokens)
  prefill_chunk  one chunked-prefill slice (its tokens)
  decode         dispatching a decode chunk, and waiting on the oldest
                 chunk's host copy
  draft, verify  a speculative round: one device call queues both legs,
                 `draft` times its dispatch and `verify` the wait for
                 its results
  sample         reading a chunk's tokens off its host copy
  detokenize     per-token emit bookkeeping (stop scan, timelines,
                 stream queues)
  preempt        evicting a batch-class decode
  resume         zero-duration marker per preempted re-admission
  host_gap       the residual of an iteration that no phase claims
  idle           waiting for work; excluded from goodput

These are HOST times. On the card a decode chunk is a CUDA-graph replay
queued behind the chunks in flight: `decode` times the replay's
dispatch and the wait on the previous chunk's host copy, not the
chunk's device work, which is what the reference's phase means on a
TPU too, where dispatch is asynchronous. Nothing here synchronizes the
device to turn a phase into device time: that would serialize the
dispatch-ahead pipeline. `goodput_ratio` is then the host-side share.

`CompileWatch` keys every call of a watched entry point by the abstract
signature of its arguments; a signature never seen before, past the
fn's first, is a recompile (`serving_recompiles_total{fn}` /
`train_recompiles_total{fn}`, and a `recompile` span). The reference
keys a jitted program's arguments, so a novel one is a trace and a
compile. On the card the port's programs are CUDA graphs picked by a
key (serving/graphs.py), so the batcher watches its entry points
through `key=`: the arguments that pick the graph (steps, slice width,
gamma, the sampling key), or for the eager admission calls the padded
row count and bucket the reference compiles per. A novel signature of a
graphed entry point is then a graph captured in traffic.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Any, Callable

from kubeflow_tpu_torch.obs.cardinality import LabelGuard
from kubeflow_tpu_torch.obs.metrics import sample_quantile

# the serving step anatomy (ContinuousBatcher's worker loop)
SERVING_PHASES = ("admit", "prefill", "prefill_chunk", "decode",
                  "draft", "verify", "sample", "detokenize",
                  "preempt", "resume", "host_gap", "idle")
# the training step anatomy: one step phase and the gap between steps
TRAIN_PHASES = ("step", "host_gap")
# goodput's numerator: the phases that produce tokens
GOODPUT_PHASES = ("decode", "draft", "verify", "step")
# excluded from goodput's denominator: a parked batcher has no work
IDLE_PHASES = ("idle",)
# the entry points the compile watches wrap (closed fn sets)
WATCHED_SERVING_FNS = ("decode_step", "prefill", "insert_many",
                       "gather_seed", "reset_slots", "prefill_append",
                       "spec_draft", "spec_verify")
WATCHED_TRAIN_FNS = ("train_step",)

_MAX_COUNTER_EVENTS = 2048


def _dtype_name(dtype) -> str:
    # `torch.bfloat16` renders as the reference's `bfloat16`: the same
    # shapes and dtypes give the same signature in both frameworks
    name = str(dtype)
    return name[6:] if name.startswith("torch.") else name


def abstract_signature(args: tuple, kwargs: dict) -> str:
    """Compact key for a call's abstract shapes: arrays (numpy, torch,
    anything with `shape` and `dtype`) render as `dtype[d0,d1,...]`,
    python scalars by value, containers structurally; an opaque leaf by
    its type's name."""

    def sig(x: Any) -> str:
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            return f"{_dtype_name(dtype)}[{','.join(str(d) for d in shape)}]"
        if isinstance(x, (bool, int, float, str, bytes)) or x is None:
            return repr(x)
        if isinstance(x, (tuple, list)):
            return "(" + ",".join(sig(v) for v in x) + ")"
        if isinstance(x, dict):
            items = sorted(x.items(), key=lambda kv: str(kv[0]))
            return "{" + ",".join(f"{k}:{sig(v)}" for k, v in items) + "}"
        # by type only: better to miss a recompile than to invent one
        # per object identity
        return type(x).__name__

    return sig(args) + sig(kwargs) if kwargs else sig(args)


class _PhaseStats:
    __slots__ = ("count", "total_s", "tokens", "window")

    def __init__(self, window: int | None):
        self.count = 0
        self.total_s = 0.0
        self.tokens = 0
        self.window: Any = (collections.deque(maxlen=window)
                            if window else [])


class PhaseProfiler:
    """Named-phase timings aggregated into totals, rolling-window
    percentiles and a goodput ledger.

        with profiler.phase("decode"):
            ... dispatch ...

    Phases nest: a parent records its EXCLUSIVE time (admit excludes the
    prefill it contains), so phase sums reconcile against wall time.
    `begin_iteration` / `end_iteration` bracket one worker-loop pass and
    book the unclaimed residual as `host_gap`: the phase sums of an
    iteration equal its wall time by construction. Phase names are a
    closed set: an unknown name collapses to the guard's `other`.
    `clock` is injectable (tests drive a fake one); `wall_clock` stamps
    the counter events on the tracer's clock. The `on_phase(phase,
    seconds, tokens)` hook (seconds None for a token-only attribution)
    never kills the instrumented loop: its exceptions are swallowed."""

    def __init__(self, *, phases: tuple[str, ...] = SERVING_PHASES,
                 clock: Callable[[], float] | None = None,
                 wall_clock: Callable[[], float] | None = None,
                 window: int | None = 512):
        self.phases = tuple(phases)
        self.guard = LabelGuard(seed=self.phases, closed=True)
        self._clock = clock or time.perf_counter
        self._wall = wall_clock or time.time
        self._window = window
        self._lock = threading.Lock()
        self._stats: dict[str, _PhaseStats] = {
            p: _PhaseStats(window) for p in self.phases}
        # nesting stack (one worker by construction): [name, start,
        # child seconds]
        self._stack: list[list] = []
        self._iter_t0: float | None = None
        self._iter_claimed = 0.0
        self._t_first: float | None = None
        self._t_last: float | None = None
        self.on_phase: Callable[[str, float | None, int], None] | None \
            = None
        self.pool_high_water = 0
        self.pool_capacity = 0
        self.occupancy_high_water = 0
        self.slots = 0
        self._pool_last = -1
        self._occ_last = -1
        # Chrome "C" events: a point per change of pool fill or
        # occupancy, the phase totals per iteration
        self._events: collections.deque = collections.deque(
            maxlen=_MAX_COUNTER_EVENTS)

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name: str, tokens: int = 0):
        start = self._clock()
        if self._t_first is None:
            # the observed window opens at the first phase's start
            self._t_first = start
        frame = [name, start, 0.0]
        self._stack.append(frame)
        try:
            yield
        finally:
            dur = self._clock() - start
            if self._stack and self._stack[-1] is frame:
                self._stack.pop()
            if self._stack:
                self._stack[-1][2] += dur
            self.record(name, max(0.0, dur - frame[2]), tokens=tokens)

    def record(self, name: str, seconds: float, tokens: int = 0) -> None:
        name = self.guard.admit(name)
        seconds = max(0.0, float(seconds))
        now = self._clock()
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _PhaseStats(self._window)
            st.count += 1
            st.total_s += seconds
            st.tokens += int(tokens)
            st.window.append(seconds)
            self._t_last = now
            if self._t_first is None:
                self._t_first = now - seconds
            if self._iter_t0 is not None:
                # exclusive durations: the records of an iteration sum to
                # the inclusive wall of its top-level phases
                self._iter_claimed += seconds
        self._hook(name, seconds, int(tokens))

    def add_tokens(self, name: str, tokens: int) -> None:
        """Tokens for a phase without a timing sample: decode tokens are
        counted where the host reads them, decode time at dispatch."""
        if tokens <= 0:
            return
        name = self.guard.admit(name)
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _PhaseStats(self._window)
            st.tokens += int(tokens)
        self._hook(name, None, int(tokens))

    def _hook(self, name: str, seconds: float | None, tokens: int) -> None:
        if self.on_phase is not None:
            try:
                self.on_phase(name, seconds, tokens)
            except Exception:  # noqa: BLE001 — a metrics hook never
                pass           # kills the instrumented loop

    def begin_iteration(self) -> None:
        self._iter_t0 = self._clock()
        self._iter_claimed = 0.0

    def end_iteration(self) -> None:
        """Book the pass's residual (its wall minus every phase recorded
        since `begin_iteration`) as `host_gap`."""
        if self._iter_t0 is None:
            return
        residual = (self._clock() - self._iter_t0) - self._iter_claimed
        self._iter_t0 = None
        if residual > 0.0:
            self.record("host_gap", residual)
        self._emit_phase_track()

    # -- pool and occupancy: high-water marks and counter tracks -----------

    def _event(self, name: str, args: dict) -> None:
        self._events.append({"name": name, "ph": "C",
                             "ts": round(self._wall() * 1e6, 1),
                             "pid": 1, "tid": 0, "args": args})

    def note_pool(self, in_use: int, capacity: int) -> None:
        self.pool_capacity = int(capacity)
        in_use = int(in_use)
        self.pool_high_water = max(self.pool_high_water, in_use)
        if in_use != self._pool_last:
            self._pool_last = in_use
            self._event("kv_blocks", {"in_use": in_use})

    def note_occupancy(self, occupied: int, slots: int) -> None:
        self.slots = int(slots)
        occupied = int(occupied)
        self.occupancy_high_water = max(self.occupancy_high_water,
                                        occupied)
        if occupied != self._occ_last:
            self._occ_last = occupied
            self._event("batch_occupancy", {"slots_active": occupied})

    def _emit_phase_track(self) -> None:
        with self._lock:
            args = {p: round(st.total_s, 6)
                    for p, st in self._stats.items() if st.count}
        if args:
            self._event("phase_seconds", args)

    # -- read side ---------------------------------------------------------

    def counter_events(self, *, prefix: str = "") -> list[dict]:
        """Chrome counter-track events (`"ph": "C"`) on the tracer's wall
        clock, so they merge into one `/debug/traces` payload with the
        spans; `prefix` namespaces the track names per model."""
        out = []
        for e in list(self._events):
            e = dict(e)
            if prefix:
                e["name"] = f"{prefix}.{e['name']}"
            out.append(e)
        return out

    def totals(self) -> dict[str, float]:
        with self._lock:
            return {p: st.total_s for p, st in self._stats.items()}

    def phase_tokens(self) -> dict[str, int]:
        with self._lock:
            return {p: st.tokens for p, st in self._stats.items()}

    def samples(self, name: str) -> list[float]:
        with self._lock:
            st = self._stats.get(name)
            return list(st.window) if st else []

    def wall_s(self) -> float:
        """The observed window, first phase start to last record."""
        with self._lock:
            if self._t_first is None or self._t_last is None:
                return 0.0
            return self._t_last - self._t_first

    def goodput(self) -> dict[str, float]:
        """The ledger: the token-producing phases' share of non-idle
        time, the host_gap (bubble) share, and the high-water marks."""
        totals = self.totals()
        busy = sum(s for p, s in totals.items() if p not in IDLE_PHASES)
        good = sum(totals.get(p, 0.0) for p in GOODPUT_PHASES)
        bubble = totals.get("host_gap", 0.0)
        return {
            "goodput_ratio": good / busy if busy > 0 else 0.0,
            "bubble_fraction": bubble / busy if busy > 0 else 0.0,
            "busy_s": busy,
            "idle_s": sum(totals.get(p, 0.0) for p in IDLE_PHASES),
            "kv_blocks_high_water": self.pool_high_water,
            "kv_blocks_capacity": self.pool_capacity,
            "occupancy_high_water": self.occupancy_high_water,
            "slots": self.slots,
        }

    def snapshot(self) -> dict:
        """Per-phase counts, totals, tokens and rolling p50 / p95
        (`sample_quantile`), with the goodput ledger and the wall."""
        with self._lock:
            items = [(p, st.count, st.total_s, st.tokens, list(st.window))
                     for p, st in self._stats.items()]
        phases = {p: {"count": count, "total_s": round(total_s, 6),
                      "tokens": tokens,
                      "p50_s": sample_quantile(win, 0.50),
                      "p95_s": sample_quantile(win, 0.95)}
                  for p, count, total_s, tokens, win in items}
        return {"phases": phases, "goodput": self.goodput(),
                "wall_s": round(self.wall_s(), 6)}


class CompileWatch:
    """Recompile detector over a batcher's or trainer's entry points.

    `watch(fn, name, key=None)` returns a wrapper that keys every call by
    `abstract_signature` of its arguments, or of `key(*args, **kwargs)`
    when given (the port's graphed entry points pass static buffers:
    their graph is picked by the values `key` returns). The FIRST
    signature per fn is the expected first build; every novel signature
    after it is a recompile: the count rises, `on_recompile(fn, sig)`
    fires (the server binds `serving_recompiles_total{fn}` there) and,
    with a tracer attached, a `recompile` span records the signature. A
    repeated signature costs one string build and a set lookup. fn
    names are a closed set behind a LabelGuard, seeded by `watch`."""

    def __init__(self, *, tracer=None,
                 on_recompile: Callable[[str, str], None] | None = None):
        self.tracer = tracer
        self.on_recompile = on_recompile
        self.guard = LabelGuard()
        self._seen: dict[str, set[str]] = {}
        self._recompiles: dict[str, int] = {}
        self._lock = threading.Lock()

    def watch(self, fn: Callable, name: str,
              key: Callable | None = None) -> Callable:
        name = self.guard.admit(name)
        with self._lock:
            self._seen.setdefault(name, set())
            self._recompiles.setdefault(name, 0)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                sig = (abstract_signature(args, kwargs) if key is None
                       else abstract_signature(key(*args, **kwargs), {}))
            except Exception:  # noqa: BLE001 — the watch never breaks fn
                return fn(*args, **kwargs)
            with self._lock:
                seen = self._seen[name]
                novel = sig not in seen
                first = novel and not seen
                if novel:
                    seen.add(sig)
                    if not first:
                        self._recompiles[name] += 1
            if novel and not first:
                self._note_recompile(name, sig)
            return fn(*args, **kwargs)

        return wrapped

    def _note_recompile(self, name: str, sig: str) -> None:
        if self.tracer is not None:
            try:
                with self.tracer.span("recompile", fn=name,
                                      signature=sig[:512]):
                    pass
            except Exception:  # noqa: BLE001
                pass
        if self.on_recompile is not None:
            try:
                self.on_recompile(name, sig)
            except Exception:  # noqa: BLE001 — a metrics hook never
                pass           # kills the instrumented loop

    def counts(self) -> dict[str, int]:
        """Per-fn recompile counts (`/debug/profile`'s `recompiles`; the
        `*_recompiles_total{fn}` counters mirror them)."""
        with self._lock:
            return dict(self._recompiles)

    def watched(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._seen)


def merge_counter_tracks(payload: dict, events: list[dict]) -> dict:
    """Append counter-track events to a Chrome-trace payload in place
    (a summary payload without `traceEvents` is left as it is)."""
    if isinstance(payload, dict) and isinstance(
            payload.get("traceEvents"), list):
        payload["traceEvents"].extend(events)
    return payload
