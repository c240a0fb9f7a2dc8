"""Step anatomy of the continuous batcher's worker loop (counterpart:
kubeflow_tpu/obs/profiling.py's phase constants, `_PhaseStats` and
`PhaseProfiler`).

Every worker iteration decomposes into named phases with their wall
time, token counts and occupancy, aggregated into totals, rolling
percentiles and a goodput ledger. The server binds the
`serving_step_phase_seconds` and `serving_step_tokens` histograms
through `on_phase` and derives `serving_goodput_ratio`,
`serving_bubble_fraction` and `serving_kv_blocks_high_water` from
`goodput()` at scrape time; the fleet heartbeat folds `totals()` into
its prefill and decode seconds.

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

Left out, with the tracer they belong to: the chrome counter tracks
(`counter_events`, `merge_counter_tracks`) and `CompileWatch` /
`abstract_signature` (recompile counting).
"""

from __future__ import annotations

import collections
import contextlib
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
    `clock` is injectable (tests drive a fake one). The `on_phase(phase,
    seconds, tokens)` hook (seconds None for a token-only attribution)
    never kills the instrumented loop: its exceptions are swallowed."""

    def __init__(self, *, phases: tuple[str, ...] = SERVING_PHASES,
                 clock: Callable[[], float] | None = None,
                 window: int | None = 512):
        self.phases = tuple(phases)
        self.guard = LabelGuard(seed=self.phases, closed=True)
        self._clock = clock or time.perf_counter
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

    # -- pool and occupancy high-water marks -------------------------------

    def note_pool(self, in_use: int, capacity: int) -> None:
        self.pool_capacity = int(capacity)
        self.pool_high_water = max(self.pool_high_water, int(in_use))

    def note_occupancy(self, occupied: int, slots: int) -> None:
        self.slots = int(slots)
        self.occupancy_high_water = max(self.occupancy_high_water,
                                        int(occupied))

    # -- read side ---------------------------------------------------------

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
