"""Declarative SLOs evaluated into multi-window burn-rate gauges
(counterpart: kubeflow_tpu/obs/slo.py, of which this is a copy).

An `Slo` names an objective ("99% of interactive requests see TTFT
under 500 ms"); the `SloEngine` turns a stream of good/bad events into
**burn rates** over a short and a long window:

    burn = bad_fraction_in_window / error_budget,
    error_budget = 1 - objective

Burn 1.0 means the service is spending its error budget exactly as
fast as the objective allows; the classic multi-window alert fires
when BOTH windows burn hot (short window = it is happening now, long
window = it is not just a blip). We expose the raw rates and leave the
AND to the alerting layer.

The engine IS a registry metric (duck-typed like `obs.Histogram`:
`name`/`help`/`TYPE`/`expositions()`), so wiring is one
`registry.register(engine)` and the gauge is computed live at scrape
time. Every `slo x window` pair is always emitted — zero-seeded — so
rates are well-defined from the first scrape even before traffic.

Feeders run on the serving hot path and the batcher worker thread, so
`observe`/`record` are a deque append under one lock; windows are
pruned lazily. The clock is injectable for tests.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Iterator

# Events kept per SLO: bounds memory if a window is set absurdly long
# or traffic is extreme; at the default 600 s long window this is only
# reached past ~27 events/s, where subsampling barely moves a fraction.
MAX_EVENTS_PER_SLO = 16384

WINDOWS = ("short", "long")


class Slo:
    """One objective. `objective` is the good-fraction target (0,1);
    `threshold_s` lets latency feeders call `observe(name, seconds)`
    instead of pre-classifying good/bad themselves."""

    __slots__ = ("name", "objective", "threshold_s", "description")

    def __init__(self, name: str, objective: float,
                 threshold_s: float | None = None, description: str = ""):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"slo {name!r}: objective must be in (0, 1), "
                f"got {objective}")
        if threshold_s is not None and threshold_s <= 0:
            raise ValueError(
                f"slo {name!r}: threshold_s must be positive")
        self.name = name
        self.objective = objective
        self.threshold_s = threshold_s
        self.description = description

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


class SloEngine:
    """Burn-rate evaluator over a set of Slos; also the
    `slo_burn_rate{slo,window}` gauge metric."""

    name = "slo_burn_rate"
    help = ("error-budget burn rate per SLO and window (1.0 = spending "
            "budget exactly at the objective's rate; >1 = burning hot)")
    TYPE = "gauge"

    def __init__(self, slos: Iterator[Slo] | list[Slo], *,
                 short_window_s: float = 60.0,
                 long_window_s: float = 600.0,
                 clock: Callable[[], float] | None = None):
        slos = list(slos)
        if len({s.name for s in slos}) != len(slos):
            raise ValueError("duplicate SLO names")
        if not short_window_s < long_window_s:
            raise ValueError("short window must be shorter than long")
        self.slos: dict[str, Slo] = {s.name: s for s in slos}
        self.windows = {"short": float(short_window_s),
                        "long": float(long_window_s)}
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._budget: SloBudgetGauge | None = None
        # per slo: deque of (t, bad) — bad is 0/1
        self._events: dict[str, collections.deque] = {
            s.name: collections.deque(maxlen=MAX_EVENTS_PER_SLO)
            for s in slos}

    def add(self, slo: Slo) -> None:
        """Add an objective to a live engine. A no-op when the name
        already exists (first definition wins — two owners sharing one
        registry must agree on the objective, and the shared engine is
        the one place they meet)."""
        with self._lock:
            if slo.name in self.slos:
                return
            self.slos[slo.name] = slo
            self._events[slo.name] = collections.deque(
                maxlen=MAX_EVENTS_PER_SLO)

    # -- feed side ---------------------------------------------------------

    def record(self, name: str, good: bool) -> None:
        """One pre-classified event against SLO `name`. Unknown names
        are dropped silently: feeders must never crash the fed path."""
        dq = self._events.get(name)
        if dq is None:
            return
        with self._lock:
            dq.append((self._clock(), 0 if good else 1))

    def observe(self, name: str, seconds: float) -> None:
        """One latency sample against a threshold SLO."""
        slo = self.slos.get(name)
        if slo is None or slo.threshold_s is None:
            return
        self.record(name, seconds <= slo.threshold_s)

    # -- read side ---------------------------------------------------------

    def burn_rates(self) -> dict[tuple[str, str], float]:
        """{(slo, window): burn}. Windows with no events burn 0.0."""
        now = self._clock()
        horizon = now - self.windows["long"]
        out: dict[tuple[str, str], float] = {}
        with self._lock:
            for name, dq in self._events.items():
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                snap = list(dq)
                slo = self.slos[name]
                for wname in WINDOWS:
                    cutoff = now - self.windows[wname]
                    total = bad = 0
                    for t, b in reversed(snap):
                        if t < cutoff:
                            break
                        total += 1
                        bad += b
                    frac = (bad / total) if total else 0.0
                    out[(name, wname)] = frac / slo.error_budget
        return out

    def expositions(self) -> Iterator[tuple[str, dict[str, str], float]]:
        rates = self.burn_rates()
        for name in sorted(self.slos):
            for wname in WINDOWS:
                yield (self.name, {"slo": name, "window": wname},
                       rates[(name, wname)])

    def budget_gauge(self) -> "SloBudgetGauge":
        """The engine's companion `slo_error_budget_remaining` metric
        (one instance per engine — the Registry dedupes by name, so a
        second family cannot come from the engine object itself)."""
        if self._budget is None:
            self._budget = SloBudgetGauge(self)
        return self._budget


class SloBudgetGauge:
    """Remaining error budget per SLO, as a fraction of the long
    window's budget: 1 - long-window burn. 1.0 = untouched, 0.0 =
    spending exactly at the objective's rate, negative = overspent.
    Operators and the fleet controller both want "how much runway is
    left", not just "how fast is it burning" — this is that number,
    computed live at scrape time from the same event windows as
    `slo_burn_rate`. Every SLO is always emitted (zero-seeded: an
    event-free window burns 0, so the budget reads a full 1.0)."""

    name = "slo_error_budget_remaining"
    help = ("fraction of the error budget left in the long burn "
            "window (1 - long-window burn rate; 1 = untouched, "
            "0 = spending at the objective's rate, negative = "
            "overspent)")
    TYPE = "gauge"

    def __init__(self, engine: SloEngine):
        self._engine = engine

    def expositions(self) -> Iterator[tuple[str, dict[str, str], float]]:
        rates = self._engine.burn_rates()
        for name in sorted(self._engine.slos):
            yield (self.name, {"slo": name},
                   1.0 - rates[(name, "long")])


def register_budget_gauge(registry, engine: SloEngine) -> None:
    """Idempotently register `engine`'s budget gauge on `registry`.
    Callers that register an engine directly (rather than through
    `get_or_create_slo_engine`) use this to get the companion family."""
    if registry.get(SloBudgetGauge.name) is None:
        try:
            registry.register(engine.budget_gauge())
        except ValueError:
            pass  # raced: the registry already carries one


def get_or_create_slo_engine(registry, slos, *,
                             short_window_s: float = 60.0,
                             long_window_s: float = 600.0,
                             clock: Callable[[], float] | None = None):
    """One burn-rate engine per registry.

    The engine IS the `slo_burn_rate` metric, so a registry can hold
    exactly one; every component that wants objectives on a shared
    registry (a serving app and a coordinator in one test process, or
    several apps behind one /metrics) must feed the same instance.
    Registers a fresh engine when the registry has none, otherwise
    merges the requested `slos` into the existing engine (first
    definition of a name wins) and returns it.
    """
    engine = registry.get("slo_burn_rate")
    if engine is None:
        engine = SloEngine(slos, short_window_s=short_window_s,
                           long_window_s=long_window_s, clock=clock)
        try:
            registry.register(engine)
        except ValueError:
            engine = registry.get("slo_burn_rate") or engine
        else:
            register_budget_gauge(registry, engine)
            return engine
    for slo in slos:
        engine.add(slo)
    register_budget_gauge(registry, engine)
    return engine
