"""Prometheus-style metrics: counters, gauges, histograms and the
registry that renders them (copies of kubeflow_tpu/controlplane/
metrics.py's `Counter`, `Gauge` and `Registry`, and of
kubeflow_tpu/obs/metrics.py's `Histogram`, its buckets,
`get_or_create_histogram` and `sample_quantile`; the port imports
nothing of the JAX package).

No prometheus_client dependency: exposition is the stable text format,
rendered directly. Collectors are callables run at scrape time, so a
gauge read from live state never drifts from it. Histogram exposition
per label set: cumulative `_bucket{le="..."}` lines in ascending bucket
order ending at `le="+Inf"` (== `_count`), then `_sum` and `_count`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Iterable, Iterator

# Latency buckets (seconds): sub-ms workqueue pops through multi-second
# compiles. The classic prometheus default, extended one decade down.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
# Batch/queue-size buckets: powers of two up to the largest slot counts.
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
# Token-count buckets (prompt/prefill sizes): powers of two out to the
# longest context lengths served.
TOKEN_BUCKETS = (1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0,
                 65536.0)


def format_float(v: float) -> str:
    """Integral floats render as ints (`1`, not `1.0`), others by repr."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _escape_label_value(v: str) -> str:
    # backslash, double-quote and newline are escaped inside label values
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def sample_quantile(xs, q: float) -> float | None:
    """Linear-interpolated quantile over raw samples (the `q * (n - 1)`
    order statistic; counterpart: kubeflow_tpu/obs/metrics.py): the one
    quantile definition of the process-local summaries (the block
    ledger's reuse and age windows, the phase profiler's snapshot)."""
    if not xs:
        return None
    xs = sorted(xs)
    if len(xs) == 1:
        return float(xs[0])
    q = min(max(float(q), 0.0), 1.0)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    frac = pos - lo
    if frac == 0.0 or lo + 1 >= len(xs):
        return float(xs[lo])
    return float(xs[lo] + (xs[lo + 1] - xs[lo]) * frac)


class Counter:
    """Monotonic counter with optional labels."""

    TYPE = "counter"

    def __init__(self, name: str, help: str,
                 registry: "Registry | None" = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[tuple[tuple[str, str], ...], float] = {}
        if registry is not None:
            registry.register(self)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        """The current value of one label set (0.0 when unseen)."""
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def samples(self) -> Iterable[tuple[dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

    def expositions(self) -> Iterable[tuple[str, dict[str, str], float]]:
        """(sample_name, labels, value) in exposition order."""
        for labels, v in sorted(self.samples(),
                                key=lambda s: sorted(s[0].items())):
            yield self.name, labels, v


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value


class Histogram:
    """Cumulative histogram with optional labels. `buckets` are strictly
    increasing upper bounds (+Inf implicit); per label set the state is
    (per-bucket counts, sum, count), cumulated at render."""

    TYPE = "histogram"

    def __init__(self, name: str, help: str, registry=None,
                 *, buckets: tuple[float, ...] = LATENCY_BUCKETS):
        if not buckets:
            raise ValueError("histogram needs at least one bucket")
        bs = tuple(float(b) for b in buckets)
        if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"buckets must be strictly increasing: {bs}")
        self.name = name
        self.help = help
        self.buckets = bs
        self._lock = threading.Lock()
        # label key -> [counts per bucket (+Inf last)], [sum, count]
        self._data: dict[tuple[tuple[str, str], ...],
                         tuple[list[int], list[float]]] = {}
        if registry is not None:
            registry.register(self)

    @staticmethod
    def _key(labels: dict) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        i = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            row = self._data.get(key)
            if row is None:
                row = ([0] * (len(self.buckets) + 1), [0.0, 0.0])
                self._data[key] = row
            row[0][i] += 1
            row[1][0] += float(value)
            row[1][1] += 1.0

    def seed(self, **labels: str) -> None:
        """Create the label set with zero observations, so the series
        shows on the first scrape."""
        key = self._key(labels)
        with self._lock:
            if key not in self._data:
                self._data[key] = ([0] * (len(self.buckets) + 1),
                                   [0.0, 0.0])

    def count(self, **labels: str) -> int:
        with self._lock:
            row = self._data.get(self._key(labels))
            return int(row[1][1]) if row else 0

    def expositions(self) -> Iterator[tuple[str, dict[str, str], float]]:
        """(sample_name, labels, value) triples in exposition order."""
        with self._lock:
            snap = [(dict(k), [list(row[0]), list(row[1])])
                    for k, row in sorted(self._data.items())]
        for labels, (counts, sum_count) in snap:
            acc = 0
            for b, c in zip(self.buckets, counts):
                acc += c
                yield (f"{self.name}_bucket",
                       {**labels, "le": format_float(b)}, float(acc))
            acc += counts[-1]
            yield (f"{self.name}_bucket", {**labels, "le": "+Inf"},
                   float(acc))
            yield f"{self.name}_sum", dict(labels), sum_count[0]
            yield f"{self.name}_count", dict(labels), sum_count[1]


class Registry:
    """Holds metrics and scrape-time collectors; renders exposition text."""

    def __init__(self):
        self._metrics: list = []
        self._collectors: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    def register(self, metric) -> None:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(
                    f"metric {metric.name!r} already registered")
            self._metrics.append(metric)

    def get(self, name: str):
        """The registered metric named `name`, or None."""
        with self._lock:
            for m in self._metrics:
                if m.name == name:
                    return m
        return None

    def register_collector(self, fn: Callable[[], None]) -> None:
        """`fn` refreshes gauges from live state; runs on every render."""
        with self._lock:
            self._collectors.append(fn)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
            metrics = list(self._metrics)
        for fn in collectors:
            fn()
        lines: list[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            # no samples yet: nothing (a synthetic unlabeled 0 would go
            # stale once labeled samples appear)
            for name, labels, v in m.expositions():
                lines.append(
                    f"{name}{_fmt_labels(labels)} {format_float(v)}")
        return "\n".join(lines) + "\n"


def get_or_create_histogram(registry, name: str, help: str,
                            *, buckets: tuple[float, ...] = LATENCY_BUCKETS
                            ) -> Histogram:
    """Idempotent registration: several owners sharing a registry must
    not register duplicate series."""
    existing = registry.get(name)
    if existing is not None:
        if not isinstance(existing, Histogram):
            raise ValueError(
                f"metric {name!r} already registered as {existing.TYPE}")
        return existing
    return Histogram(name, help, registry, buckets=buckets)


_default_registry: Registry | None = None


def default_registry() -> Registry:
    """Process-wide registry for owners with no app to serve one (the
    checkpointer)."""
    global _default_registry
    if _default_registry is None:
        _default_registry = Registry()
    return _default_registry
