"""Profiling: torch.profiler traces, time to the first step, step timing
(counterpart: kubeflow_tpu/utils/profiling.py).

The platform's north-star latency metric is pod-to-first-compile
seconds: how long a user waits between pod start and a first finished
step. The pod start time comes from `KFTPU_POD_START_TIME` (epoch
seconds, injected beside the topology env), else the process start.

On the card there is no XLA compile. What the first call pays instead
is the CUDA context, the first build and load of the hand-written
kernels (`nvcc` and `ctypes`, ops/cuda/_build.py) and of the native
data libraries (data/_native.py), and the allocator's growth; so
`time_to_first_compile` is the time to the first synchronized call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

_PROCESS_START = time.time()
POD_START_ENV = "KFTPU_POD_START_TIME"


def pod_start_time() -> float:
    raw = os.environ.get(POD_START_ENV, "")
    try:
        return float(raw)
    except ValueError:
        return _PROCESS_START


def synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for without a
    CUDA context)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_to_first_compile(
    fn: Callable[..., Any], *args: Any, **kwargs: Any
) -> tuple[float, Any]:
    """Run `fn(*args, **kwargs)` once, synchronized, and return (seconds
    since pod start at its completion, result). On the card the first
    call's extra cost is the kernels' first build and load, not an XLA
    compile (see the module docstring)."""
    out = fn(*args, **kwargs)
    synchronize()
    return time.time() - pod_start_time(), out


@contextlib.contextmanager
def trace(logdir: str, tracer: Any = None):
    """A `torch.profiler` trace of the block (host and, where there is a
    card, device activity), written as a Chrome trace
    `trace-<pid>-<ms>.json` into `logdir` (open it in Perfetto or
    chrome://tracing):

        with profiling.trace("/tmp/profile"):
            state, loss = trainer.step(state, tokens, targets)

    Pass an `obs.Tracer` to also drop a `torch.profile` span into the
    app-level trace ring (the reference's `xla.profile`), marking which
    wall-clock window the heavy trace covers."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    ctx = (tracer.span("torch.profile", logdir=logdir)
           if tracer is not None else contextlib.nullcontext())
    with ctx:
        prof = profile(activities=activities)
        prof.start()
        try:
            yield prof
        finally:
            synchronize()
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}"
                ".json"))


class StepTimer:
    """Blocking step timer with a percentile summary: a thin adapter over
    `obs.PhaseProfiler`, so every recorded step is a `name` phase on the
    profiler (totals, rolling percentiles, counter tracks), and
    `summary()` takes `obs.sample_quantile`'s interpolation.

    `with timer.step(): ...` synchronizes the card at exit, so a step
    whose work is only queued does not time as fast (the reference's
    `ready` argument, the result to block on, has no counterpart).

    Optional obs bridge: give it a `tracer` and/or `histogram` and each
    timed step also becomes a span (named `name`) and a histogram
    observation."""

    def __init__(self, tracer: Any = None, histogram: Any = None,
                 name: str = "train.step"):
        from kubeflow_tpu_torch.obs.profiling import PhaseProfiler

        self.durations: list[float] = []
        self.tracer = tracer
        self.histogram = histogram
        self.name = name
        self.profiler = PhaseProfiler(phases=(name,))

    @contextlib.contextmanager
    def step(self, **attrs: Any):
        ctx = (self.tracer.span(self.name, **attrs)
               if self.tracer is not None else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            yield
            synchronize()
            self.record(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.durations.append(seconds)
        self.profiler.record(self.name, seconds)
        if self.histogram is not None:
            self.histogram.observe(seconds)

    def summary(self) -> dict[str, float]:
        from kubeflow_tpu_torch.obs.metrics import sample_quantile

        if not self.durations:
            return {}
        xs = sorted(self.durations)
        return {
            "count": len(xs),
            "mean_s": sum(xs) / len(xs),
            "p50_s": sample_quantile(xs, 0.50),
            "p90_s": sample_quantile(xs, 0.90),
            "p99_s": sample_quantile(xs, 0.99),
            "max_s": xs[-1],
        }
