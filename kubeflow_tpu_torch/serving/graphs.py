"""CUDA graphs for the serving hot paths, and the host-device staging
around them (counterpart: the reference's `jax.jit` program caches in
kubeflow_tpu/serving/continuous.py and engine.py).

The reference compiles each decode step as one program and dispatches
it with one call; the port's eager PyTorch launches every op of every
layer from Python. A `GraphRunner` gives the port the same shape: it
owns a body (a callable over static tensors: inputs that the caller
fills in place, outputs that the body returns), runs it once eagerly on
a side stream (which builds the kernels through `_build.load`, creates
the cuBLAS handles and fills the allocator: none of that may happen
during capture), captures it with `torch.cuda.graph`, and from then on
`replay()` is the whole dispatch.

- On the CPU a runner calls its body directly, so the CPU tests run the
  same body that the card captures.
- On the card a capture that fails raises. There is no fallback to
  eager launches: the only eager CUDA path is a `GraphCache` built with
  `eager=True`, which a caller names explicitly (a control run).
- At tensor > 1 (a tensor-parallel engine, serving/gang.py) every
  cache is eager: a gloo collective stages through host memory, which a
  graph cannot capture. `captured` counts the graphs this process has
  captured, so a caller can check that none was.
- Launch counts stay exact under replay: a capture records what the
  body's kernel wrappers counted (`ops.cuda.launch_counts()` and
  `ops.attention.impl_counts()`), takes it back (a capture launches
  nothing), and every replay adds it again.

Staging: `torch.as_tensor(numpy, device="cuda")`, and any copy from
pageable memory, blocks the host until the stream has drained, which
would serialise the host behind every chunk in flight. `upload` and
`stage` go through pinned memory with `non_blocking=True`; PyTorch's
pinned-memory cache does not hand a pinned block out again before the
copy that reads it has run. `HostCopy` brings results back the same
way, behind an event.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from kubeflow_tpu_torch.ops import attention
from kubeflow_tpu_torch.ops.cuda import add_launch_counts, launch_counts


# graphs captured in this process (a `GraphCache`'s `captures` counts its
# eager runners too)
captured = {"graphs": 0}


def upload(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values (numpy, list, CPU tensor) as a new tensor on `device`,
    without blocking the host on a CUDA device."""
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    src = values.to(dtype)
    if device.type != "cuda":
        return src.to(device)
    return src.pin_memory().to(device, non_blocking=True)


def stage(dst: torch.Tensor, values) -> torch.Tensor:
    """Copy host values into the existing tensor `dst` (a static graph
    input) without blocking the host on a CUDA device."""
    src = torch.as_tensor(np.asarray(values)).to(dst.dtype).reshape(
        dst.shape)
    if dst.device.type == "cuda":
        src = src.pin_memory()
    return dst.copy_(src, non_blocking=dst.device.type == "cuda")


class HostCopy:
    """Device tensors copied to host memory behind the work queued so
    far. On the card the copies land in pinned buffers with
    `non_blocking=True` and an event marks them; `ready()` asks the event
    and `wait()` blocks on it (call it off the event loop). On the CPU the
    work is done when the copy is made, and `ready()` stays False so that
    a dispatch-ahead loop processes results in the order it would when
    the card is the bottleneck: deterministic, whatever the host's
    speed."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.detach().clone() for t in tensors]

    def ready(self) -> bool:
        return self.event is not None and self.event.query()

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


# One side stream per device for every warm-up run: PyTorch keeps a
# cuBLAS workspace for each stream a matmul ever ran on, for the life of
# the process, so a new stream per capture would leak one per capture.
_side_streams: dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = _side_streams.get(index)
    if stream is None:
        stream = _side_streams[index] = torch.cuda.Stream(index)
    return stream


def _counts() -> dict[str, dict[str, int]]:
    return {"launch": launch_counts(), "impl": attention.impl_counts()}


def _add_counts(delta: dict[str, dict[str, int]], sign: int = 1) -> None:
    add_launch_counts({k: sign * n for k, n in delta["launch"].items()})
    attention.add_impl_counts({k: sign * n
                               for k, n in delta["impl"].items()})


class GraphRunner:
    """One body, captured once on the card and replayed per call.

    The first call on the card runs the body eagerly on a side stream
    (its result is that call's result: the work is real, not a dry run),
    then captures it; every later call replays the graph and returns the
    static outputs the capture produced, which the next replay
    overwrites. `generator`: a CUDA generator the body draws from, which
    each replay advances."""

    def __init__(self, body, device: torch.device, *, eager: bool = False,
                 generator: torch.Generator | None = None, pool=None,
                 on_capture=None):
        self.body = body
        self.device = device
        self.eager = eager or device.type != "cuda"
        self.generator = generator
        self.pool = pool
        self.on_capture = on_capture
        self.graph = None
        self.out = None
        self.delta = None
        self.replays = 0

    def __call__(self):
        if self.eager:
            return self.body()
        if self.graph is None:
            return self._warm_and_capture()
        self.graph.replay()
        _add_counts(self.delta)
        self.replays += 1
        return self.out

    def _warm_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            result = self.body()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _counts()
        # No cyclic garbage collection during the capture: it may free an
        # unreachable engine's graphs, and destroying a graph is not
        # permitted while a stream captures (the capture would fail).
        gc_enabled = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the host keeps querying and waiting on events
            # of chunks in flight from other threads while this captures
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = self.body()
        finally:
            if gc_enabled:
                gc.enable()
        after = _counts()
        self.delta = {kind: {k: after[kind][k] - before[kind][k]
                             for k in after[kind]} for kind in after}
        _add_counts(self.delta, -1)   # a capture launches nothing
        self.graph, self.out = graph, out
        captured["graphs"] += 1
        if self.on_capture is not None:
            self.on_capture()
        return result


class GraphCache:
    """Runners by key, sharing one memory pool; `captures` counts the
    graphs captured (on the CPU, and with `eager=True`, the runners
    built: each is a body the card would capture), `replays` the
    replays. After a warmup, traffic must not raise `captures`."""

    def __init__(self, device: torch.device, *, eager: bool = False):
        self.device = device
        self.eager = eager
        self.captures = 0
        self._runners: dict = {}
        self._pool = None

    def runner(self, key, body, generator=None) -> GraphRunner:
        run = self._runners.get(key)
        if run is None:
            if self.device.type == "cuda" and not self.eager \
                    and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            run = GraphRunner(body, self.device, eager=self.eager,
                              generator=generator, pool=self._pool,
                              on_capture=self._captured)
            if run.eager:
                self.captures += 1
            self._runners[key] = run
        return run

    def _captured(self) -> None:
        self.captures += 1

    @property
    def replays(self) -> int:
        return sum(r.replays for r in self._runners.values())

    def __contains__(self, key) -> bool:
        return key in self._runners
