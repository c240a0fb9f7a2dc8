"""Trace-driven scenario engine: record, generate, and replay
production traffic shapes against any serving target.

One trace format (`trace.py`), deterministic-seeded generators for the
shapes that break schedulers (`generate.py`), a recorder that captures
any live run off the timeline store (`record.py`), and an open-loop
replayer with declarative SLO assertions (`replay.py`);
`python -m kubeflow_tpu_torch.scenarios` is the front door. A copy of
kubeflow_tpu/scenarios/ (stdlib only): the port imports nothing of the
JAX package, and the same generator and seed give a byte-identical
trace file in both.
"""

from kubeflow_tpu_torch.scenarios.generate import GENERATORS, generate
from kubeflow_tpu_torch.scenarios.record import (
    record_from_server,
    trace_from_store,
    trace_from_timeline_payloads,
)
from kubeflow_tpu_torch.scenarios.replay import (
    HttpTarget,
    assert_expect,
    check_expect,
    prompt_ids_for,
    replay,
    summarize,
)
from kubeflow_tpu_torch.scenarios.trace import (
    TRACE_VERSION,
    Trace,
    TraceRequest,
    read_trace,
    write_trace,
)

__all__ = [
    "TRACE_VERSION", "Trace", "TraceRequest", "read_trace",
    "write_trace", "GENERATORS", "generate", "record_from_server",
    "trace_from_store", "trace_from_timeline_payloads", "HttpTarget",
    "assert_expect", "check_expect", "prompt_ids_for", "replay",
    "summarize",
]
