"""Observability of the port (counterpart: kubeflow_tpu/obs/): the span
tracer behind `/debug/traces` and `X-Trace-Id` (`tracing`), the KV block
lifecycle ledger and the prefix hashing that the continuous batcher's
radix prefix cache reports through (`cachestats`), per-request token
timelines (`timeline`), the metric registry, counters, gauges and
histograms behind the serving app's `/metrics` (`metrics`), the SLO
burn-rate engine whose gauges it renders (`slo`), the label guard that
caps the values a client's `X-Tenant` header can put into a label
(`cardinality`), the step anatomy and compile watch of the
batcher's worker loop and the trainer's steps (`profiling`), and the
strict exposition parser and renderer (`exposition`) under the metrics
federation of the elastic coordinator (`federation`).

`obs.endpoints` (the aiohttp `/metrics` and `/debug/traces` handlers)
is not imported here: importing `obs` must not pull aiohttp into a
process that serves no HTTP (the trainer).
"""

from __future__ import annotations

from kubeflow_tpu_torch.obs.cachestats import (
    DEFER_CAUSES,
    EVICTION_CAUSES,
    PEER_FETCH_OUTCOMES,
    PREFILL_SOURCES,
    REUSE_BUCKETS,
    UNATTRIBUTED,
    CacheLedger,
    canonical_prefix,
    prefix_hash,
)
from kubeflow_tpu_torch.obs.cardinality import OVERFLOW_LABEL, LabelGuard
from kubeflow_tpu_torch.obs.exposition import (
    ExpositionError,
    parse_exposition,
    render_families,
)
from kubeflow_tpu_torch.obs.federation import federate, merge_families
from kubeflow_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    TOKEN_BUCKETS,
    Histogram,
    default_registry,
    format_float,
    get_or_create_histogram,
    sample_quantile,
)
from kubeflow_tpu_torch.obs.profiling import (
    SERVING_PHASES,
    TRAIN_PHASES,
    WATCHED_SERVING_FNS,
    WATCHED_TRAIN_FNS,
    CompileWatch,
    PhaseProfiler,
    abstract_signature,
    merge_counter_tracks,
)
from kubeflow_tpu_torch.obs.slo import (
    Slo,
    SloBudgetGauge,
    SloEngine,
    get_or_create_slo_engine,
    register_budget_gauge,
)
from kubeflow_tpu_torch.obs.timeline import RequestTimeline, TimelineStore
from kubeflow_tpu_torch.obs.tracing import (
    Span,
    Tracer,
    merge_chrome_traces,
    traces_response_payload,
)

__all__ = [
    "DEFER_CAUSES",
    "EVICTION_CAUSES",
    "ExpositionError",
    "LATENCY_BUCKETS",
    "PEER_FETCH_OUTCOMES",
    "PREFILL_SOURCES",
    "REUSE_BUCKETS",
    "SIZE_BUCKETS",
    "TOKEN_BUCKETS",
    "SERVING_PHASES",
    "TRAIN_PHASES",
    "UNATTRIBUTED",
    "WATCHED_SERVING_FNS",
    "WATCHED_TRAIN_FNS",
    "CacheLedger",
    "CompileWatch",
    "Histogram",
    "LabelGuard",
    "OVERFLOW_LABEL",
    "PhaseProfiler",
    "RequestTimeline",
    "Slo",
    "SloBudgetGauge",
    "SloEngine",
    "Span",
    "TimelineStore",
    "Tracer",
    "DEFAULT_TRACER",
    "abstract_signature",
    "canonical_prefix",
    "default_registry",
    "federate",
    "format_float",
    "get_or_create_histogram",
    "get_or_create_slo_engine",
    "merge_chrome_traces",
    "merge_counter_tracks",
    "merge_families",
    "parse_exposition",
    "prefix_hash",
    "register_budget_gauge",
    "render_families",
    "sample_quantile",
    "traces_response_payload",
]

# Process-wide default tracer: components without an injected tracer
# (the trainer, ad-hoc scripts) share it, so one view correlates them.
DEFAULT_TRACER = Tracer()
