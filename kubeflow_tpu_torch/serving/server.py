"""HTTP serving app (counterpart: kubeflow_tpu/serving/server.py).

Routes, each with the reference's request and response bodies:
- `POST /v1/models/{name}:generate` — body `{"tokens": [[ids...], ...]}`
  or `{"text": "..."}` (the app's tokenizer, else the byte-level
  fallback; the response then carries `"text"`), with `"max_new": 16,
  "temperature", "top_k", "top_p", "logprobs", "stop"` (up to 4
  token-id lists: the output ends before the earliest one),
  `"stream"` (SSE: one `data: {"tokens": [[...]]}` event per token on
  the continuous path, per decoded chunk on the one-shot path, then
  `{"done": true, "total": n[, "text"]}`, or `{"error": ..., "total":
  n}` once headers are out), `"speculative", "gamma", "prefix"`,
  `"adapter"` (a name in the engine's adapter pack, with the
  reference's 400s: not a string, no pack, an unknown name, with
  `prefix`, with `speculative`, streamed without the continuous
  batcher; adapter rows ride the continuous batcher, and under a window
  batcher the direct path). Continuous-path responses carry
  `X-Request-Id` (the
  client's, else a minted one), the key of the request's timeline.
- `POST /v1/models/{name}:score` — teacher-forced logprobs of a given
  sequence (`{"tokens": [[...]]}` or `{"text": "..."}`).
- `GET /v1/requests/{id}/timeline`, `GET /v1/requests/timelines` — the
  continuous batchers' per-request token timelines.
- `GET /metrics` — Prometheus exposition of the serving families whose
  sources the port has (`ServingObs`), the SLO burn rates among them.
- `GET /v1/spec`, `POST /v1/spec {"enabled": bool}` — the continuous
  speculative decoding's per-model state and its kill switch.
- `POST /drain` — stop admission: bodyless, in-flight work decodes to
  completion (the wait-out drain); `{"migrate": true, "peers": [url,
  ...]}` exports every admitted sequence (serving/migration.py records)
  and pushes them round-robin to the peers' `/v1/migrate/in` (the
  instant drain). `POST /v1/migrate/in` imports one record's KV blocks
  into the radix cache (400 on a bad record or geometry, 500 on a failed
  transfer, rolled back), `POST /v1/blocks/export` exports a cached
  prefix as a record (404 when it is not cached, 400 on a bad prefix
  hash). Shutdown drains within `drain_grace_s` before it closes.
- `POST /v1/models/{name}:prefill` — the prefill half of a
  disaggregated handoff: the prompt (`tokens` or `text`, one row) runs
  through normal admission with max_new 1 (its one token is thrown
  away), its cached full-block KV prefix is exported as a migration
  record and pushed to `"peer"`'s `/v1/migrate/in`. -> `{"prefilled",
  "handoff", "blocks", "bytes", "handoff_s", "request_id"}` (429 on a
  throttled tenant or a full queue, 503 while draining).
- `X-KV-Peer: URL` on a single-row `:generate` without `prefix` or
  `adapter` (a router's heat hint): before admission the replica
  pulls the prompt's cached blocks from the peer's `/v1/blocks/export`
  and imports them (default namespace only); every failure falls
  through to plain prefill.
  `fleet_peer_fetch_total{outcome=ok|miss|failed}` and
  `serving_prefill_tokens{source="peer_fetched"}` book it.
- `POST /v1/reload {"version", "model"?, "source": {...}, "defect"?}`
  — live weight reload: admission closes, in-flight work drains within
  the grace window (409, old weights live, when it does not), the
  `reloader` materializes the new params on the host (`{"checkpoint":
  dir, "step"?}` by default; the CLI adds `{"seed": n}`), a name,
  shape or dtype mismatch is refused (400), and each new tensor is
  copied into the live parameter in place, on the stream the CUDA
  graphs replay on: every captured graph reads the new weights and
  none is recaptured. Every cached KV is forgotten, admission opens,
  the version label is adopted, `defect.ttft_delay_s` is planted (each
  `:generate` sleeps it first) or healed, and a fleet registration is
  forced. Every failure re-opens admission with the old weights.
- `GET /healthz` (200 only while the server admits work: 503 `draining`
  after a drain), `GET /readyz` (liveness), `GET /v1/models`.

Fleet plane: `pool` ("mixed", "prefill" or "decode"; the two roles need
`continuous`) is the replica's disaggregation role, `model_version` its
weights' label; `enable_fleet_registration` registers with a fleet
router at start-up, heartbeats `fleet_stats` (queue, slots, KV blocks,
draining, pool, version, prefill and decode phase seconds from the
batcher's step profiler, the radix heat digest) with
`sequence_checkpoints` every `period_s`, re-registers on a 404 and
deregisters first thing at cleanup.

Modes, as in the reference's `create_serving_app`:
- default (`continuous=False`): the one-shot engine on a dense KV cache.
  With `batch_window_ms > 0`, single-prompt requests arriving within the
  window coalesce into one left-padded `engine.generate` call
  (`Batcher`); explicit multi-row batches, and every request when the
  window is 0, call `engine.generate` directly. The port's window
  batcher also carries `logprobs` (the reference sends such a request
  to the direct path instead).
- `continuous=True`: every prompt rides the model's continuous batcher
  on the paged KV pool (serving/continuous.py): radix prefix reuse,
  monolithic admission by default, chunked prefill with
  `prefill_chunk_tokens`, decode chunks dispatched ahead as CUDA-graph
  replays, an optional host spill tier (`kv_spill_bytes`). A request's
  `"prefix"` names a prefix registered with `prefixes=`, whose tokens
  go before the prompt's and whose KV is computed once.
- `"speculative": true` (either mode, a model registered in `drafts`):
  batch-1 speculative decoding through `SpeculativeEngine`.
- `spec_decode=True` (continuous only, a draft for every model): every
  request decodes speculatively in its model's continuous batcher,
  `spec_gamma` draft tokens verified a round on the paged KV pool.
- `tenancy` (continuous only, a `TenancyConfig`): a request's tenant is
  its `X-Tenant` header (absent or unknown: `default`), which rides the
  sampling channel into the batcher's fair-share queue, rate limits (a
  429 whose Retry-After is the bucket's refill time), KV shares,
  prefix isolation and batch-class preemption; `/metrics` grows
  zero-seeded `serving_tenant_*` series and the SLOs count each
  request under its tenant's priority class.

Observability: every routed request opens a root `http.request` span
(adopting a valid `X-Trace-Id` / `X-Parent-Span` pair as its remote
parent, else a new trace) and every response carries `X-Trace-Id`, SSE
streams and errors included; the paths below it open the reference's
spans (`batcher.submit`, `stream.continuous`, `stream.decode`,
`engine.generate`, `engine.speculative`, `engine.score`, the executor's
`device.generate` / `device.score`, `migrate.out`, `migrate.in`,
`blocks.export`, `peer.fetch`, `weights.reload`, `prefill.handoff`, and
the batcher's `decode.attention` per decode chunk). `GET /debug/traces`
returns the tracer's ring as Chrome trace events (`?name=`, `?limit=`,
`?trace_id=`, `?format=summary`; 400 on a bad limit) with each
continuous batcher's counter tracks, named `<model>.<track>`; `GET
/debug/profile` returns each continuous batcher's step anatomy, its
`recompiles` (the compile watch's counts, which
`serving_recompiles_total{fn}` mirrors) and its `cache` anatomy. Spans
are host time: nothing here synchronizes the device.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import secrets
import time
from typing import Any, Mapping

import numpy as np
import torch
from aiohttp import web

from kubeflow_tpu_torch.obs.cachestats import (
    DEFER_CAUSES,
    EVICTION_CAUSES,
    PEER_FETCH_OUTCOMES,
    PREFILL_SOURCES,
    REUSE_BUCKETS,
    UNATTRIBUTED,
)
from kubeflow_tpu_torch.obs.cardinality import LabelGuard
from kubeflow_tpu_torch.obs.endpoints import metrics_handler
from kubeflow_tpu_torch.obs.metrics import (
    SIZE_BUCKETS,
    TOKEN_BUCKETS,
    Counter,
    Gauge,
    Registry,
    get_or_create_histogram,
)
from kubeflow_tpu_torch.obs.profiling import (
    SERVING_PHASES,
    WATCHED_SERVING_FNS,
    merge_counter_tracks,
)
from kubeflow_tpu_torch.obs.tracing import Tracer, traces_response_payload
from kubeflow_tpu_torch.obs.slo import Slo, get_or_create_slo_engine
from kubeflow_tpu_torch.ops.cuda import launch_counts
from kubeflow_tpu_torch.serving import migration
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    MigratedAway,
    Overloaded,
    bucket_pow2,
    pow2_ceil,
)
from kubeflow_tpu_torch.serving.engine import InferenceEngine
from kubeflow_tpu_torch.serving.quant import QTensor
from kubeflow_tpu_torch.serving.speculative import SpeculativeEngine
from kubeflow_tpu_torch.tenancy import (
    THROTTLE_REASONS,
    TenancyConfig,
    Throttled,
)
from kubeflow_tpu_torch.train.checkpoint import flatten, load_serving_params

BYTE_OFFSET = 3  # 0=pad, 1=bos, 2=eos
BOS, EOS = 1, 2


def byte_encode(text: str) -> list[int]:
    return [BOS] + [b + BYTE_OFFSET for b in text.encode("utf-8")]


def byte_decode(tokens: list[int], on_dropped=None) -> str:
    """Ids outside the byte range are dropped. Specials below the offset
    (pad/bos/eos) are expected in generated rows and stay silent; ids
    past the byte range (the model's vocab tail: tokenizer/model drift)
    are counted through `on_dropped(count)`."""
    kept = [t - BYTE_OFFSET for t in tokens
            if BYTE_OFFSET <= t < BYTE_OFFSET + 256]
    if on_dropped is not None:
        tail = sum(1 for t in tokens if t >= BYTE_OFFSET + 256)
        if tail:
            on_dropped(tail)
    return bytes(kept).decode("utf-8", errors="replace")


ENGINES_KEY: web.AppKey = web.AppKey("engines", dict)
BATCHERS_KEY: web.AppKey = web.AppKey("batchers", dict)
SPEC_KEY: web.AppKey = web.AppKey("speculative", dict)
GPU_LOCK_KEY: web.AppKey = web.AppKey("gpu_lock", asyncio.Lock)
TOKENIZER_KEY: web.AppKey = web.AppKey("tokenizer", object)
OBS_KEY: web.AppKey = web.AppKey("obs", object)
DRAIN_KEY: web.AppKey = web.AppKey("drain_state", dict)
TENANCY_KEY: web.AppKey = web.AppKey("tenancy", object)  # TenancyConfig|None
FLEET_REG_KEY: web.AppKey = web.AppKey("fleet_registration", dict)
POOL_KEY: web.AppKey = web.AppKey("pool_role", str)
# the weights' label in heartbeats, the /v1/reload materializer (None:
# the checkpoint loader) and the defect a reload planted
MODEL_VERSION_KEY: web.AppKey = web.AppKey("model_version", str)
RELOADER_KEY: web.AppKey = web.AppKey("weight_reloader", object)
DEFECT_KEY: web.AppKey = web.AppKey("reload_defect", dict)

# disaggregation roles: "mixed" serves both phases
POOL_ROLES = ("mixed", "prefill", "decode")

# Server-side decode granularity of a one-shot SSE stream: fixed (not a
# client knob), as the reference's.
STREAM_CHUNK = 8
# Retry-After ceiling: past this, a client should go to another replica
# rather than wait on this one.
RETRY_AFTER_CAP_S = 60
# The tenant label of a tenant-blind deployment: the label guard maps
# the empty identity to its overflow bucket.
TENANT_BLIND = "other"
MIGRATION_DIRECTIONS = ("in", "out")
# The tenant priority classes: every SLO family is seeded for each; a
# request counts under its tenant's class, every request of a
# tenant-blind deployment under PRIORITY's.
PRIORITIES = ("interactive", "standard", "batch")
PRIORITY = "standard"
# The reference's replica SLOs: TTFT thresholds per priority class, the
# ITL threshold, the latency and availability objectives, and the share
# of verified draft tokens speculation must keep accepted (the TTFT
# thresholds and the acceptance objective are overridable per app:
# `create_serving_app(slo_ttft_s=, slo_spec_acceptance=)`).
SLO_TTFT_THRESHOLDS_S = {"interactive": 0.5, "standard": 2.0, "batch": 10.0}
SLO_ITL_THRESHOLD_S = 0.25
SLO_LATENCY_OBJECTIVE = 0.95
SLO_ERROR_OBJECTIVE = 0.99
SLO_SPEC_ACCEPTANCE_OBJECTIVE = 0.5

log = logging.getLogger(__name__)


class ServingObs:
    """The app's metric registry, span tracer and serving families,
    under the reference's names, help, labels and buckets. `/metrics`
    renders the registry, `/debug/traces` the tracer's ring, and `slo`
    (obs/slo.py, the `slo_burn_rate` and `slo_error_budget_remaining`
    gauges) holds the reference's SLOs: TTFT per priority class (its
    thresholds merged with `slo_ttft_s`), ITL, errors per priority
    class, speculative acceptance (objective `slo_spec_acceptance`). The
    tenant families carry samples only with a tenancy config;
    `tenant_guard` caps the values a raw `X-Tenant` header can put into
    a label."""

    def __init__(self, registry=None, tracer=None, *, slo_ttft_s=None,
                 slo_spec_acceptance: float | None = None):
        self.registry = reg = (registry if registry is not None
                               else Registry())
        self.tracer = tracer if tracer is not None else Tracer()
        self.request_latency = get_or_create_histogram(
            reg, "serving_request_duration_seconds",
            "Serving HTTP request latency by route/method")
        self.ttft = get_or_create_histogram(
            reg, "serving_time_to_first_token_seconds",
            "Request arrival to first generated token, per model "
            "(streaming: first token on the wire; one-shot: full "
            "generation, an upper bound)")
        self.batch_size = get_or_create_histogram(
            reg, "serving_batch_size",
            "Requests co-scheduled per engine invocation",
            buckets=SIZE_BUCKETS)
        self.prefix_hits = Counter(
            "serving_prefix_cache_hits_total",
            "Admissions that reused cached KV cells (radix prefix "
            "cache or a registered prefix)", reg)
        self.prefix_misses = Counter(
            "serving_prefix_cache_misses_total",
            "Admissions that prefilled their whole prompt (no cached "
            "prefix matched)", reg)
        self.kv_blocks = Gauge(
            "serving_kv_blocks_in_use",
            "KV pool blocks held by active requests plus the radix "
            "prefix cache, per model (under tensor parallelism each rank "
            "holds these blocks of its own KV heads: the leading rank's "
            "view)", reg)
        self.prefill_tokens = get_or_create_histogram(
            reg, "serving_prefill_tokens",
            "Per-admission prompt tokens by source: computed (suffix "
            "actually prefilled), reused (served from device-resident "
            "cached KV), restored (host spill tier, host->device "
            "copy), peer_fetched (imported from a peer replica via "
            "the X-KV-Peer heat hint)", buckets=TOKEN_BUCKETS)
        self.dropped_tokens = Counter(
            "serving_tokenizer_dropped_tokens_total",
            "Generated token ids outside the byte-decoder's range "
            "(vocab tail / specials) dropped from text responses — "
            "nonzero means tokenizer/model drift", reg)
        self.attention_impl = Gauge(
            "serving_attention_impl",
            "Resolved paged-attention impl per model (info gauge: "
            "value 1, impl in the label)", reg)
        self.itl = get_or_create_histogram(
            reg, "serving_itl_seconds",
            "Inter-token latency: gap between consecutive decode "
            "tokens of one request, per model (gaps spanning a "
            "preempt/resume hole are excluded — those measure "
            "scheduling, see serving_queue_wait_seconds)")
        self.queue_wait = get_or_create_histogram(
            reg, "serving_queue_wait_seconds",
            "Enqueue to first admission into the decode batch, per "
            "model (scheduling delay; excludes prefill)")
        # multi-tenant QoS: counters synced from the ledger's totals at
        # scrape time, the gauge read live
        self.tenant_queue_depth = Gauge(
            "serving_tenant_queue_depth",
            "Requests waiting in a tenant's admission sub-queue", reg)
        self.tenant_tokens = Counter(
            "serving_tenant_tokens_total",
            "Tokens generated per tenant and model", reg)
        self.tenant_throttled = Counter(
            "serving_tenant_throttled_total",
            "Admissions shed or deferred per tenant by reason: rate "
            "(request bucket empty, HTTP 429) or kv_quota (concurrent "
            "KV-block share spent, request waits)", reg)
        self.tenant_preemptions = Counter(
            "serving_tenant_preemptions_total",
            "Batch-class decodes evicted mid-generation to free a slot "
            "for interactive work, per tenant", reg)
        # live KV-block migration: failures roll back and count here
        self.migration_out = Counter(
            "serving_migration_out_total",
            "In-flight sequences exported to a peer replica on "
            "instant drain, per model", reg)
        self.migration_in = Counter(
            "serving_migration_in_total",
            "Migrated sequences imported into the local KV pool "
            "(cache-warm; the router re-dispatch resumes them), per "
            "model", reg)
        self.migration_failed = Counter(
            "serving_migration_failed_total",
            "Migration transfers that failed and rolled back, per "
            "model and direction (in: import rejected or wedged, "
            "out: no peer accepted the record)", reg)
        self.migration_blocks = Counter(
            "serving_migration_blocks_total",
            "KV pool blocks moved by live migration, per model and "
            "direction", reg)
        # the step anatomy (the batcher's PhaseProfiler): closed phase
        # sets, zero-seeded per model; the ratios derive at scrape time
        self.step_phase_seconds = get_or_create_histogram(
            reg, "serving_step_phase_seconds",
            "Wall time per worker-loop phase (admit, prefill, decode, "
            "sample, detokenize, preempt, resume, host_gap, idle), "
            "per model — phases record exclusive time, so summing "
            "them reconstructs loop wall time")
        self.step_tokens = get_or_create_histogram(
            reg, "serving_step_tokens",
            "Tokens attributed per phase and model (prefill: suffix "
            "tokens computed per grouped prefill; decode: tokens "
            "emitted per chunk)", buckets=TOKEN_BUCKETS)
        self.goodput = Gauge(
            "serving_goodput_ratio",
            "Decode device-time share of total non-idle step time, "
            "per model (the Podracer-style goodput ledger; 1.0 means "
            "every non-idle second decoded tokens)", reg)
        self.bubble = Gauge(
            "serving_bubble_fraction",
            "host_gap share of total non-idle step time, per model — "
            "the bubble dispatch-ahead exists to hide", reg)
        self.kv_high_water = Gauge(
            "serving_kv_blocks_high_water",
            "High-water mark of KV pool blocks in use since startup, "
            "per model (capacity headroom for the pool sizing knob; per "
            "rank under tensor parallelism)", reg)
        # the host spill tier's traffic and occupancy, and the peer
        # block fetch by outcome (any non-ok fell back to plain prefill)
        self.kv_spill_demotions = Counter(
            "serving_kv_spill_demotions_total",
            "KV blocks demoted from the device pool into the host-RAM "
            "spill tier on eviction, per model (deaths booked to "
            "cause=spill in serving_kv_evictions_total)", reg)
        self.kv_spill_restores = Counter(
            "serving_kv_spill_restores_total",
            "Spilled KV blocks promoted back into the device pool on "
            "a prefix re-hit (host->device copy instead of prefill "
            "recompute), per model", reg)
        self.kv_spill_bytes = Gauge(
            "serving_kv_spill_bytes",
            "Host RAM currently holding spilled KV block contents, "
            "per model (bounded by --kv-spill-bytes)", reg)
        self.peer_fetch = Counter(
            "fleet_peer_fetch_total",
            "Replica-side KV block fetches from a peer named by the "
            "router's X-KV-Peer heat hint, by outcome: ok (blocks "
            "imported, prefill seeded), miss (peer no longer caches "
            "the prefix), failed (transport/geometry error — request "
            "fell back to plain prefill)", reg)
        # the compile watch (a graph captured in traffic on the card) and
        # the KV block ledger's families: closed cause sets, zero-seeded
        # per model with `unattributed`, whose permanent zero is the
        # conservation contract
        self.recompiles = Counter(
            "serving_recompiles_total",
            "Recompiles of a watched entry point (a novel signature "
            "past the fn's first; on the card a CUDA graph captured in "
            "traffic) — nonzero RATE in steady state means the shape "
            "bucketing leaked", reg)
        self.kv_evictions = Counter(
            "serving_kv_evictions_total",
            "KV pool blocks freed, by cause: lru (radix eviction), "
            "pressure (preemption), refdrop (normal retirement), "
            "divergence (duplicate content), migration (exported or "
            "rolled back). `unattributed` is a free site that forgot "
            "to book a cause — always zero, or it's a bug", reg)
        self.kv_admission_defers = Counter(
            "serving_kv_admission_defers_total",
            "Admissions pushed back for lack of KV blocks, by cause: "
            "kv_quota (tenant share spent) vs pool_exhausted (pool "
            "empty even after LRU eviction)", reg)
        self.kv_reuse_distance = get_or_create_histogram(
            reg, "serving_kv_reuse_distance_admissions",
            "Admissions between consecutive touches of the same cached "
            "KV block, per model — the working-set curve; mass beyond "
            "the pool's block count predicts misses an LRU pool of "
            "that size must take", buckets=REUSE_BUCKETS)
        self.kv_block_age = get_or_create_histogram(
            reg, "serving_kv_block_age_admissions",
            "Block age at death in admissions, per model — young "
            "deaths under pressure/lru mean the pool churns before "
            "reuse can pay off", buckets=REUSE_BUCKETS)
        self.tenant_guard = LabelGuard()
        ttft_thr = dict(SLO_TTFT_THRESHOLDS_S)
        ttft_thr.update(slo_ttft_s or {})
        spec_obj = (SLO_SPEC_ACCEPTANCE_OBJECTIVE
                    if slo_spec_acceptance is None
                    else float(slo_spec_acceptance))
        slos = [Slo(f"serving_ttft_{cls}", SLO_LATENCY_OBJECTIVE,
                    threshold_s=ttft_thr[cls],
                    description=f"p95 TTFT for {cls} traffic under "
                                f"{ttft_thr[cls]:g} s")
                for cls in PRIORITIES]
        slos.append(Slo(
            "serving_itl", SLO_LATENCY_OBJECTIVE,
            threshold_s=SLO_ITL_THRESHOLD_S,
            description=f"p95 inter-token latency under "
                        f"{SLO_ITL_THRESHOLD_S:g} s"))
        slos.extend(Slo(f"serving_errors_{cls}", SLO_ERROR_OBJECTIVE,
                        description=f"99% of {cls} requests answered "
                                    "without a 5xx")
                    for cls in PRIORITIES)
        slos.append(Slo(
            "serving_spec_acceptance", spec_obj,
            description=f"{spec_obj:.0%} of verified draft tokens "
                        "accepted (below this the draft burns more "
                        "verify slots than it saves)"))
        self.slo = get_or_create_slo_engine(reg, slos)


_OBS_T0 = "obs_request_start"
_OBS_TTFT_DONE = "obs_ttft_recorded"


def _priority_class(request: web.Request) -> str:
    """The request's tenant priority class, for the SLOs: PRIORITY for
    every request of a tenant-blind deployment."""
    tenancy = request.app[TENANCY_KEY]
    if tenancy is None:
        return PRIORITY
    return tenancy.resolve(request.headers.get("X-Tenant", "")).priority


def _observe_first_token(request: web.Request, model: str) -> None:
    """Record time-to-first-token once per request: streams at their
    first token on the wire, the other paths after generation."""
    t0 = request.get(_OBS_T0)
    if t0 is None or request.get(_OBS_TTFT_DONE):
        return
    request[_OBS_TTFT_DONE] = True
    dt = time.perf_counter() - t0
    sobs = request.app[OBS_KEY]
    labels = {"model": model}
    tenant_hdr = request.headers.get("X-Tenant")
    if tenant_hdr:
        # guarded: the label echoes a client-chosen value
        labels["tenant"] = sobs.tenant_guard.admit(tenant_hdr)
    sobs.ttft.observe(dt, **labels)
    sobs.slo.observe(f"serving_ttft_{_priority_class(request)}", dt)


def _observed(route: str, handler):
    """`handler` under a root `http.request` span, feeding the latency
    histogram of every response it gives, labelled by route PATTERN
    (`/v1/models/{name}:generate`), never the raw path, so label
    cardinality does not grow with the names clients probe. A request
    with a valid `X-Trace-Id` / `X-Parent-Span` pair (a router's
    propagation) commits its spans under that remote trace; a malformed
    pair starts a fresh trace. Every response, error responses included,
    carries `X-Trace-Id` (streams set it before they send headers). The
    reference does this in a middleware; a wrapper per route does the
    same for every routed request (a path no route matches is not
    observed) and keeps the app out of aiohttp's process-wide middleware
    cache, which would hold every app built in a process alive, engines
    and KV pools included."""

    async def observed(request: web.Request):
        sobs = request.app[OBS_KEY]
        request[_OBS_T0] = time.perf_counter()
        status = 500
        remote_tid = request.headers.get("X-Trace-Id", "")
        remote_psid = request.headers.get("X-Parent-Span", "")
        if remote_tid and remote_psid:
            span_cm = sobs.tracer.span_from_remote(
                "http.request", remote_tid, remote_psid,
                method=request.method, route=route)
        else:
            span_cm = sobs.tracer.span("http.request",
                                       method=request.method, route=route)
        with span_cm as span:
            tenant_hdr = request.headers.get("X-Tenant")
            if tenant_hdr:
                # guarded: the attribute echoes a client-chosen value
                span.attrs["tenant"] = sobs.tenant_guard.admit(tenant_hdr)
            try:
                resp = await handler(request)
                status = resp.status
                span.attrs["status"] = status
                if not resp.prepared:   # streams set it before prepare
                    resp.headers.setdefault("X-Trace-Id", span.trace_id)
                return resp
            except web.HTTPException as exc:
                status = exc.status
                span.attrs["status"] = status
                exc.headers.setdefault("X-Trace-Id", span.trace_id)
                raise
            finally:
                sobs.request_latency.observe(
                    time.perf_counter() - request[_OBS_T0], route=route,
                    method=request.method)
                if route.startswith("/v1/models/"):
                    # the availability SLO counts inference traffic only
                    sobs.slo.record(
                        f"serving_errors_{_priority_class(request)}",
                        status < 500)

    return observed


class Batcher:
    """Window batching for one engine: concurrent single-prompt requests
    collected within `window_ms` run as ONE left-padded
    `engine.generate` call.

    Decode reads every weight once per step whatever the batch, so N
    coalesced requests cost about one request's weight traffic. Rows,
    prompt width and max_new are bucketed to powers of two; filler rows
    decode greedily; each caller gets its own row trimmed to its own
    max_new, with the logprobs of its tokens. `calls` counts engine
    calls and `requests` the requests they served (counted on success);
    `on_batch(n)`, when set, is called with each successful call's
    request count.
    """

    def __init__(self, engine: InferenceEngine, gpu_lock: asyncio.Lock, *,
                 window_ms: float = 5.0, max_batch: int = 8):
        self.engine = engine
        self.gpu_lock = gpu_lock
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.calls = 0
        self.requests = 0
        self.on_batch = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        self._inflight: list = []   # dequeued but unresolved (see close)
        self._closed = False
        self._draining = False

    def in_flight(self) -> int:
        return self._queue.qsize() + len(self._inflight)

    def begin_drain(self) -> None:
        """Stop admission; queued work still runs."""
        self._draining = True

    def end_drain(self) -> None:
        """Open admission again after a completed drain (a reload)."""
        self._draining = False

    async def drain(self, timeout: float | None = None) -> bool:
        """Stop admission and wait for admitted work to resolve (the
        continuous batcher's contract: False on timeout, or with work
        left and no worker to run it)."""
        self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.in_flight():
            if self._worker is None or self._worker.done():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            await asyncio.sleep(0.01)
        return True

    async def submit(self, tokens: list[int], max_new: int,
                     sampling: dict | None = None):
        """-> (tokens [max_new], logprobs [max_new]) for one prompt."""
        if self._closed:
            raise RuntimeError("batcher is shut down")
        if self._draining:
            raise RuntimeError("batcher is draining")
        loop = asyncio.get_running_loop()
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._run())
        fut = loop.create_future()
        await self._queue.put((list(tokens), max_new, dict(sampling or {}),
                               fut))
        return await fut

    async def _run(self) -> None:
        while True:
            first = await self._queue.get()
            self._inflight = [first]
            await asyncio.sleep(self.window_s)   # let siblings arrive
            batch = [first]
            while len(batch) < self.max_batch and not self._queue.empty():
                batch.append(self._queue.get_nowait())
            self._inflight = batch
            # split only when the combination would overflow the cache
            # (each request alone fits)
            cap = self.engine.ec.max_len
            sub: list = []
            for item in batch:
                trial = sub + [item]
                need = (max(len(t) for t, _, _, _ in trial)
                        + max(mn for _, mn, _, _ in trial))
                if sub and need > cap:
                    await self._run_group(sub)
                    sub = [item]
                else:
                    sub = trial
            if sub:
                await self._run_group(sub)
            self._inflight = []

    async def _run_group(self, items: list) -> None:
        ec = self.engine.ec
        cap = ec.max_len
        longest = max(len(t) for t, _, _, _ in items)
        max_new = max(mn for _, mn, _, _ in items)
        # bucket both widths; exact sizes when the buckets do not fit
        max_new_b = bucket_pow2(max_new, cap - longest)
        longest_b = bucket_pow2(longest, cap - max_new_b)
        if longest_b < longest or max_new_b < max_new:
            longest_b, max_new_b = longest, max_new
        rows = pow2_ceil(len(items))   # filler rows, outputs dropped
        arr = np.zeros((rows, longest_b), np.int64)
        mask = np.zeros((rows, longest_b), bool)
        mask[:, -1] = True   # filler rows need one real token
        # filler rows decode greedily: a sampled EngineConfig default
        # there would drag an all-greedy batch into the sampled branch
        temp = np.zeros(rows, np.float32)
        top_k = np.zeros(rows, np.int64)
        top_p = np.ones(rows, np.float32)
        for i, (toks, _, sampling, _) in enumerate(items):
            arr[i, longest_b - len(toks):] = toks
            mask[i, :longest_b - len(toks)] = False
            mask[i, longest_b - len(toks):] = True
            temp[i] = sampling.get("temperature", ec.temperature)
            top_k[i] = sampling.get("top_k", ec.top_k)
            top_p[i] = sampling.get("top_p", ec.top_p)

        def run():
            toks, lps = self.engine.generate(
                arr, max_new=max_new_b, prompt_mask=mask, temperature=temp,
                top_k=top_k, top_p=top_p, return_logprobs=True)
            return toks.cpu().numpy(), lps.cpu().numpy()

        try:
            loop = asyncio.get_running_loop()
            async with self.gpu_lock:
                out, lps = await loop.run_in_executor(None, run)
            self.calls += 1
            self.requests += len(items)
            if self.on_batch is not None:
                self.on_batch(len(items))
            for i, (_, mn, _, fut) in enumerate(items):
                if not fut.done():
                    fut.set_result((out[i, :mn].tolist(),
                                    lps[i, :mn].tolist()))
        except Exception as e:  # noqa: BLE001 — fail the waiting requests
            for _, _, _, fut in items:
                if not fut.done():
                    fut.set_exception(e)

    async def close(self) -> None:
        """Cancel the worker and fail everything unresolved, queued and
        already dequeued."""
        self._closed = True
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
        pending = list(self._inflight)
        self._inflight = []
        while not self._queue.empty():
            pending.append(self._queue.get_nowait())
        for _, _, _, fut in pending:
            if not fut.done():
                fut.set_exception(RuntimeError("server shutting down"))


def create_serving_app(engines: dict[str, InferenceEngine], *,
                       tokenizer=None,
                       batch_window_ms: float = 0.0, max_batch: int = 8,
                       continuous: bool = False, warmup: bool = False,
                       prefill_chunk: int | None = None,
                       prefill_chunk_tokens: int | None = None,
                       pipeline_depth: int | None = None,
                       kv_block_size: int = 64,
                       kv_pool_blocks: int | None = None,
                       kv_spill_bytes: int | None = None,
                       prefixes: dict[str, list[int]] | None = None,
                       max_pending: int | None = None,
                       paged_attention_impl: str = "auto",
                       drafts: dict[str, InferenceEngine] | None = None,
                       spec_decode: bool = False, spec_gamma: int = 4,
                       seed: int | None = None,
                       tenancy: TenancyConfig | None = None,
                       drain_grace_s: float = 30.0,
                       pool: str = "mixed", model_version: str = "",
                       reloader=None, registry=None, tracer=None,
                       slo_ttft_s: dict[str, float] | None = None,
                       slo_spec_acceptance: float | None = None,
                       ) -> web.Application:
    """`continuous=False` (the default) serves through the one-shot
    engine: a window `Batcher` per model when `batch_window_ms > 0`,
    else every request calls `engine.generate` directly.
    `continuous=True` gives each model a continuous batcher of
    `max_batch` slots on the paged KV pool: monolithic admission unless
    `prefill_chunk_tokens` sets a chunked-prefill budget;
    `prefill_chunk` slices long monolithic prefills; `pipeline_depth`
    (None: 2 on CUDA, 1 on the CPU) is the decode
    dispatch-ahead depth; `kv_block_size` the pool's block,
    `kv_pool_blocks` its size (None: every slot at max_len),
    `kv_spill_bytes` the host spill tier's budget (None: off);
    `prefixes` maps names to registered prefix tokens; `max_pending`
    (None: 256) is the queue depth past which a request is shed with a
    429; `seed` seeds the sampler. `paged_attention_impl` is the
    reference's knob ("auto", "xla" or "pallas"): on the card the paged
    path is the CUDA kernels, which "auto" and "pallas" select, and
    "xla" (the plain gathered path, what the CPU runs) is refused for a
    CUDA engine rather than run the plain version quietly.
    Outside continuous mode these knobs raise the reference's
    `ValueError`, whose text names `warmup` too: the port's one-shot
    mode takes `warmup` (it warms the decode graphs).
    `tokenizer` (data/bpe.py's `Tokenizer`, or anything with encode,
    decode and vocab_size) serves the "text" request field; without one
    the byte-level fallback applies. A tokenizer whose vocab exceeds a
    model's is refused here, not per request, and one with a native
    encoder (`warm_native`) builds it here, so no request compiles it on
    the event loop.
    `warmup=True` runs every serving shape in an on_startup hook before
    the app takes traffic: the continuous batchers' `warmup`, or in the
    one-shot mode each engine's decode graphs for the window batcher's
    row counts (powers of two up to max_batch). `drafts` maps model
    names to draft engines; a request with "speculative": true then
    decodes through `SpeculativeEngine`. `spec_decode=True`
    (continuous only) instead puts each model's draft into its
    continuous batcher: EVERY request decodes speculatively on the paged
    KV pool, `spec_gamma` draft tokens verified a round; it needs a
    draft for every model, and `/v1/spec` switches it off and on.
    `tenancy` (continuous only) makes each batcher multi-tenant (the
    module docstring); without it the server is tenant-blind, FIFO, as
    before. `drain_grace_s` bounds how long shutdown waits for in-flight
    generations before it closes the batchers. The app's metric registry
    (`app[OBS_KEY].registry`) is rendered at `/metrics`, the SLO burn
    rates with it.
    `pool` is the replica's disaggregation role, "mixed" (the default:
    both phases), "prefill" or "decode" (continuous only): it rides the
    fleet heartbeat, where a pool-aware router reads it; it changes
    routing, not capability. `model_version` labels the boot weights
    (heartbeats; `/v1/reload` replaces it). `reloader(name, engine,
    source) -> params` materializes `/v1/reload`'s new weights (a nested
    dict of tensors, on the host or the card); without one, a
    `{"checkpoint": dir, "step": n}` source loads through
    train/checkpoint.py.
    `registry` / `tracer` share an external metric registry and span
    tracer (default: the app owns fresh ones, rendered at `/metrics` and
    `/debug/traces`); `slo_ttft_s` ({priority class: seconds}) overrides
    TTFT thresholds and `slo_spec_acceptance` the acceptance objective of
    the app's SLOs."""
    if pool not in POOL_ROLES:
        raise ValueError(
            f"pool must be one of {POOL_ROLES}, got {pool!r}")
    if pool != "mixed" and not continuous:
        raise ValueError(
            f"pool={pool!r} requires continuous=True (the handoff "
            "path ships paged KV blocks)")
    if not continuous and (prefill_chunk is not None
                           or prefill_chunk_tokens is not None
                           or prefixes or max_pending is not None
                           or pipeline_depth is not None
                           or kv_block_size != 64
                           or kv_pool_blocks is not None
                           or kv_spill_bytes is not None
                           or paged_attention_impl != "auto"
                           or spec_decode or tenancy is not None):
        # these knobs only exist on the continuous batcher; ignoring
        # them would ship a server without what the caller asked for
        # (max_pending especially: the caller believes overload sheds at
        # that depth; tenancy: that quotas are enforced). The reference's
        # text, which lists warmup too
        raise ValueError(
            "warmup/prefill_chunk/prefill_chunk_tokens/prefixes/"
            "max_pending/pipeline_depth/kv_block_size/kv_pool_blocks/"
            "kv_spill_bytes/paged_attention_impl/spec_decode/tenancy "
            "require continuous=True")
    if paged_attention_impl not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"paged attention impl must be 'auto', 'xla' or 'pallas', "
            f"got {paged_attention_impl!r}")
    on_card = [name for name, eng in engines.items()
               if eng.device.type == "cuda"]
    if paged_attention_impl == "xla" and on_card:
        raise ValueError(
            f"paged_attention_impl='xla' is the plain gathered path, which "
            f"the port runs on the CPU only: on the card the paged path is "
            f"the CUDA kernel ('auto' or 'pallas'); models {on_card}")
    unknown = set(drafts or {}) - set(engines)
    if unknown:
        raise ValueError(f"drafts registered for unknown models "
                         f"{sorted(unknown)}")
    if spec_decode:
        missing = set(engines) - set(drafts or {})
        if missing:
            raise ValueError(
                f"spec_decode=True requires a draft for every served "
                f"model; missing {sorted(missing)}")
    tok_vocab = getattr(tokenizer, "vocab_size", None)
    if tok_vocab is not None:
        # fail at start-up: ids past a model's vocab would 400 every
        # text request with a confusing range error
        for name, eng in engines.items():
            if tok_vocab > eng.cfg.vocab_size:
                raise ValueError(
                    f"tokenizer vocab {tok_vocab} exceeds model "
                    f"{name!r} vocab {eng.cfg.vocab_size}")
    warm_native = getattr(tokenizer, "warm_native", None)
    if warm_native is not None:
        warm_native()
    app = web.Application()
    sobs = ServingObs(registry=registry, tracer=tracer,
                      slo_ttft_s=slo_ttft_s,
                      slo_spec_acceptance=slo_spec_acceptance)
    app[OBS_KEY] = sobs
    app[TENANCY_KEY] = tenancy
    app[POOL_KEY] = pool
    app[MODEL_VERSION_KEY] = str(model_version or "")
    app[RELOADER_KEY] = reloader
    app[DEFECT_KEY] = {}
    app[DRAIN_KEY] = {"draining": False, "grace_s": float(drain_grace_s)}
    app[ENGINES_KEY] = dict(engines)
    app[TOKENIZER_KEY] = tokenizer
    app[SPEC_KEY] = {name: SpeculativeEngine(engines[name], draft)
                     for name, draft in (drafts or {}).items()}
    # one inference at a time per process: the card is the bottleneck
    gpu_lock = asyncio.Lock()
    app[GPU_LOCK_KEY] = gpu_lock
    if continuous:
        app[BATCHERS_KEY] = {
            name: ContinuousBatcher(
                eng, gpu_lock, max_slots=max_batch,
                prefill_chunk=prefill_chunk,
                prefill_chunk_tokens=prefill_chunk_tokens,
                prefixes=prefixes,
                max_pending=256 if max_pending is None else max_pending,
                pipeline_depth=pipeline_depth,
                kv_block_size=kv_block_size, kv_pool_blocks=kv_pool_blocks,
                kv_spill_bytes=kv_spill_bytes, seed=seed,
                draft=(drafts or {}).get(name) if spec_decode else None,
                spec_gamma=spec_gamma, tenancy=tenancy)
            for name, eng in engines.items()}
    else:
        app[BATCHERS_KEY] = (
            {name: Batcher(eng, gpu_lock, window_ms=batch_window_ms,
                           max_batch=max_batch)
             for name, eng in engines.items()}
            if batch_window_ms > 0 else {})
    for name, b in app[BATCHERS_KEY].items():
        if isinstance(b, Batcher):
            b.on_batch = (lambda n, _m=name:
                          sobs.batch_size.observe(n, model=_m))
        else:
            _wire_continuous_metrics(sobs, name, b)
    if continuous:
        sobs.registry.register_collector(
            lambda: _collect_continuous(sobs, app[BATCHERS_KEY]))
    if tenancy is not None:
        _wire_tenant_metrics(sobs, app, tenancy)
    if warmup:
        rows = [1]
        while rows[-1] < max_batch:
            rows.append(rows[-1] * 2)

        async def _warm(app_):
            loop = asyncio.get_running_loop()
            async with gpu_lock:
                for name, eng in app_[ENGINES_KEY].items():
                    b = app_[BATCHERS_KEY].get(name)
                    fn = (b.warmup if isinstance(b, ContinuousBatcher)
                          else lambda eng=eng: eng.warmup(rows))
                    n = await loop.run_in_executor(None, fn)
                    log.info("warmed %s: %d serving shapes", name, n)

        app.on_startup.append(_warm)

    async def _close_batchers(app_):
        # drain first: admission stops and admitted work decodes to
        # completion within the grace window; close fails only the
        # stragglers
        app_[DRAIN_KEY]["draining"] = True
        grace = app_[DRAIN_KEY]["grace_s"]
        for b in app_[BATCHERS_KEY].values():
            b.begin_drain()
        for b in app_[BATCHERS_KEY].values():
            if not await b.drain(timeout=grace):
                log.warning("shutdown drain timed out with %d request(s) "
                            "in flight; closing anyway", b.in_flight())
        for b in app_[BATCHERS_KEY].values():
            await b.close()

    app.on_cleanup.append(_close_batchers)

    get, post = app.router.add_get, app.router.add_post
    for add, route, handler in (
            (get, "/healthz", healthz),
            (get, "/readyz", _ok),
            (get, "/metrics", metrics_handler(sobs.registry)),
            (get, "/debug/traces", debug_traces),
            (get, "/debug/profile", debug_profile),
            (get, "/v1/spec", spec_toggle),
            (post, "/v1/spec", spec_toggle),
            (get, "/v1/models", list_models),
            (get, "/v1/requests/timelines", request_timelines_index),
            (get, "/v1/requests/{id}/timeline", request_timeline),
            (post, "/v1/models/{name}:generate", generate),
            (post, "/v1/models/{name}:prefill", prefill_handoff),
            (post, "/v1/models/{name}:score", score),
            (post, "/v1/reload", reload_weights),
            (post, "/drain", drain_endpoint),
            (post, "/v1/migrate/in", migrate_in),
            (post, "/v1/blocks/export", blocks_export)):
        add(route, _observed(route, handler))
    return app


def _wire_continuous_metrics(sobs: ServingObs, model: str,
                             b: ContinuousBatcher) -> None:
    """Bind a continuous batcher's hooks to the app's families and seed
    their series at zero, as the reference does."""

    def on_prefix(computed, reused, hit, tenant="", restored=0):
        fam = sobs.prefix_hits if hit else sobs.prefix_misses
        fam.inc(model=model)
        fam.inc(model=model, tenant=sobs.tenant_guard.admit(tenant))
        sobs.prefill_tokens.observe(computed, model=model,
                                    source="computed")
        # restored cells are radix hits whose content came off the host
        # spill tier: split out of `reused`, the two partition the cells
        restored = max(0, min(int(restored), int(reused)))
        if reused - restored:
            sobs.prefill_tokens.observe(reused - restored, model=model,
                                        source="reused")
        if restored:
            sobs.prefill_tokens.observe(restored, model=model,
                                        source="restored")

    def on_itl(gap):
        sobs.itl.observe(gap, model=model)
        sobs.slo.observe("serving_itl", gap)

    def on_spec_round(proposed, accepted):
        # every verified draft token is one event against the acceptance
        # SLO: a rejected one burns its budget
        accepted = min(int(accepted), int(proposed))
        for _ in range(accepted):
            sobs.slo.record("serving_spec_acceptance", True)
        for _ in range(int(proposed) - accepted):
            sobs.slo.record("serving_spec_acceptance", False)

    b.on_prefix = on_prefix
    b.on_itl = on_itl
    b.on_queue_wait = lambda wait: sobs.queue_wait.observe(wait,
                                                           model=model)
    b.on_spec_round = on_spec_round
    for fam in (sobs.prefix_hits, sobs.prefix_misses):
        fam.inc(0, model=model)
        fam.inc(0, model=model, tenant=TENANT_BLIND)
    for source in PREFILL_SOURCES:
        sobs.prefill_tokens.seed(model=model, source=source)
    sobs.migration_out.inc(0, model=model)
    sobs.migration_in.inc(0, model=model)
    for direction in MIGRATION_DIRECTIONS:
        sobs.migration_failed.inc(0, model=model, direction=direction)
        sobs.migration_blocks.inc(0, model=model, direction=direction)
    sobs.attention_impl.set(1, model=model, impl=b.cengine.attention_impl)
    for phase in SERVING_PHASES:
        sobs.step_phase_seconds.seed(model=model, phase=phase)
        sobs.step_tokens.seed(model=model, phase=phase)
    sobs.goodput.set(0.0, model=model)
    sobs.bubble.set(0.0, model=model)
    sobs.kv_high_water.set(0, model=model)
    for outcome in PEER_FETCH_OUTCOMES:
        sobs.peer_fetch.inc(0, model=model, outcome=outcome)
    sobs.kv_spill_demotions.inc(0, model=model)
    sobs.kv_spill_restores.inc(0, model=model)
    sobs.kv_spill_bytes.set(0, model=model)
    for fn in WATCHED_SERVING_FNS:
        sobs.recompiles.inc(0, model=model, fn=fn)
    for cause in (*EVICTION_CAUSES, UNATTRIBUTED):
        sobs.kv_evictions.inc(0, model=model, cause=cause)
    for cause in DEFER_CAUSES:
        sobs.kv_admission_defers.inc(0, model=model, cause=cause)
    sobs.kv_reuse_distance.seed(model=model)
    sobs.kv_block_age.seed(model=model)

    def on_phase(phase, seconds, tokens):
        # seconds is None for a token-only attribution
        if seconds is not None:
            sobs.step_phase_seconds.observe(seconds, model=model,
                                            phase=phase)
        if tokens:
            sobs.step_tokens.observe(tokens, model=model, phase=phase)

    b.profiler.on_phase = on_phase
    led = b.cache_ledger
    led.on_free = lambda cause, n: sobs.kv_evictions.inc(
        n, model=model, cause=cause)
    led.on_reuse = lambda dist: sobs.kv_reuse_distance.observe(
        dist, model=model)
    led.on_age = lambda age: sobs.kv_block_age.observe(age, model=model)
    led.on_defer = lambda cause: sobs.kv_admission_defers.inc(
        model=model, cause=cause)
    b.tracer = sobs.tracer
    b.compile_watch.tracer = sobs.tracer
    b.compile_watch.on_recompile = lambda fn, sig: sobs.recompiles.inc(
        model=model, fn=fn)


def _sync_counter(counter, total, **labels) -> None:
    """A counter brought up to a cumulative total kept elsewhere (a
    counter only rises: add the difference since the last scrape)."""
    cur = counter.value(**labels)
    if total > cur:
        counter.inc(total - cur, **labels)


def _collect_continuous(sobs: ServingObs, batchers: dict) -> None:
    """Scrape-time refresh of the continuous batchers' derived series:
    the live pool, the step profiler's goodput ledger and the spill
    tier's traffic (the block ledger's totals) and occupancy."""
    for model, b in batchers.items():
        sobs.kv_blocks.set(b.kv_blocks_in_use(), model=model)
        g = b.profiler.goodput()
        sobs.goodput.set(g["goodput_ratio"], model=model)
        sobs.bubble.set(g["bubble_fraction"], model=model)
        sobs.kv_high_water.set(g["kv_blocks_high_water"], model=model)
        led = b.cache_ledger
        _sync_counter(sobs.kv_spill_demotions, led.spill_demotions,
                      model=model)
        _sync_counter(sobs.kv_spill_restores, led.spill_restores,
                      model=model)
        tier = b._spill_tier
        sobs.kv_spill_bytes.set(tier.spilled_bytes if tier else 0,
                                model=model)


def _wire_tenant_metrics(sobs: ServingObs, app: web.Application,
                         tenancy: TenancyConfig) -> None:
    """Zero-seed every configured tenant's series (dashboards see the
    full set from the first scrape), admit the configured names into the
    label guard, and register the collector that syncs the counters
    with the batchers' ledgers at scrape time."""
    for tenant in tenancy.names():
        sobs.tenant_guard.admit(tenant)
        for model in app[BATCHERS_KEY]:
            sobs.tenant_queue_depth.set(0, model=model, tenant=tenant)
            sobs.tenant_tokens.inc(0, model=model, tenant=tenant)
            sobs.tenant_preemptions.inc(0, model=model, tenant=tenant)
            sobs.prefix_hits.inc(0, model=model, tenant=tenant)
            sobs.prefix_misses.inc(0, model=model, tenant=tenant)
            for reason in THROTTLE_REASONS:
                sobs.tenant_throttled.inc(0, model=model, tenant=tenant,
                                          reason=reason)

    def collect_tenants():
        for model, b in app[BATCHERS_KEY].items():
            for tenant, st in b.tenant_stats().items():
                tenant = sobs.tenant_guard.admit(tenant)
                sobs.tenant_queue_depth.set(st.get("queued", 0),
                                            model=model, tenant=tenant)
                _sync_counter(sobs.tenant_tokens, st["tokens"],
                              model=model, tenant=tenant)
                _sync_counter(sobs.tenant_preemptions, st["preempted"],
                              model=model, tenant=tenant)
                for reason, n in st["throttled"].items():
                    _sync_counter(sobs.tenant_throttled, n, model=model,
                                  tenant=tenant, reason=reason)

    sobs.registry.register_collector(collect_tenants)


async def _ok(request: web.Request):
    return web.json_response({"status": "ok"})


def _continuous(app: web.Application):
    return ((name, b) for name, b in app[BATCHERS_KEY].items()
            if isinstance(b, ContinuousBatcher))


async def debug_traces(request: web.Request):
    """The tracer's ring (`traces_response_payload`: 400 on a bad
    `?limit=`) with each continuous batcher's counter tracks (phase
    budgets, pool fill, occupancy, cumulative frees per cause), named
    `<model>.<track>`, on the spans' clock."""
    try:
        payload = traces_response_payload(request.app[OBS_KEY].tracer,
                                          request.rel_url.query)
    except ValueError as e:
        raise web.HTTPBadRequest(text=str(e)) from None
    for name, b in _continuous(request.app):
        merge_counter_tracks(payload, b.profiler.counter_events(prefix=name))
        merge_counter_tracks(payload,
                             b.cache_ledger.counter_events(prefix=name))
    return web.json_response(payload)


async def debug_profile(request: web.Request):
    """Per continuous batcher: the step anatomy (per-phase counts,
    totals, tokens, rolling p50 / p95, the goodput ledger), `recompiles`
    (the compile watch's counts) and `cache` (`cache_anatomy()`)."""
    models = {}
    for name, b in _continuous(request.app):
        snap = b.profiler.snapshot()
        snap["recompiles"] = b.compile_watch.counts()
        snap["cache"] = b.cache_anatomy()
        models[name] = snap
    return web.json_response({"models": models})


def _spec_state(app: web.Application) -> dict:
    """Per-model continuous speculative decoding state for /v1/spec."""
    out = {}
    for name, b in app[BATCHERS_KEY].items():
        has_draft = (isinstance(b, ContinuousBatcher)
                     and b.cengine.draft is not None)
        out[name] = {"draft": has_draft,
                     "spec_enabled": bool(has_draft and b.spec_enabled)}
    return out


async def spec_toggle(request: web.Request):
    """`POST /v1/spec {"enabled": bool}`: the kill switch of continuous
    speculative decoding on every model with a draft (a draft that stops
    earning its keep costs a verify round per window for nothing).
    `GET` returns the per-model state."""
    if request.method == "GET":
        return web.json_response({"models": _spec_state(request.app)})
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001 — any unparsable body is a 400
        return web.json_response({"error": "invalid JSON"}, status=400)
    enabled = body.get("enabled") if isinstance(body, dict) else None
    if not isinstance(enabled, bool):
        return web.json_response(
            {"error": "body needs a boolean 'enabled'"}, status=400)
    for b in request.app[BATCHERS_KEY].values():
        if isinstance(b, ContinuousBatcher) and b.cengine.draft is not None:
            b.spec_enabled = enabled
    return web.json_response({"enabled": enabled,
                              "models": _spec_state(request.app)})


def _in_flight(app: web.Application) -> int:
    return sum(b.in_flight() for b in app[BATCHERS_KEY].values())


async def healthz(request: web.Request):
    """200 only when the server admits work: not draining, every
    continuous batcher's queue below its shed depth. /readyz stays the
    bare liveness 200."""
    app = request.app
    if app[DRAIN_KEY]["draining"]:
        return web.json_response(
            {"status": "draining", "in_flight": _in_flight(app)},
            status=503)
    models = {}
    overloaded = False
    for name, b in request.app[BATCHERS_KEY].items():
        if isinstance(b, ContinuousBatcher):
            models[name] = {
                "pending": len(b._pending),
                "active_slots": len(b._active),
                "kv_blocks_free": b.cengine.pool.num_free,
                "kv_blocks_total": b.cengine.num_blocks,
            }
            overloaded = overloaded or len(b._pending) >= b.max_pending
        else:
            models[name] = {"in_flight": b.in_flight()}
    if overloaded:
        return web.json_response(
            {"status": "overloaded", "models": models}, status=503)
    return web.json_response({"status": "ok", "models": models})


async def list_models(request: web.Request):
    out = []
    for name, eng in request.app[ENGINES_KEY].items():
        entry = {
            "name": name,
            "family": eng.family.name,
            "max_len": eng.ec.max_len,
            "vocab_size": eng.cfg.vocab_size,
            "hidden_size": eng.cfg.hidden_size,
            "num_layers": eng.cfg.num_layers,
            "device": str(eng.device),
        }
        if eng.adapter_pack is not None:
            entry["adapters"] = sorted(eng.adapter_pack.names)
        b = request.app[BATCHERS_KEY].get(name)
        if b is not None:
            # window batcher: mean batch = batched_requests / calls;
            # continuous: calls are decode steps, occupancy the analog
            entry["batcher_calls"] = b.calls
            entry["batched_requests"] = b.requests
            if isinstance(b, ContinuousBatcher):
                entry.update({
                    "batcher_mode": "continuous",
                    "pipeline_depth": b.pipeline_depth,
                    "occupancy": round(b.occupancy(), 3),
                    "pending": len(b._pending),
                    "active_slots": len(b._active),
                    "kv_block_size": b.cengine.block_size,
                    "kv_pool_blocks": b.cengine.num_blocks,
                    "prefix_cache": b.prefix_cache_stats(),
                })
                tstats = b.tenant_stats()
                if tstats:
                    entry["tenants"] = tstats
                if b._prefixes:
                    entry["prefixes"] = {
                        n: len(t) for n, t in b._prefixes.items()}
            else:
                entry["batcher_mode"] = "window"
        out.append(entry)
    return web.json_response({"models": out,
                              "kernel_launches": launch_counts()})


async def request_timeline(request: web.Request):
    """One request's timeline by its X-Request-Id, live or finished,
    while the bounded store holds it."""
    rid = request.match_info["id"]
    for b in request.app[BATCHERS_KEY].values():
        if isinstance(b, ContinuousBatcher):
            tl = b.timelines.get(rid)
            if tl is not None:
                return web.json_response(tl.to_dict())
    return web.json_response(
        {"error": f"no timeline for request {rid!r} (timelines "
                  "exist for continuous-batching requests only, "
                  "and the store is bounded)"},
        status=404)


async def request_timelines_index(request: web.Request):
    """Every id the bounded stores still hold, oldest first per model."""
    ids: list[str] = []
    for b in request.app[BATCHERS_KEY].values():
        if isinstance(b, ContinuousBatcher):
            ids.extend(b.timelines.ids())
    return web.json_response({"requests": ids})


def _bad(msg: str) -> web.Response:
    return web.json_response({"error": msg}, status=400)


async def _on_device(request: web.Request, fn, span: str):
    """Run one blocking engine call in the executor under the gpu lock,
    as span `span` (the tracer carries the request's context into the
    executor thread, which `run_in_executor` does not)."""
    loop = asyncio.get_running_loop()
    fn = request.app[OBS_KEY].tracer.wrap(fn, span)
    async with request.app[GPU_LOCK_KEY]:
        return await loop.run_in_executor(None, fn)


def _retry_after_s(batcher: ContinuousBatcher, exc: Exception) -> str:
    """Retry-After of a 429: a `Throttled` tenant's bucket refill time;
    for `Overloaded`, when the backlog should clear: queue depth x the
    recent per-request service time over the slot count. Clamped to [1,
    RETRY_AFTER_CAP_S] whole seconds."""
    if isinstance(exc, Throttled):
        est = exc.retry_after
    else:
        slots = max(1, len(batcher._free) + len(batcher._active))
        # service_ewma is 0.0 until the first completion: a second a
        # request, the old constant, is then the floor
        est = ((len(batcher._pending) + 1) * (batcher.service_ewma or 1.0)
               / slots)
    return str(max(1, min(RETRY_AFTER_CAP_S, math.ceil(est))))


def _shed(batcher: ContinuousBatcher, e: Exception) -> web.Response:
    """The 429 of a throttled tenant or an overloaded queue."""
    msg = str(e) if isinstance(e, Throttled) else f"server overloaded: {e}"
    return web.json_response(
        {"error": msg}, status=429,
        headers={"Retry-After": _retry_after_s(batcher, e)})


def _draining() -> web.Response:
    # 503, not 429: the server is going away; try another replica
    return web.json_response({"error": "server is draining"}, status=503,
                             headers={"Retry-After": "5"})


def _decode_text(request: web.Request, model: str, ids: list[int]) -> str:
    tokenizer = request.app[TOKENIZER_KEY]
    if tokenizer is not None:
        return tokenizer.decode(ids)
    sobs = request.app[OBS_KEY]
    return byte_decode(
        ids, on_dropped=lambda n: sobs.dropped_tokens.inc(n, model=model))


def _sse(obj: dict) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


_SSE_HEADERS = {"Content-Type": "text/event-stream",
                "Cache-Control": "no-cache", "X-Accel-Buffering": "no"}


def _sse_headers(tracer: Tracer) -> dict:
    """A stream's headers, with the root span's `X-Trace-Id`: the route
    wrapper cannot add a header once the stream is prepared."""
    trace_id = tracer.current_trace_id()
    return ({**_SSE_HEADERS, "X-Trace-Id": trace_id} if trace_id
            else dict(_SSE_HEADERS))


async def _stream_generate(request: web.Request, engine: InferenceEngine,
                           arr: np.ndarray, max_new: int, sampling: dict,
                           text_mode: bool) -> web.StreamResponse:
    """SSE over the one-shot engine: `data: {"tokens": [[...]]}` per
    decoded chunk of STREAM_CHUNK tokens, then the terminal record. The
    stream ends early once every row hits EOS. The gpu lock is held for
    each chunk's device work only, never across the client write, so a
    slow reader holds back its own stream and no other request."""
    # the generator validates eagerly: an argument the handler's checks
    # missed is still a clean 400, never a 200 that dies mid-stream
    try:
        gen = engine.generate_stream(arr, max_new=max_new,
                                     chunk=STREAM_CHUNK, **sampling)
    except ValueError as e:
        return _bad(str(e))
    model = request.match_info.get("name", "")
    tracer = request.app[OBS_KEY].tracer
    resp = web.StreamResponse(headers=_sse_headers(tracer))
    await resp.prepare(request)
    loop = asyncio.get_running_loop()
    chunks: list[np.ndarray] = []
    error: str | None = None
    with tracer.span("stream.decode", model=model):
        while True:
            try:
                async with request.app[GPU_LOCK_KEY]:
                    part = await loop.run_in_executor(None, next, gen, None)
            except Exception as e:  # noqa: BLE001 — headers are out
                # a raise here would abort the connection like a network
                # drop: end with a terminal error record instead
                log.exception("decode failed mid-stream")
                error = f"{type(e).__name__}: {e}"
                break
            if part is None:
                break
            chunks.append(part)
            _observe_first_token(request, model)
            await resp.write(_sse({"tokens": part.tolist()}))
    total = int(sum(c.shape[1] for c in chunks))
    if error is not None:
        final: dict[str, Any] = {"error": error, "total": total}
    else:
        final = {"done": True, "total": total}
        if text_mode and chunks:
            final["text"] = _decode_text(
                request, model, np.concatenate(chunks, axis=1)[0].tolist())
    await resp.write(_sse(final))
    await resp.write_eof()
    return resp


async def _stream_continuous(request: web.Request,
                             batcher: ContinuousBatcher, tokens: list[int],
                             max_new: int, sampling: dict,
                             text_mode: bool) -> web.StreamResponse:
    """SSE through the continuous batcher: one event per emitted token
    (`data: {"tokens": [[t]]}`), then the same terminal record as
    `_stream_generate`. Concurrent streams share the slot batch; each
    consumer awaits its own tokens, never the gpu lock."""
    try:
        # enqueue before the SSE headers: admission errors, Overloaded
        # included, are a clean 429/4xx, never a mid-stream abort
        fut, q = batcher.open_stream(tokens, max_new, sampling)
    except (Throttled, Overloaded) as e:
        return _shed(batcher, e)
    model = request.match_info.get("name", "")
    tracer = request.app[OBS_KEY].tracer
    resp = web.StreamResponse(headers={
        **_sse_headers(tracer), "X-Request-Id": sampling["request_id"]})
    ids: list[int] = []
    error: str | None = None
    try:
        await resp.prepare(request)
        with tracer.span("stream.continuous", model=model):
            while True:
                tok = await q.get()
                if tok is None:
                    break
                ids.append(tok)
                _observe_first_token(request, model)
                await resp.write(_sse({"tokens": [[tok]]}))
        try:
            await fut   # admission and step errors surface after drain
        except MigratedAway as e:
            # an instant drain exported it: the terminal error event
            # tells the client to resume elsewhere
            error = f"{type(e).__name__}: {e}"
        except Exception as e:  # noqa: BLE001 — headers are out
            log.exception("continuous decode failed mid-stream")
            error = f"{type(e).__name__}: {e}"
    finally:
        if not fut.done():
            fut.cancel()   # consumer gone: release the slot
    if error is not None:
        final: dict[str, Any] = {"error": error, "total": len(ids)}
    else:
        final = {"done": True, "total": len(ids)}
        if text_mode and ids:
            final["text"] = _decode_text(request, model, ids)
    await resp.write(_sse(final))
    await resp.write_eof()
    return resp


def _parse_token_lists(body: dict, tokenizer, *, min_len: int):
    """Token rows from "text" or "tokens", the one parser of the
    generate and score doors. -> (token_lists, text_mode) or a 400
    response. `min_len` is the per-row floor: 1 to generate, 2 to score
    (a single token has nothing to predict)."""
    text_mode = "text" in body
    if text_mode:
        if not isinstance(body["text"], str):
            return _bad("'text' must be a string")
        token_lists = [tokenizer.encode(body["text"], bos=True)
                       if tokenizer else byte_encode(body["text"])]
        if len(token_lists[0]) < min_len:
            return _bad(f"text encodes to fewer than {min_len} tokens (at "
                        "least 2 needed to score)"
                        if min_len > 1 else "text encodes to no tokens")
    elif "tokens" in body:
        token_lists = body["tokens"]
        if (not isinstance(token_lists, list) or not token_lists
                or not all(
                    isinstance(t, list) and len(t) >= min_len
                    and all(isinstance(x, int) and not isinstance(x, bool)
                            for x in t)
                    for t in token_lists)):
            return _bad("tokens must be a non-empty list of integer "
                        f"token-id lists with at least {min_len} "
                        "token(s) each")
    else:
        return _bad("body needs 'text' or 'tokens'")
    return token_lists, text_mode


async def _json_body(request: web.Request):
    """The request's JSON object, or a 400 response."""
    try:
        body = await request.json()
    except ValueError:
        return _bad("invalid JSON")
    if not isinstance(body, dict):
        return _bad("body must be a JSON object")
    return body


def _token_array(token_lists, vocab: int):
    """-> int64 [rows, len] of in-range ids, or a 400 response."""
    try:
        arr = np.asarray(token_lists, dtype=np.int64)
    except OverflowError:
        return _bad(f"token ids must be in [0, {vocab})")
    if arr.min() < 0 or arr.max() >= vocab:
        return _bad(f"token ids must be in [0, {vocab})")
    return arr


async def score(request: web.Request):
    """Teacher-forced scoring: log P(token_i | prefix) of a given
    sequence (the perplexity / eval door). Body {"tokens": [[...]]} or
    {"text": "..."}; response: per-position logprobs (s - 1 a row), each
    row's total, and the count. One forward of the one-shot engine."""
    if request.app[DRAIN_KEY]["draining"]:
        return _draining()
    name = request.match_info["name"]
    engine = request.app[ENGINES_KEY].get(name)
    if engine is None:
        return web.json_response({"error": f"no model {name!r}"},
                                 status=404)
    body = await _json_body(request)
    if isinstance(body, web.Response):
        return body
    parsed = _parse_token_lists(body, request.app[TOKENIZER_KEY],
                                min_len=2)
    if isinstance(parsed, web.Response):
        return parsed
    token_lists, _ = parsed
    if len({len(t) for t in token_lists}) != 1:
        return _bad("all rows must share a length (static shapes)")
    if len(token_lists[0]) > engine.ec.max_len:
        return _bad(f"sequence {len(token_lists[0])} exceeds model "
                    f"max_len {engine.ec.max_len}")
    arr = _token_array(token_lists, engine.cfg.vocab_size)
    if isinstance(arr, web.Response):
        return arr
    with request.app[OBS_KEY].tracer.span("engine.score", model=name,
                                          batch=int(arr.shape[0])):
        lps = await _on_device(
            request, lambda: engine.score(arr).cpu().numpy(), "device.score")
    return web.json_response({
        "logprobs": [[round(float(x), 6) for x in row] for row in lps],
        "total": [round(float(row.sum()), 6) for row in lps],
        "count": int(arr.shape[1] - 1),
    })


def _tenant(request: web.Request) -> dict:
    """The X-Tenant header as a sampling-channel entry: a header, not a
    body field, so a proxy forwards it without parsing the payload; the
    batcher pops it back out and resolves it (absent or unknown:
    `default`)."""
    tenant = request.headers.get("X-Tenant", "")
    return {"tenant": tenant} if tenant else {}


def _apply_stop(row: list[int], stop: list[list[int]]) -> list[int]:
    """Cut `row` before the earliest occurrence of any stop sequence."""
    cut = None
    for seq in stop:
        n = len(seq)
        for i in range(len(row) - n + 1):
            if row[i:i + n] == seq:
                cut = i if cut is None else min(cut, i)
                break
    return row if cut is None else row[:cut]


async def generate(request: web.Request):
    if request.app[DRAIN_KEY]["draining"]:
        # admission stops at the door; in-flight work keeps decoding
        return _draining()
    name = request.match_info["name"]
    engine = request.app[ENGINES_KEY].get(name)
    if engine is None:
        return web.json_response({"error": f"no model {name!r}"},
                                 status=404)
    # a defect /v1/reload planted: a deliberate TTFT stall a rollout's
    # canary judge must catch
    delay = request.app[DEFECT_KEY].get("ttft_delay_s", 0.0)
    if delay:
        await asyncio.sleep(float(delay))
    body = await _json_body(request)
    if isinstance(body, web.Response):
        return body
    tokenizer = request.app[TOKENIZER_KEY]
    parsed = _parse_token_lists(body, tokenizer, min_len=1)
    if isinstance(parsed, web.Response):
        return parsed
    token_lists, text_mode = parsed
    max_new = body.get("max_new", 16)
    if not isinstance(max_new, int) or isinstance(max_new, bool) \
            or max_new < 1:
        return _bad("max_new must be a positive integer")
    sampling: dict[str, Any] = {}
    temperature = body.get("temperature")
    if temperature is not None:
        if not isinstance(temperature, (int, float)) \
                or isinstance(temperature, bool) \
                or not math.isfinite(temperature) or temperature < 0:
            return _bad("temperature must be a finite number >= 0")
        sampling["temperature"] = float(temperature)
    top_k = body.get("top_k")
    if top_k is not None:
        if not isinstance(top_k, int) or isinstance(top_k, bool) \
                or top_k < 0 or top_k >= 2**31:
            return _bad("top_k must be an integer in [0, 2**31)")
        sampling["top_k"] = top_k
    top_p = body.get("top_p")
    if top_p is not None:
        if not isinstance(top_p, (int, float)) \
                or isinstance(top_p, bool) or not 0.0 < top_p <= 1.0:
            return _bad("top_p must be in (0, 1]")
        sampling["top_p"] = float(top_p)
    adapter = body.get("adapter", "")
    if not isinstance(adapter, str):
        return _bad("adapter must be a string")
    if adapter:
        if engine.adapter_pack is None:
            return _bad(f"model {name!r} has no adapters loaded")
        try:
            engine.adapter_pack.resolve(adapter)
        except ValueError as e:
            return _bad(str(e))
    prefix = body.get("prefix", "")
    if not isinstance(prefix, str):
        return _bad("prefix must be a string")
    logprobs = body.get("logprobs", False)
    if not isinstance(logprobs, bool):
        return _bad("logprobs must be a boolean")
    stop = body.get("stop", [])
    if (not isinstance(stop, list) or len(stop) > 4
            or not all(isinstance(s, list) and 0 < len(s) <= 16
                       and all(isinstance(t, int)
                               and not isinstance(t, bool) for t in s)
                       for s in stop)):
        return _bad("stop must be up to 4 non-empty token-id lists of at "
                    "most 16 tokens")
    lens = {len(t) for t in token_lists}
    if len(lens) != 1:
        return _bad("all prompts in a batch must share a length "
                    "(static shapes); pad client-side")
    prompt_len = lens.pop()
    cap = engine.ec.max_len
    if prompt_len + max_new > cap:
        return _bad(f"prompt {prompt_len} + max_new {max_new} exceeds "
                    f"model max_len {cap}")
    batcher = request.app[BATCHERS_KEY].get(name)
    if prefix:
        if not isinstance(batcher, ContinuousBatcher):
            return _bad("prefix requires continuous batching")
        if prefix not in batcher._prefixes:
            return _bad(f"unknown prefix {prefix!r}; registered: "
                        f"{sorted(batcher._prefixes)}")
        if adapter:
            return _bad("prefix does not compose with adapter")
        if len(token_lists) != 1:
            return _bad("prefix requests are single-prompt")
        if body.get("speculative", False) is True:
            return _bad("prefix does not compose with speculative")
        plen = len(batcher._prefixes[prefix])
        if plen + prompt_len + max_new > cap:
            return _bad(f"prefix {plen} + prompt {prompt_len} + max_new "
                        f"{max_new} exceeds model max_len {cap}")
        sampling["prefix"] = prefix
    if adapter:
        # an engine.generate kwarg, and the batcher's sampling channel
        sampling["adapter"] = adapter
    arr = _token_array(token_lists, engine.cfg.vocab_size)
    if isinstance(arr, web.Response):
        return arr
    # a router's heat hint: a peer caches this prompt's first block and
    # this replica does not, so pull the blocks before admission; every
    # failure falls through to the plain prefill. A peer exports base
    # cells only, which an adapter's radix key never matches, so an
    # adapter request fetches nothing
    peer_hint = request.headers.get("X-KV-Peer", "")
    if (peer_hint and not prefix and not adapter and arr.shape[0] == 1
            and not request.app[DRAIN_KEY]["draining"]
            and isinstance(batcher, ContinuousBatcher)):
        await _peer_fetch_blocks(request.app, name, batcher,
                                 token_lists[0], peer_hint)
    speculative = body.get("speculative", False)
    if not isinstance(speculative, bool):
        return _bad("speculative must be a boolean")
    # the one-shot paths generate to a power-of-two bucket of max_new
    # and trim the response back to the ask
    max_new_req = max_new
    max_new = max(bucket_pow2(max_new, cap - prompt_len), max_new_req)
    gamma = body.get("gamma", 4)
    if not isinstance(gamma, int) or isinstance(gamma, bool) or gamma < 1:
        return _bad("gamma must be a positive integer")
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        return _bad("stream must be a boolean")
    continuous = isinstance(batcher, ContinuousBatcher)
    req_id = None
    if continuous:
        # the timeline's key, echoed as X-Request-Id; a client's (a
        # router's) id wins, so a resumed request keeps its timeline
        req_id = request.headers.get("X-Request-Id") or secrets.token_hex(8)
    if stream:
        if speculative:
            return _bad("stream does not compose with speculative")
        if stop:
            # a streamed stop would need partial-match buffering so as
            # not to emit half a stop sequence
            return _bad("stop does not compose with stream")
        if logprobs:
            return _bad("logprobs does not compose with stream")
        if continuous and arr.shape[0] == 1:
            return await _stream_continuous(
                request, batcher, token_lists[0], max_new_req,
                {**sampling, **_tenant(request), "request_id": req_id},
                text_mode)
        if adapter:
            return _bad("adapter streaming requires continuous batching "
                        "(create_serving_app continuous)")
        return await _stream_generate(request, engine, arr, max_new_req,
                                      sampling, text_mode)

    resp: dict[str, Any] = {}
    lp_rows = None
    if speculative:
        if logprobs:
            return _bad("logprobs does not compose with speculative")
        if adapter:
            return _bad("adapter does not compose with speculative")
        spec = request.app[SPEC_KEY].get(name)
        if spec is None:
            return _bad(f"no draft model registered for {name!r}")
        if arr.shape[0] != 1:
            return _bad("speculative decoding is batch-1")
        # gamma to a power of two <= 8 before the capacity check (a perf
        # knob only: bucketing never changes the output law)
        g = 1
        while g * 2 <= min(gamma, 8):
            g *= 2
        gamma = g
        # the draft's cache must hold the window too; the bucketed
        # max_new shrinks back toward the ask before anything is refused
        cap = min(cap, spec.draft.ec.max_len)
        if prompt_len + max_new + gamma > cap:
            max_new = max(cap - prompt_len - gamma, max_new_req)
        if prompt_len + max_new_req + gamma > cap:
            return _bad(f"prompt {prompt_len} + max_new {max_new_req} + "
                        f"gamma {gamma} exceeds model max_len {cap}")

        def run_spec():
            toks_, stats_ = spec.generate(arr, max_new=max_new, gamma=gamma,
                                          **sampling)
            return toks_.cpu().numpy(), stats_

        with request.app[OBS_KEY].tracer.span(
                "engine.speculative", model=name, gamma=gamma,
                max_new=max_new):
            toks, stats = await _on_device(request, run_spec,
                                           "device.generate")
        _observe_first_token(request, name)
        # the speculative engine does not special-case EOS; pin the tail
        # after the first EOS as the plain path does
        eos = engine.ec.eos_token
        if eos is not None:
            hits = np.where(toks[0] == eos)[0]
            if hits.size:
                toks[0, hits[0]:] = eos
        resp["speculative"] = {
            "acceptance_rate": round(stats.acceptance_rate, 4),
            "proposed": int(stats.proposed),
            "accepted": int(stats.accepted),
            "gamma": gamma,   # the effective (bucketed) window
        }
        rows = toks[:, :max_new_req].tolist()
    elif continuous:
        submit = {**sampling, **_tenant(request)}
        if stop:
            # the batcher retires the slot the moment a stop sequence
            # completes; the post-trim below is then a no-op
            submit["stop"] = stop
        if len(token_lists) == 1:
            submit["request_id"] = req_id
        else:
            req_id = None   # rows keep the batcher's own timeline ids
        try:
            with request.app[OBS_KEY].tracer.span(
                    "batcher.submit", model=name, max_new=max_new_req):
                results = await asyncio.gather(*(
                    batcher.submit(t, max_new_req, submit,
                                   with_logprobs=True)
                    for t in token_lists))
        except (Throttled, Overloaded) as e:
            return _shed(batcher, e)
        except MigratedAway as e:
            # an instant drain shipped this sequence to a peer: retryable
            return web.json_response({"error": str(e), "migrated": True},
                                     status=503, headers={"Retry-After": "0"})
        _observe_first_token(request, name)
        rows = [list(toks) for toks, _ in results]
        lp_rows = [list(lps) for _, lps in results]
    elif batcher is not None and arr.shape[0] == 1 and not adapter:
        # single prompts ride the window batcher; explicit client-side
        # batches, and adapter requests (the window batcher's groups
        # carry no adapter ids), keep their one-shot call
        with request.app[OBS_KEY].tracer.span(
                "batcher.submit", model=name, max_new=max_new_req):
            toks, lps = await batcher.submit(token_lists[0], max_new_req,
                                             sampling)
        _observe_first_token(request, name)
        rows, lp_rows = [toks], [lps]
    else:
        def run_direct():
            toks_, lps_ = engine.generate(arr, max_new=max_new,
                                          return_logprobs=True, **sampling)
            return toks_.cpu().numpy(), lps_.cpu().numpy()

        with request.app[OBS_KEY].tracer.span(
                "engine.generate", model=name, batch=int(arr.shape[0]),
                max_new=max_new):
            toks, lps = await _on_device(request, run_direct,
                                         "device.generate")
        request.app[OBS_KEY].batch_size.observe(arr.shape[0], model=name)
        _observe_first_token(request, name)
        rows = toks[:, :max_new_req].tolist()
        lp_rows = lps[:, :max_new_req].tolist()
    if stop:
        # OpenAI semantics on every path: the output ends before the
        # earliest occurrence of a stop sequence
        rows = [_apply_stop(r, stop) for r in rows]
        if lp_rows is not None:
            lp_rows = [lp[:len(r)] for lp, r in zip(lp_rows, rows)]
    resp["tokens"] = rows
    if logprobs:
        # entries cover tokens up to AND INCLUDING the row's first EOS
        eos = engine.ec.eos_token
        out_lps = []
        for r, lp in zip(rows, lp_rows):
            n = len(r)
            if eos is not None and eos in r:
                n = r.index(eos) + 1
            out_lps.append([round(float(x), 6) for x in lp[:n]])
        resp["logprobs"] = out_lps
    if text_mode:
        resp["text"] = _decode_text(request, name, rows[0])
    return web.json_response(
        resp, headers={"X-Request-Id": req_id} if req_id else None)


async def drain_endpoint(request: web.Request):
    """Stop admission now. Bodyless: admitted generations decode to
    completion and the response reports what is still in flight (the
    wait-out drain). `{"migrate": true, "peers": [url, ...]}`: every
    admitted sequence is exported (serving/migration.py records) and
    pushed round-robin to the peers' `/v1/migrate/in`, so the replica
    can exit at once (the instant drain); the response counts the
    records `migrated` and those no peer accepted as `failed`."""
    app = request.app
    app[DRAIN_KEY]["draining"] = True
    for b in app[BATCHERS_KEY].values():
        b.begin_drain()
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001 — bodyless wait-out drain
        body = {}
    if not (isinstance(body, dict) and body.get("migrate")):
        return web.json_response(
            {"draining": True, "in_flight": _in_flight(app)})
    import aiohttp

    peers = [str(p).rstrip("/") for p in body.get("peers", []) if p]
    sobs: ServingObs = app[OBS_KEY]
    t0 = time.monotonic()
    migrated = failed = 0
    async with aiohttp.ClientSession() as session:
        for name, b in app[BATCHERS_KEY].items():
            if not isinstance(b, ContinuousBatcher):
                continue
            with sobs.tracer.span("migrate.out", model=name):
                records = await b.export_sequences()
            for i, record in enumerate(records):
                ok = False
                for j in range(len(peers)):
                    peer = peers[(i + j) % len(peers)]
                    try:
                        async with session.post(
                                f"{peer}/v1/migrate/in",
                                json={"model": name, "record": record},
                                timeout=aiohttp.ClientTimeout(
                                    total=30)) as r:
                            if r.status == 200:
                                ok = True
                                break
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError):
                        continue
                if ok:
                    migrated += 1
                    sobs.migration_out.inc(model=name)
                    kv = record.get("kv")
                    if kv:
                        sobs.migration_blocks.inc(
                            kv["n_full"], model=name, direction="out")
                else:
                    failed += 1
                    sobs.migration_failed.inc(model=name, direction="out")
    return web.json_response({
        "draining": True, "in_flight": _in_flight(app),
        "migrated": migrated, "failed": failed,
        "migrate_s": round(time.monotonic() - t0, 3)})


def _record_limit(batcher: ContinuousBatcher) -> int:
    """Body bytes `/v1/migrate/in` accepts: a record of every full block
    a slot can hold, float32 and base64 (4/3) for K and V, with 1 MiB
    for the token lists. aiohttp's default body limit (1 MiB, which the
    reference keeps) is below one llama3-1b block (8 MiB on the wire)."""
    ce = batcher.cengine
    cfg = ce.engine.cfg
    kv = 2 * cfg.num_layers * ce.kv_width * cfg.num_kv_heads * cfg.head_dim
    return kv * 4 * 4 // 3 + (1 << 20)


async def _read_record_body(request: web.Request, limit: int):
    """The request's JSON body, read up to `limit` bytes past the app's
    default body limit. -> the parsed body, or a 400 / 413 response."""
    raw = bytearray()
    while True:
        chunk = await request.content.read(1 << 20)
        if not chunk:
            break
        raw += chunk
        if len(raw) > limit:
            return web.json_response(
                {"error": f"migration record over {limit} bytes"},
                status=413)
    try:
        return json.loads(raw)
    except ValueError:
        return web.json_response({"error": "invalid JSON"}, status=400)


async def migrate_in(request: web.Request):
    """Import one migrated sequence (`{"model": name, "record": <wire
    record>}`): geometry validated, local blocks allocated, the KV
    scattered into them and the prefix indexed in the radix cache under
    the record's namespace. Nothing is enqueued: the re-issued
    generation (replay tokens, remaining budget) hits the imported
    prefix. Any failure, a wedged transfer (`"wedge": true`, a fault
    injected mid-transfer) included, rolls back: every block it took is
    freed."""
    app = request.app
    # a record carries its KV blocks: past the app's 1 MiB body limit at
    # real widths, so the body is read up to the largest record this
    # replica's pools can import
    limit = max([_record_limit(b) for b in app[BATCHERS_KEY].values()
                 if isinstance(b, ContinuousBatcher)] + [1 << 20])
    body = await _read_record_body(request, limit)
    if isinstance(body, web.Response):
        return body
    name = body.get("model", "") if isinstance(body, dict) else ""
    batcher = app[BATCHERS_KEY].get(name)
    if name not in app[ENGINES_KEY]:
        return web.json_response({"error": f"no model {name!r}"},
                                 status=404)
    if not isinstance(batcher, ContinuousBatcher):
        return web.json_response(
            {"error": "migration import requires continuous batching"},
            status=400)
    record = body.get("record")
    wedge = bool(body.get("wedge", False))
    sobs: ServingObs = app[OBS_KEY]
    try:
        with sobs.tracer.span("migrate.in", model=name, wedge=wedge):
            blocks = await batcher.import_sequence(record, wedge=wedge)
    except ValueError as e:
        sobs.migration_failed.inc(model=name, direction="in")
        return web.json_response({"error": str(e)}, status=400)
    except Exception as e:  # noqa: BLE001 — rolled back inside
        sobs.migration_failed.inc(model=name, direction="in")
        return web.json_response({"error": f"{type(e).__name__}: {e}"},
                                 status=500)
    sobs.migration_in.inc(model=name)
    if blocks:
        sobs.migration_blocks.inc(blocks, model=name, direction="in")
    rid = (str(record.get("request_id", ""))
           if isinstance(record, dict) else "")
    return web.json_response(
        {"imported": True, "blocks": blocks, "request_id": rid})


async def blocks_export(request: web.Request):
    """The peer side of a block pull: body
    `migration.prefix_fetch_request` (`model`, `tokens`, `ns` and the
    16-hex hash of the first block). -> this replica's cached full-block
    KV prefix of `tokens` as a migration wire record with `out=[]`, the
    `/v1/migrate/in` format. 404 when the prefix is not cached, 400 when
    the hash disagrees with the tokens."""
    app = request.app
    try:
        body: dict[str, Any] = await request.json()
    except Exception:  # noqa: BLE001 — any unparsable body is a 400
        return web.json_response({"error": "invalid JSON"}, status=400)
    name = body.get("model", "") if isinstance(body, dict) else ""
    if name not in app[ENGINES_KEY]:
        return web.json_response({"error": f"no model {name!r}"},
                                 status=404)
    batcher = app[BATCHERS_KEY].get(name)
    if not isinstance(batcher, ContinuousBatcher):
        return web.json_response(
            {"error": "block export requires continuous batching"},
            status=400)
    try:
        _, tokens, ns = migration.validate_fetch_request(
            body, block_size=batcher.cengine.block_size)
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=400)
    rid = request.headers.get("X-Request-Id") or secrets.token_hex(8)
    with app[OBS_KEY].tracer.span("blocks.export", model=name):
        record = await batcher.export_prefix(tokens, ns=ns, request_id=rid)
    if record is None:
        return web.json_response({"error": "prefix not cached"},
                                 status=404)
    blocks = int(record["kv"]["n_full"]) if record.get("kv") else 0
    if blocks:
        app[OBS_KEY].migration_blocks.inc(blocks, model=name,
                                          direction="out")
    return web.json_response({"record": record, "blocks": blocks})


async def _peer_fetch_blocks(app: web.Application, name: str,
                             batcher: ContinuousBatcher, tokens: list[int],
                             peer: str) -> None:
    """The requester side of the fleet cache tier's pull: `peer` (the
    `X-KV-Peer` hint) caches this prompt's first block, so its cached
    full blocks are fetched over `/v1/blocks/export` and imported
    before admission, which then hits them in the radix tree. Skipped
    for a prompt shorter than one block and a token (admission leaves a
    token to prefill) and for a prefix the local tree already holds.
    Only the shared namespace takes part: hints join on un-namespaced
    hashes, and an isolated tenant's tree never leaves its replica.
    Best-effort: every failure books its outcome and falls through to
    the plain prefill, which gives the same tokens."""
    sobs: ServingObs = app[OBS_KEY]
    bs = batcher.cengine.block_size
    if len(tokens) < bs + 1:
        return
    nodes, _, _ = batcher._radix.match(tokens)
    if nodes:
        return   # cached here already: the hint is stale
    try:
        req = migration.prefix_fetch_request(name, tokens, block_size=bs)
    except ValueError:
        return
    import aiohttp

    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(
                    f"{peer.rstrip('/')}/v1/blocks/export", json=req,
                    timeout=aiohttp.ClientTimeout(total=30)) as r:
                if r.status == 404:
                    sobs.peer_fetch.inc(model=name, outcome="miss")
                    return
                if r.status != 200:
                    sobs.peer_fetch.inc(model=name, outcome="failed")
                    return
                payload = await r.json()
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError, ValueError):
        sobs.peer_fetch.inc(model=name, outcome="failed")
        return
    record = payload.get("record") if isinstance(payload, dict) else None
    if record is None:
        sobs.peer_fetch.inc(model=name, outcome="miss")
        return
    try:
        with sobs.tracer.span("peer.fetch", model=name):
            blocks = await batcher.import_sequence(record)
    except Exception:  # noqa: BLE001 — the import rolled back
        sobs.peer_fetch.inc(model=name, outcome="failed")
        return
    sobs.peer_fetch.inc(model=name, outcome="ok")
    if blocks:
        # transfer traffic: admission books the same cells as reused
        sobs.prefill_tokens.observe(blocks * bs, model=name,
                                    source="peer_fetched")


# a version label: 1..64 characters of this set
_VERSION_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def _valid_version(v: Any) -> bool:
    return (isinstance(v, str) and 0 < len(v) <= 64
            and all(c in _VERSION_CHARS for c in v))


def param_leaves(params: Mapping) -> dict:
    """A param tree as a flat name -> tensor map; a QTensor leaf gives
    `name.q` and `name.scale` (an int8 model's reload must bring int8
    leaves: a plain tensor there differs in structure)."""
    out = {}
    for name, t in flatten(params).items():
        if isinstance(t, QTensor):
            out[f"{name}.q"], out[f"{name}.scale"] = t.q, t.scale
        else:
            out[name] = t
    return out


def _params_mismatch(old: dict, new: dict) -> str:
    """Compatibility of new weights with the live ones, over flat
    name -> tensor maps: the same names, and each tensor's shape and
    dtype (the captured graphs read the live storage at its shape and
    dtype). -> "" when compatible, else the reason."""
    if set(old) != set(new):
        return ("parameter tree structure differs from the live "
                "model's")
    for name, o in old.items():
        n = new[name]
        o_shape = tuple(o.shape)
        n_shape = getattr(n, "shape", None)
        n_shape = tuple(n_shape) if n_shape is not None else None
        o_dtype, n_dtype = o.dtype, getattr(n, "dtype", None)
        if o_shape != n_shape or o_dtype != n_dtype:
            return (f"leaf {name}: incoming {n_shape}/{n_dtype} vs live "
                    f"{o_shape}/{o_dtype}")
    return ""


def _default_reloader(name: str, engine: InferenceEngine, source: dict):
    """New weights from `source["checkpoint"]` (a train/checkpoint.py
    directory: `source["step"]`, else the newest committed step), params
    only, on the host: the path `--checkpoint` boots from."""
    ckpt_dir = source.get("checkpoint", "")
    if not ckpt_dir:
        raise ValueError(
            "reload source needs a 'checkpoint' directory (no custom "
            "reloader is installed on this replica)")
    step = source.get("step")
    try:
        return load_serving_params(
            ckpt_dir, engine.cfg, "cpu",
            step=step if isinstance(step, int) else None)
    except FileNotFoundError as e:
        raise ValueError(str(e)) from None


def copy_params(engine: InferenceEngine, params: Mapping) -> None:
    """Copy `params` into the engine's live tensors, leaf by leaf, in
    place. The engine keeps its tensors (and the per-layer views into
    them), so every captured CUDA graph reads the new weights on its
    next replay and none is recaptured; the copies queue on the stream
    the graphs replay on, behind any chunk still in flight, and the
    device is synchronized before this returns. No second full copy of
    the weights is held on the card: `params` may live on the host. An
    int8 leaf's `q` and `scale` are copied into the live QTensor's."""
    live, new = param_leaves(engine.params), param_leaves(params)
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(new[name])
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _resume_admission(app: web.Application, draining: bool) -> None:
    """Undo a reload's drain: every batcher open again, the door flag
    restored (a replica draining before the reload stays draining)."""
    for b in app[BATCHERS_KEY].values():
        b.end_drain()
    app[DRAIN_KEY]["draining"] = draining


async def reload_weights(request: web.Request):
    """`POST /v1/reload`: drain, then swap the weights live. Body:

        {"version": "step-12",            # [A-Za-z0-9._-]{1,64}
         "model": "llama3-1b",            # optional with one model
         "source": {"checkpoint": dir,    # the reloader's input
                    "step": 12},
         "defect": {"ttft_delay_s": 2}}   # optional, a planted stall

    Admission stops (the door and every batcher), in-flight work drains
    within the grace window (409 with the old weights live when it does
    not), the reloader materializes the new params in the executor under
    the gpu lock, a name, shape or dtype mismatch is refused (400), and
    `copy_params` writes them into the live tensors under the gpu lock.
    The batcher forgets every cached KV (`flush_cache`), admission opens,
    the version is adopted, the defect is planted or healed, and a fleet
    registration is forced so the router sees the new version at once.
    Every failure re-opens admission with the old weights. A tensor-
    parallel engine (one rank of a serving gang) is refused (400)."""
    app = request.app
    try:
        body: dict[str, Any] = await request.json()
    except Exception:  # noqa: BLE001 — any unparsable body is a 400
        return web.json_response({"error": "invalid JSON"}, status=400)
    if not isinstance(body, dict):
        return web.json_response({"error": "body must be an object"},
                                 status=400)
    version = body.get("version", "")
    if not _valid_version(version):
        return web.json_response(
            {"error": "version must be 1..64 chars of [A-Za-z0-9._-]"},
            status=400)
    engines = app[ENGINES_KEY]
    name = body.get("model", "")
    if not name and len(engines) == 1:
        name = next(iter(engines))
    if name not in engines:
        return web.json_response(
            {"error": f"no model {name!r} (serving {sorted(engines)})"},
            status=404)
    source = body.get("source")
    if source is not None and not isinstance(source, dict):
        return web.json_response({"error": "source must be an object"},
                                 status=400)
    defect = body.get("defect")
    if defect is not None:
        delay = (defect.get("ttft_delay_s", 0.0)
                 if isinstance(defect, dict) else None)
        if not isinstance(delay, (int, float)) \
                or isinstance(delay, bool) or not 0 <= delay <= 30:
            return web.json_response(
                {"error": "defect.ttft_delay_s must be a number in "
                          "[0, 30]"}, status=400)
    engine = engines[name]
    if getattr(engine, "group", None) is not None:
        return web.json_response(
            {"error": "a weight reload at tensor > 1 (into every rank of "
                      "the serving gang) is not ported yet (ROADMAP Queue "
                      "1 item 3i)"}, status=400)
    was_draining = app[DRAIN_KEY]["draining"]
    app[DRAIN_KEY]["draining"] = True
    batchers = app[BATCHERS_KEY]
    for b in batchers.values():
        b.begin_drain()
    for b in batchers.values():
        if not await b.drain(timeout=app[DRAIN_KEY]["grace_s"]):
            _resume_admission(app, was_draining)
            return web.json_response(
                {"error": f"drain timed out with {b.in_flight()} "
                          "request(s) in flight; weights unchanged"},
                status=409)
    reloader = app[RELOADER_KEY] or _default_reloader
    loop = asyncio.get_running_loop()
    t0 = time.monotonic()
    try:
        with app[OBS_KEY].tracer.span("weights.reload", model=name,
                                      version=version):
            async with app[GPU_LOCK_KEY]:
                params = await loop.run_in_executor(
                    None, reloader, name, engine, dict(source or {}))
            why = (_params_mismatch(param_leaves(engine.params),
                                    param_leaves(params))
                   if isinstance(params, Mapping)
                   else "parameter tree structure differs from the live "
                        "model's")
            if why:
                raise ValueError(f"incompatible weights: {why}")
            async with app[GPU_LOCK_KEY]:
                await loop.run_in_executor(None, copy_params, engine,
                                           params)
            b = batchers.get(name)
            if isinstance(b, ContinuousBatcher):
                # drained above: no request holds a block the flush frees
                b.flush_cache()
    except ValueError as e:
        _resume_admission(app, was_draining)
        return web.json_response({"error": str(e)}, status=400)
    except Exception as e:  # noqa: BLE001 — the old weights stay live
        _resume_admission(app, was_draining)
        return web.json_response({"error": f"{type(e).__name__}: {e}"},
                                 status=500)
    _resume_admission(app, False)
    app[MODEL_VERSION_KEY] = version
    app[DEFECT_KEY].clear()
    if isinstance(defect, dict):
        app[DEFECT_KEY].update(defect)
    register = (app.get(FLEET_REG_KEY) or {}).get("register_fn")
    if register is not None:
        try:
            await register()
        except Exception:  # noqa: BLE001 — the beat loop retries
            log.exception("fleet re-registration after a reload failed")
    return web.json_response({
        "reloaded": True, "model": name, "version": version,
        "reload_s": round(time.monotonic() - t0, 3)})


async def prefill_handoff(request: web.Request):
    """`POST /v1/models/{name}:prefill`: the prefill half of a
    disaggregated handoff. Body: the prompt (`tokens`, one row, or
    `text`) and an optional `"peer"` URL, the decode replica a
    pool-aware router picked. The prompt runs through normal admission
    with max_new 1 (its one token is thrown away: the decode replica
    owns the generation), which leaves its full blocks in the radix
    tree; the cached full-block prefix is exported as a migration record
    with `out=[]` and pushed to the peer's `/v1/migrate/in`, where the
    generation that follows hits it and prefills only the tail. A
    prompt shorter than one block exports nothing (`handoff` false,
    `blocks` 0). Best-effort: a failed handoff costs the decode replica
    one ordinary prefill."""
    app = request.app
    if app[DRAIN_KEY]["draining"]:
        return _draining()
    name = request.match_info["name"]
    engine = app[ENGINES_KEY].get(name)
    if engine is None:
        return web.json_response({"error": f"no model {name!r}"},
                                 status=404)
    batcher = app[BATCHERS_KEY].get(name)
    if not isinstance(batcher, ContinuousBatcher):
        return web.json_response(
            {"error": "prefill handoff requires continuous batching"},
            status=400)
    try:
        body: dict[str, Any] = await request.json()
    except Exception:  # noqa: BLE001 — any unparsable body is a 400
        return web.json_response({"error": "invalid JSON"}, status=400)
    if not isinstance(body, dict):
        return _bad("body must be a JSON object")
    parsed = _parse_token_lists(body, app[TOKENIZER_KEY], min_len=1)
    if isinstance(parsed, web.Response):
        return parsed
    token_lists, _ = parsed
    if len(token_lists) != 1:
        return _bad("prefill handoff is single-prompt")
    toks = [int(t) for t in token_lists[0]]
    vocab = engine.cfg.vocab_size
    if min(toks) < 0 or max(toks) >= vocab:
        return _bad(f"token ids must be in [0, {vocab})")
    if len(toks) + 1 > engine.ec.max_len:
        return _bad(f"prompt {len(toks)} + 1 exceeds model max_len "
                    f"{engine.ec.max_len}")
    peer = body.get("peer", "")
    if not isinstance(peer, str):
        return _bad("peer must be a URL string")
    rid = request.headers.get("X-Request-Id") or secrets.token_hex(8)
    sobs: ServingObs = app[OBS_KEY]
    t0 = time.monotonic()
    try:
        with sobs.tracer.span("prefill.handoff", model=name):
            await batcher.submit(toks, 1,
                                 {"request_id": rid, **_tenant(request)})
    except (Throttled, Overloaded) as e:
        return _shed(batcher, e)
    except MigratedAway as e:
        return web.json_response({"error": str(e), "migrated": True},
                                 status=503, headers={"Retry-After": "0"})
    record = await batcher.export_prefix(toks, request_id=rid)
    blocks = nbytes = 0
    if record is not None and record.get("kv"):
        blocks = int(record["kv"]["n_full"])
        nbytes = len(record["kv"]["k"]) + len(record["kv"]["v"])
    handoff = False
    if record is not None and peer:
        import aiohttp

        try:
            async with aiohttp.ClientSession() as session:
                async with session.post(
                        f"{peer.rstrip('/')}/v1/migrate/in",
                        json={"model": name, "record": record},
                        timeout=aiohttp.ClientTimeout(total=30)) as r:
                    handoff = r.status == 200
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            handoff = False
        if handoff:
            sobs.migration_out.inc(model=name)
            if blocks:
                sobs.migration_blocks.inc(blocks, model=name,
                                          direction="out")
        else:
            sobs.migration_failed.inc(model=name, direction="out")
    return web.json_response({
        "prefilled": True, "handoff": handoff, "blocks": blocks,
        "bytes": nbytes if handoff else 0,
        "handoff_s": round(time.monotonic() - t0, 6),
        "request_id": rid})


def fleet_stats(app: web.Application) -> dict:
    """Routing and autoscaling stats in the fleet heartbeat's vocabulary,
    summed over models: queue depth, active and max slots, free and
    total KV blocks, draining, the pool role, the version label, the
    step profiler's totals folded into prefill (prefill and
    prefill_chunk) and decode (decode, draft and verify) seconds, and
    the radix heat digest. The window batcher's max_slots is its
    max_batch. Every value is a plain int, float, str, bool, list or
    dict: the payload goes through `json.dumps`."""
    queue_depth = active = max_slots = 0
    kv_free = kv_total = 0
    phase_prefill = phase_decode = 0.0
    cache_digest: list = []
    for b in app[BATCHERS_KEY].values():
        if isinstance(b, ContinuousBatcher):
            queue_depth += len(b._pending)
            active += len(b._active)
            max_slots += len(b._free) + len(b._active)
            kv_free += int(b.cengine.pool.num_free)
            kv_total += int(b.cengine.num_blocks)
            cache_digest.extend(b._radix.heat_digest(16))
            totals = b.profiler.totals()
            phase_prefill += (totals.get("prefill", 0.0)
                              + totals.get("prefill_chunk", 0.0))
            phase_decode += (totals.get("decode", 0.0)
                             + totals.get("draft", 0.0)
                             + totals.get("verify", 0.0))
        else:
            queue_depth += b._queue.qsize()
            active += len(b._inflight)
            max_slots += b.max_batch
    return {
        "queue_depth": queue_depth, "active_slots": active,
        "max_slots": max_slots, "kv_blocks_free": kv_free,
        "kv_blocks_total": kv_total,
        "draining": bool(app[DRAIN_KEY]["draining"]),
        "pool": app[POOL_KEY],
        "version": app[MODEL_VERSION_KEY],
        "phase_seconds": {"prefill": round(float(phase_prefill), 6),
                          "decode": round(float(phase_decode), 6)},
        "cache_digest": cache_digest,
    }


def sequence_checkpoints(app: web.Application) -> list[dict]:
    """Resume records (tokens only, no KV) of every admitted request
    across models: the crash-failover feed of each heartbeat, which a
    router replays on a healthy peer when this replica dies."""
    out = []
    for name, b in app[BATCHERS_KEY].items():
        if isinstance(b, ContinuousBatcher):
            out.extend({"model": name, **ck} for ck in b.checkpoints())
    return out


def enable_fleet_registration(app: web.Application, router_url: str,
                              advertise_url: str, *,
                              replica_id: str | None = None,
                              period_s: float = 2.0) -> None:
    """Wire this replica into a fleet router: register at start-up,
    heartbeat `fleet_stats` and `sequence_checkpoints` every `period_s`
    (re-registering when the router answers 404: it restarted and lost
    its table), deregister at cleanup, before the drain-and-close hook,
    so the router stops routing here while the drain finishes. An
    unreachable router is never fatal: the replica serves alone and the
    beat keeps trying. `state["register_fn"]` forces a registration
    (`/v1/reload` calls it)."""
    import aiohttp

    router = router_url.rstrip("/")
    state: dict[str, Any] = {
        "router": router, "advertise": advertise_url,
        "id": replica_id or advertise_url, "period_s": period_s,
        "session": None, "task": None,
    }
    app[FLEET_REG_KEY] = state

    def payload(app_) -> dict:
        return {"id": state["id"], "url": state["advertise"],
                "models": sorted(app_[ENGINES_KEY]),
                "checkpoints": sequence_checkpoints(app_),
                **fleet_stats(app_)}

    async def register(app_) -> bool:
        try:
            async with state["session"].post(
                    f"{router}/fleet/register", json=payload(app_),
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                return r.status == 200
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            return False

    async def register_now() -> bool:
        if state["session"] is None:
            return False
        return await register(app)

    state["register_fn"] = register_now

    async def beat_loop(app_):
        while True:
            await asyncio.sleep(state["period_s"])
            try:
                async with state["session"].post(
                        f"{router}/fleet/heartbeat", json=payload(app_),
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
                    if r.status == 404:
                        await register(app_)
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                pass   # router down or restarting: keep beating

    async def start(app_):
        state["session"] = aiohttp.ClientSession()
        if not await register(app_):
            log.warning("fleet: could not register with router %s (the "
                        "heartbeat keeps trying)", router)
        state["task"] = asyncio.get_running_loop().create_task(
            beat_loop(app_))

    async def stop(app_):
        task = state["task"]
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        if state["session"] is not None:
            try:
                async with state["session"].post(
                        f"{router}/fleet/deregister",
                        json={"id": state["id"]},
                        timeout=aiohttp.ClientTimeout(total=5)):
                    pass
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                pass
            await state["session"].close()

    app.on_startup.append(start)
    app.on_cleanup.insert(0, stop)
