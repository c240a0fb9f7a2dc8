"""HTTP serving app (counterpart: kubeflow_tpu/serving/server.py).

Routes, each with the reference's request and response bodies:
- `POST /v1/models/{name}:generate` — body `{"tokens": [[ids...], ...],
  "max_new": 16, "temperature", "top_k", "top_p", "logprobs",
  "speculative", "gamma", "prefix"}`;
- `GET /healthz` (200 only while the server admits work), `GET /readyz`
  (liveness), `GET /v1/models`.

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
The reference's other routes (SSE streams, stop sequences, text mode,
scoring, drain, migration, reload, metrics, traces) are not ported yet.
"""

from __future__ import annotations

import asyncio
import logging
import math
from typing import Any

import numpy as np
from aiohttp import web

from kubeflow_tpu_torch.ops.cuda import launch_counts
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    Overloaded,
    bucket_pow2,
    pow2_ceil,
)
from kubeflow_tpu_torch.serving.engine import InferenceEngine
from kubeflow_tpu_torch.serving.speculative import SpeculativeEngine

ENGINES_KEY: web.AppKey = web.AppKey("engines", dict)
BATCHERS_KEY: web.AppKey = web.AppKey("batchers", dict)
SPEC_KEY: web.AppKey = web.AppKey("speculative", dict)
GPU_LOCK_KEY: web.AppKey = web.AppKey("gpu_lock", asyncio.Lock)

log = logging.getLogger(__name__)


class Batcher:
    """Window batching for one engine: concurrent single-prompt requests
    collected within `window_ms` run as ONE left-padded
    `engine.generate` call.

    Decode reads every weight once per step whatever the batch, so N
    coalesced requests cost about one request's weight traffic. Rows,
    prompt width and max_new are bucketed to powers of two; filler rows
    decode greedily; each caller gets its own row trimmed to its own
    max_new, with the logprobs of its tokens. `calls` counts engine
    calls and `requests` the requests they served (counted on success).
    """

    def __init__(self, engine: InferenceEngine, gpu_lock: asyncio.Lock, *,
                 window_ms: float = 5.0, max_batch: int = 8):
        self.engine = engine
        self.gpu_lock = gpu_lock
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.calls = 0
        self.requests = 0
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        self._inflight: list = []   # dequeued but unresolved (see close)
        self._closed = False

    def in_flight(self) -> int:
        return self._queue.qsize() + len(self._inflight)

    async def submit(self, tokens: list[int], max_new: int,
                     sampling: dict | None = None):
        """-> (tokens [max_new], logprobs [max_new]) for one prompt."""
        if self._closed:
            raise RuntimeError("batcher is shut down")
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
                       batch_window_ms: float = 0.0, max_batch: int = 8,
                       continuous: bool = False, warmup: bool = False,
                       prefill_chunk: int | None = None,
                       prefill_chunk_tokens: int | None = None,
                       pipeline_depth: int | None = None,
                       kv_block_size: int = 64,
                       kv_pool_blocks: int | None = None,
                       kv_spill_bytes: int | None = None,
                       prefixes: dict[str, list[int]] | None = None,
                       drafts: dict[str, InferenceEngine] | None = None,
                       seed: int | None = None) -> web.Application:
    """`continuous=False` (the default) serves through the one-shot
    engine: a window `Batcher` per model when `batch_window_ms > 0`,
    else every request calls `engine.generate` directly.
    `continuous=True` gives each model a continuous batcher of
    `max_batch` slots on the paged KV pool: monolithic admission unless
    `prefill_chunk_tokens` sets a chunked-prefill budget;
    `prefill_chunk` slices long monolithic prefills; `pipeline_depth`
    (None: 2 on CUDA, 1 on the CPU) is the decode dispatch-ahead depth;
    `kv_block_size` the pool's block, `kv_pool_blocks` its size (None:
    every slot at max_len), `kv_spill_bytes` the host spill tier's
    budget (None: off); `prefixes` maps names to registered prefix
    tokens; `seed` seeds the sampler.
    `warmup=True` runs every serving shape in an on_startup hook before
    the app takes traffic: the continuous batchers' `warmup`, or in the
    one-shot mode each engine's decode graphs for the window batcher's
    row counts (powers of two up to max_batch). `drafts` maps model
    names to draft engines; a request with "speculative": true then
    decodes through `SpeculativeEngine`."""
    if not continuous and (prefill_chunk is not None
                           or prefill_chunk_tokens is not None
                           or pipeline_depth is not None
                           or kv_block_size != 64
                           or kv_pool_blocks is not None
                           or kv_spill_bytes is not None or prefixes):
        # these knobs only exist on the continuous batcher; ignoring
        # them would ship a server without what the caller asked for
        raise ValueError("prefill_chunk/prefill_chunk_tokens/"
                         "pipeline_depth/kv_block_size/kv_pool_blocks/"
                         "kv_spill_bytes/prefixes require "
                         "continuous=True")
    unknown = set(drafts or {}) - set(engines)
    if unknown:
        raise ValueError(f"drafts registered for unknown models "
                         f"{sorted(unknown)}")
    app = web.Application()
    app[ENGINES_KEY] = dict(engines)
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
                prefixes=prefixes, pipeline_depth=pipeline_depth,
                kv_block_size=kv_block_size, kv_pool_blocks=kv_pool_blocks,
                kv_spill_bytes=kv_spill_bytes, seed=seed)
            for name, eng in engines.items()}
    else:
        app[BATCHERS_KEY] = (
            {name: Batcher(eng, gpu_lock, window_ms=batch_window_ms,
                           max_batch=max_batch)
             for name, eng in engines.items()}
            if batch_window_ms > 0 else {})
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
        for b in app_[BATCHERS_KEY].values():
            await b.close()

    app.on_cleanup.append(_close_batchers)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/readyz", _ok)
    app.router.add_get("/v1/models", list_models)
    app.router.add_post("/v1/models/{name}:generate", generate)
    return app


async def _ok(request: web.Request):
    return web.json_response({"status": "ok"})


async def healthz(request: web.Request):
    """200 only when every model admits work (a continuous batcher's
    queue below its shed depth); /readyz stays the bare liveness 200."""
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
                if b._prefixes:
                    entry["prefixes"] = {
                        n: len(t) for n, t in b._prefixes.items()}
            else:
                entry["batcher_mode"] = "window"
        out.append(entry)
    return web.json_response({"models": out,
                              "kernel_launches": launch_counts()})


def _bad(msg: str) -> web.Response:
    return web.json_response({"error": msg}, status=400)


async def _on_device(request: web.Request, fn):
    """Run one blocking engine call in the executor under the gpu lock."""
    loop = asyncio.get_running_loop()
    async with request.app[GPU_LOCK_KEY]:
        return await loop.run_in_executor(None, fn)


async def generate(request: web.Request):
    name = request.match_info["name"]
    engine = request.app[ENGINES_KEY].get(name)
    if engine is None:
        return web.json_response({"error": f"no model {name!r}"},
                                 status=404)
    try:
        body: dict[str, Any] = await request.json()
    except ValueError:
        return _bad("invalid JSON")
    if not isinstance(body, dict):
        return _bad("body must be a JSON object")
    token_lists = body.get("tokens")
    if (not isinstance(token_lists, list) or not token_lists
            or not all(isinstance(t, list) and len(t) >= 1
                       and all(isinstance(x, int)
                               and not isinstance(x, bool) for x in t)
                       for t in token_lists)):
        return _bad("tokens must be a non-empty list of integer token-id "
                    "lists with at least 1 token(s) each")
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
    prefix = body.get("prefix", "")
    if not isinstance(prefix, str):
        return _bad("prefix must be a string")
    logprobs = body.get("logprobs", False)
    if not isinstance(logprobs, bool):
        return _bad("logprobs must be a boolean")
    lens = {len(t) for t in token_lists}
    if len(lens) != 1:
        return _bad("all prompts in a batch must share a length "
                    "(static shapes); pad client-side")
    prompt_len = lens.pop()
    cap = engine.ec.max_len
    if prompt_len + max_new > cap:
        return _bad(f"prompt {prompt_len} + max_new {max_new} exceeds "
                    f"model max_len {cap}")
    vocab = engine.cfg.vocab_size
    if any(x < 0 or x >= vocab for t in token_lists for x in t):
        return _bad(f"token ids must be in [0, {vocab})")
    speculative = body.get("speculative", False)
    if not isinstance(speculative, bool):
        return _bad("speculative must be a boolean")
    batcher = request.app[BATCHERS_KEY].get(name)
    if prefix:
        if not isinstance(batcher, ContinuousBatcher):
            return _bad("prefix requires continuous batching")
        if prefix not in batcher._prefixes:
            return _bad(f"unknown prefix {prefix!r}; registered: "
                        f"{sorted(batcher._prefixes)}")
        if len(token_lists) != 1:
            return _bad("prefix requests are single-prompt")
        if speculative:
            return _bad("prefix does not compose with speculative")
        plen = len(batcher._prefixes[prefix])
        if plen + prompt_len + max_new > cap:
            return _bad(f"prefix {plen} + prompt {prompt_len} + max_new "
                        f"{max_new} exceeds model max_len {cap}")
        sampling["prefix"] = prefix
    gamma = body.get("gamma", 4)
    if not isinstance(gamma, int) or isinstance(gamma, bool) or gamma < 1:
        return _bad("gamma must be a positive integer")
    arr = np.asarray(token_lists, np.int64)
    # the one-shot paths generate to a power-of-two bucket of max_new
    # and trim the response back to the ask
    max_new_req = max_new
    max_new = max(bucket_pow2(max_new, cap - prompt_len), max_new_req)
    resp: dict[str, Any] = {}
    lp_rows = None
    if speculative:
        if logprobs:
            return _bad("logprobs does not compose with speculative")
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

        toks, stats = await _on_device(request, run_spec)
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
    elif isinstance(batcher, ContinuousBatcher):
        try:
            results = await asyncio.gather(*(
                batcher.submit(t, max_new_req, sampling, with_logprobs=True)
                for t in token_lists))
        except Overloaded as e:
            return web.json_response(
                {"error": f"server overloaded: {e}"}, status=429,
                headers={"Retry-After": "1"})
        rows = [list(toks) for toks, _ in results]
        lp_rows = [list(lps) for _, lps in results]
    elif batcher is not None and arr.shape[0] == 1:
        # single prompts ride the window batcher; explicit client-side
        # batches keep their one-shot call
        toks, lps = await batcher.submit(token_lists[0], max_new_req,
                                         sampling)
        rows, lp_rows = [toks], [lps]
    else:
        def run_direct():
            toks_, lps_ = engine.generate(arr, max_new=max_new,
                                          return_logprobs=True, **sampling)
            return toks_.cpu().numpy(), lps_.cpu().numpy()

        toks, lps = await _on_device(request, run_direct)
        rows = toks[:, :max_new_req].tolist()
        lp_rows = lps[:, :max_new_req].tolist()
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
    return web.json_response(resp)
