"""HTTP serving app (counterpart: kubeflow_tpu/serving/server.py).

Routes, each with the reference's request and response bodies:
- `POST /v1/models/{name}:generate` — body `{"tokens": [[ids...], ...],
  "max_new": 16, "temperature", "top_k", "top_p", "logprobs"}`; every
  prompt rides the model's continuous batcher;
- `GET /healthz` (200 only while the server admits work), `GET /readyz`
  (liveness), `GET /v1/models`.
The reference's other routes (SSE streams, stop sequences, text mode,
scoring, drain, migration, reload, metrics, traces) are not ported yet.
"""

from __future__ import annotations

import asyncio
import math
from typing import Any

from aiohttp import web

from kubeflow_tpu_torch.ops.cuda import launch_counts
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    Overloaded,
)
from kubeflow_tpu_torch.serving.engine import InferenceEngine

ENGINES_KEY: web.AppKey = web.AppKey("engines", dict)
BATCHERS_KEY: web.AppKey = web.AppKey("batchers", dict)


def create_serving_app(engines: dict[str, InferenceEngine], *,
                       max_batch: int = 8, prefill_chunk_tokens: int = 64,
                       kv_block_size: int = 64,
                       seed: int | None = None) -> web.Application:
    """One continuous batcher (max_batch slots) per served model."""
    app = web.Application()
    app[ENGINES_KEY] = dict(engines)
    gpu_lock = asyncio.Lock()
    app[BATCHERS_KEY] = {
        name: ContinuousBatcher(
            eng, gpu_lock, max_slots=max_batch,
            prefill_chunk_tokens=prefill_chunk_tokens,
            kv_block_size=kv_block_size, seed=seed)
        for name, eng in engines.items()}

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
    """200 only when every model admits work (queue below its shed
    depth); /readyz stays the bare liveness 200."""
    models = {}
    overloaded = False
    for name, b in request.app[BATCHERS_KEY].items():
        models[name] = {
            "pending": len(b._pending),
            "active_slots": len(b._active),
            "kv_blocks_free": b.cengine.pool.num_free,
            "kv_blocks_total": b.cengine.num_blocks,
        }
        overloaded = overloaded or len(b._pending) >= b.max_pending
    if overloaded:
        return web.json_response(
            {"status": "overloaded", "models": models}, status=503)
    return web.json_response({"status": "ok", "models": models})


async def list_models(request: web.Request):
    out = []
    for name, eng in request.app[ENGINES_KEY].items():
        b = request.app[BATCHERS_KEY][name]
        out.append({
            "name": name,
            "family": eng.family.name,
            "max_len": eng.ec.max_len,
            "vocab_size": eng.cfg.vocab_size,
            "hidden_size": eng.cfg.hidden_size,
            "num_layers": eng.cfg.num_layers,
            "device": str(eng.device),
            "batcher_mode": "continuous",
            "batcher_calls": b.calls,
            "batched_requests": b.requests,
            "occupancy": round(b.occupancy(), 3),
            "pending": len(b._pending),
            "active_slots": len(b._active),
            "kv_block_size": b.cengine.block_size,
            "kv_pool_blocks": b.cengine.num_blocks,
        })
    return web.json_response({"models": out,
                              "kernel_launches": launch_counts()})


def _bad(msg: str) -> web.Response:
    return web.json_response({"error": msg}, status=400)


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
    logprobs = body.get("logprobs", False)
    if not isinstance(logprobs, bool):
        return _bad("logprobs must be a boolean")
    lens = {len(t) for t in token_lists}
    if len(lens) != 1:
        return _bad("all prompts in a batch must share a length "
                    "(static shapes); pad client-side")
    prompt_len = lens.pop()
    if prompt_len + max_new > engine.ec.max_len:
        return _bad(f"prompt {prompt_len} + max_new {max_new} exceeds "
                    f"model max_len {engine.ec.max_len}")
    vocab = engine.cfg.vocab_size
    if any(x < 0 or x >= vocab for t in token_lists for x in t):
        return _bad(f"token ids must be in [0, {vocab})")
    batcher = request.app[BATCHERS_KEY][name]
    try:
        results = await asyncio.gather(*(
            batcher.submit(t, max_new, sampling, with_logprobs=True)
            for t in token_lists))
    except Overloaded as e:
        return web.json_response(
            {"error": f"server overloaded: {e}"}, status=429,
            headers={"Retry-After": "1"})
    rows = [list(toks) for toks, _ in results]
    resp: dict[str, Any] = {"tokens": rows}
    if logprobs:
        # entries cover tokens up to AND INCLUDING the row's first EOS
        eos = engine.ec.eos_token
        out_lps = []
        for (toks, lps) in results:
            n = len(toks)
            if eos is not None and eos in toks:
                n = toks.index(eos) + 1
            out_lps.append([round(float(x), 6) for x in lps[:n]])
        resp["logprobs"] = out_lps
    return web.json_response(resp)
