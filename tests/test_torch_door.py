"""The port's HTTP door against the JAX reference app, on the CPU.

The same LLAMA_TINY weights (the reference's init, lm_head x50 so that
greedy argmax cannot flip on fp32 rounding) serve through both
frameworks' `create_serving_app`. One scripted session of requests runs
against each app — `stop`, `stream` (SSE), `text` (a BPE tokenizer in
continuous mode, the byte-level fallback one-shot), `:score`, the
request timelines, the refusals and `/metrics` — and the tests compare
what the two apps answered: statuses and error texts exactly, greedy
tokens and SSE events exactly, logprobs within 1e-4 (fp32, different
sum orders, as tests/test_torch_serving.py holds them), and the metric
families' names, labels and counts. Port-only cases drive every serving
path (continuous chunked and monolithic at dispatch-ahead depths 1 and
2, the window batcher, the direct path) against the reference engine's
greedy tokens and the reference's own `_apply_stop`.
"""

import asyncio
import gc
import json
import re
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.data import bpe as jbpe
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.data import bpe
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

ROOT = Path(__file__).resolve().parents[1]
BS = 8
MAX_NEW = 8
MODEL = "tiny"
GEN = f"/v1/models/{MODEL}:generate"
SCORE = f"/v1/models/{MODEL}:score"
LP_TOL = 1e-4

# bodies both apps must refuse with the same status and error text
REFUSALS = [
    (GEN, {"tokens": [[1, 2]], "adapter": "fr"}),
    (GEN, {"tokens": [[1, 2]], "adapter": 3}),
    (GEN, {"tokens": [[1, 2]], "stop": "x"}),
    (GEN, {"tokens": [[1, 2]], "stop": [[]]}),
    (GEN, {"tokens": [[1, 2]], "stop": [[1]] * 5}),
    (GEN, {"tokens": [[1, 2]], "stop": [[True]]}),
    (GEN, {"tokens": [[1, 2]], "stream": "yes"}),
    (GEN, {"tokens": [[1, 2]], "stream": True, "stop": [[1]]}),
    (GEN, {"tokens": [[1, 2]], "stream": True, "logprobs": True}),
    (GEN, {"tokens": [[1, 2]], "stream": True, "speculative": True}),
    (GEN, {"text": 5}),
    (GEN, {"max_new": 3}),
    (GEN, {"tokens": [[1, 2]], "max_new": 0}),
    (GEN, {"tokens": [[1, 2], [3]]}),
    (GEN, {"tokens": [[1, 10**6]]}),
    (GEN, {"tokens": [[1, 2]], "prefix": "sys"}),
    (SCORE, {"tokens": [[1]]}),
    (SCORE, {"tokens": [[1, 2], [1, 2, 3]]}),
    (SCORE, {"tokens": [[1, 2**40]]}),
    (SCORE, {"text": 7}),
    (SCORE, {"tokens": [list(range(97))]}),
    ("/v1/models/nope:generate", {"tokens": [[1]]}),
]


@pytest.fixture(scope="module")
def engines():
    cfg = jllama.LLAMA_TINY
    params = dict(jllama.init(jax.random.key(0), cfg))
    params["lm_head"] = params["lm_head"] * 50.0  # argmax can't flip
    jeng = JEngine(params, cfg, J_LLAMA, JEngineConfig(max_len=96))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=96),
        device="cpu")
    rng = np.random.default_rng(11)
    prompts = {"long": rng.integers(0, cfg.vocab_size, 20).tolist(),
               "a": rng.integers(0, cfg.vocab_size, 12).tolist(),
               "b": rng.integers(0, cfg.vocab_size, 12).tolist()}
    want = {k: np.asarray(jeng.generate(jnp.asarray([p], jnp.int32),
                                        max_new=MAX_NEW))[0].tolist()
            for k, p in prompts.items()}
    return jeng, teng, prompts, want


@pytest.fixture(scope="module")
def tokenizers():
    """A BPE fitted on the repo's README at the tiny model's vocab, and
    the reference's Tokenizer loaded from its JSON."""
    tok = bpe.train([(ROOT / "README.md").read_text()], vocab_size=512)
    return tok, jbpe.Tokenizer.loads(tok.dumps())


def _stop_of(want: list[int]) -> list[int]:
    return want[3:5]


async def _events(resp) -> list[dict]:
    out = []
    async for line in resp.content:
        line = line.strip()
        if line.startswith(b"data: "):
            out.append(json.loads(line[len(b"data: "):]))
    return out


async def _post(client, path, body, rid=None) -> dict:
    headers = {"X-Request-Id": rid} if rid else None
    async with client.post(path, json=body, headers=headers) as r:
        rec = {"status": r.status, "request_id": r.headers.get("X-Request-Id"),
               "retry_after": r.headers.get("Retry-After"),
               "content_type": r.content_type}
        if r.content_type == "text/event-stream":
            rec["events"] = await _events(r)
        else:
            rec["body"] = await r.json()
        return rec


async def _get(client, path) -> dict:
    async with client.get(path) as r:
        if r.content_type == "application/json":
            return {"status": r.status, "body": await r.json()}
        return {"status": r.status, "text": await r.text()}


def _run(app, script):
    async def go():
        async with TestClient(TestServer(app)) as client:
            return await script(client)

    return asyncio.run(go())


def continuous_script(prompts, want):
    """One session on a continuous app: plain, stop, stream, text, the
    plain prompt again (a radix hit), score, timelines, refusals,
    metrics."""
    stop = _stop_of(want["a"])

    async def script(client):
        out = {}
        out["plain"] = await _post(client, GEN, {
            "tokens": [prompts["long"]], "max_new": MAX_NEW,
            "logprobs": True}, rid="r-plain")
        out["stop"] = await _post(client, GEN, {
            "tokens": [prompts["a"]], "max_new": MAX_NEW, "stop": [stop],
            "logprobs": True}, rid="r-stop")
        out["stream"] = await _post(client, GEN, {
            "tokens": [prompts["b"]], "max_new": MAX_NEW, "stream": True},
            rid="r-stream")
        out["text"] = await _post(client, GEN, {
            "text": "the port serves text", "max_new": MAX_NEW})
        out["repeat"] = await _post(client, GEN, {
            "tokens": [prompts["long"]], "max_new": MAX_NEW})
        out["score"] = await _post(client, SCORE, {
            "tokens": [prompts["long"] + out["plain"]["body"]["tokens"][0]]})
        out["score_text"] = await _post(client, SCORE, {
            "text": "the port scores text"})
        out["timelines"] = {rid: await _get(
            client, f"/v1/requests/{rid}/timeline")
            for rid in ("r-plain", "r-stop", "r-stream", "r-none")}
        out["index"] = await _get(client, "/v1/requests/timelines")
        out["refusals"] = [await _post(client, path, body)
                           for path, body in REFUSALS]
        out["metrics"] = (await _get(client, "/metrics"))["text"]
        return out

    return script


def oneshot_script(prompts, want):
    """One session on a one-shot app (direct path): byte-level text,
    a text stream, a token stream, stop, a 2-row batch, metrics."""
    stop = _stop_of(want["a"])

    async def script(client):
        out = {}
        out["text"] = await _post(client, GEN, {
            "text": "hi there", "max_new": MAX_NEW})
        out["text_stream"] = await _post(client, GEN, {
            "text": "hi there", "max_new": MAX_NEW, "stream": True})
        out["stream"] = await _post(client, GEN, {
            "tokens": [prompts["b"]], "max_new": MAX_NEW, "stream": True})
        out["stop"] = await _post(client, GEN, {
            "tokens": [prompts["a"]], "max_new": MAX_NEW, "stop": [stop]})
        out["pair"] = await _post(client, GEN, {
            "tokens": [prompts["a"], prompts["b"]], "max_new": MAX_NEW})
        out["metrics"] = (await _get(client, "/metrics"))["text"]
        return out

    return script


@pytest.fixture(scope="module")
def sessions(engines, tokenizers):
    """The continuous (BPE text) and one-shot (byte text) sessions on
    the reference's apps and the port's."""
    jeng, teng, prompts, want = engines
    tok, jtok = tokenizers
    kw = dict(continuous=True, max_batch=2, kv_block_size=BS,
              prefill_chunk_tokens=3)
    cont = continuous_script(prompts, want)
    one = oneshot_script(prompts, want)
    return {
        "ref": _run(jserver.create_serving_app(
            {MODEL: jeng}, tokenizer=jtok, paged_attention_impl="xla",
            **kw), cont),
        "port": _run(server.create_serving_app(
            {MODEL: teng}, tokenizer=tok, **kw), cont),
        "ref_oneshot": _run(jserver.create_serving_app({MODEL: jeng}), one),
        "port_oneshot": _run(server.create_serving_app({MODEL: teng}), one),
    }


def _same_answer(got: dict, want: dict) -> None:
    assert got["status"] == want["status"]
    assert got["content_type"] == want["content_type"]
    if "events" in want:
        assert got["events"] == want["events"]
        return
    g, w = got["body"], want["body"]
    assert set(g) == set(w)
    for key in w:
        if key in ("logprobs", "total") and w[key] and isinstance(
                w[key][0], (list, float)):
            np.testing.assert_allclose(np.asarray(g[key], float),
                                       np.asarray(w[key], float),
                                       atol=LP_TOL, rtol=LP_TOL)
        else:
            assert g[key] == w[key], key


@pytest.mark.parametrize("name", ["plain", "stop", "stream", "text",
                                  "repeat", "score", "score_text"])
def test_torch_continuous_answers_match_reference(sessions, name):
    _same_answer(sessions["port"][name], sessions["ref"][name])


@pytest.mark.parametrize("name", ["text", "text_stream", "stream", "stop",
                                  "pair"])
def test_torch_oneshot_answers_match_reference(sessions, name):
    _same_answer(sessions["port_oneshot"][name],
                 sessions["ref_oneshot"][name])


def test_torch_answers_carry_what_the_session_asked(sessions, engines,
                                                    tokenizers):
    """The reference's own contract, spelled out: stop trimmed with its
    `_apply_stop`, streams ending in the terminal record, text decoded
    by the app's tokenizer, X-Request-Id echoed on continuous paths."""
    _, _, prompts, want = engines
    tok, _ = tokenizers
    s, one = sessions["port"], sessions["port_oneshot"]
    stop = _stop_of(want["a"])
    assert s["plain"]["body"]["tokens"] == [want["long"]]
    assert s["stop"]["body"]["tokens"] == [jserver._apply_stop(want["a"],
                                                               [stop])]
    assert len(s["stop"]["body"]["logprobs"][0]) == len(
        s["stop"]["body"]["tokens"][0])
    assert s["plain"]["request_id"] == "r-plain"
    assert s["stream"]["request_id"] == "r-stream"
    assert len(s["text"]["request_id"]) == 16   # minted: 8 random bytes
    assert s["stream"]["content_type"] == "text/event-stream"
    events = s["stream"]["events"]
    assert [e["tokens"] for e in events[:-1]] == [[[t]] for t in want["b"]]
    assert events[-1] == {"done": True, "total": MAX_NEW}
    text = s["text"]["body"]
    assert text["text"] == tok.decode(text["tokens"][0])
    # one-shot: chunk events (1 token, then STREAM_CHUNK), byte text
    events = one["stream"]["events"]
    assert [len(e["tokens"][0]) for e in events[:-1]] == [1, MAX_NEW - 1]
    assert sum((e["tokens"][0] for e in events[:-1]), []) == want["b"]
    body = one["text"]["body"]
    assert body["text"] == jserver.byte_decode(body["tokens"][0])
    assert one["text_stream"]["events"][-1]["text"] == body["text"]
    assert one["stop"]["body"]["tokens"] == [jserver._apply_stop(
        want["a"], [stop])]
    assert one["stop"]["request_id"] is None


@pytest.mark.parametrize("i", range(len(REFUSALS)),
                         ids=[f"{p.rsplit('/', 1)[-1]}-{i}"
                              for i, (p, _) in enumerate(REFUSALS)])
def test_torch_refusals_match_reference(sessions, i):
    got, want = sessions["port"]["refusals"][i], \
        sessions["ref"]["refusals"][i]
    assert want["status"] in (400, 404)
    assert got["status"] == want["status"]
    assert got["body"] == want["body"]


@pytest.mark.parametrize("rid", ["r-plain", "r-stop", "r-stream"])
def test_torch_timelines_match_reference(sessions, rid):
    got = sessions["port"]["timelines"][rid]
    want = sessions["ref"]["timelines"][rid]
    assert got["status"] == want["status"] == 200
    g, w = got["body"], want["body"]
    for key in ("request_id", "model", "tenant", "prompt_tokens", "max_new",
                "output_tokens", "tokens", "done"):
        assert g[key] == w[key], key
    assert [e["kind"] for e in g["events"]] == \
        [e["kind"] for e in w["events"]]
    for ge, we in zip(g["events"], w["events"]):
        assert set(ge) == set(we)
        for key in ("tokens", "max_new", "priority", "slot",
                    "prefill_computed", "prefill_reused"):
            assert ge.get(key) == we.get(key), (ge["kind"], key)
    assert g["itl"]["count"] == w["itl"]["count"]
    assert g["ttft_s"] <= g["token_times"][-1]


def test_torch_timeline_index_and_unknown_id_match_reference(sessions):
    got, want = sessions["port"], sessions["ref"]
    assert got["timelines"]["r-none"] == want["timelines"]["r-none"]
    assert want["timelines"]["r-none"]["status"] == 404
    ids = got["index"]["body"]["requests"]
    assert len(ids) == len(want["index"]["body"]["requests"])
    assert {"r-plain", "r-stop", "r-stream"} <= set(ids)


_SAMPLE = re.compile(r"^(\w+)(?:\{(.*)\})? (\S+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _parse(text: str) -> dict:
    """exposition -> {(sample name, sorted label items): value}"""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, line
        labels = tuple(sorted(_LABEL.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


# the families the port ports, by how their samples compare: counts and
# counter values exactly; histogram sums are timings or token totals
COUNTED = ("serving_request_duration_seconds_count",
           "serving_time_to_first_token_seconds_count",
           "serving_itl_seconds_count", "serving_queue_wait_seconds_count",
           "serving_batch_size_count", "serving_batch_size_sum",
           "serving_prefill_tokens_count", "serving_prefill_tokens_sum",
           "serving_prefix_cache_hits_total",
           "serving_prefix_cache_misses_total",
           "serving_kv_blocks_in_use",
           "serving_tokenizer_dropped_tokens_total")


def _counted(parsed: dict) -> dict:
    return {k: v for k, v in parsed.items() if k[0] in COUNTED
            # the reference's fourth prefill source needs its peer
            # block fetch, not ported (ROADMAP)
            and ("source", "peer_fetched") not in k[1]}


@pytest.mark.parametrize("session", ["continuous", "oneshot"])
def test_torch_metrics_match_reference(sessions, session):
    suffix = "" if session == "continuous" else "_oneshot"
    got = _parse(sessions["port" + suffix]["metrics"])
    want = _parse(sessions["ref" + suffix]["metrics"])
    assert _counted(got) == _counted(want)
    model = (("model", MODEL),)
    generated = [k for k, r in sessions["port" + suffix].items()
                 if isinstance(r, dict) and r.get("status") == 200
                 and "content_type" in r and "score" not in k]
    assert got[("serving_time_to_first_token_seconds_count", model)] == \
        len(generated)
    if session == "continuous":
        # the repeated prompt reused the first one's blocks
        assert got[("serving_prefix_cache_hits_total", model)] == 1
        assert got[("serving_itl_seconds_count", model)] > 0
        impl = [k for k in got if k[0] == "serving_attention_impl"]
        assert impl == [("serving_attention_impl",
                         (("impl", "torch"), ("model", MODEL)))]
        assert got[impl[0]] == 1
        assert [k[1][0] for k in want if k[0] == "serving_attention_impl"] \
            == [("impl", "xla")]
    else:
        # byte-level text: the vocab tail the decoder dropped
        dropped = ("serving_tokenizer_dropped_tokens_total",
                   (("model", MODEL),))
        assert got[dropped] == sum(
            t >= server.BYTE_OFFSET + 256 for t in
            sessions["port_oneshot"]["text"]["body"]["tokens"][0]) + sum(
            t >= server.BYTE_OFFSET + 256 for e in
            sessions["port_oneshot"]["text_stream"]["events"][:-1]
            for t in e["tokens"][0])


def test_torch_byte_codec_matches_reference():
    for text in ("", "hi there", "naïve — ünïcode ✓"):
        assert server.byte_encode(text) == jserver.byte_encode(text)
    ids = [0, 1, 2, 3, 104, 105, 258, 259, 300, 511]
    got, want = [], []
    assert server.byte_decode(ids, got.append) == \
        jserver.byte_decode(ids, want.append)
    assert got == want == [3]


def test_torch_tokenizer_wider_than_model_refused(engines):
    _, teng, _, _ = engines
    tok = bpe.Tokenizer(merges=tuple((0, 1) for _ in range(600)))
    with pytest.raises(ValueError, match="exceeds model"):
        server.create_serving_app({MODEL: teng}, tokenizer=tok)


def test_torch_native_encoder_built_before_traffic(engines):
    """The app builds a BPE tokenizer's native encoder when it is
    created, so no text request waits on the compiler."""
    _, teng, _, _ = engines
    tok = bpe.Tokenizer(merges=((104, 105), (256, 32)))
    handle = tok._ranks_id
    assert handle._native is bpe._RanksHandle._NATIVE_UNSET
    server.create_serving_app({MODEL: teng}, tokenizer=tok)
    assert handle._native is not bpe._RanksHandle._NATIVE_UNSET
    assert (handle._native is not None) == (bpe._load_bpe_lib() is not None)


@pytest.mark.parametrize("stream", [False, True])
def test_torch_retry_after_matches_reference(engines, stream):
    """An Overloaded 429's Retry-After from queue depth and the service
    time EWMA (7.5 s over 2 slots: ceil(3.75) = 4), on the reference's
    app and the port's, streamed or not. The batchers' queues take no
    request (max_pending 0), so every request is shed."""
    jeng, teng, prompts, _ = engines
    body = {"tokens": [prompts["a"]], "max_new": 2, "stream": stream}

    def run(create, eng, **kw):
        app = create({MODEL: eng}, continuous=True, max_batch=2,
                     kv_block_size=BS, **kw)
        for b in app[jserver.BATCHERS_KEY if create is
                     jserver.create_serving_app else
                     server.BATCHERS_KEY].values():
            b.max_pending = 0
            b.service_ewma = 7.5

        async def script(client):
            return await _post(client, GEN, body)

        return _run(app, script)

    want = run(jserver.create_serving_app, jeng,
               paged_attention_impl="xla")
    got = run(server.create_serving_app, teng)
    assert want["status"] == got["status"] == 429
    assert got["retry_after"] == want["retry_after"] == "4"
    assert got["body"] == want["body"]


# -- port-only: every serving path against the reference engine ----------

PATHS = {
    "chunked-depth1": dict(continuous=True, prefill_chunk_tokens=3,
                           pipeline_depth=1),
    "chunked-depth2": dict(continuous=True, prefill_chunk_tokens=3,
                           pipeline_depth=2),
    "monolithic-depth1": dict(continuous=True, pipeline_depth=1),
    "monolithic-depth2": dict(continuous=True, pipeline_depth=2),
    "window": dict(batch_window_ms=5.0),
    "direct": dict(),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_torch_stop_and_stream_on_every_path(engines, path):
    """Stop trims as the reference's `_apply_stop` on every path, and a
    continuous slot retires where the stop completes: the request's
    timeline holds exactly the tokens up to the stop's end, and at most
    `pipeline_depth` chunks of the batcher are decoded past it and
    dropped. Streams concatenate to the reference engine's greedy
    tokens."""
    _, teng, prompts, want = engines
    kw = dict(PATHS[path])
    if kw.get("continuous"):
        kw["kv_block_size"] = BS
    app = server.create_serving_app({MODEL: teng}, max_batch=2, **kw)
    stop = _stop_of(want["a"])
    cut = jserver._apply_stop(want["a"], [stop])

    async def script(client):
        return (await _post(client, GEN, {
                    "tokens": [prompts["a"]], "max_new": MAX_NEW,
                    "stop": [stop], "logprobs": True}, rid="s"),
                await _post(client, GEN, {
                    "tokens": [prompts["b"]], "max_new": MAX_NEW,
                    "stream": True}))

    stopped, streamed = _run(app, script)
    assert stopped["status"] == 200
    assert stopped["body"]["tokens"] == [cut]
    assert len(stopped["body"]["logprobs"][0]) == len(cut)
    assert sum((e["tokens"][0] for e in streamed["events"][:-1]),
               []) == want["b"]
    assert streamed["events"][-1] == {"done": True, "total": MAX_NEW}
    b = app[server.BATCHERS_KEY].get(MODEL)
    if kw.get("continuous"):
        assert stopped["request_id"] == "s"
        tl = b.timelines.get("s")
        assert len(tl.tokens) == len(cut) + len(stop)
        assert tl.done
        assert b.tokens_dropped <= b.pipeline_depth * b.chunk
        assert not b._active
    else:
        assert stopped["request_id"] is None


def test_torch_served_app_is_freed_after_cleanup(engines):
    """Once an app is cleaned up, nothing process-wide holds it: its
    batchers (and on the card their KV pools and graphs) go with it.
    aiohttp's middleware cache would keep every app with a middleware
    alive, so the latency histogram wraps each route instead."""
    _, teng, prompts, _ = engines
    app = server.create_serving_app({MODEL: teng}, continuous=True,
                                    max_batch=2, kv_block_size=BS)
    batcher = weakref.ref(app[server.BATCHERS_KEY][MODEL])

    async def script(client):
        await _post(client, GEN, {"tokens": [prompts["a"]], "max_new": 2})
        return (await _get(client, "/metrics"))["status"]

    assert _run(app, script) == 200
    del app
    gc.collect()
    assert batcher() is None
