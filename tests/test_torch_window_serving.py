"""The port's default serving mode (one-shot engine on a dense cache:
window batcher, direct path, speculative route) over HTTP, on the CPU.

The model is LLAMA_TINY with the reference's init and lm_head x50 (the
reference's test idiom: padded and batched shapes must not flip
near-tied argmaxes). Responses are held against `engine.generate` alone
and against the JAX reference engine; logprobs within 1e-3 absolute
(fp32, other batch shapes and sum orders, x50 head).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.server import (
    BATCHERS_KEY,
    Batcher,
    create_serving_app,
)

pytest_plugins = ("aiohttp.pytest_plugin",)

URL = "/v1/models/m:generate"
LP_ATOL = 1e-3


@pytest.fixture(scope="module")
def engines():
    params = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    params["lm_head"] = params["lm_head"] * 50.0
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=64))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=64),
        device="cpu")
    return jeng, teng


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).tolist() for n in lens]


async def _post(client, body, status=200):
    r = await client.post(URL, json=body)
    assert r.status == status, await r.text()
    return await r.json()


async def test_window_batcher_coalesces_concurrent_prompts(engines,
                                                           aiohttp_client):
    """Concurrent single prompts of different lengths run as one padded
    engine call (calls < requests); each response equals what the
    prompt generates alone, and the reference's tokens."""
    jeng, teng = engines
    app = create_serving_app({"m": teng}, batch_window_ms=80.0)
    client = await aiohttp_client(app)
    prompts = _prompts(2, (4, 7, 7, 10))
    alone = [teng.generate([p], max_new=5, return_logprobs=True)
             for p in prompts]
    bodies = await asyncio.gather(*(
        _post(client, {"tokens": [p], "max_new": 5, "logprobs": True})
        for p in prompts))
    batcher = app[BATCHERS_KEY]["m"]
    assert isinstance(batcher, Batcher)
    assert batcher.calls < batcher.requests == len(prompts)
    for p, body, (toks, lps) in zip(prompts, bodies, alone):
        assert body["tokens"] == [toks.numpy()[0].tolist()]
        want = np.asarray(jeng.generate(jnp.asarray([p], jnp.int32),
                                        max_new=5))
        assert body["tokens"] == want.tolist()
        np.testing.assert_allclose(body["logprobs"][0], lps.numpy()[0],
                                   atol=LP_ATOL)
    models = await (await client.get("/v1/models")).json()
    entry = models["models"][0]
    assert entry["batcher_mode"] == "window"
    assert entry["batched_requests"] == 4
    assert (await client.get("/healthz")).status == 200


async def test_window_batcher_mixes_sampling_knobs(engines, aiohttp_client):
    """Greedy, sampled and top_k=1 requests share one call; the
    deterministic rows keep their solo outputs."""
    _, teng = engines
    app = create_serving_app({"m": teng}, batch_window_ms=80.0)
    client = await aiohttp_client(app)
    prompts = _prompts(4, (4, 6, 8))
    greedy = [teng.generate([p], max_new=5).numpy()[0].tolist()
              for p in prompts]
    got = await asyncio.gather(
        _post(client, {"tokens": [prompts[0]], "max_new": 5}),
        _post(client, {"tokens": [prompts[1]], "max_new": 5,
                       "temperature": 0.9, "top_p": 0.8}),
        _post(client, {"tokens": [prompts[2]], "max_new": 5,
                       "temperature": 1.0, "top_k": 1}))
    assert app[BATCHERS_KEY]["m"].calls == 1
    assert got[0]["tokens"][0] == greedy[0]
    assert got[2]["tokens"][0] == greedy[2]
    assert all(0 <= t < 512 for t in got[1]["tokens"][0])


@pytest.mark.parametrize("window_ms", [0.0, 80.0])
async def test_direct_path_serves_multi_row_batches(engines, aiohttp_client,
                                                    window_ms):
    """An explicit batch calls engine.generate directly (also beside a
    window batcher, which it bypasses); max_new is bucketed for the call
    and the response trimmed back to the ask."""
    jeng, teng = engines
    app = create_serving_app({"m": teng}, batch_window_ms=window_ms)
    client = await aiohttp_client(app)
    rows = _prompts(5, (6, 6))
    want = np.asarray(jeng.generate(jnp.asarray(rows, jnp.int32),
                                    max_new=16, return_logprobs=True)[0])
    for ask in (3, 7):
        body = await _post(client, {"tokens": rows, "max_new": ask,
                                    "logprobs": True})
        assert body["tokens"] == want[:, :ask].tolist()
        assert [len(lp) for lp in body["logprobs"]] == [ask, ask]
    if window_ms:
        assert app[BATCHERS_KEY]["m"].calls == 0
    else:
        assert app[BATCHERS_KEY] == {}
        single = await _post(client, {"tokens": [rows[0]], "max_new": 4})
        assert single["tokens"] == [want[0, :4].tolist()]
    models = await (await client.get("/v1/models")).json()
    assert ("batcher_mode" in models["models"][0]) == bool(window_ms)


async def test_speculative_field_over_http(engines, aiohttp_client):
    """A model registered with a draft serves "speculative": true: greedy
    output identical to the plain path, stats in the response, and the
    reference's 400s."""
    _, teng = engines
    app = create_serving_app({"m": teng}, batch_window_ms=20.0,
                             drafts={"m": teng})   # self-draft: accepts all
    client = await aiohttp_client(app)
    prompt = _prompts(6, (8,))[0]
    want = teng.generate([prompt], max_new=10).numpy()[0].tolist()
    body = await _post(client, {"tokens": [prompt], "max_new": 10,
                                "speculative": True, "gamma": 3})
    assert body["tokens"] == [want]
    stats = body["speculative"]
    assert stats["acceptance_rate"] == 1.0
    assert stats["gamma"] == 2   # bucketed to a power of two <= 8
    assert stats["proposed"] > 0 and stats["proposed"] % 2 == 0
    for bad in ({"tokens": [prompt, prompt], "max_new": 4,
                 "speculative": True},
                {"tokens": [prompt], "max_new": 4, "speculative": True,
                 "gamma": 0},
                {"tokens": [prompt], "max_new": 50, "speculative": True,
                 "gamma": 8},
                {"tokens": [prompt], "max_new": 4, "speculative": True,
                 "logprobs": True},
                {"tokens": [prompt], "max_new": 4, "speculative": 1}):
        await _post(client, bad, status=400)
    client2 = await aiohttp_client(create_serving_app({"m": teng}))
    body = await _post(client2, {"tokens": [prompt], "max_new": 4,
                                 "speculative": True}, status=400)
    assert "no draft model" in body["error"]


def test_continuous_only_knobs_and_drafts_are_checked(engines):
    _, teng = engines
    for kw in (dict(prefill_chunk_tokens=8), dict(kv_block_size=16)):
        with pytest.raises(ValueError, match="require continuous=True"):
            create_serving_app({"m": teng}, **kw)
    with pytest.raises(ValueError, match="unknown models"):
        create_serving_app({"m": teng}, drafts={"x": teng})
    app = create_serving_app({"m": teng}, continuous=True)
    batcher = app[BATCHERS_KEY]["m"]
    assert isinstance(batcher, ContinuousBatcher)
    assert batcher.prefill_chunk_tokens is None   # monolithic admission


async def test_continuous_mode_reports_its_batcher(engines, aiohttp_client):
    _, teng = engines
    client = await aiohttp_client(create_serving_app(
        {"m": teng}, continuous=True, kv_block_size=8,
        prefill_chunk_tokens=4))
    body = await _post(client, {"tokens": [[1, 2, 3]], "max_new": 3})
    assert len(body["tokens"][0]) == 3
    models = await (await client.get("/v1/models")).json()
    assert models["models"][0]["batcher_mode"] == "continuous"


def test_cli_modes():
    with pytest.raises(SystemExit):   # continuous-only knob
        cli.parse_args(["--model", "llama-tiny", "--random",
                        "--prefill-chunk-tokens", "8"])
    assert "llama3-8b" in cli.model_registry()
    window = cli.build_app(cli.parse_args(
        ["--model", "llama-tiny", "--random", "--cpu", "--max-len", "64",
         "--batch-window-ms", "5"]))
    assert isinstance(window[BATCHERS_KEY]["llama-tiny"], Batcher)
    direct = cli.build_app(cli.parse_args(
        ["--model", "llama-tiny", "--random", "--cpu", "--max-len", "64"]))
    assert direct[BATCHERS_KEY] == {}
    cont = cli.build_app(cli.parse_args(
        ["--model", "llama-tiny", "--random", "--cpu", "--max-len", "64",
         "--continuous"]))
    batcher = cont[BATCHERS_KEY]["llama-tiny"]
    assert isinstance(batcher, ContinuousBatcher)
    assert batcher.prefill_chunk_tokens is None   # monolithic admission
