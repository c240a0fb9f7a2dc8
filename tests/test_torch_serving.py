"""The port's serving path against the JAX reference, on the CPU.

One LLAMA_TINY model (the reference's init, lm_head scaled x50 so that
greedy argmax cannot flip on fp32 rounding — the reference's own test
idiom) serves through both frameworks. The port's continuous batcher
must emit the JAX batcher's greedy tokens exactly, at every chunked-
prefill budget (1 token per slice up to the whole prompt in one slice),
with logprobs within 1e-4 (fp32, different sum orders); its device half
must leave the same KV in the pool; and its HTTP `:generate` must
return the tokens the JAX engine generates.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import SamplingParams as JSamplingParams
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu.serving.engine import filter_logits as j_filter
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.continuous import ContinuousEngine
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
    SamplingParams,
    filter_logits,
)
from kubeflow_tpu_torch.serving.server import create_serving_app

pytest_plugins = ("aiohttp.pytest_plugin",)

BS = 8
MAX_NEW = 5
LENS = (4, 7, 12, 20)


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
    gen = np.random.default_rng(4)
    prompts = [gen.integers(0, cfg.vocab_size, n).tolist() for n in LENS]
    return jeng, teng, prompts


async def _serve(batcher, prompts):
    try:
        return await asyncio.gather(*(
            batcher.submit(p, MAX_NEW, (), with_logprobs=True)
            if isinstance(batcher, JBatcher) else
            batcher.submit(p, MAX_NEW, with_logprobs=True)
            for p in prompts))
    finally:
        await batcher.close()


@pytest.fixture(scope="module")
def reference(engines):
    """The JAX continuous batcher's tokens and logprobs (XLA paged path,
    chunked prefill at budget 3)."""
    jeng, _, prompts = engines

    async def run():
        return await _serve(JBatcher(
            jeng, asyncio.Lock(), max_slots=4, kv_block_size=BS,
            prefill_chunk_tokens=3, paged_attention_impl="xla"), prompts)

    return asyncio.run(run())


@pytest.mark.parametrize("budget", [1, 3, 8, 64])
def test_batcher_tokens_match_reference(engines, reference, budget):
    _, teng, prompts = engines

    async def run():
        return await _serve(ContinuousBatcher(
            teng, asyncio.Lock(), max_slots=4, kv_block_size=BS,
            prefill_chunk_tokens=budget), prompts)

    got = asyncio.run(run())
    for (toks, lps), (wtoks, wlps) in zip(got, reference):
        assert list(toks) == list(wtoks), f"budget={budget}"
        np.testing.assert_allclose(lps, wlps, atol=1e-4, rtol=1e-4)


def test_engine_device_half_matches_reference(engines):
    """Drive both device halves through the same calls — adopt, two
    chunked-prefill slices (the second finishing), decode steps with the
    other slot frozen mid-prefill — and compare tokens, cursors and the
    pool (block 0, the trash sink, excluded)."""
    jeng, teng, prompts = engines
    jce = JCEngine(jeng, max_slots=2, block_size=BS,
                   paged_attention_impl="xla")
    tce = ContinuousEngine(teng, max_slots=2, block_size=BS)
    prompt, other = prompts[3], prompts[2]   # 20 and 12 tokens
    table0 = np.zeros(jce.blocks_per_slot, np.int32)
    table0[:4] = [3, 5, 7, 9]
    table1 = np.zeros(jce.blocks_per_slot, np.int32)
    table1[:3] = [2, 4, 6]
    greedy = dict(temperature=np.zeros(2, np.float32),
                  top_k=np.zeros(2, np.int64), top_p=np.ones(2, np.float32))
    jsp = JSamplingParams(*(jnp.asarray(greedy[k])
                            for k in ("temperature", "top_k", "top_p")))
    tsp = SamplingParams.make(greedy["temperature"], greedy["top_k"],
                              greedy["top_p"], "cpu")
    rng = jax.random.key(0)
    gen = torch.Generator().manual_seed(0)
    jst, tst = jce.init_slots(), tce.init_slots()
    jst = jce.adopt_slot(jst, 0, table0, 0, prompt[0])
    jst = jce.adopt_slot(jst, 1, table1, 0, other[0])
    tce.adopt_slot(tst, 0, table0, 0, prompt[0])
    tce.adopt_slot(tst, 1, table1, 0, other[0])
    s = 16
    for fed, n, finish in ((0, 16, False), (16, 4, True)):
        toks = np.zeros((1, s), np.int32)
        toks[0, :n] = prompt[fed:fed + n]
        jst, jt, _, rng = jce.append_rows(jst, [0], toks, [n], [finish],
                                          jsp, rng)
        _, tt, _ = tce.append_rows(tst, [0], toks, [n], [finish], tsp, gen)
    assert int(tt[0]) == int(jt[0])
    jst, jtoks, _, rng = jce.step(jst, jsp, rng, 3)
    _, ttoks, _ = tce.step(tst, tsp, gen, 3)
    np.testing.assert_array_equal(ttoks.numpy()[0], np.asarray(jtoks)[0])
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))
    np.testing.assert_array_equal(tst.frozen.numpy(), np.asarray(jst.frozen))
    np.testing.assert_allclose(tst.k.numpy()[:, 1:], np.asarray(jst.k)[:, 1:],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tst.v.numpy()[:, 1:], np.asarray(jst.v)[:, 1:],
                               atol=1e-5, rtol=1e-5)
    # copy-on-write seed and slot reset
    jst = jce.copy_cells(jst, 3, 11, 5)
    tce.copy_cells(tst, 3, 11, 5)
    np.testing.assert_allclose(tst.k.numpy()[:, 11], np.asarray(jst.k)[:, 11],
                               atol=1e-5, rtol=1e-5)
    jst = jce.reset_slots(jst, [0])
    tce.reset_slots(tst, [0])
    np.testing.assert_array_equal(tst.block_table.numpy(),
                                  np.asarray(jst.block_table))
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, 1.0), (3, 0.5),
                                         (7, 0.8)])
def test_filter_logits_matches_reference(top_k, top_p):
    logits = np.random.default_rng(5).normal(size=(3, 64)).astype(
        np.float32) * 3
    want = j_filter(jnp.asarray(logits), jnp.asarray(top_k),
                    jnp.asarray(top_p))
    got = filter_logits(torch.from_numpy(logits), torch.tensor(top_k),
                        torch.tensor(top_p))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))


def test_sampled_rows_draw_inside_the_filtered_set(engines):
    """Sampled tokens cannot match the reference's RNG; hold them to the
    filter's support and to the raw-distribution logprob instead."""
    _, teng, _ = engines
    logits = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 512)).astype(np.float32))
    sp = SamplingParams.make([1.0, 0.0, 0.7, 1.0], [3, 0, 0, 1],
                             [1.0, 1.0, 0.5, 1.0], "cpu")
    tok, lp = teng._sample(logits, torch.Generator().manual_seed(1), sp)
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    assert int(tok[0]) in top3
    assert int(tok[1]) == int(torch.argmax(logits[1]))
    assert int(tok[3]) == int(torch.argmax(logits[3]))   # top_k=1
    raw = torch.log_softmax(logits, -1)
    torch.testing.assert_close(lp, raw[torch.arange(4), tok.long()])


async def test_http_generate_returns_reference_tokens(engines,
                                                      aiohttp_client):
    jeng, teng, prompts = engines
    same_len = [prompts[2], prompts[2][::-1]]
    want = [np.asarray(jeng.generate(jnp.asarray([p], jnp.int32),
                                     max_new=MAX_NEW))[0].tolist()
            for p in same_len]
    client = await aiohttp_client(create_serving_app(
        {"tiny": teng}, max_batch=2, continuous=True, kv_block_size=BS,
        prefill_chunk_tokens=4))
    resp = await client.post("/v1/models/tiny:generate",
                             json={"tokens": same_len, "max_new": MAX_NEW,
                                   "logprobs": True})
    assert resp.status == 200, await resp.text()
    body = await resp.json()
    assert body["tokens"] == want
    assert [len(lp) for lp in body["logprobs"]] == [MAX_NEW, MAX_NEW]
    assert (await client.get("/healthz")).status == 200
    assert (await client.get("/readyz")).status == 200
    models = await (await client.get("/v1/models")).json()
    assert models["models"][0]["batched_requests"] == 2
    for bad in ({"tokens": [[1, 2], [3]]}, {"tokens": [[1]], "max_new": 0},
                {"tokens": [[512]]}, {"tokens": [[1] * 95], "max_new": 2},
                {"tokens": "x"}):
        assert (await client.post("/v1/models/tiny:generate",
                                  json=bad)).status == 400
    assert (await client.post("/v1/models/nope:generate",
                              json={"tokens": [[1]]})).status == 404


async def test_cli_app_serves_on_cpu(aiohttp_client):
    with pytest.raises(SystemExit):
        cli.parse_args(["--model", "llama-tiny"])   # --random required
    app = cli.build_app(cli.parse_args(
        ["--model", "llama-tiny", "--random", "--cpu", "--max-len", "64",
         "--continuous", "--prefill-chunk-tokens", "4"]))
    client = await aiohttp_client(app)
    resp = await client.post("/v1/models/llama-tiny:generate",
                             json={"tokens": [[3, 1, 4, 1, 5, 9, 2, 6]],
                                   "max_new": 3})
    assert resp.status == 200
    toks = (await resp.json())["tokens"]
    assert len(toks) == 1 and len(toks[0]) == 3
    assert all(0 <= t < tllama.LLAMA_TINY.vocab_size for t in toks[0])
