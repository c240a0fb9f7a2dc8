"""The bodies the card captures as CUDA graphs, and the dispatch-ahead
batcher, against the JAX reference on the CPU.

One LLAMA_TINY model (the reference's init, lm_head scaled x50 so that
greedy argmax cannot flip on fp32 rounding — the reference's own test
idiom) in both frameworks. On the CPU a graph runner calls its body, so
these tests run exactly what the card replays:

- the continuous step through the engine's static buffers
  (`ContinuousEngine.sampling` / `decode` / `prefill_slice`) for steps
  1-4 against `JCEngine.step`, with the knobs changing between calls
  and a row frozen mid-prefill; rows that sample do so with top_k = 1
  (or a nucleus of one token), which the reference's RNG and the port's
  must both resolve to the argmax;
- `ContinuousBatcher(pipeline_depth=2)` against the reference's, with a
  request that stops at EOS inside a chunk while the next chunk is in
  flight and its slot re-admitted before that chunk lands;
- the one-shot device-cursor step (`InferenceEngine.generate`) against
  the host-cursor step of `_forward_cached` and the reference engine's
  `generate`, for batch 1, 2 and 4 with left pads.

Tokens exact; logprobs and the pool within 1e-4 (fp32, sums in another
order).
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
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
)
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.server import (
    BATCHERS_KEY,
    create_serving_app,
)

pytest_plugins = ("aiohttp.pytest_plugin",)

BS = 8
MAX_LEN = 96
TOL = dict(atol=1e-4, rtol=1e-4)


def _params():
    p = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    p["lm_head"] = p["lm_head"] * 50.0   # argmax can't flip
    return p


def _pair(params, **ec):
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN, **ec))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN, **ec),
        device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def engines(params):
    return _pair(params)


def _knobs(temperature, top_k, top_p):
    return (np.asarray(temperature, np.float32),
            np.asarray(top_k, np.int64), np.asarray(top_p, np.float32))


def test_step_body_through_static_buffers_matches_reference(engines):
    """Slot 0 prefills in two slices and decodes; slot 1 is fed one
    slice and stays frozen. Then steps 1, 2, 3, 4 with other knobs each
    time: greedy; a top-k/top-p filter at temperature 0 (the greedy
    graph); slot 0 sampled at top_k 1 (the sampled+filtered graph);
    slot 0 sampled with a one-token nucleus."""
    jeng, teng = engines
    jce = JCEngine(jeng, max_slots=2, block_size=BS,
                   paged_attention_impl="xla")
    tce = ContinuousEngine(teng, max_slots=2, block_size=BS, seed=0)
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, 512, 20).tolist()
    other = rng.integers(0, 512, 12).tolist()
    table0 = np.zeros(jce.blocks_per_slot, np.int32)
    table0[:4] = [3, 5, 7, 9]
    table1 = np.zeros(jce.blocks_per_slot, np.int32)
    table1[:3] = [2, 4, 6]
    key = jax.random.key(0)
    jst = jce.init_slots()
    jst = jce.adopt_slot(jst, 0, table0, 0, prompt[0])
    jst = jce.adopt_slot(jst, 1, table1, 0, other[0])
    tst = tce.slots()
    tce.adopt_slot(tst, 0, table0, 0, prompt[0])
    tce.adopt_slot(tst, 1, table1, 0, other[0])
    greedy = _knobs([0, 0], [0, 0], [1, 1])

    def jsp(knobs):
        return JSamplingParams(*(jnp.asarray(k) for k in knobs))

    s = 16
    for slot, toks_src, fed, n, finish in ((0, prompt, 0, 16, False),
                                           (1, other, 0, 7, False),
                                           (0, prompt, 16, 4, True)):
        toks = np.zeros((1, s), np.int32)
        toks[0, :n] = toks_src[fed:fed + n]
        jst, jt, jl, key = jce.append_rows(jst, [slot], toks, [n], [finish],
                                           jsp(greedy), key)
        tt, tl = tce.prefill_slice(tce.sampling(*greedy), slot, toks, n,
                                   finish)
    assert int(tt[0]) == int(jt[0])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    plans = [(1, greedy, (False, False)),
             (2, _knobs([0, 0], [5, 0], [0.9, 1]), (False, False)),
             (3, _knobs([0.8, 0], [1, 0], [1, 1]), (True, True)),
             (4, _knobs([1.3, 0], [0, 0], [1e-6, 1]), (True, True))]
    for steps, knobs, graph_key in plans:
        sp = tce.sampling(*knobs)
        assert tce._key(sp) == graph_key
        jst, jtoks, jlps, key = jce.step(jst, jsp(knobs), key, steps)
        ttoks, tlps = tce.decode(sp, steps)
        np.testing.assert_array_equal(ttoks.numpy()[0],
                                      np.asarray(jtoks)[0])
        np.testing.assert_allclose(tlps.numpy()[0], np.asarray(jlps)[0],
                                   **TOL)
        np.testing.assert_array_equal(tst.length.numpy(),
                                      np.asarray(jst.length))
        np.testing.assert_array_equal(tst.frozen.numpy(),
                                      np.asarray(jst.frozen))
        np.testing.assert_array_equal(tst.tok.numpy()[0],
                                      np.asarray(jst.tok)[0])
    assert tst.frozen.tolist() == [False, True]
    np.testing.assert_allclose(tst.k.numpy()[:, 1:], np.asarray(jst.k)[:, 1:],
                               **TOL)
    np.testing.assert_allclose(tst.v.numpy()[:, 1:], np.asarray(jst.v)[:, 1:],
                               **TOL)
    # one body per (steps, key) and per slice key: what the card captures
    assert ("step", 3, True, True) in tce.graphs
    assert tce.graphs.captures == 5


@pytest.fixture(scope="module")
def eos_engines(params):
    """Engines whose EOS is the third token the first prompt generates
    greedily, so that request stops inside its first decode chunk."""
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, 512, n).tolist() for n in (6, 11, 4, 9, 14)]
    _, plain = _pair(params)
    first = plain.generate(np.asarray([prompts[0]]), max_new=6).numpy()[0]
    return _pair(params, eos_token=int(first[2])), prompts, int(first[2])


async def _serve(batcher, prompts, max_new):
    try:
        return await asyncio.gather(*(
            batcher.submit(p, max_new, (), with_logprobs=True)
            if isinstance(batcher, JBatcher) else
            batcher.submit(p, max_new, with_logprobs=True)
            for p in prompts))
    finally:
        await batcher.close()


@pytest.mark.parametrize("prefill_chunk_tokens", [None, 4])
def test_dispatch_ahead_batcher_matches_reference(eos_engines,
                                                  prefill_chunk_tokens):
    (jeng, teng), prompts, eos = eos_engines
    kw = dict(max_slots=2, kv_block_size=BS, chunk=4,
              prefill_chunk_tokens=prefill_chunk_tokens)

    async def run_ref():
        return await _serve(JBatcher(
            jeng, asyncio.Lock(), pipeline_depth=2,
            paged_attention_impl="xla", **kw), prompts, 8)

    want = asyncio.run(run_ref())
    batcher = ContinuousBatcher(teng, asyncio.Lock(), pipeline_depth=2,
                                seed=0, **kw)
    stale = []   # chunks holding a row of a slot re-admitted meanwhile
    process = batcher._process_chunk

    def spy(rec):
        stale.extend(s for s, r in rec["snap"].items()
                     if s in batcher._active and batcher._active[s] is not r)
        process(rec)

    batcher._process_chunk = spy
    got = asyncio.run(_serve(batcher, prompts, 8))
    assert stale, "no slot was re-admitted under a chunk in flight"
    assert got[0][0][:3] == want[0][0][:3] and got[0][0][2] == eos
    assert batcher.calls > batcher.tokens_emitted / 2   # over-decoding
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        assert list(toks) == list(wtoks)
        np.testing.assert_allclose(lps, wlps, **TOL)


def _host_cursor_generate(teng, arr, mask, max_new):
    """The eager host-int path: prefill, then `_forward_cached` one
    token at a time from the shared host cursor."""
    with torch.inference_mode():
        sp, gen, prompt, maskd = teng._prep(arr, max_new, None, None, None,
                                            None, mask)
        state, tok, _, lp = teng._prefill_sample(
            prompt, teng.init_state(arr.shape[0]), gen, sp, maskd)
        toks, lps = [tok], [lp]
        for _ in range(max_new - 1):
            logits, state = teng._forward_cached(tok[:, None], state)
            tok, lp = teng._sample(logits, gen, sp)
            toks.append(tok)
            lps.append(lp)
    return torch.stack(toks, 1).numpy(), torch.stack(lps, 1).numpy()


@pytest.mark.parametrize("lens", [[9], [5, 9], [5, 9, 2, 7]])
def test_device_cursor_step_matches_host_cursor_and_reference(engines,
                                                              lens):
    jeng, teng = engines
    rng = np.random.default_rng(len(lens))
    width = max(lens)
    arr = np.zeros((len(lens), width), np.int32)
    mask = np.zeros((len(lens), width), bool)
    for i, n in enumerate(lens):
        arr[i, width - n:] = rng.integers(0, 512, n)
        mask[i, width - n:] = True
    max_new = 7
    got, glp = teng.generate(arr, prompt_mask=mask, max_new=max_new,
                             return_logprobs=True)
    host, hlp = _host_cursor_generate(teng, arr, mask, max_new)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_allclose(glp.numpy(), hlp, **TOL)
    want, wlp = jeng.generate(jnp.asarray(arr), prompt_mask=jnp.asarray(mask),
                              max_new=max_new, return_logprobs=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(glp.numpy(), np.asarray(wlp), **TOL)
    # the lane's cursor went one cell per step past the prompt
    lane = teng._lanes[len(lens)]
    assert lane.cursor.tolist() == [width + max_new - 1] * len(lens)


def test_one_shot_warmup_covers_window_rows_and_streams(engines):
    """Warmed batch sizes capture nothing in traffic; a stream holding
    its lane gives a concurrent `generate` of the same batch size a lane
    of its own, and both match the unshared result."""
    _, teng = engines
    eng = InferenceEngine(teng.params, teng.cfg, LLAMA_FAMILY, teng.ec,
                          device="cpu")
    assert eng.warmup((1, 2)) == 6
    assert eng.captures == 6
    arr = np.random.default_rng(23).integers(0, 512, (2, 6))
    alone = eng.generate(arr, max_new=6).numpy()
    assert eng.captures == 6
    stream = eng.generate_stream(arr, max_new=6, chunk=2)
    parts = [next(stream)]
    during = eng.generate(arr, max_new=6).numpy()
    parts += list(stream)
    np.testing.assert_array_equal(during, alone)
    np.testing.assert_array_equal(np.concatenate(parts, 1), alone)
    assert eng.captures == 7   # the private lane's greedy step
    assert not eng._lanes[2].busy


async def test_warmup_runs_at_startup_and_cli_flags(engines, aiohttp_client):
    _, teng = engines
    app = create_serving_app({"m": teng}, continuous=True, kv_block_size=BS,
                             max_batch=2, warmup=True, pipeline_depth=2)
    batcher = app[BATCHERS_KEY]["m"]
    assert batcher.cengine.graphs.captures == 0
    client = await aiohttp_client(app)
    warmed = batcher.cengine.graphs.captures
    assert warmed == 3 * batcher.chunk
    resp = await client.post("/v1/models/m:generate",
                             json={"tokens": [[3, 1, 4, 1, 5]], "max_new": 6})
    assert resp.status == 200, await resp.text()
    assert batcher.cengine.graphs.captures == warmed
    models = await (await client.get("/v1/models")).json()
    assert models["models"][0]["pipeline_depth"] == 2
    assert batcher.prefill_chunk_tokens is None   # monolithic
    with pytest.raises(ValueError, match="require continuous=True"):
        create_serving_app({"m": teng}, pipeline_depth=2)
    for argv in (["--warmup"], ["--pipeline-depth", "2"],
                 ["--prefill-chunk", "8"], ["--continuous",
                                            "--pipeline-depth", "-1"]):
        with pytest.raises(SystemExit):
            cli.parse_args(["--model", "llama-tiny", "--random", *argv])
    args = cli.parse_args(["--model", "llama-tiny", "--random", "--cpu",
                           "--continuous", "--warmup", "--pipeline-depth",
                           "2", "--prefill-chunk", "16", "--max-len", "64"])
    built = cli.build_app(args)[BATCHERS_KEY]["llama-tiny"]
    assert (built.pipeline_depth, built.cengine.prefill_chunk,
            built.prefill_chunk_tokens) == (2, 16, None)
