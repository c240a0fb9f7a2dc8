"""Multi-LoRA serving in the port (serving/multilora.py through both
engines, the continuous batcher and the HTTP app) against the JAX
reference, on the CPU.

LLAMA_TINY with the reference's init and lm_head x50 (argmax cannot flip
on fp32 sum order), two adapters of rank 4 over every block matrix with
B non-zero (`_adapter`, the reference test's recipe). Oracles: the JAX
engine with the same pack (bridged by `bridge.pack_from_jax`), and an
engine on `merge_lora`-folded weights. Tokens must be equal; logprobs
within 1e-3 absolute (fp32, other sum orders, the x50 head).

The radix case: the reference matches a prompt in its radix tree by
namespace alone (kubeflow_tpu/serving/continuous.py:2137), so an adapter
request after a base request on the same prompt reuses the base
request's K/V cells. The port keys its tree by (namespace, adapter id);
`test_radix_keys_adapters_apart` shows the reference's hybrid and the
port's isolation on an unscaled head, where logprobs show the cells'
difference.
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
from kubeflow_tpu.serving import build_pack as jbuild_pack
from kubeflow_tpu.serving import quant as jquant
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu.serving.continuous import (
    ContinuousBatcher as JContinuousBatcher,
)
from kubeflow_tpu.train.lora import LoraConfig as JLoraConfig
from kubeflow_tpu.train.lora import init_lora
from kubeflow_tpu.train.lora import merge_lora as jmerge_lora
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    cache_ns,
)
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.multilora import build_pack
from kubeflow_tpu_torch.serving.quant import QTensor, quantize_blocks
from kubeflow_tpu_torch.train.lora import LoraConfig, merge_lora

pytest_plugins = ("aiohttp.pytest_plugin",)

CFG = jllama.LLAMA_TINY
TCFG = tllama.LLAMA_TINY
JLCFG = JLoraConfig(rank=4)
LCFG = LoraConfig(rank=4)
MAX_LEN = 64
LP_ATOL = 1e-3
URL = "/v1/models/m:generate"


def _adapter(seed: int):
    """A LoRA tree with non-zero B (a fresh init has B = 0: the base)."""
    ad = init_lora(jax.random.key(seed), CFG, JLCFG)
    ad["blocks"] = {
        t: {"A": ab["A"],
            "B": jax.random.normal(
                jax.random.key(seed + 99), ab["B"].shape) * 0.05}
        for t, ab in ad["blocks"].items()}
    return ad


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jparams, pack=None, **kw):
    return InferenceEngine(bridge.from_jax(_np(jparams), TCFG, "cpu"), TCFG,
                           LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
                           device="cpu", adapter_pack=pack, **kw)


@pytest.fixture(scope="module")
def setup():
    params = dict(jllama.init(jax.random.key(0), CFG))
    params["lm_head"] = params["lm_head"] * 50.0
    adapters = {"alice": _adapter(1), "bob": _adapter(2)}
    jpack = jbuild_pack(CFG, JLCFG, adapters)
    jeng = JEngine(params, CFG, J_LLAMA, JEngineConfig(max_len=MAX_LEN),
                   adapter_pack=jpack)
    teng = _port(params, bridge.pack_from_jax(jpack, "cpu"))
    merged = {n: InferenceEngine(
        merge_lora(teng.params, _np(a), LCFG), TCFG, LLAMA_FAMILY,
        EngineConfig(max_len=MAX_LEN), device="cpu")
        for n, a in adapters.items()}
    merged[""] = _port(params)
    return jeng, teng, merged, params, adapters


def _solo(engine, prompt, max_new, **kw):
    toks, lps = engine.generate([prompt], max_new=max_new,
                                return_logprobs=True, **kw)
    return toks[0].tolist(), lps[0].numpy()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).tolist() for n in lens]


def test_build_pack_matches_reference_layout(setup):
    jeng, teng, _, _, adapters = setup
    port = build_pack(TCFG, LCFG, _np(adapters))
    ref = jeng.adapter_pack
    assert port.names == ref.names == {"alice": 1, "bob": 2}
    assert port.scaling == ref.scaling == 4.0
    for t, ab in ref.blocks.items():
        for k in ("A", "B"):
            assert tuple(port.blocks[t][k].shape) == ab[k].shape
            np.testing.assert_array_equal(port.blocks[t][k].numpy(),
                                          np.asarray(ab[k]))
    # id 0 is the zero adapter
    assert not port.blocks["wq"]["A"][:, 0].any()
    assert port.resolve("") == 0 and port.resolve("bob") == 2


def test_merge_lora_matches_reference(setup):
    _, teng, _, params, adapters = setup
    want = jmerge_lora(params, adapters["alice"], JLCFG)
    got = merge_lora(teng.params, _np(adapters["alice"]), LCFG)
    for name in JLCFG.targets:
        np.testing.assert_allclose(got["blocks"][name].numpy(),
                                   np.asarray(want["blocks"][name]),
                                   rtol=1e-6, atol=1e-6)


def test_adapter_generate_matches_reference_and_merged_oracle(setup):
    """The reference's headline case, plus the JAX engine's tokens."""
    jeng, teng, merged, _, _ = setup
    p = _prompts(0, [6])[0]
    base, _ = _solo(teng, p, 5)
    for name in ("alice", "bob"):
        got, lps = _solo(teng, p, 5, adapter=name)
        wt, wl = jeng.generate(jnp.asarray([p], jnp.int32), max_new=5,
                               adapter=name, return_logprobs=True)
        assert got == np.asarray(wt)[0].tolist()
        np.testing.assert_allclose(lps, np.asarray(wl)[0], atol=LP_ATOL)
        want, wlps = _solo(merged[name], p, 5)
        assert got == want
        np.testing.assert_allclose(lps, wlps, atol=LP_ATOL)
        assert got != base   # the adapters change the model
    # '' selects the zero adapter: the plain base
    assert _solo(teng, p, 5, adapter="")[0] == base


@pytest.mark.parametrize("prefill_chunk", [None, 4])
def test_mixed_adapter_rows_in_one_batch(setup, prefill_chunk):
    """One batch of base, alice and bob rows (the reference's case),
    also prefilled in slices; each row equals its own engine."""
    jeng, teng, merged, _, _ = setup
    p = _prompts(1, [5])[0]
    names = ["", "alice", "bob"]
    got = teng.generate([p, p, p], max_new=5, adapter=names,
                        prefill_chunk=prefill_chunk)
    want = np.asarray(jeng.generate(jnp.asarray([p, p, p], jnp.int32),
                                    max_new=5, adapter=names))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, name in enumerate(names):
        assert got[i].tolist() == _solo(merged[name], p, 5)[0]


def test_adapter_score_matches_merged_oracle(setup):
    _, teng, merged, _, _ = setup
    seq = [_prompts(2, [12])[0]]
    np.testing.assert_allclose(teng.score(seq, adapter="bob").numpy(),
                               merged["bob"].score(seq).numpy(),
                               atol=LP_ATOL)


def test_adapter_validation(setup):
    """The reference's refusals, in its words."""
    jeng, teng, _, _, _ = setup
    p = [[1, 2, 3]]
    with pytest.raises(ValueError, match="unknown adapter"):
        teng.generate(p, max_new=2, adapter="carol")
    with pytest.raises(ValueError, match="3 adapter names"):
        teng.generate(p, max_new=2, adapter=["a", "b", "c"])
    bare = InferenceEngine(teng.params, TCFG, LLAMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device="cpu")
    with pytest.raises(ValueError, match="no adapter_pack"):
        bare.generate(p, max_new=2, adapter="alice")


def test_pack_shape_mismatch_rejected():
    a, b = _np(_adapter(1)), _np(_adapter(2))
    b["blocks"]["wq"]["A"] = b["blocks"]["wq"]["A"][:, :, :2]   # rank 2
    with pytest.raises(ValueError, match="same rank"):
        build_pack(TCFG, LCFG, {"a": a, "b": b})
    b = _np(_adapter(2))
    del b["blocks"]["wk"]
    with pytest.raises(ValueError, match="missing target"):
        build_pack(TCFG, LCFG, {"a": a, "b": b})
    with pytest.raises(ValueError, match="at least one adapter"):
        build_pack(TCFG, LCFG, {})


def test_speculative_batcher_refuses_a_pack(setup):
    _, teng, merged, _, _ = setup
    with pytest.raises(ValueError, match="does not compose"):
        ContinuousBatcher(teng, asyncio.Lock(), draft=merged[""])


@pytest.mark.parametrize("chunk_tokens", [None, 4])
async def test_continuous_batcher_mixes_adapters_per_slot(setup,
                                                          chunk_tokens):
    """Concurrent requests for different fine-tunes and the base share
    one slot batch (monolithic and chunked admission), each decoding its
    own adapter's tokens; a slot reused by another adapter leaks
    nothing; an unknown name raises at submit."""
    _, teng, merged, _, _ = setup
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=4,
                                kv_block_size=8,
                                prefill_chunk_tokens=chunk_tokens)
    pa, pb, pc, pd = _prompts(3, [4, 9, 6, 11])
    reqs = [(pa, "alice"), (pb, "bob"), (pc, ""), (pd, "alice")]
    outs = await asyncio.gather(*(
        batcher.submit(p, 5, {"adapter": a} if a else {},
                       with_logprobs=True) for p, a in reqs))
    for (p, a), (toks, lps) in zip(reqs, outs):
        want, wlps = _solo(merged[a], p, 5)
        assert toks == want, a
        np.testing.assert_allclose(lps, wlps, atol=LP_ATOL)
    got = await batcher.submit(pb, 5, {"adapter": "alice"})
    assert got == _solo(merged["alice"], pb, 5)[0]
    with pytest.raises(ValueError, match="unknown adapter"):
        await batcher.submit(pa, 5, {"adapter": "carol"})
    await batcher.close()


async def test_adapters_under_pipelined_depth2(setup):
    """Per-slot ids survive dispatch-ahead slot reuse: one slot,
    re-admitted under another adapter while a chunk is in flight."""
    _, teng, merged, _, _ = setup
    p1, p2 = _prompts(70, [5, 8])
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=1, chunk=2,
                                pipeline_depth=2)
    assert await batcher.submit(p1, 5, {"adapter": "alice"}) == \
        _solo(merged["alice"], p1, 5)[0]
    assert await batcher.submit(p2, 5, {"adapter": "bob"}) == \
        _solo(merged["bob"], p2, 5)[0]
    await batcher.close()


async def test_batcher_refusals(setup):
    _, teng, merged, _, _ = setup
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                                prefixes={"sys": [1, 2, 3]})
    with pytest.raises(ValueError, match="prefix does not compose"):
        await batcher.submit([4, 5], 3, {"adapter": "alice",
                                         "prefix": "sys"})
    bare = ContinuousBatcher(merged[""], asyncio.Lock(), max_slots=2)
    with pytest.raises(ValueError, match="no adapter pack"):
        await bare.submit([4, 5], 3, {"adapter": "alice"})
    await batcher.close()
    await bare.close()


def test_int8_base_under_a_pack(setup):
    """An int8 base composes with the pack: the base product through
    qdot's QTensor path, the delta beside it; tokens equal the JAX
    engine's over the reference's quantize_blocks and the same pack."""
    jeng, _, _, params, _ = setup
    qparams = jquant.quantize_blocks(params)
    jq = JEngine(qparams, CFG, J_LLAMA, JEngineConfig(max_len=MAX_LEN),
                 adapter_pack=jeng.adapter_pack)
    tq = InferenceEngine(
        quantize_blocks(bridge.from_jax(_np(params), TCFG, "cpu")), TCFG,
        LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN), device="cpu",
        adapter_pack=bridge.pack_from_jax(jeng.adapter_pack, "cpu"))
    assert isinstance(tq.params["blocks"]["w_up"], QTensor)
    p = _prompts(4, [7])[0]
    names = ["alice", "", "bob"]
    got, lps = tq.generate([p] * 3, max_new=5, adapter=names,
                           return_logprobs=True)
    wt, wl = jq.generate(jnp.asarray([p] * 3, jnp.int32), max_new=5,
                         adapter=names, return_logprobs=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(wt))
    np.testing.assert_allclose(lps.numpy(), np.asarray(wl), atol=LP_ATOL)


async def test_import_sequence_keys_an_adapter_record_apart(setup):
    """A migrated record keeps its adapter in `sampling`; its blocks are
    indexed under the adapter's key, so the base never hits them."""
    _, teng, _, _, _ = setup
    src = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                            kv_block_size=8)
    dst = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                            kv_block_size=8)
    p = _prompts(5, [20])[0]
    fut = src._enqueue(p, 12, {"adapter": "bob"}, queue=None)
    while src.tokens_emitted < 2:
        await asyncio.sleep(0)
    records = await src.export_sequences()
    with pytest.raises(Exception):
        await fut
    (rec,) = records
    assert rec["sampling"]["adapter"] == "bob"
    assert await dst.import_sequence(rec) > 0
    ns = cache_ns("", 2)
    assert dst._radix.match(rec["tokens"], ns=ns)[0]
    assert not dst._radix.match(rec["tokens"])[0]
    await src.close()
    await dst.close()


# -- the radix case (part 2) --------------------------------------------

@pytest.fixture(scope="module")
def unscaled():
    """The same model without the x50 head (logprobs show the cells'
    difference) and one adapter; kv blocks of 8."""
    params = dict(jllama.init(jax.random.key(0), CFG))
    adapters = {"alice": _adapter(1)}
    jpack = jbuild_pack(CFG, JLCFG, adapters)
    jeng = JEngine(params, CFG, J_LLAMA, JEngineConfig(max_len=MAX_LEN),
                   adapter_pack=jpack)
    teng = _port(params, bridge.pack_from_jax(jpack, "cpu"))
    merged = JEngine(jmerge_lora(params, adapters["alice"], JLCFG), CFG,
                     J_LLAMA, JEngineConfig(max_len=MAX_LEN))
    return jeng, teng, merged


async def _base_then_alice(batcher, prompt, sampling_alice):
    """The prompt under the base, then under alice: -> alice's
    (tokens, logprobs) and the cells her admission reused."""
    await batcher.submit(prompt, 4, sampling_alice[0], with_logprobs=True)
    reused = batcher.tokens_reused
    toks, lps = await batcher.submit(prompt, 4, sampling_alice[1],
                                     with_logprobs=True)
    return toks, np.asarray(lps), batcher.tokens_reused - reused


async def test_radix_keys_adapters_apart(unscaled):
    """The reference serves `alice` over the base request's cached K/V
    (a hybrid: its logprobs part from alice alone); the port misses,
    prefills under alice and gives alice-alone's logprobs. A second
    alice request then hits alice's own cells. Oracle: the JAX engine on
    alice's merged weights."""
    jeng, teng, merged = unscaled
    prompt = _prompts(6, [20])[0]
    _, oracle = merged.generate(jnp.asarray([prompt], jnp.int32), max_new=4,
                                return_logprobs=True)
    oracle = np.asarray(oracle)[0]

    jb = JContinuousBatcher(jeng, asyncio.Lock(), max_slots=2,
                            kv_block_size=8)
    _, jl, jreused = await _base_then_alice(
        jb, prompt, [(), (("adapter", "alice"),)])
    await jb.close()
    jfresh = JContinuousBatcher(jeng, asyncio.Lock(), max_slots=2,
                                kv_block_size=8)
    _, jl_alone = await jfresh.submit(prompt, 4, (("adapter", "alice"),),
                                      with_logprobs=True)
    await jfresh.close()
    assert jreused == 16            # two of the base's blocks reused
    hybrid = float(np.abs(jl - oracle).max())
    assert hybrid > 1e-2, hybrid    # the reference's hybrid
    np.testing.assert_allclose(np.asarray(jl_alone), oracle, atol=LP_ATOL)

    tb = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                           kv_block_size=8)
    tt, tl, treused = await _base_then_alice(
        tb, prompt, [{}, {"adapter": "alice"}])
    assert treused == 0             # keyed apart: a miss
    tfresh = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                               kv_block_size=8)
    ft, fl = await tfresh.submit(prompt, 4, {"adapter": "alice"},
                                 with_logprobs=True)
    await tfresh.close()
    assert tt == ft
    np.testing.assert_array_equal(tl, np.asarray(fl))
    np.testing.assert_allclose(tl, oracle, atol=LP_ATOL)
    # alice's own cells: the repeat reuses them (16 cells, two blocks)
    before = tb.tokens_reused
    again = await tb.submit(prompt, 4, {"adapter": "alice"})
    assert tb.tokens_reused - before == 16 and again == tt
    await tb.close()


# -- the HTTP app ---------------------------------------------------------

async def _answers(app, bodies):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = []
        for body in bodies:
            r = await client.post(URL, json=body)
            if r.content_type == "text/event-stream":
                out.append((r.status, {"stream": await r.text()}))
            else:
                out.append((r.status, await r.json()))
        r = await client.get("/v1/models")
        out.append((r.status, (await r.json())["models"][0].get("adapters")))
        return out
    finally:
        await client.close()


def _bodies(p):
    return [
        {"tokens": [p], "max_new": 4, "adapter": "alice"},
        {"tokens": [p], "max_new": 4, "adapter": "carol"},
        {"tokens": [p], "max_new": 4, "adapter": 3},
        {"tokens": [p], "max_new": 4, "adapter": "bob",
         "speculative": True},
        {"tokens": [p], "max_new": 4, "adapter": "bob", "stream": True},
        {"tokens": [p], "max_new": 4, "adapter": "bob", "prefix": "sys"},
    ]


@pytest.mark.parametrize("mode", ["continuous", "window", "bare"])
async def test_app_answers_adapter_requests_as_the_reference(setup, mode):
    """The same requests to the JAX app and the port's: statuses equal,
    200s with the merged oracle's tokens, 400s with the reference's
    reasons. `continuous` rides the continuous batcher, `window` the
    direct path beside a window batcher (where streaming an adapter is
    refused), `bare` is a model without a pack."""
    jeng, teng, merged, params, _ = setup
    p = _prompts(7, [5])[0]
    kw = {"continuous": dict(continuous=True, max_batch=4,
                             prefixes={"sys": [1, 2, 3]}),
          "window": dict(batch_window_ms=5.0, max_batch=4),
          "bare": dict(continuous=True, max_batch=4)}[mode]
    if mode == "bare":
        jm = JEngine(params, CFG, J_LLAMA, JEngineConfig(max_len=MAX_LEN))
        tm = merged[""]
    else:
        jm, tm = jeng, teng
    ref = await _answers(jserver.create_serving_app({"m": jm}, **kw),
                         _bodies(p))
    port = await _answers(server.create_serving_app({"m": tm}, **kw),
                          _bodies(p))
    assert [s for s, _ in port] == [s for s, _ in ref]
    for (s, jb), (_, tb) in zip(ref[:-1], port[:-1]):
        if s == 200 and "stream" in jb:
            assert '"done": true' in tb["stream"]
        elif s == 200:
            assert tb["tokens"] == jb["tokens"]
        elif s == 400:
            assert tb["error"] == jb["error"]
    assert port[-1] == ref[-1]
    if mode != "bare":
        assert port[0][0] == 200
        assert port[0][1]["tokens"][0] == _solo(merged["alice"], p, 4)[0]


async def test_peer_hint_skips_adapter_requests(setup):
    """A peer exports base cells, which an adapter's radix key never
    matches: an adapter request with an `X-KV-Peer` hint fetches nothing
    and books no fetch, and answers the merged oracle's tokens. The same
    prompt without the adapter pulls the warm peer's block."""
    from aiohttp.test_utils import TestClient, TestServer

    _, teng, merged, _, _ = setup
    p = _prompts(11, [12])[0]       # one full block of 8 and a tail
    kw = dict(continuous=True, max_batch=2, kv_block_size=8)

    async def metrics(client):
        out = {}
        for line in (await (await client.get("/metrics")).text()).split(
                "\n"):
            if line and not line.startswith("#"):
                key, _, value = line.rpartition(" ")
                out[key] = float(value)
        return {o: out[f'fleet_peer_fetch_total{{model="m",outcome="{o}"}}']
                for o in ("ok", "miss", "failed")}, out.get(
            'serving_prefill_tokens_sum{model="m",source="peer_fetched"}',
            0.0)

    ca = TestClient(TestServer(server.create_serving_app({"m": teng}, **kw)))
    cb = TestClient(TestServer(server.create_serving_app({"m": teng}, **kw)))
    await ca.start_server()
    await cb.start_server()
    try:
        peer = {"X-KV-Peer": str(cb.make_url("")).rstrip("/")}
        r = await cb.post(URL, json={"tokens": [p], "max_new": 4})
        assert r.status == 200          # the peer caches the base block
        r = await ca.post(URL, json={"tokens": [p], "max_new": 4,
                                     "adapter": "alice"}, headers=peer)
        assert r.status == 200
        alice = (await r.json())["tokens"][0]
        after_adapter = await metrics(ca)
        r = await ca.post(URL, json={"tokens": [p], "max_new": 4},
                          headers=peer)
        assert r.status == 200
        after_base = await metrics(ca)
    finally:
        await ca.close()
        await cb.close()
    assert alice == _solo(merged["alice"], p, 4)[0]
    assert after_adapter == ({"ok": 0, "miss": 0, "failed": 0}, 0.0)
    assert after_base == ({"ok": 1, "miss": 0, "failed": 0}, 8.0)
