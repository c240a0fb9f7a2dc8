"""The port's MoE serving (`MOE_LLAMA_FAMILY`, `mixtral-tiny`) against
the JAX reference, on the CPU: the counterparts of
tests/test_serving.py::test_moe_cached_decode_matches_full_recompute
and tests/test_continuous.py::test_non_llama_families_through_the_slot_
engine, kept out of `slow` at tiny sizes.

The reference's MIXTRAL_TINY weights (`llama_moe.init`, lm_head x50 so
that greedy argmax cannot flip on fp32 rounding: the reference's own
idiom) reach the port through `bridge.from_jax`; prompts come from
numpy seeds. Both serve dropless (capacity factor E / k).

Tolerances: greedy tokens identical; logprobs within 1e-3 + 1e-4 |ref|
(fp32, the logits in the hundreds after the x50 head, sums in another
order: llama's and gemma's serving bound). A row alone and the same row
among batch-mates and pads: the FFN within 1e-6 (the expert products
run over another number of slots), tokens identical, logprobs within
1e-5.

The MoE combinations the CLI and the engines accept are tested here
(speculative decoding with a MoE target or a MoE draft: greedy in,
greedy out; int8 weights against the reference's int8 engine, bit-equal
leaves; an attention-only adapter pack against the reference's engine
with the same pack and the merged oracles, at LP_TOL); a pack that
targets the dense MLP is refused by name.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama_moe as jmodel
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import MOE_LLAMA_FAMILY as J_MOE
from kubeflow_tpu.serving import build_pack as jbuild_pack
from kubeflow_tpu.serving import quant as jquant
from kubeflow_tpu.serving.__main__ import model_registry as j_registry
from kubeflow_tpu.train.lora import LoraConfig as JLoraConfig
from kubeflow_tpu.train.lora import init_lora as j_init_lora
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import llama_moe as tmodel
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    MOE_LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
    _moe_serving_mlp,
)
from kubeflow_tpu_torch.serving.multilora import AdapterPack, build_pack
from kubeflow_tpu_torch.serving.quant import (
    BLOCK_MATMUL_WEIGHTS,
    QTensor,
    param_bytes,
    quantize_blocks,
)
from kubeflow_tpu_torch.train.lora import LoraConfig, merge_lora
from kubeflow_tpu_torch.serving.server import (
    ENGINES_KEY,
    create_serving_app,
)

pytest_plugins = ("aiohttp.pytest_plugin",)

BS = 8
MAX_LEN = 96
MAX_NEW = 5
LENS = (4, 9, 6, 20)
LP_TOL = dict(atol=1e-3, rtol=1e-4)
DROPLESS = jmodel.MIXTRAL_TINY.num_experts / jmodel.MIXTRAL_TINY.top_k


@pytest.fixture(scope="module")
def engines():
    """Both frameworks' engines on the reference's weights (head x50),
    the prompts, and the reference's solo tokens and logprobs."""
    cfg = jmodel.MIXTRAL_TINY
    params = dict(jmodel.init(jax.random.key(2), cfg))
    params["lm_head"] = params["lm_head"] * 50.0
    jeng = JEngine(params, cfg, J_MOE, JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tmodel.MIXTRAL_TINY, "cpu"),
        tmodel.MIXTRAL_TINY, MOE_LLAMA_FAMILY,
        EngineConfig(max_len=MAX_LEN), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENS]
    solo = []
    for p in prompts:
        t, lp = jeng.generate(jnp.asarray([p], jnp.int32), max_new=MAX_NEW,
                              return_logprobs=True)
        solo.append((np.asarray(t)[0].tolist(), np.asarray(lp)[0]))
    return jeng, teng, prompts, solo


def _padded(prompts):
    width = max(len(p) for p in prompts)
    arr = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), bool)
    for i, p in enumerate(prompts):
        arr[i, width - len(p):] = p
        mask[i, width - len(p):] = True
    return arr, mask


# -- the one-shot engine -----------------------------------------------------


def test_cached_decode_matches_reference_and_full_recompute(engines):
    """Greedy tokens of the dense-cache engine equal the reference
    engine's and a full-prefix recompute through the port's
    `llama_moe.apply` at the dropless capacity, step by step."""
    jeng, teng, _, _ = engines
    prompt = np.random.default_rng(3).integers(
        0, jmodel.MIXTRAL_TINY.vocab_size, (2, 6)).astype(np.int32)
    want, wlp = jeng.generate(jnp.asarray(prompt), max_new=4,
                              return_logprobs=True)
    got, glp = teng.generate(prompt, max_new=4, return_logprobs=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(glp.numpy(), np.asarray(wlp), **LP_TOL)
    cfg = dataclasses.replace(tmodel.MIXTRAL_TINY, capacity_factor=DROPLESS)
    toks = torch.from_numpy(prompt).long()
    steps = []
    for _ in range(4):
        logits, _ = tmodel.apply(teng.params, cfg, toks)
        nxt = torch.argmax(logits[:, -1], -1)
        steps.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    np.testing.assert_array_equal(got.numpy(),
                                  torch.stack(steps, 1).int().numpy())


def test_padded_batch_matches_reference(engines):
    """A left-padded batch of mixed lengths: each row as the reference
    generates it."""
    jeng, teng, prompts, solo = engines
    arr, mask = _padded(prompts)
    wt, wl = jeng.generate(jnp.asarray(arr), prompt_mask=jnp.asarray(mask),
                           max_new=MAX_NEW, return_logprobs=True)
    gt, gl = teng.generate(arr, prompt_mask=mask, max_new=MAX_NEW,
                           return_logprobs=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LP_TOL)
    # and each row as its solo generation
    assert gt.numpy().tolist() == [t for t, _ in solo]


def test_row_alone_equals_row_among_batchmates_and_pads(engines):
    """At capacity T nothing drops, so a row's FFN output and its tokens
    do not depend on the other rows (pads and garbage rows included)."""
    _, teng, prompts, _ = engines
    cfg, p = teng.cfg, teng.layers[1]
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.standard_normal((3, 8, 128)).astype(np.float32))
    h[1, :3] = 0.0                          # a left-pad run
    h[2] = 1e3 * h[2]                       # a garbage row
    alone = _moe_serving_mlp(cfg, p, h[1:2, 3:])
    among = _moe_serving_mlp(cfg, p, h)[1:2, 3:]
    torch.testing.assert_close(among, alone, atol=1e-6, rtol=1e-6)
    row = prompts[1]
    t1, l1 = teng.generate([row], max_new=MAX_NEW, return_logprobs=True)
    arr, mask = _padded([prompts[3], row, prompts[0]])
    tb, lb = teng.generate(arr, prompt_mask=mask, max_new=MAX_NEW,
                           return_logprobs=True)
    assert tb[1].tolist() == t1[0].tolist()
    torch.testing.assert_close(lb[1], l1[0], atol=1e-5, rtol=1e-5)


# -- continuous batching ------------------------------------------------------


async def _serve(batcher, prompts):
    try:
        return await asyncio.gather(*(
            batcher.submit(p, MAX_NEW, with_logprobs=True) for p in prompts))
    finally:
        await batcher.close()


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_continuous_batcher_matches_solo_engine(engines, chunk_tokens):
    """The paged continuous batcher, monolithic admission (None) and
    chunked prefill at an 8-token budget, 4 prompts on 3 slots (a row
    waits, rows retire, chunked rows sit frozen while others decode):
    token-exact against the reference's solo engine."""
    _, teng, prompts, solo = engines
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=3,
                                kv_block_size=BS,
                                prefill_chunk_tokens=chunk_tokens, seed=0)
    got = asyncio.run(_serve(batcher, prompts))
    if chunk_tokens is None:
        assert batcher.prefills >= 1 and batcher.slices == 0
    else:
        assert batcher.slices == sum(-(-len(p) // chunk_tokens)
                                     for p in prompts)
    for (toks, lps), (wtoks, wlps) in zip(got, solo):
        assert list(toks) == wtoks
        np.testing.assert_allclose(lps, wlps, **LP_TOL)


@pytest.mark.parametrize("moe_role", ["target", "draft"])
def test_speculative_decoding_with_moe(engines, moe_role):
    """Continuous speculative decoding with the MoE model as the target
    (a llama-tiny draft) or as the draft (a llama-tiny target, head
    x50): greedy in, greedy out, so every sequence equals the target's
    solo greedy tokens."""
    _, teng, prompts, solo = engines
    ec = EngineConfig(max_len=MAX_LEN)
    llama_p = tllama.init(tllama.LLAMA_TINY, 5, "cpu")
    if moe_role == "target":
        target = teng
        draft = InferenceEngine(llama_p, tllama.LLAMA_TINY, LLAMA_FAMILY,
                                ec, device="cpu")
        want = [t for t, _ in solo]
    else:
        llama_p["lm_head"] = llama_p["lm_head"] * 50.0
        target = InferenceEngine(llama_p, tllama.LLAMA_TINY, LLAMA_FAMILY,
                                 ec, device="cpu")
        draft = teng
        want = [target.generate([p], max_new=MAX_NEW)[0].tolist()
                for p in prompts]
    batcher = ContinuousBatcher(target, asyncio.Lock(), max_slots=4,
                                kv_block_size=BS, draft=draft,
                                spec_gamma=3, seed=0)
    got = asyncio.run(_serve(batcher, prompts))
    assert batcher.spec_rounds > 0
    assert [list(t) for t, _ in got] == want


# -- the doors ---------------------------------------------------------------


@pytest.mark.parametrize("continuous", [False, True])
async def test_http_generate_and_models(engines, continuous,
                                        aiohttp_client):
    _, teng, prompts, solo = engines
    kw = (dict(continuous=True, kv_block_size=BS, prefill_chunk_tokens=4)
          if continuous else dict(batch_window_ms=5.0))
    client = await aiohttp_client(create_serving_app(
        {"mixtral-tiny": teng}, max_batch=2, **kw))
    bodies = await asyncio.gather(*(
        client.post("/v1/models/mixtral-tiny:generate",
                    json={"tokens": [p], "max_new": MAX_NEW,
                          "logprobs": True}) for p in prompts[:2]))
    for r, (want, wlp) in zip(bodies, solo):
        assert r.status == 200, await r.text()
        body = await r.json()
        assert body["tokens"] == [want]
        np.testing.assert_allclose(body["logprobs"][0], wlp, **LP_TOL)
    models = (await (await client.get("/v1/models")).json())["models"]
    assert models[0]["name"] == "mixtral-tiny"
    assert models[0]["family"] == "llama-moe"
    assert models[0]["num_layers"] == tmodel.MIXTRAL_TINY.num_layers


def test_cli_registry_names_the_reference_entry():
    jcfg, _, jfam = j_registry()["mixtral-tiny"]
    tcfg, init, tfam = cli.model_registry()["mixtral-tiny"]
    assert init is tmodel.init and tfam is MOE_LLAMA_FAMILY
    assert tfam.name == jfam.name == "llama-moe" and not tfam.scale_embed
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_cli_builds_mixtral_tiny_on_the_cpu():
    app = cli.build_app(cli.parse_args(
        ["--model", "mixtral-tiny", "--random", "--cpu", "--max-len", "64",
         "--continuous", "--spec-decode", "--draft-model", "llama-tiny"]))
    eng = app[ENGINES_KEY]["mixtral-tiny"]
    assert eng.family is MOE_LLAMA_FAMILY
    assert eng.params["blocks"]["w_gate"].shape == (2, 4, 128, 192)
    out = eng.generate([[3, 1, 4, 1, 5]], max_new=3)
    assert tuple(out.shape) == (1, 3)


def test_cli_refuses_mixtral_tiny_off_the_cpu():
    """Without --cpu the model is served on the card, whose kernels take
    head dims 128 and 256: mixtral-tiny's 32 is refused there as
    gemma-tiny's is; with no card the device is refused first."""
    args = cli.parse_args(["--model", "mixtral-tiny", "--random",
                           "--max-len", "512"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            cli.build_app(args)
        return
    eng = cli.build_app(args)[ENGINES_KEY]["mixtral-tiny"]
    with pytest.raises(ValueError, match="head_dim"):
        eng.generate([[3] * 300], max_new=2)


def test_refused_combinations_name_the_moe_family(engines, capsys):
    """What stays refused for the MoE family, by name: an adapter pack
    that targets the dense MLP (w_gate / w_up / w_down), which a routed
    FFN lacks. `--quant int8` and attention-only packs are served
    (below)."""
    _, teng, _, _ = engines
    args = cli.parse_args(["--model", "mixtral-tiny", "--random", "--cpu",
                           "--quant", "int8"])
    assert args.quant == "int8"
    assert "not ported" not in capsys.readouterr().err
    fake = AdapterPack(blocks={"wq": {}, "w_up": {}}, scaling=1.0,
                       names={"a": 1})
    with pytest.raises(ValueError, match=r"target \['w_up'\] are refused "
                                         "for the llama-moe family"):
        InferenceEngine(teng.params, teng.cfg, MOE_LLAMA_FAMILY,
                        device="cpu", adapter_pack=fake)


# -- int8 weights -------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_engines(engines):
    """The reference's int8 engine (its `quantize_blocks` of the x50
    weights) and the port's on the same weights, quantized by the port."""
    jeng, teng, _, _ = engines
    jq = JEngine(jquant.quantize_blocks(jeng.params), jeng.cfg, J_MOE,
                 JEngineConfig(max_len=MAX_LEN))
    tq = InferenceEngine(quantize_blocks(teng.params), teng.cfg,
                         MOE_LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
                         device="cpu")
    return jq, tq


def test_int8_blocks_match_reference_bit_for_bit(int8_engines):
    """Every block matmul weight, the [L, E, D, M] expert stacks among
    them, quantizes to the reference's q and scale; the router stays
    as it is; param bytes are the reference's `param_bytes`."""
    jq, tq = int8_engines
    for name in BLOCK_MATMUL_WEIGHTS:
        got, want = tq.params["blocks"][name], jq.params["blocks"][name]
        assert isinstance(got, QTensor), name
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.float().numpy(),
                                      np.asarray(want.scale, np.float32))
    assert tq.params["blocks"]["w_gate"].scale.shape == (2, 4, 1, 192)
    assert not isinstance(tq.params["blocks"]["router"], QTensor)
    assert param_bytes(tq.params) == jquant.param_bytes(jq.params)


def test_int8_generate_matches_reference(engines, int8_engines):
    """One-shot generate on a left-padded batch: greedy tokens equal to
    the reference's int8 engine, logprobs within LP_TOL."""
    _, _, prompts, _ = engines
    jq, tq = int8_engines
    arr, mask = _padded(prompts)
    wt, wl = jq.generate(jnp.asarray(arr), prompt_mask=jnp.asarray(mask),
                         max_new=MAX_NEW, return_logprobs=True)
    gt, gl = tq.generate(arr, prompt_mask=mask, max_new=MAX_NEW,
                         return_logprobs=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LP_TOL)


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_int8_continuous_matches_reference(engines, int8_engines,
                                           chunk_tokens):
    """The continuous batcher over the int8 MoE weights, monolithic and
    chunked: each row the reference's int8 solo generation."""
    _, _, prompts, _ = engines
    jq, tq = int8_engines
    got = asyncio.run(_serve(ContinuousBatcher(
        tq, asyncio.Lock(), max_slots=3, kv_block_size=BS,
        prefill_chunk_tokens=chunk_tokens, seed=0), prompts))
    for p, (toks, lps) in zip(prompts, got):
        wt, wl = jq.generate(jnp.asarray([p], jnp.int32), max_new=MAX_NEW,
                             return_logprobs=True)
        assert list(toks) == np.asarray(wt)[0].tolist()
        np.testing.assert_allclose(lps, np.asarray(wl)[0], **LP_TOL)


# -- attention-only adapter packs ---------------------------------------------

ATTN = ("wq", "wk", "wv", "wo")


def _lora_adapter(seed: int, lcfg):
    """A reference LoRA tree on MIXTRAL_TINY with B non-zero (a fresh
    init has B = 0: the base), the dense pack tests' recipe."""
    ad = j_init_lora(jax.random.key(seed), jmodel.MIXTRAL_TINY,
                     JLoraConfig(rank=lcfg.rank, targets=lcfg.targets))
    return {"blocks": {
        t: {"A": np.asarray(ab["A"]),
            "B": np.asarray(jax.random.normal(
                jax.random.key(seed + 99), ab["B"].shape) * 0.05)}
        for t, ab in ad["blocks"].items()}}


@pytest.fixture(scope="module")
def lora_engines(engines):
    """Both engines with one pack of two attention-only adapters (rank
    4), and the port's engines on each adapter's merged weights."""
    jeng, teng, _, _ = engines
    lcfg = LoraConfig(rank=4, targets=ATTN)
    jlcfg = JLoraConfig(rank=4, targets=ATTN)
    adapters = {"a": _lora_adapter(1, lcfg), "b": _lora_adapter(2, lcfg)}
    jpack = jbuild_pack(jeng.cfg, jlcfg, adapters)
    jl = JEngine(jeng.params, jeng.cfg, J_MOE,
                 JEngineConfig(max_len=MAX_LEN), adapter_pack=jpack)
    tl = InferenceEngine(teng.params, teng.cfg, MOE_LLAMA_FAMILY,
                         EngineConfig(max_len=MAX_LEN), device="cpu",
                         adapter_pack=build_pack(teng.cfg, lcfg, adapters))
    merged = {n: InferenceEngine(
        merge_lora(teng.params, a, lcfg), teng.cfg, MOE_LLAMA_FAMILY,
        EngineConfig(max_len=MAX_LEN), device="cpu")
        for n, a in adapters.items()}
    return jl, tl, merged


def test_attention_pack_generate_matches_reference(engines, lora_engines):
    """Per-row adapters in one batch (base, a, b): greedy tokens equal to
    the reference's engine with the same pack and to each merged
    oracle, logprobs within LP_TOL; the adapters move the tokens, and
    the zero adapter gives the base's."""
    _, teng, prompts, _ = engines
    jl, tl, merged = lora_engines
    p = prompts[1]
    names = ["", "a", "b"]
    gt, gl = tl.generate([p] * 3, max_new=MAX_NEW, adapter=names,
                         return_logprobs=True)
    wt, wl = jl.generate(jnp.asarray([p] * 3, jnp.int32), max_new=MAX_NEW,
                         adapter=names, return_logprobs=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LP_TOL)
    base = teng.generate([p], max_new=MAX_NEW)[0].tolist()
    assert gt[0].tolist() == base
    for i, n in enumerate(names[1:], 1):
        mt, ml = merged[n].generate([p], max_new=MAX_NEW,
                                    return_logprobs=True)
        assert gt[i].tolist() == mt[0].tolist()
        np.testing.assert_allclose(gl[i].numpy(), ml[0].numpy(), **LP_TOL)
    assert not np.allclose(gl[1].numpy(), gl[0].numpy(), atol=1e-3)


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_attention_pack_continuous_matches_reference(engines, lora_engines,
                                                     chunk_tokens):
    """The continuous batcher takes the engine's pack: concurrent base,
    a and b requests decode their adapters' reference tokens."""
    _, _, prompts, _ = engines
    jl, tl, _ = lora_engines
    reqs = list(zip(prompts, ["a", "", "b", "a"]))
    batcher = ContinuousBatcher(tl, asyncio.Lock(), max_slots=3,
                                kv_block_size=BS,
                                prefill_chunk_tokens=chunk_tokens, seed=0)

    async def serve():
        try:
            return await asyncio.gather(*(
                batcher.submit(p, MAX_NEW, {"adapter": a} if a else {},
                               with_logprobs=True) for p, a in reqs))
        finally:
            await batcher.close()

    for (p, a), (toks, lps) in zip(reqs, asyncio.run(serve())):
        wt, wl = jl.generate(jnp.asarray([p], jnp.int32), max_new=MAX_NEW,
                             adapter=a, return_logprobs=True)
        assert list(toks) == np.asarray(wt)[0].tolist(), a
        np.testing.assert_allclose(lps, np.asarray(wl)[0], **LP_TOL)
