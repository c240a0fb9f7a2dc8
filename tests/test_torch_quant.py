"""Weight-only int8 serving in the port (serving/quant.py, `qdot` and the
grouped `qdot_many` through both engines, the continuous and
speculative batchers and the CLI) against the JAX reference, on the
CPU.

- `quantize` repeats the reference's arithmetic (the scale rounded to
  bf16 first, then round-half-to-even of w / scale, clipped to +-127):
  on the same fp32 weights `q` and `scale` are bit-equal.
- The engines run the same bridged int8 weights: prefill logits within
  1e-5 of max|l| (fp32 on both sides, sums in another order), greedy
  tokens equal one-shot and in the continuous batcher (monolithic and
  chunked), on llama-tiny (lm_head x50) and gemma-tiny (final norm 49:
  argmax cannot flip on fp32 rounding, the reference tests' idiom);
  logprobs within 1e-3.
- The quantized model's prefill logits lie within 0.05 max|l| of full
  precision (the reference's own bound, tests/test_quant.py:65-66).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import quant as jquant
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops.cuda import int8_proj as ip
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving import quant
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
    transformer_block,
)
from kubeflow_tpu_torch.serving.multilora import lora_proj

MAX_LEN = 64
BS = 8
MAX_NEW = 5
LOGIT_REL = 1e-5
LP_ATOL = 1e-3

# family -> (reference module, config, family; port module, config,
# family)
MODELS = {
    "llama": (jllama, jllama.LLAMA_TINY, J_LLAMA, tllama, tllama.LLAMA_TINY,
              LLAMA_FAMILY),
    "gemma": (jgemma, jgemma.GEMMA_TINY, J_GEMMA, tgemma, tgemma.GEMMA_TINY,
              GEMMA_FAMILY),
}


def _sharpen(name, params):
    params = dict(params)
    if name == "llama":
        params["lm_head"] = params["lm_head"] * 50.0
    else:
        params["final_norm"] = jnp.full_like(params["final_norm"], 49.0)
    return params


def _np(tree):
    """A reference param tree as numpy, each QTensor leaf flattened to
    {"q", "scale"} (what `bridge.from_jax` takes)."""
    def leaf(x):
        if isinstance(x, jquant.QTensor):
            return {"q": np.asarray(x.q),
                    "scale": np.asarray(x.scale.astype(jnp.float32))}
        return np.asarray(x)

    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, jquant.QTensor))


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    """Both frameworks' engines on the same int8 weights (the reference's
    quantize_blocks, bridged), plus the full-precision port engine."""
    name = request.param
    jmod, jcfg, jfam, tmod, tcfg, tfam = MODELS[name]
    params = _sharpen(name, jmod.init(jax.random.key(0), jcfg))
    qparams = jquant.quantize_blocks(params)
    jeng = JEngine(qparams, jcfg, jfam, JEngineConfig(max_len=MAX_LEN))
    ec = EngineConfig(max_len=MAX_LEN)
    teng = InferenceEngine(bridge.from_jax(_np(qparams), tcfg, "cpu"), tcfg,
                           tfam, ec, device="cpu")
    full = InferenceEngine(bridge.from_jax(_np(params), tcfg, "cpu"), tcfg,
                           tfam, ec, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (4, 7, 12, 20)]
    return name, jeng, teng, full, params, prompts


# -- the module --------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_is_bit_equal_to_the_reference(name):
    jmod, jcfg, *_ = MODELS[name]
    params = jmod.init(jax.random.key(3), jcfg)
    tblocks = {k: torch.from_numpy(np.array(params["blocks"][k], np.float32))
               for k in quant.BLOCK_MATMUL_WEIGHTS}
    got = quant.quantize_blocks({"blocks": tblocks})["blocks"]
    for k in quant.BLOCK_MATMUL_WEIGHTS:
        assert params["blocks"][k].dtype == jnp.float32
        want = jquant.quantize(params["blocks"][k])
        assert got[k].q.dtype == torch.int8
        assert got[k].scale.dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(
            got[k].scale.float().numpy(),
            np.asarray(want.scale.astype(jnp.float32)))
        # the layer-by-layer quantize is the whole-leaf one
        whole = quant.quantize(tblocks[k])
        assert torch.equal(whole.q, got[k].q)
        assert torch.equal(whole.scale, got[k].scale)


@pytest.fixture(scope="module")
def tiny_params():
    return tllama.init(tllama.LLAMA_TINY, 0, "cpu")


def test_quantize_roundtrip_error_bound(tiny_params):
    """Round-to-nearest symmetric int8: per-element error <= scale / 2
    (x 1.01: the bf16 scale's slack), |q| <= 127."""
    w = tiny_params["blocks"]["w_gate"]   # [L, D, I]
    qt = quant.quantize(w)
    assert qt.q.dtype == torch.int8 and qt.q.shape == w.shape
    assert tuple(qt.scale.shape) == (w.shape[0], 1, w.shape[2])
    err = (qt.to(torch.float32) - w.float()).abs()
    assert (err <= qt.scale.float() / 2 * 1.01).all()
    assert int(qt.q.abs().max()) <= 127


def test_quantized_blocks_structure_and_bytes(tiny_params):
    params = tiny_params
    qp = quant.quantize_blocks(params)
    for name in quant.BLOCK_MATMUL_WEIGHTS:
        assert isinstance(qp["blocks"][name], quant.QTensor), name
    assert qp["embed"] is params["embed"]
    assert qp["blocks"]["attn_norm"] is params["blocks"]["attn_norm"]
    full = sum(params["blocks"][n].numel() * 4
               for n in quant.BLOCK_MATMUL_WEIGHTS)
    packed = sum(qp["blocks"][n].nbytes for n in quant.BLOCK_MATMUL_WEIGHTS)
    assert packed < 0.3 * full
    assert quant.param_bytes(qp) < quant.param_bytes(params)
    # exact books: int8 weights plus a bf16 scale per output channel
    w = params["blocks"]["wq"]
    assert qp["blocks"]["wq"].nbytes == (w.numel()
                                         + 2 * w.shape[0] * w.shape[2])


def test_qtensor_layer_views_and_qdot(tiny_params):
    """A stacked leaf's layer is a QTensor of views; qdot of a plain
    tensor is today's product, of a QTensor the reference's right-hand
    form (the kernel's plain version on a CPU tensor)."""
    qt = quant.quantize(tiny_params["blocks"]["wo"])
    layer = qt[1]
    assert layer.q.data_ptr() == qt.q[1].data_ptr()
    assert layer.scale.data_ptr() == qt.scale[1].data_ptr()
    assert tuple(layer.scale.shape) == (1, qt.shape[-1])
    h = torch.randn(2, 3, qt.shape[1], generator=torch.Generator()
                    .manual_seed(0))
    w = tiny_params["blocks"]["wo"][1]
    assert torch.equal(quant.qdot(h, w, torch.float32), h @ w)
    before = ip.launches
    got = quant.qdot(h, layer, torch.float32)
    assert ip.launches == before    # the plain version: no launch
    want = jquant.qdot(jnp.asarray(h.numpy()),
                       jquant.QTensor(jnp.asarray(layer.q.numpy()),
                                      jnp.asarray(layer.scale.float()
                                                  .numpy(), jnp.bfloat16)),
                       jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got, h @ layer.to(torch.float32))


@pytest.mark.parametrize("names", [("wq", "wk", "wv"), ("w_gate", "w_up"),
                                   ("w_down",)])
def test_qdot_many_is_qdot_bit_for_bit(tiny_params, names):
    """The grouped products of one h equal each weight's qdot bit for
    bit: all QTensors (one int8_proj_many call), plain weights, and a
    mix; on the CPU no launch is counted."""
    qts = [quant.quantize(tiny_params["blocks"][n])[1] for n in names]
    plain = [tiny_params["blocks"][n][1] for n in names]
    h = torch.randn(2, 3, qts[0].shape[0],
                    generator=torch.Generator().manual_seed(1))
    for ws in (qts, plain, qts[:1] + plain[1:]):
        before = ip.launches
        got = quant.qdot_many(h, ws, torch.float32)
        assert ip.launches == before
        assert len(got) == len(ws)
        for y, w in zip(got, ws):
            assert torch.equal(y, quant.qdot(h, w, torch.float32))


def _block(eng, proj):
    """Layer 0 of `eng` on a fixed x, attention stubbed to the identity
    on q (the products are what is held here)."""
    cfg = eng.cfg
    x = torch.randn(2, 5, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(2))
    pos = torch.arange(5).expand(2, 5)
    out, _ = transformer_block(cfg, eng.family, eng.layers[0], x, pos,
                               eng._inv_freq, lambda k, v: (k, v),
                               lambda q, kc, vc: q, proj)
    return out


def test_block_groups_the_products_of_one_h(models):
    """transformer_block hands `proj` the products that read one h
    together, four calls a layer ((wq, wk, wv), (wo,), (w_gate, w_up),
    (w_down,)), and the grouped block equals one that takes each product
    alone, bit for bit, over int8 and full-precision weights."""
    _, _, teng, full, _, _ = models
    for eng in (teng, full):
        calls = []

        def grouped(names, h, ws, dt=eng.cfg.dtype):
            calls.append(tuple(names))
            return quant.qdot_many(h, ws, dt)

        def alone(names, h, ws, dt=eng.cfg.dtype):
            return [quant.qdot(h, w, dt) for w in ws]

        got = _block(eng, grouped)
        assert calls == [("wq", "wk", "wv"), ("wo",), ("w_gate", "w_up"),
                         ("w_down",)]
        assert torch.equal(got, _block(eng, alone))
        assert torch.equal(got, _block(eng, None))   # the default proj


def test_grouped_lora_proj_is_each_product_plus_its_delta(models):
    """The grouped lora_proj: each base product as qdot makes it, plus
    its target's per-row delta; a weight without an adapter keeps the
    base product."""
    _, _, teng, _, _, _ = models
    cfg, layer = teng.cfg, teng.layers[0]
    gen = torch.Generator().manual_seed(3)
    r = 4
    pack = {n: {"A": torch.randn(3, cfg.hidden_size, r, generator=gen),
                "B": torch.randn(3, r, layer[n].shape[-1], generator=gen)}
            for n in ("wq", "w_up")}
    ids = torch.tensor([2, 0])
    h = torch.randn(2, 5, cfg.hidden_size, generator=gen)
    proj = lora_proj(pack, ids, 2.0, cfg)
    for names in (("wq", "wk", "wv"), ("w_gate", "w_up")):
        ws = [layer[n] for n in names]
        got = proj(names, h, ws)
        for name, w, y in zip(names, ws, got):
            want = quant.qdot(h, w, cfg.dtype)
            if name in pack:
                a = pack[name]["A"][ids].to(cfg.dtype)
                b = pack[name]["B"][ids].to(cfg.dtype)
                want = want + torch.tensor(2.0, dtype=cfg.dtype) * torch.bmm(
                    torch.bmm(h.to(cfg.dtype), a), b)
            assert torch.equal(y, want)


def test_bridge_carries_int8_leaves_exactly(models):
    """The reference's QTensor leaves cross the bridge bit for bit, and
    the port's quantize of the bridged full-precision weights gives the
    same leaves."""
    name, jeng, teng, full, params, _ = models
    ported = quant.quantize_blocks(full.params)
    for k in quant.BLOCK_MATMUL_WEIGHTS:
        got = teng.params["blocks"][k]
        assert isinstance(got, quant.QTensor)
        np.testing.assert_array_equal(got.q.numpy(),
                                      np.asarray(jeng.params["blocks"][k].q))
        assert torch.equal(got.q, ported["blocks"][k].q)
        assert torch.equal(got.scale, ported["blocks"][k].scale)


# -- the engines -------------------------------------------------------------


def test_quantized_prefill_logits_match_reference(models):
    name, jeng, teng, _, _, prompts = models
    arr = np.asarray([prompts[2]], np.int32)
    want, _ = jeng._forward_cached(jeng.params, jnp.asarray(arr),
                                   jeng.init_state(1))
    got, _ = teng._forward_cached(torch.from_numpy(arr).long(),
                                  teng.init_state(1))
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= LOGIT_REL * np.abs(want).max(), err


def test_quantized_logits_close_to_full_precision(models):
    """The reference's bound: int8 prefill logits within 0.05 max|l| of
    full precision."""
    name, _, teng, full, _, _ = models
    arr = torch.from_numpy(np.random.default_rng(0).integers(
        0, teng.cfg.vocab_size, (2, 12))).long()
    lf, _ = full._forward_cached(arr, full.init_state(2))
    lq, _ = teng._forward_cached(arr, teng.init_state(2))
    scale = lf.abs().max()
    assert (lq - lf).abs().max() < 0.05 * scale
    assert not torch.equal(lq, lf)   # the weights really are int8


def test_quantized_generate_matches_reference(models):
    """One-shot generate on a left-padded batch of mixed lengths."""
    name, jeng, teng, _, _, prompts = models
    width = max(len(p) for p in prompts)
    arr = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), bool)
    for i, p in enumerate(prompts):
        arr[i, width - len(p):] = p
        mask[i, width - len(p):] = True
    wt, wl = jeng.generate(jnp.asarray(arr), prompt_mask=jnp.asarray(mask),
                           max_new=MAX_NEW, return_logprobs=True)
    gt, gl = teng.generate(arr, prompt_mask=mask, max_new=MAX_NEW,
                           return_logprobs=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LP_ATOL)


async def _serve(batcher, prompts):
    try:
        return await asyncio.gather(*(
            batcher.submit(p, MAX_NEW, (), with_logprobs=True)
            if isinstance(batcher, JBatcher) else
            batcher.submit(p, MAX_NEW, with_logprobs=True)
            for p in prompts))
    finally:
        await batcher.close()


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_quantized_continuous_matches_reference(models, chunk_tokens):
    """The continuous batcher over int8 weights, monolithic (None) and
    chunked at an 8-token budget, against the reference's batcher in the
    same mode on the same weights."""
    name, jeng, teng, _, _, prompts = models
    want = asyncio.run(_serve(JBatcher(
        jeng, asyncio.Lock(), max_slots=4, kv_block_size=BS,
        prefill_chunk_tokens=chunk_tokens, paged_attention_impl="xla"),
        prompts))
    got = asyncio.run(_serve(ContinuousBatcher(
        teng, asyncio.Lock(), max_slots=4, kv_block_size=BS,
        prefill_chunk_tokens=chunk_tokens, seed=0), prompts))
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        assert toks == list(wtoks)
        np.testing.assert_allclose(lps, wlps, atol=LP_ATOL)


def test_speculative_batcher_with_an_int8_target(models):
    """Continuous speculative decoding verifies through the int8 target
    (the draft stays full precision, as the CLI leaves it): greedy tokens
    equal the target's own."""
    name, _, teng, full, _, prompts = models
    want = [teng.generate([p], max_new=MAX_NEW)[0].tolist()
            for p in prompts]
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=4,
                                kv_block_size=BS, prefill_chunk_tokens=8,
                                draft=full, spec_gamma=3, seed=0)
    got = asyncio.run(_serve(batcher, prompts))
    assert [list(t) for t, _ in got] == want
    assert batcher.spec_rounds > 0


# -- the CLI and reload ------------------------------------------------------


def test_cli_quant_int8_serves_and_reloads_in_place():
    """`--quant int8 --cpu`: every block matrix is int8; `/v1/reload` of a
    seed quantizes as boot does and copies q and scale into the live
    tensors (every data_ptr kept); the tokens after it are a fresh int8
    engine's at that seed; a full-precision tree is refused (400) and
    changes nothing."""
    args = cli.parse_args(["--model", "llama-tiny", "--random", "--cpu",
                           "--quant", "int8", "--continuous", "--max-len",
                           str(MAX_LEN), "--max-batch", "2"])
    app = cli.build_app(args)
    eng = app[server.ENGINES_KEY]["llama-tiny"]
    for k in quant.BLOCK_MATMUL_WEIGHTS:
        assert isinstance(eng.params["blocks"][k], quant.QTensor)
        assert eng.params["blocks"][k].q.dtype == torch.int8
    ptrs = {n: t.data_ptr()
            for n, t in server.param_leaves(eng.params).items()}
    cfg = tllama.LLAMA_TINY
    fresh = InferenceEngine(quant.quantize_blocks(tllama.init(cfg, 3, "cpu")),
                            cfg, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
                            device="cpu")
    prompt = [3, 5, 7, 11, 13, 17]
    want = fresh.generate([prompt], max_new=6)[0].tolist()
    cli_reload = app[server.RELOADER_KEY]
    plain = []   # set: the next reload brings a full-precision tree

    def reloader(name, engine, source):
        if plain:
            return tllama.init(cfg, 4, "cpu")
        return cli_reload(name, engine, source)

    app[server.RELOADER_KEY] = reloader

    async def script():
        async with TestClient(TestServer(app)) as client:
            r = await client.post("/v1/reload", json={
                "version": "v2", "source": {"seed": 3}})
            assert r.status == 200, await r.text()
            r = await client.post("/v1/models/llama-tiny:generate",
                                  json={"tokens": [prompt], "max_new": 6})
            toks = (await r.json())["tokens"][0]
            plain.append(True)
            r = await client.post("/v1/reload", json={
                "version": "v3", "source": {"seed": 4}})
            return toks, r.status, await r.json()

    toks, status, body = asyncio.run(script())
    assert toks == want
    assert status == 400 and "incompatible weights" in body["error"]
    for k in quant.BLOCK_MATMUL_WEIGHTS:
        assert isinstance(eng.params["blocks"][k], quant.QTensor)
        assert torch.equal(eng.params["blocks"][k].q,
                           fresh.params["blocks"][k].q)
    assert {n: t.data_ptr()
            for n, t in server.param_leaves(eng.params).items()} == ptrs
    assert all(isinstance(layer["wq"], quant.QTensor)
               and layer["wq"].q.data_ptr() == eng.params["blocks"]["wq"]
               .q[i].data_ptr() for i, layer in enumerate(eng.layers))


def test_cli_quant_flag_parses():
    assert cli.parse_args(["--random"]).quant == ""
    with pytest.raises(SystemExit):
        cli.parse_args(["--random", "--quant", "int4"])
