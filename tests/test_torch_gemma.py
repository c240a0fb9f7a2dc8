"""The port's Gemma family against the JAX reference, on the CPU.

Two configs: the reference's GEMMA_TINY (4 heads of 32, one kv head)
and a narrow head-dim-256 config with gemma-2b's head geometry (8 query
heads, one kv head, head dim 256) at hidden 256, so that q_dim (2048)
differs from hidden. The reference's weights (`gemma.init`) reach the
port through `bridge.from_jax`, the tokens come from numpy seeds.

Tolerances:
- fp32 logits: atol = rtol = 1e-4, two layers of fp32 matmuls whose
  sums run in another order in each framework.
- bf16 logits: |err| <= 0.02 max|ref|. Both frameworks round the
  activations to bf16 after each matmul, norm and the embedding scale,
  but XLA and PyTorch order the fp32 work inside each differently, so
  an element may round to the neighbouring bf16 value (2^-8 of
  itself), and two layers carry that into the logits: 1.8e-3 to
  2.7e-3 of max|ref| over seeds 1-3 of both configs, so the bound
  sits 7x above the worst reading. The rounding point of the
  embedding scale is pinned exactly by its own test (45.25 at hidden
  2048).
- served tokens: identical greedy tokens; logprobs within 1e-3 + 1e-4
  |ref|. The final norm is set to 49 on both sides ((1 + w) = 50, the
  reference's x50-head idiom for a tied head), so greedy argmax cannot
  flip on fp32 rounding, and logits in the hundreds differ by ~1e-5 of
  themselves.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving.__main__ import model_registry as j_registry
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
)
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.server import ENGINES_KEY

FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 0.02
LP_TOL = dict(atol=1e-3, rtol=1e-4)
BS = 8
MAX_LEN = 96
MAX_NEW = 5

_HD256 = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=8, num_kv_heads=1, head_dim=256)
# name -> (reference config, port config)
CFGS = {
    "tiny": (jgemma.GEMMA_TINY, tgemma.GEMMA_TINY),
    "hd256": (dataclasses.replace(jgemma.GEMMA_TINY, **_HD256),
              dataclasses.replace(tgemma.GEMMA_TINY, **_HD256)),
}


def _params(name, seed=0, final_norm=None):
    """The reference's init for config `name` (numpy leaves), and the
    same weights in the port."""
    jcfg, tcfg = CFGS[name]
    params = dict(jgemma.init(jax.random.key(seed), jcfg))
    if final_norm is not None:
        params["final_norm"] = jnp.full_like(params["final_norm"],
                                             final_norm)
    return params, bridge.from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("variant", [{}, {"sliding_window": 5}])
@pytest.mark.parametrize("name", list(CFGS))
def test_logits_match_reference(name, variant):
    jcfg, tcfg = (dataclasses.replace(c, **variant) for c in CFGS[name])
    params, tparams = _params(name)
    toks = _tokens(0, 2, 12)
    want = jgemma.apply(params, jcfg, jnp.asarray(toks))
    got = tgemma.apply(tparams, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("name", list(CFGS))
def test_bf16_logits_match_reference(name):
    jcfg, tcfg = CFGS[name]
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params, _ = _params(name, seed=1)
    tparams = bridge.from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    assert tparams["blocks"]["wq"].dtype == torch.bfloat16
    toks = _tokens(1, 2, 10)
    want = np.asarray(jgemma.apply(params, jcfg, jnp.asarray(toks)))
    got = tgemma.apply(tparams, tcfg, torch.from_numpy(toks)).numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


def test_embed_scale_is_rounded_to_the_activation_dtype():
    """sqrt(2048) = 45.2548... becomes 45.25 in bf16 before the
    multiply, as the reference's jnp.asarray(..., cfg.dtype) makes it;
    the serving engines' embeddings agree exactly at hidden 2048."""
    assert float(jnp.asarray(2048**0.5, jnp.bfloat16)) == 45.25
    assert tgemma.embed_scale(tgemma.GEMMA_2B).item() == 45.25
    jcfg = dataclasses.replace(jgemma.GEMMA_TINY, hidden_size=2048,
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tgemma.GEMMA_TINY, hidden_size=2048,
                               dtype=torch.bfloat16)
    params = jgemma.init(jax.random.key(5), jcfg)
    toks = _tokens(5, 2, 6)
    want = JEngine(params, jcfg, J_GEMMA)._embed(params, jnp.asarray(toks))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"),
        tcfg, GEMMA_FAMILY, device="cpu")
    got = teng._embed(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_bridge_dtypes_and_shapes():
    params, _ = _params("hd256", seed=2)
    cfg = dataclasses.replace(CFGS["hd256"][1], dtype=torch.bfloat16)
    tparams = bridge.from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    shapes = tgemma.param_shapes(cfg)
    assert "lm_head" not in tparams
    assert set(tparams) == set(shapes)
    assert tparams["embed"].dtype == torch.float32
    assert tuple(tparams["embed"].shape) == shapes["embed"]
    assert tparams["final_norm"].dtype == torch.float32
    for name, shape in shapes["blocks"].items():
        leaf = tparams["blocks"][name]
        assert tuple(leaf.shape) == shape
        want = torch.bfloat16 if name in tgemma.MATRICES else torch.float32
        assert leaf.dtype == want, name
    # q_dim != hidden: wq is [L, 256, 2048], wo [L, 2048, 256]
    assert shapes["blocks"]["wq"] == (2, 256, 2048)
    back = bridge.to_numpy(bridge.from_jax(
        jax.tree.map(np.asarray, params), CFGS["hd256"][1], "cpu"))
    np.testing.assert_array_equal(back["blocks"]["w_down"],
                                  np.asarray(params["blocks"]["w_down"]))


def test_seeded_init_is_repeatable_and_shaped():
    cfg = CFGS["hd256"][1]
    a = tgemma.init(cfg, 3, "cpu")
    b = tgemma.init(cfg, 3, "cpu")
    c = tgemma.init(cfg, 4, "cpu")
    assert "lm_head" not in a
    assert torch.equal(a["blocks"]["wo"], b["blocks"]["wo"])
    assert not torch.equal(a["blocks"]["wo"], c["blocks"]["wo"])
    for name, shape in tgemma.param_shapes(cfg)["blocks"].items():
        assert tuple(a["blocks"][name].shape) == shape
    # the reference's fan-in scaling: truncated N(0,1) * fan_in**-0.5
    w = a["blocks"]["wo"]
    assert abs(float(w.std()) * cfg.q_dim**0.5 - 0.88) < 0.05
    assert torch.count_nonzero(a["blocks"]["attn_norm"]) == 0
    assert torch.count_nonzero(a["final_norm"]) == 0
    # gemma-2b's tree, leaf by leaf, as the reference's init shapes it
    want = jax.eval_shape(lambda: jgemma.init(jax.random.key(0),
                                              jgemma.GEMMA_2B))
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        tgemma.param_shapes(tgemma.GEMMA_2B)


# -- serving -----------------------------------------------------------------


@pytest.fixture(scope="module", params=list(CFGS))
def engines(request):
    """Both frameworks' engines on the same weights, final norm x50."""
    name = request.param
    jcfg, tcfg = CFGS[name]
    params, tparams = _params(name, final_norm=49.0)
    jeng = JEngine(params, jcfg, J_GEMMA, JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(tparams, tcfg, GEMMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (4, 7, 12, 20)]
    return jeng, teng, prompts


def test_generate_matches_reference(engines):
    """One-shot `generate` on a left-padded batch of mixed lengths."""
    jeng, teng, prompts = engines
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
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LP_TOL)


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
def test_continuous_batcher_matches_reference(engines, chunk_tokens):
    """Continuous batching over paged KV, monolithic admission (None)
    and chunked prefill at an 8-token budget, against the reference's
    batcher in the same mode."""
    jeng, teng, prompts = engines

    async def run_ref():
        return await _serve(JBatcher(
            jeng, asyncio.Lock(), max_slots=4, kv_block_size=BS,
            prefill_chunk_tokens=chunk_tokens, paged_attention_impl="xla"),
            prompts)

    want = asyncio.run(run_ref())
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=4,
                                kv_block_size=BS,
                                prefill_chunk_tokens=chunk_tokens, seed=0)
    got = asyncio.run(_serve(batcher, prompts))
    if chunk_tokens is None:
        assert batcher.prefills >= 1 and batcher.slices == 0
    else:
        assert batcher.slices == sum(-(-len(p) // chunk_tokens)
                                     for p in prompts)
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        assert list(toks) == list(wtoks)
        np.testing.assert_allclose(lps, wlps, **LP_TOL)


def test_kv_bytes_match_reference(engines):
    """One kv head of 256 (or 32) per layer: the dense cache's and a
    pool block's bytes as the reference counts them."""
    jeng, teng, _ = engines
    for batch, cells in ((1, None), (8, 64), (3, 17)):
        assert teng.kv_cache_bytes(batch, cells) == \
            jeng.kv_cache_bytes(batch, cells)
    want = JCEngine(jeng, max_slots=2, block_size=BS).kv_block_bytes()
    assert ContinuousEngine(teng, max_slots=2,
                            block_size=BS).kv_block_bytes() == want
    cfg = teng.cfg
    assert want == 2 * cfg.num_layers * BS * cfg.head_dim * 4


# -- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma-tiny", "gemma-2b"])
def test_cli_registry_names_the_reference_gemma_entries(name):
    jcfg, _, jfam = j_registry()[name]
    tcfg, init, tfam = cli.model_registry()[name]
    assert init is tgemma.init and tfam is GEMMA_FAMILY
    assert tfam.name == jfam.name == "gemma" and tfam.scale_embed
    fields = [f.name for f in dataclasses.fields(jcfg)]
    assert fields == [f.name for f in dataclasses.fields(tcfg)]
    for f in fields:
        if f not in ("dtype", "param_dtype"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name


def test_cli_builds_gemma_tiny_on_the_cpu():
    app = cli.build_app(cli.parse_args(
        ["--model", "gemma-tiny", "--random", "--cpu", "--max-len", "64"]))
    eng = app[ENGINES_KEY]["gemma-tiny"]
    assert eng.family is GEMMA_FAMILY and "lm_head" not in eng.params
    out = eng.generate([[3, 1, 4, 1, 5]], max_new=3)
    assert tuple(out.shape) == (1, 3)
