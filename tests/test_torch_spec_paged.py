"""The port's continuous speculative decoding against the JAX reference,
on the CPU (the counterpart of tests/test_spec_paged.py).

The reference's weights (`init`, lm_head x50 for llama so that greedy
argmax cannot flip on fp32 rounding; gemma's tied head through a final
norm of 49, the same idiom) reach the port through `bridge.from_jax`;
prompts come from numpy seeds. A draft from another seed disagrees with
the target (acceptance near 0), so every round takes the rejection and
rollback path; a self-draft accepts everything. Greedy in = greedy out:
every served sequence must equal the reference's solo `generate`
exactly, and the reference's speculative batcher too, with logprobs
within 1e-4 (fp32, sums in another order).

The acceptance arithmetic (`spec_accept`, `spec_emit`) is held to the
reference's `ContinuousEngine.spec_verify` on the reference's own
inputs: its target distributions, draft distributions and drafted
tokens, and its uniforms (`jax.random.split(rng, 3)[1]`, as in
kubeflow_tpu/serving/continuous.py:1130). k and the accepted prefix must
be equal, the residual or bonus distribution within 1e-6 of the
reference's formula, the reference's own Gumbel draw from it must give
its emitted token, and the logprobs must be within 1e-5.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import __main__ as jcli
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu.serving.engine import SamplingParams as JSamplingParams
from kubeflow_tpu.serving.speculative import _dist as jdist
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
    spec_accept,
    spec_emit,
)
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_LEN = 96
LP_TOL = dict(atol=1e-4, rtol=1e-4)
# gemma-tiny with a sliding window shorter than the prompts, so that the
# window bites in the verify pass
GEMMA_WINDOW = 16


def _pair(family="llama", seed=0, max_len=MAX_LEN, eos=None):
    """(reference engine, port engine) on the same weights."""
    if family == "llama":
        jcfg, tcfg = jllama.LLAMA_TINY, tllama.LLAMA_TINY
        params = dict(jllama.init(jax.random.key(seed), jcfg))
        params["lm_head"] = params["lm_head"] * 50.0  # argmax can't flip
        jfam, tfam = J_LLAMA, LLAMA_FAMILY
    else:
        jcfg = dataclasses.replace(jgemma.GEMMA_TINY,
                                   sliding_window=GEMMA_WINDOW)
        tcfg = dataclasses.replace(tgemma.GEMMA_TINY,
                                   sliding_window=GEMMA_WINDOW)
        params = dict(jgemma.init(jax.random.key(seed), jcfg))
        # (1 + w) = 50 on the tied head: argmax can't flip
        params["final_norm"] = jnp.full_like(params["final_norm"], 49.0)
        jfam, tfam = J_GEMMA, GEMMA_FAMILY
    jeng = JEngine(params, jcfg, jfam,
                   JEngineConfig(max_len=max_len, eos_token=eos))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"),
        tcfg, tfam, EngineConfig(max_len=max_len, eos_token=eos),
        device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def llama():
    """target (seed 0) and a disagreeing draft (seed 5), both
    frameworks."""
    (jt, tt), (jd, td) = _pair(seed=0), _pair(seed=5)
    return jt, tt, jd, td


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _solo(jeng, prompt, max_new):
    return np.asarray(jeng.generate(jnp.asarray([prompt], jnp.int32),
                                    max_new=max_new))[0].tolist()


def _port(engine, draft=None, gamma=4, **kw):
    return ContinuousBatcher(engine, asyncio.Lock(), max_slots=4,
                             kv_block_size=BS, draft=draft,
                             spec_gamma=gamma, seed=0, **kw)


def _ref(engine, draft=None, gamma=4, **kw):
    return JBatcher(engine, asyncio.Lock(), max_slots=4, kv_block_size=BS,
                    draft=draft, spec_gamma=gamma,
                    paged_attention_impl="xla", **kw)


async def _submit_all(batcher, prompts, max_new):
    """-> [(tokens, logprobs)] of prompts submitted at once; closes."""
    ref = isinstance(batcher, JBatcher)
    try:
        out = await asyncio.gather(*(
            batcher.submit(p, max_new, () if ref else None,
                           with_logprobs=True) for p in prompts))
        return [(list(t), list(lp)) for t, lp in out]
    finally:
        await batcher.close()


def _serve(batcher, prompts, max_new):
    return asyncio.run(_submit_all(batcher, prompts, max_new))


def _assert_parity(got, want, solo):
    for (toks, lps), (wtoks, wlps), stoks in zip(got, want, solo):
        assert toks == wtoks == stoks
        np.testing.assert_allclose(lps, wlps, **LP_TOL)


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_spec_parity_across_gamma_llama(llama, gamma):
    """A draft that disagrees with the target takes the rejection and
    rollback path every round: the served tokens are still the solo
    oracle's and the reference spec batcher's, for any gamma."""
    jt, tt, jd, td = llama
    prompts = _prompts(4, (4, 7, 12, 20))
    solo = [_solo(jt, p, 6) for p in prompts]
    want = _serve(_ref(jt, jd, gamma), prompts, 6)
    b = _port(tt, td, gamma)
    got = _serve(b, prompts, 6)
    _assert_parity(got, want, solo)
    assert b.spec_proposed > 0 and b.spec_rounds > 0
    assert b.spec_accepted <= b.spec_proposed
    assert b.spec_proposed % gamma == 0


def test_spec_self_draft_accepts_everything(llama):
    """Draft == target, greedy: the ratio test accepts every proposal,
    so each round advances gamma + 1 tokens (the k == gamma branch of
    the draft rollback)."""
    jt, tt, _, _ = llama
    prompts = _prompts(7, (5, 9))
    solo = [_solo(jt, p, 9) for p in prompts]
    b = _port(tt, tt, 4)
    got = _serve(b, prompts, 9)
    assert [t for t, _ in got] == solo
    assert b.spec_accepted == b.spec_proposed > 0
    # first token from the prefill, then two rounds of 5 cover 8 more
    assert b.spec_rounds == 2


def test_spec_parity_gemma():
    """The other family: GQA 4:1 and a 16-token sliding window through
    the verify pass and the draft's dense decode."""
    (jt, tt), (jd, td) = _pair("gemma", seed=1), _pair("gemma", seed=8)
    prompts = _prompts(9, (7, 11, 20, 30))
    solo = [_solo(jt, p, 6) for p in prompts]
    got = _serve(_port(tt, td, 3), prompts, 6)
    assert [t for t, _ in got] == solo
    plain = _serve(_port(tt), prompts, 6)
    for (_, lps), (_, plps) in zip(got, plain):
        np.testing.assert_allclose(lps, plps, **LP_TOL)


def test_spec_eos_mid_window(llama):
    """EOS in the middle of an accepted window stops the row as plain
    decode does: the window's tail is dropped with the retired slot."""
    jt, _, _, _ = llama
    prompt = [3, 5, 7, 11]
    trace = _solo(jt, prompt, 8)
    jeos, teos = _pair(seed=0, eos=trace[2])
    want = _serve(_ref(jeos), [prompt], 8)
    plain = _serve(_port(teos), [prompt], 8)
    b = _port(teos, teos, 4)
    spec = _serve(b, [prompt], 8)
    assert spec[0][0] == plain[0][0] == want[0][0]
    assert spec[0][0][:3] == trace[:3]
    assert len([t for t in spec[0][0] if t != trace[2]]) < 8
    # self-draft: the first round accepts 4, emits 5, keeps 2
    assert b.spec_rounds == 1 and b.tokens_dropped == 3


@pytest.mark.parametrize("prefill_chunk_tokens", [None, 3])
def test_spec_composes_with_admission(llama, prefill_chunk_tokens):
    """Monolithic admission (the default) and chunked prefill: a chunked
    request joins the rounds once its last slice is fed (a frozen row
    rides along in the verify pass without moving), token-exact."""
    jt, tt, jd, td = llama
    prompts = _prompts(11, (4, 9, 26))
    solo = [_solo(jt, p, 6) for p in prompts]
    want = _serve(_ref(jt, jd, 2, prefill_chunk_tokens=prefill_chunk_tokens),
                  prompts, 6)
    b = _port(tt, td, 2, prefill_chunk_tokens=prefill_chunk_tokens)
    got = _serve(b, prompts, 6)
    _assert_parity(got, want, solo)
    if prefill_chunk_tokens:
        assert b.slices == sum(-(-len(p) // 3) for p in prompts)
    else:
        assert b.prefills >= 1 and b.slices == 0


def test_spec_radix_reuse_after_rounds(llama):
    """Blocks donated after speculative rounds hold the accepted tokens'
    KV only (rejected cells above the cursor never enter the tree): the
    repeated prompt hits the cache with the same tokens, and a prompt
    that continues a served sequence seeds from blocks the verify pass
    wrote and still gives the solo oracle's tokens."""
    jt, tt, jd, td = llama
    (p,) = _prompts(13, (20,))

    async def run(b):
        try:
            first, _ = await b.submit(p, 30, with_logprobs=True)
            again = await b.submit(p, 30)
            cont = await b.submit(p + list(first), 6)
            return list(first), list(again), list(cont)
        finally:
            await b.close()

    b = _port(tt, td, 3)
    first, again, cont = asyncio.run(run(b))
    assert first == again == _solo(jt, p, 30)
    assert cont == _solo(jt, p + first, 6)
    assert b.prefix_hits == 2
    # the repeat seeds all but its last prompt cell; the continuation
    # every full block the first request donated (cells below 49)
    assert b.tokens_reused == (20 - 1) + 48
    assert b.cache_anatomy()["ledger"]["conserved"]


@pytest.mark.parametrize("chunked", [False, True])
def test_spec_at_the_max_len_edge(llama, chunked):
    """prompt + max_new == max_len: the last rounds feed fewer than
    gamma + 1 tokens (clamped at the pool's window), which neither raises
    nor changes a token."""
    jt, tt, jd, td = llama
    prompts = _prompts(17, (90, 88))
    solo = [_solo(jt, p, MAX_LEN - len(p)) for p in prompts]

    async def run(b):
        try:
            return [list(t) for t in await asyncio.gather(*(
                b.submit(p, MAX_LEN - len(p)) for p in prompts))]
        finally:
            await b.close()

    b = _port(tt, td, 5, prefill_chunk_tokens=16 if chunked else None)
    assert asyncio.run(run(b)) == solo
    assert b.spec_rounds > 0


def test_spec_kill_switch_with_a_drained_batcher(llama):
    """Off: plain decode chunks carry on, no round runs and no draft row
    is seeded; back on once drained: rounds again. Tokens exact
    throughout."""
    jt, tt, _, td = llama
    prompts = _prompts(19, (6, 10))
    solo = [_solo(jt, p, 7) for p in prompts]
    b = _port(tt, td, 3)
    seeds = []
    seed = b.cengine.draft_prefill
    b.cengine.draft_prefill = lambda *a: seeds.append(a[1]) or seed(*a)

    async def wave():
        return [list(t) for t in await asyncio.gather(*(
            b.submit(p, 7) for p in prompts))]

    async def run():
        try:
            out = [await wave()]
            rounds, calls = b.spec_rounds, b.calls
            b.spec_enabled = False
            out.append(await wave())
            assert b.spec_rounds == rounds and b.calls > calls
            assert len(seeds) == len(prompts)
            b.spec_enabled = True
            out.append(await wave())
            assert b.spec_rounds > rounds
            assert len(seeds) == 2 * len(prompts)
            return out
        finally:
            await b.close()

    for got in asyncio.run(run()):
        assert got == solo


def test_spec_turned_on_with_a_chunk_in_flight(llama):
    """At dispatch-ahead depth 2 a plain chunk is still in flight when
    speculation turns on mid-request: it is processed before the first
    round, so the tokens come out in order (the slot has no draft row:
    the round drafts from a stale cache, and the output law holds)."""
    jt, tt, _, td = llama
    (p,) = _prompts(23, (9,))
    b = _port(tt, td, 2, pipeline_depth=2, chunk=2)
    b.spec_enabled = False
    on_itl = []

    def hook(gap):
        on_itl.append(gap)
        b.spec_enabled = True

    b.on_itl = hook

    async def run():
        try:
            return list(await b.submit(p, 12))
        finally:
            await b.close()

    assert asyncio.run(run()) == _solo(jt, p, 12)
    assert b.spec_rounds > 0 and b.calls > b.spec_rounds


# -- the acceptance arithmetic on the reference's inputs ---------------------


def _ref_residual(ps, qs, k, gamma):
    """The reference's residual-or-bonus distribution
    (kubeflow_tpu/serving/continuous.py:1148-1154), on its inputs."""
    pk = jnp.take_along_axis(ps, k[:, None, None], axis=1)[:, 0]
    qk = jnp.take_along_axis(
        qs, jnp.minimum(k, gamma - 1)[:, None, None], axis=1)[:, 0]
    resid = jnp.clip(pk - qk, 0.0, None)
    resid = jnp.where(jnp.sum(resid, axis=1, keepdims=True) > 0.0, resid,
                      pk)
    return jnp.where((k == gamma)[:, None], ps[:, gamma], resid)


@pytest.mark.parametrize("sampled,draft_seed,head_scale", [
    (False, 5, 1.0),    # greedy, a disagreeing draft: k = 0, residual
    (False, 0, 2.0),    # greedy, the target's argmax: k = gamma, bonus
    (True, 0, 2.0),     # sampled, a sharper copy: k varies
])
def test_accept_matches_reference_spec_verify(sampled, draft_seed,
                                              head_scale):
    """One round of the reference's `spec_draft` + `spec_verify` on four
    prompts; the port's `spec_accept` and `spec_emit` on the same
    distributions, drafts and uniforms give its k, accepted prefix,
    extra-token distribution and logprobs."""
    gamma, S = 4, 4
    cfg = jllama.LLAMA_TINY
    ec = JEngineConfig(max_len=MAX_LEN)
    jt = JEngine(dict(jllama.init(jax.random.key(0), cfg)), cfg, J_LLAMA,
                 ec)
    params = dict(jllama.init(jax.random.key(draft_seed), cfg))
    params["lm_head"] = params["lm_head"] * head_scale
    jd = JEngine(params, cfg, J_LLAMA, ec)
    jce = JCEngine(jt, max_slots=S, block_size=BS, draft=jd,
                   paged_attention_impl="xla")
    prompts = _prompts(29, (5, 9, 12, 14))
    temp = np.full(S, 0.8 if sampled else 0.0, np.float32)
    samplings = [{"temperature": float(t), "top_k": 20 if sampled else 0,
                  "top_p": 1.0} for t in temp]
    rng = jax.random.key(3)
    pstate, first, _, _ = jce.prefill_batch(prompts, 16, samplings, rng)
    st = jce.insert_many(jce.init_slots(), list(range(S)), pstate,
                         list(range(S)), first)
    dst = jce.init_draft_slots()
    for slot, p in enumerate(prompts):
        dst, rng = jce.draft_prefill(dst, slot, p, rng)
    sp = JSamplingParams(temperature=jnp.asarray(temp),
                         top_k=jnp.asarray([s["top_k"] for s in samplings]),
                         top_p=jnp.ones(S, jnp.float32))
    dst, drafted, qs, rng = jce.spec_draft(st, dst, sp, rng, gamma)
    # the reference's target distributions over the verify window
    tin = jnp.concatenate([st.tok[:, None], drafted], axis=1)
    x, _, _ = jce._paged_forward(
        jt.params, None, st, jnp.arange(S, dtype=jnp.int32), tin,
        jnp.full((S,), gamma + 1, jnp.int32), st.length)
    logits = jt._head(jt.params, x)
    ps = jax.vmap(lambda lg: jdist(lg, sp), in_axes=1, out_axes=1)(logits)
    _, r_us, r_x = jax.random.split(rng, 3)
    us = jax.random.uniform(r_us, (S, gamma))
    _, _, emit, lps, k, _ = jce.spec_verify(st, dst, drafted, qs, sp, rng,
                                            gamma)

    def t(x):
        return torch.from_numpy(np.array(x))

    k_t, dist_t = spec_accept(t(ps), t(qs), t(drafted), t(us))
    k_ref = np.asarray(k)
    np.testing.assert_array_equal(k_t.numpy(), k_ref)
    if sampled:
        assert len(set(k_ref.tolist())) > 1   # the window's cases vary
    else:
        assert set(k_ref.tolist()) == {0 if draft_seed else gamma}
    np.testing.assert_allclose(
        dist_t.numpy(), np.asarray(_ref_residual(ps, qs, k, gamma)),
        atol=1e-6, rtol=0)
    # the reference's own draw from the port's distribution: its token
    redraw = jax.random.categorical(r_x, jnp.log(jnp.asarray(dist_t.numpy())))
    extra = np.asarray(emit)[np.arange(S), k_ref]
    np.testing.assert_array_equal(np.asarray(redraw), extra)
    emit_t, lps_t = spec_emit(t(drafted), k_t, torch.from_numpy(extra),
                              t(logits))
    for row in range(S):
        n = int(k_ref[row]) + 1
        assert emit_t[row, :n].tolist() == np.asarray(emit)[row, :n].tolist()
        np.testing.assert_allclose(lps_t[row, :n].numpy(),
                                   np.asarray(lps)[row, :n], atol=1e-5,
                                   rtol=0)


def test_race_draw_keeps_the_law():
    """The graph-safe draw of the rounds: the empirical law of many race
    draws from one distribution is the distribution (4-sigma bound per
    token), a zero-probability token is never drawn, a one-hot draws its
    token."""
    from kubeflow_tpu_torch.serving.engine import race_draw

    p = torch.tensor([0.5, 0.25, 0.0, 0.125, 0.125])
    n = 40000
    gen = torch.Generator().manual_seed(0)
    draws = race_draw(p.expand(n, 5).contiguous(), gen)
    freq = torch.bincount(draws, minlength=5).float() / n
    sigma = (p * (1 - p) / n).sqrt()
    assert bool(((freq - p).abs() <= 4 * sigma + 1e-9).all())
    assert int((draws == 2).sum()) == 0
    onehot = torch.nn.functional.one_hot(torch.arange(5), 5).float()
    assert race_draw(onehot, gen).tolist() == [0, 1, 2, 3, 4]


# -- construction doors -------------------------------------------------------


def test_engine_rejects_incompatible_drafts(llama):
    jt, tt, jd, td = llama
    vcfg = dataclasses.replace(tllama.LLAMA_TINY, vocab_size=256)
    vdraft = InferenceEngine(tllama.init(vcfg, 3, "cpu"), vcfg, LLAMA_FAMILY,
                             EngineConfig(max_len=MAX_LEN), device="cpu")
    jvcfg = dataclasses.replace(jllama.LLAMA_TINY, vocab_size=256)
    jvdraft = JEngine(dict(jllama.init(jax.random.key(3), jvcfg)), jvcfg,
                      J_LLAMA, JEngineConfig(max_len=MAX_LEN))
    _, short = _pair(seed=5, max_len=32)
    jshort, _ = _pair(seed=5, max_len=32)
    for port_draft, ref_draft, match in ((vdraft, jvdraft, "vocab"),
                                         (short, jshort, "max_len")):
        with pytest.raises(ValueError, match=match) as got:
            ContinuousEngine(tt, max_slots=2, draft=port_draft)
        with pytest.raises(ValueError, match=match) as want:
            JCEngine(jt, max_slots=2, draft=ref_draft)
        assert str(got.value) == str(want.value)


def test_batcher_app_and_cli_knob_validation(llama):
    jt, tt, jd, td = llama
    with pytest.raises(ValueError, match="spec_gamma"):
        ContinuousBatcher(tt, asyncio.Lock(), max_slots=2, draft=td,
                          spec_gamma=0)
    for app_kw in (dict(drafts={"m": td}, spec_decode=True),
                   dict(continuous=True, spec_decode=True)):
        jkw = dict(app_kw)
        if "drafts" in jkw:
            jkw["drafts"] = {"m": jd}
        with pytest.raises(ValueError) as want:
            jserver.create_serving_app({"m": jt}, **jkw)
        with pytest.raises(ValueError) as got:
            server.create_serving_app({"m": tt}, **app_kw)
        assert ("require continuous" in str(got.value)) == \
            ("require continuous" in str(want.value))
        assert ("missing ['m']" in str(got.value)) == \
            ("missing ['m']" in str(want.value))
    base = ["--model", "llama-tiny", "--random"]
    for extra in (["--spec-decode", "--draft-model", "llama-tiny"],
                  ["--continuous", "--spec-decode"],
                  ["--continuous", "--draft-model", "llama-tiny"]):
        # the reference's main() refuses these while parsing
        for parse in (jcli.main, cli.parse_args):
            with pytest.raises(SystemExit) as exit_:
                parse(base + extra)
            assert exit_.value.code == 2
    args = cli.parse_args(base + ["--continuous", "--spec-decode",
                                  "--draft-model", "llama-tiny",
                                  "--spec-gamma", "3", "--cpu"])
    app = cli.build_app(args)
    b = app[server.BATCHERS_KEY]["llama-tiny"]
    assert b.spec_gamma == 3 and b.cengine.draft is not None
    # the random draft is seeded at seed + 1
    want = tllama.init(tllama.LLAMA_TINY, 1, "cpu")
    assert torch.equal(b.cengine.draft.params["embed"], want["embed"])
