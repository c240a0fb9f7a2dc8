"""The port's one-shot `InferenceEngine` (dense KV cache) against the
JAX reference's, on the CPU.

One LLAMA_TINY model (the reference's init, lm_head scaled x50 so that
greedy argmax cannot flip on fp32 rounding, the reference's own test
idiom) runs through both engines. Greedy tokens must be equal and
logprobs within LP_TOL: fp32 on both sides with sums in another order,
which the x50 head turns into logit differences of ~1e-5 of logits in
the hundreds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

MAX_LEN = 96
LP_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    p = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    p["lm_head"] = p["lm_head"] * 50.0   # argmax can't flip
    return p


def _engines(params, **ec):
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN, **ec))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN, **ec),
        device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def engines(params):
    return _engines(params)


def _prompts(seed, lens):
    """Left-padded [b, max(lens)] tokens and their prompt_mask."""
    rng = np.random.default_rng(seed)
    width = max(lens)
    arr = np.zeros((len(lens), width), np.int32)
    mask = np.zeros((len(lens), width), bool)
    for i, n in enumerate(lens):
        arr[i, width - n:] = rng.integers(0, 512, n)
        mask[i, width - n:] = True
    return arr, mask


def _compare(jeng, teng, arr, mask=None, **kw):
    jmask = None if mask is None else jnp.asarray(mask)
    wt, wl = jeng.generate(jnp.asarray(arr), prompt_mask=jmask,
                           return_logprobs=True, **kw)
    gt, gl = teng.generate(arr, prompt_mask=mask, return_logprobs=True, **kw)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LP_TOL)
    return gt.numpy()


def test_generate_batch_one_matches_reference(engines):
    arr, _ = _prompts(0, [9])
    _compare(*engines, arr, max_new=8)


def test_left_padded_mixed_lengths_match_reference(engines):
    """Pads are masked out of attention and rope sees logical positions:
    each padded row decodes what the reference's padded row does, and
    what the port's unpadded prompt does alone."""
    jeng, teng = engines
    lens = [5, 9, 2, 7]
    arr, mask = _prompts(1, lens)
    got = _compare(jeng, teng, arr, mask, max_new=6)
    for i, n in enumerate(lens):
        alone = teng.generate(arr[i:i + 1, arr.shape[1] - n:], max_new=6)
        np.testing.assert_array_equal(got[i], alone.numpy()[0])


def test_prefill_chunk_matches_reference(engines):
    arr, mask = _prompts(2, [11, 6])
    got = _compare(*engines, arr, mask, max_new=5, prefill_chunk=4)
    plain = engines[1].generate(arr, prompt_mask=mask, max_new=5)
    np.testing.assert_array_equal(got, plain.numpy())


def test_eos_forcing_matches_reference(params):
    arr, _ = _prompts(3, [8])
    ref = _engines(params)[1].generate(arr, max_new=8).numpy()[0]
    eos = int(ref[1])   # the greedy second token: forcing must trigger
    jeng, teng = _engines(params, eos_token=eos)
    wt = np.asarray(jeng.generate(jnp.asarray(arr), max_new=8))
    got = teng.generate(arr, max_new=8).numpy()
    np.testing.assert_array_equal(got, wt)
    first = int(np.argmax(got[0] == eos))
    assert (got[0, first:] == eos).all()
    # the stream stops once every row is done
    parts = list(teng.generate_stream(arr, max_new=8, chunk=2))
    streamed = np.concatenate(parts, axis=1)
    assert streamed.shape[1] < 8
    np.testing.assert_array_equal(streamed, got[:, :streamed.shape[1]])


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_stream_prefix_equals_generate(engines, sampled):
    _, teng = engines
    arr, mask = _prompts(4, [6, 4])
    kw = dict(temperature=0.8, top_k=5) if sampled else {}
    full = teng.generate(arr, prompt_mask=mask, max_new=13,
                         rng=torch.Generator().manual_seed(7), **kw).numpy()
    parts = list(teng.generate_stream(
        arr, prompt_mask=mask, max_new=13, chunk=4,
        rng=torch.Generator().manual_seed(7), **kw))
    assert [p.shape[1] for p in parts] == [1, 4, 4, 4]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    # the caller's code between chunks runs outside inference mode
    stream = teng.generate_stream(arr, prompt_mask=mask, max_new=5, chunk=2)
    next(stream)
    assert not torch.is_inference_mode_enabled()
    stream.close()


def test_score_matches_reference(engines):
    jeng, teng = engines
    arr, mask = _prompts(5, [12, 8])
    want = np.asarray(jeng.score(jnp.asarray(arr), jnp.asarray(mask)))
    got = teng.score(arr, mask).numpy()
    np.testing.assert_allclose(got, want, **LP_TOL)
    assert (got[1, :3] == 0).all()   # pad positions score 0


def test_precompute_prefix_matches_reference(engines):
    jeng, teng = engines
    prefix = np.random.default_rng(6).integers(0, 512, 10).tolist()
    want = jeng.precompute_prefix(prefix)
    got = teng.precompute_prefix(prefix)
    assert got.length == int(want.length) == 10
    for g, w in ((got.k, want.k), (got.v, want.v)):
        np.testing.assert_allclose(g.numpy()[:, :, :10],
                                   np.asarray(w)[:, :, :10],
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.pad.numpy(), np.asarray(want.pad))
    np.testing.assert_array_equal(got.offset.numpy(),
                                  np.asarray(want.offset))


def test_kv_cache_bytes_match_reference(engines):
    jeng, teng = engines
    for batch, cells in ((1, None), (8, None), (3, 17)):
        assert teng.kv_cache_bytes(batch, cells) == \
            jeng.kv_cache_bytes(batch, cells)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kwargs", [
    dict(max_new=90),
    dict(max_new=4, top_p=0.0),
    dict(max_new=4, top_k=-1),
    dict(max_new=4, temperature=1.0, top_k=2**31),
    dict(max_new=4, temperature=[1.0, 0.5, 0.0]),
    dict(max_new=4, temperature=[[1.0]]),
    dict(max_new=4, prefill_chunk=0),
    dict(max_new=81, prefill_chunk=16),
    dict(max_new=4, prompt_mask=np.ones((2, 4), bool)),
    dict(max_new=4, prompt_mask=np.array([[True] * 4 + [False] + [True] * 4,
                                          [True] * 9])),
])
def test_validation_messages_match_reference(engines, kwargs):
    jeng, teng = engines
    arr, _ = _prompts(7, [9, 9])
    jkw = {k: jnp.asarray(v) if k == "prompt_mask" else v
           for k, v in kwargs.items()}
    assert _message(lambda: teng.generate(arr, **kwargs)) == \
        _message(lambda: jeng.generate(jnp.asarray(arr), **jkw))


def test_score_and_prefix_validation_match_reference(engines):
    jeng, teng = engines
    for call in (lambda e: e.score(np.zeros((1, 1), np.int32)),
                 lambda e: e.score(np.zeros((1, 97), np.int32)),
                 lambda e: e.precompute_prefix([]),
                 lambda e: e.precompute_prefix([1] * 96)):
        assert _message(lambda: call(teng)) == _message(lambda: call(jeng))
    # an adapter on an engine without a pack: the reference's refusal
    arr = np.zeros((1, 3), np.int32)
    assert _message(lambda: teng.generate(arr, max_new=2, adapter="x")) \
        == _message(lambda: jeng.generate(jnp.asarray(arr), max_new=2,
                                          adapter="x"))


def test_sampled_rows_stay_inside_top_k(engines):
    """Sampled tokens cannot match the reference's RNG: every drawn token
    must lie in its step's top-5 (dense-forward replay of the emitted
    prefix), and a greedy row beside sampled ones stays greedy."""
    _, teng = engines
    arr, _ = _prompts(8, [8, 8])
    greedy = teng.generate(arr, max_new=6).numpy()
    drawn = teng.generate(arr, max_new=6, temperature=[0.9, 0.0],
                          top_k=[5, 0], top_p=[0.9, 1.0],
                          rng=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(drawn[1], greedy[1])
    seq = np.concatenate([arr, drawn], axis=1)
    for step in range(drawn.shape[1]):
        logits = tllama.apply(teng.params, teng.cfg, torch.from_numpy(
            seq[:1, :arr.shape[1] + step]).long())
        top5 = torch.topk(logits[0, -1], 5).indices.tolist()
        assert drawn[0, step] in top5, step
