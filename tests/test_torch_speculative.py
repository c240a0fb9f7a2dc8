"""The port's speculative decoding against the target-only path and the
JAX reference's `SpeculativeEngine`, on the CPU.

The target is LLAMA_TINY with the reference's init and lm_head scaled
x50 (the reference's "confident" idiom): the draft decodes one token per
forward while the verifier scores gamma+1, so equal weights still give
ulp-different logits, which would flip near-tied argmaxes of a plain
random model. With separated logits, greedy speculative output must
equal target-only greedy output token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving.speculative import SpeculativeEngine as JSpec
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.speculative import SpeculativeEngine

# a weaker draft: same vocab, shallower and narrower, its own init
DCFG = dataclasses.replace(
    tllama.LLAMA_TINY, num_layers=1, hidden_size=64, intermediate_size=192,
    num_heads=2, num_kv_heads=1)


@pytest.fixture(scope="module")
def engines():
    params = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    params["lm_head"] = params["lm_head"] * 50.0
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=96))
    target = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=96),
        device="cpu")
    draft = InferenceEngine(tllama.init(DCFG, 99, "cpu"), DCFG,
                            LLAMA_FAMILY, EngineConfig(max_len=96),
                            device="cpu")
    return jeng, target, draft


def _prompt(seed=0, s=8):
    return np.random.default_rng(seed).integers(0, 512, (1, s))


@pytest.mark.parametrize("gamma", [1, 2, 4, 7])
def test_greedy_specdecode_equals_target_only(engines, gamma):
    _, target, draft = engines
    prompt = _prompt()
    want = target.generate(prompt, max_new=24).numpy()
    got, stats = SpeculativeEngine(target, draft).generate(
        prompt, max_new=24, gamma=gamma)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats.emitted >= 24
    assert stats.proposed > 0
    assert 0 <= stats.accepted <= stats.proposed


def test_confident_self_draft_matches_reference(engines):
    """Target as its own draft: every proposal is accepted, and the
    tokens equal the reference's SpeculativeEngine's."""
    jeng, target, _ = engines
    prompt = _prompt(3)
    want, wstats = JSpec(jeng, jeng).generate(
        jnp.asarray(prompt, jnp.int32), max_new=16, gamma=4)
    got, stats = SpeculativeEngine(target, target).generate(
        prompt, max_new=16, gamma=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), target.generate(prompt, max_new=16).numpy())
    assert stats.acceptance_rate == wstats.acceptance_rate == 1.0
    assert (stats.emitted, stats.accepted, stats.proposed) == tuple(
        int(x) for x in wstats)
    _, stats = SpeculativeEngine(target, target).generate(
        prompt, max_new=16, gamma=4, temperature=0.7,
        rng=torch.Generator().manual_seed(5))
    assert stats.acceptance_rate > 0.9, stats


def test_sampled_specdecode_stays_in_target_top3(engines):
    """Rejection sampling never emits outside the target's filtered
    support: with top_k=3 each token lies in its step's top-3 (replay of
    the emitted prefix through the dense forward)."""
    _, target, draft = engines
    prompt = _prompt(7)
    got, _ = SpeculativeEngine(target, draft).generate(
        prompt, max_new=12, gamma=3, temperature=1.0, top_k=3,
        rng=torch.Generator().manual_seed(11))
    drawn = got.numpy()
    seq = np.concatenate([prompt, drawn], axis=1)
    for step in range(drawn.shape[1]):
        logits = tllama.apply(target.params, target.cfg, torch.from_numpy(
            seq[:, :prompt.shape[1] + step]).long())
        assert drawn[0, step] in torch.topk(logits[0, -1], 3).indices, step


def test_specdecode_validation(engines):
    _, target, draft = engines
    spec = SpeculativeEngine(target, draft)
    with pytest.raises(ValueError, match="batch-1"):
        spec.generate(np.zeros((2, 4), np.int32), max_new=4)
    with pytest.raises(ValueError, match="gamma"):
        spec.generate(_prompt(), max_new=4, gamma=0)
    with pytest.raises(ValueError, match="target cache bucket"):
        spec.generate(_prompt(), max_new=90, gamma=4)
    small = InferenceEngine(draft.params, DCFG, LLAMA_FAMILY,
                            EngineConfig(max_len=32), device="cpu")
    with pytest.raises(ValueError, match="draft cache bucket"):
        SpeculativeEngine(target, small).generate(_prompt(), max_new=24,
                                                  gamma=4)
    bad_vocab = dataclasses.replace(DCFG, vocab_size=1024)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(target, InferenceEngine(
            tllama.init(bad_vocab, 1, "cpu"), bad_vocab, LLAMA_FAMILY,
            EngineConfig(max_len=96), device="cpu"))
