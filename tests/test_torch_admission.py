"""The port's monolithic admission against the JAX reference's, on the
CPU.

One LLAMA_TINY model (the reference's init, lm_head scaled x50 so that
greedy argmax cannot flip on fp32 rounding — the reference's own test
idiom) in both frameworks. `bucket_for` must pick the reference's
bucket exactly; `prefill_batch` + `insert_many` must sample the same
first tokens and leave the same cursors exactly and the same K/V in the
inserted blocks within 1e-4 (fp32, sums in another order); the batcher
in its default monolithic mode must emit the reference batcher's greedy
tokens exactly, with a group of 5 arrivals padded to max_slots = 6
rows (the reference pads to 8), and logprobs within 1e-4.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
    group_sizes,
)
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_LEN = 96
MAX_NEW = 5
TOL = dict(atol=1e-4, rtol=1e-4)
GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


@pytest.fixture(scope="module")
def engines():
    cfg = jllama.LLAMA_TINY
    params = dict(jllama.init(jax.random.key(0), cfg))
    params["lm_head"] = params["lm_head"] * 50.0  # argmax can't flip
    jeng = JEngine(params, cfg, J_LLAMA, JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
        device="cpu")
    return jeng, teng


@pytest.mark.parametrize("n_tokens,max_new,reserve,prefill_chunk", [
    (1, 4, 0, None), (5, 16, 0, None), (16, 8, 0, None),
    (17, 8, 0, None), (40, 30, 0, None), (70, 20, 0, None),
    (80, 16, 0, None), (60, 10, 20, None), (12, 4, 0, 8),
    (20, 8, 0, 8), (20, 70, 0, 8), (33, 8, 0, 16), (90, 6, 0, 16),
    (8, 8, 0, 8), (30, 8, 40, 8),
])
def test_bucket_for_matches_reference(engines, n_tokens, max_new, reserve,
                                      prefill_chunk):
    jeng, teng = engines
    want = JCEngine(jeng, max_slots=2, block_size=BS,
                    prefill_chunk=prefill_chunk).bucket_for(
                        n_tokens, max_new, reserve)
    got = ContinuousEngine(teng, max_slots=2, block_size=BS,
                           prefill_chunk=prefill_chunk).bucket_for(
                               n_tokens, max_new, reserve)
    assert got == want


@pytest.mark.parametrize("max_slots,sizes", [
    (1, [1]), (2, [1, 2]), (6, [1, 2, 4, 6]), (8, [1, 2, 4, 8]),
    (9, [1, 2, 4, 8, 9])])
def test_group_sizes_cover_every_padded_group(max_slots, sizes):
    assert group_sizes(max_slots) == sizes
    for g in range(1, max_slots + 1):
        p = 1
        while p < g:
            p *= 2
        assert min(p, max_slots) in sizes


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_prefill_batch_and_insert_many_match_reference(engines,
                                                       prefill_chunk):
    """Three left-padded prompts in one bucket, the middle row a dummy
    the insert skips; rows land in slots 2, 0 and 3's explicit tables
    (shared-free, trash-padded)."""
    jeng, teng = engines
    rng = np.random.default_rng(11)
    lists = [rng.integers(0, 512, n).tolist() for n in (9, 3, 14, 16)]
    kw = dict(max_slots=4, block_size=BS, prefill_chunk=prefill_chunk)
    jce = JCEngine(jeng, paged_attention_impl="xla", **kw)
    tce = ContinuousEngine(teng, seed=0, **kw)
    bucket = tce.bucket_for(16, MAX_NEW)
    assert bucket == jce.bucket_for(16, MAX_NEW) == 16
    samps = [GREEDY] * len(lists)
    jp, jfirst, _, jlps = jce.prefill_batch(lists, bucket, samps,
                                            jax.random.key(0))
    tp, tfirst, _, tlps = tce.prefill_batch(
        lists, bucket, samps, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), **TOL)
    slots, rows = [2, 0, 3], [0, 2, 3]
    mb = tce.blocks_per_slot
    tables = np.zeros((3, mb), np.int32)
    tables[0, :3] = [5, 9, 2]
    tables[1, :4] = [7, 1, 30, 12]
    tables[2, :3] = [4, 20, 8]
    jst = jce.insert_many(jce.init_slots(), slots, jp, rows, jfirst,
                          tables=tables)
    tst = tce.insert_many(tce.init_slots(), slots, tp, rows, tfirst,
                          tables=tables)
    for name in ("length", "offset", "pad", "tok", "block_table",
                 "frozen"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    blocks = sorted({int(b) for b in tables.reshape(-1) if b})
    for got, want in ((tst.k, jst.k), (tst.v, jst.v)):
        np.testing.assert_allclose(got.numpy()[:, blocks],
                                   np.asarray(want)[:, blocks], **TOL)
    # the compacted row starts at cell 0: cursor == unpadded prompt
    assert tst.length.numpy()[[2, 0, 3]].tolist() == [9, 14, 16]


async def _serve(batcher, prompts, max_new=MAX_NEW):
    try:
        return await asyncio.gather(*(
            batcher.submit(p, max_new, (), with_logprobs=True)
            if isinstance(batcher, JBatcher) else
            batcher.submit(p, max_new, with_logprobs=True)
            for p in prompts))
    finally:
        await batcher.close()


def test_monolithic_batcher_matches_reference(engines):
    """max_slots 6 and five arrivals in one bucket: the port pads the
    group to 6 rows, never past what warmup covers; tokens exact."""
    jeng, teng = engines
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, n).tolist() for n in (4, 7, 12, 15, 9)]

    async def run_ref():
        return await _serve(JBatcher(
            jeng, asyncio.Lock(), max_slots=6, kv_block_size=BS,
            paged_attention_impl="xla"), prompts)

    want = asyncio.run(run_ref())
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=6,
                                kv_block_size=BS, seed=0)
    assert batcher.prefill_chunk_tokens is None
    groups = []
    prefill = batcher.cengine.prefill_batch

    def spy(lists, bucket, *args, **kwargs):
        groups.append((len(lists), bucket))
        return prefill(lists, bucket, *args, **kwargs)

    batcher.cengine.prefill_batch = spy
    got = asyncio.run(_serve(batcher, prompts))
    assert groups == [(6, 16)]
    assert batcher.prefills == 1 and batcher.slices == 0
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        assert list(toks) == list(wtoks)
        np.testing.assert_allclose(lps, wlps, **TOL)


def test_warmup_covers_monolithic_traffic(engines):
    """After `warmup`, traffic in every group size needs no new graph:
    `captures` (on the CPU, step bodies built) stays put."""
    _, teng = engines
    batcher = ContinuousBatcher(teng, asyncio.Lock(), max_slots=3,
                                kv_block_size=BS, chunk=2, seed=0)
    assert batcher.warmup() == 2 * len(group_sizes(3)) + 3 * 2 + 1
    warmed = batcher.cengine.graphs.captures
    assert warmed == 3 * 2   # steps 1 and 2 x three sampling keys
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, n).tolist() for n in (3, 20, 5, 8)]
    out = asyncio.run(_serve(batcher, prompts, max_new=4))
    assert [len(t) for t, _ in out] == [4] * 4
    assert batcher.cengine.graphs.captures == warmed
