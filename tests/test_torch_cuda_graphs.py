"""The serving paths' CUDA graphs on the card. Every test here is marked
`cuda` and skips without an NVIDIA card: a CUDA graph has no CPU mode.
This file imports no JAX, so the card machine runs it with

    python -m pytest --noconftest tests/test_torch_cuda_graphs.py

A small bf16 llama (head_dim 128, as the kernels take; 2 layers, random
weights from seed 0) serves through the continuous engine (paged decode
and prefill-append kernels) and the one-shot engine (dense decode
kernel, a 512-cell cache). The replayed graphs run the same kernels on
the same inputs as the explicit eager path, so greedy tokens and
logprobs are bit-identical to it; launch counts under replay are the
capture's counts times the replays; warmup leaves traffic nothing to
capture; sampled rows stay inside their top-k set. With a draft of the
same shape, the speculative rounds' draft and verify graphs replay to
the eager spec path's tokens.
"""

import asyncio

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops.attention import impl_counts, reset_impl_counts
from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
)
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

CFG = llama.LlamaConfig(vocab_size=1024, hidden_size=512,
                        intermediate_size=1024, num_layers=2, num_heads=4,
                        num_kv_heads=2, head_dim=128)
MAX_LEN = 512
BS = 64


@pytest.fixture(scope="module")
def params():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return llama.init(CFG, 0, torch.device("cuda"))


def _engine(params, graphs=True):
    return InferenceEngine(params, CFG, LLAMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device="cuda",
                           cuda_graphs=graphs)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).tolist() for n in lens]


def _drive(ce: ContinuousEngine, prompts):
    """Adopt slot 0 and 1, prefill slot 0 in 64-token slices and slot 1
    partly (it stays frozen), then decode steps 1-4 greedily. -> slot
    0's first token, its decoded tokens and logprobs, the cursors and
    the K/V cells slot 0 wrote, on the host (slot 1's rows read cells
    past its cursor, whose garbage differs between engines)."""
    st = ce.slots()
    greedy = (np.zeros(2, np.float32), np.zeros(2, np.int64),
              np.ones(2, np.float32))
    out = []
    for slot, p in enumerate(prompts):
        table = np.zeros(ce.blocks_per_slot, np.int32)
        table[:4] = [1 + 4 * slot + j for j in range(4)]
        ce.adopt_slot(st, slot, table, 0, p[0])
    feeds = [(0, 0, 64), (1, 0, 64), (0, 64, len(prompts[0]) - 64)]
    for slot, fed, n in feeds:
        toks = np.zeros((1, 64), np.int64)
        toks[0, :n] = prompts[slot][fed:fed + n]
        finish = fed + n == len(prompts[slot])
        got = ce.prefill_slice(ce.sampling(*greedy), slot, toks, n, finish)
        if finish:
            out += [t.cpu() for t in got]
    for steps in (1, 2, 3, 4):
        out += [t[0].cpu() for t in ce.decode(ce.sampling(*greedy), steps)]
    n0 = int(st.length[0])
    out += [st.length.cpu(),
            st.k[:, 1:5].reshape(CFG.num_layers, -1, CFG.num_kv_heads,
                                 CFG.head_dim)[:, :n0].float().cpu()]
    return out


@pytest.mark.cuda
def test_replayed_continuous_step_and_slice_equal_eager(params):
    eng = _engine(params)
    prompts = _prompts(0, (100, 150))
    with torch.inference_mode():
        graphed = _drive(ContinuousEngine(eng, 2, BS, seed=0), prompts)
        # the first call of each key ran eagerly and captured: drive a
        # second engine whose graphs all exist already
        ce = ContinuousEngine(eng, 2, BS, seed=0)
        ce.warmup(step_sizes=range(1, 5), slice_tokens=64)
        warm = ce.graphs.captures
        replayed = _drive(ce, prompts)
        eager = _drive(ContinuousEngine(eng, 2, BS, seed=0,
                                        cuda_graphs=False), prompts)
    assert ce.graphs.captures == warm and ce.graphs.replays == 7
    for g, r, e in zip(graphed, replayed, eager):
        assert torch.equal(g, e) and torch.equal(r, e)


@pytest.mark.cuda
def test_replayed_one_shot_step_equals_eager(params):
    lens = (30, 75, 120, 9)
    width = max(lens)
    arr = np.zeros((4, width), np.int64)
    mask = np.zeros((4, width), bool)
    for i, p in enumerate(_prompts(1, lens)):
        arr[i, width - len(p):] = p
        mask[i, width - len(p):] = True
    outs = []
    for graphs in (True, True, False):
        eng = _engine(params, graphs)
        eng.warmup((4,))
        outs.append([t.cpu() for t in eng.generate(
            arr, prompt_mask=mask, max_new=24, return_logprobs=True)])
    for got in outs[:2]:
        assert all(torch.equal(g, e) for g, e in zip(got, outs[2]))


@pytest.mark.cuda
def test_sampled_rows_under_replay_stay_in_the_top_k(params):
    """temperature 4 flattens the draw; every token must be one of its
    step's 3 most likely under a teacher-forced pass of the plain model
    (a 0.1 slack for bf16), and the draws must not all be the argmax."""
    eng = _engine(params)
    prompts = _prompts(2, (40, 40))
    toks = eng.generate(prompts, max_new=16, temperature=4.0, top_k=3,
                        rng=torch.Generator("cuda").manual_seed(5))
    assert eng.replays == 14   # the first step ran eagerly and captured
    off_argmax = 0
    with torch.inference_mode():
        for p, o in zip(prompts, toks.tolist()):
            seq = torch.tensor([p + o[:-1]], device="cuda")
            logp = torch.log_softmax(
                llama.apply(params, CFG, seq)[0, len(p) - 1:].float(), -1)
            top = torch.topk(logp, 3, -1)
            for j, t in enumerate(o):
                assert logp[j, t] >= top.values[j, 2] - 0.1
                off_argmax += t != int(top.indices[j, 0])
    assert off_argmax > 0


@pytest.mark.cuda
def test_launch_counts_under_replay(params):
    eng = _engine(params)
    ce = ContinuousEngine(eng, 2, BS, seed=0)
    with torch.inference_mode():
        sp = ce.sampling(np.zeros(2), np.zeros(2), np.ones(2))
        ce.decode(sp, 3)   # eager run + capture
        reset_launch_counts()
        for _ in range(5):
            ce.decode(sp, 3)
        torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["paged_decode_attention"] == 5 * 3 * CFG.num_layers
    assert sum(counts.values()) == counts["paged_decode_attention"]
    eng.warmup((2,))
    reset_launch_counts()
    reset_impl_counts()
    eng.generate(_prompts(3, (20, 20)), max_new=9)
    counts = launch_counts()
    assert counts["decode_attention"] == 8 * CFG.num_layers
    assert impl_counts()["decode"] == 8 * CFG.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("prefill_chunk_tokens", [None, 64])
def test_warmup_leaves_traffic_nothing_to_capture(params,
                                                  prefill_chunk_tokens):
    eng = _engine(params)
    batcher = ContinuousBatcher(eng, asyncio.Lock(), max_slots=4,
                                prefill_chunk_tokens=prefill_chunk_tokens,
                                seed=0)
    batcher.warmup()
    warm = batcher.cengine.graphs.captures
    prompts = _prompts(4, (17, 130, 300, 17, 60))

    async def serve():
        try:
            return await asyncio.gather(*(
                batcher.submit(p, 12, {"temperature": t, "top_k": k})
                for p, t, k in zip(prompts, (0, 0.8, 0, 1.0, 0),
                                   (0, 5, 0, 0, 0))))
        finally:
            await batcher.close()

    out = asyncio.run(serve())
    assert [len(o) for o in out] == [12] * 5
    assert batcher.cengine.graphs.captures == warm
    eng.warmup((1, 2, 4))
    warm = eng.captures
    for b in (1, 2, 4):
        eng.generate(_prompts(5, (33,) * b), max_new=8)
    assert eng.captures == warm


@pytest.mark.cuda
def test_concurrent_streams_with_a_stop_under_replay_equal_eager(params):
    """Two continuous streams at once, the second with a stop sequence,
    under graph replay at dispatch-ahead depth 2: each stream's tokens
    equal the eager control's, the stop retires its slot where the stop
    completes (a chunk in flight for it is dropped), and both streams
    end with the None sentinel."""
    prompts = _prompts(6, (130, 40))

    def run(graphs):
        batcher = ContinuousBatcher(_engine(params, graphs), asyncio.Lock(),
                                    max_slots=4, prefill_chunk_tokens=64,
                                    pipeline_depth=2, seed=0,
                                    cuda_graphs=graphs)
        if graphs:
            batcher.warmup()

        async def one(p, sampling):
            return [t async for t in batcher.stream(p, 24, sampling)]

        async def serve():
            try:
                plain = await one(prompts[1], {})
                stop = plain[10:12]
                got = await asyncio.gather(
                    one(prompts[0], {}),
                    one(prompts[1], {"stop": [stop],
                                     "request_id": "stopped"}))
                return plain, stop, got
            finally:
                await batcher.close()

        out = asyncio.run(serve())
        return out, batcher

    (plain, stop, got), replayed = run(True)
    (eplain, estop, egot), _ = run(False)
    assert plain == eplain and got == egot
    cut = next(i for i in range(len(plain)) if plain[i:i + 2] == stop)
    assert got[1] == plain[:cut + 2]     # a stream carries the stop itself
    assert len(replayed.timelines.get("stopped").tokens) == cut + 2
    assert replayed.tokens_dropped <= replayed.pipeline_depth \
        * replayed.chunk * 2
    assert replayed.cengine.graphs.replays > 0


@pytest.mark.cuda
@pytest.mark.parametrize("prefill_chunk_tokens", [None, 64])
def test_replayed_spec_rounds_equal_eager(params, prefill_chunk_tokens):
    """Continuous speculative decoding (a draft of the same shape from
    seed 1, gamma 3; its 512-cell dense cache takes the dense decode
    kernel): the warmed spec draft and verify graphs replay to the eager
    spec path's tokens and logprobs bit for bit, capture nothing in
    traffic, and launch exactly what the design implies."""
    draft_params = llama.init(CFG, 1, torch.device("cuda"))
    prompts = _prompts(7, (100, 150, 30, 65))
    gamma = 3

    def run(graphs):
        batcher = ContinuousBatcher(
            _engine(params, graphs), asyncio.Lock(), max_slots=4,
            prefill_chunk_tokens=prefill_chunk_tokens, seed=0,
            cuda_graphs=graphs, draft=_engine(draft_params, graphs),
            spec_gamma=gamma)
        if graphs:
            batcher.warmup()
        warm = batcher.cengine.graphs.captures
        reset_launch_counts()

        async def serve():
            try:
                return await asyncio.gather(*(
                    batcher.submit(p, 12, with_logprobs=True)
                    for p in prompts))
            finally:
                await batcher.close()

        out = [(list(t), list(lp)) for t, lp in asyncio.run(serve())]
        torch.cuda.synchronize()
        return out, batcher, warm, launch_counts()

    graphed, gb, warm, counts = run(True)
    eager, eb, _, eager_counts = run(False)
    assert graphed == eager
    assert gb.cengine.graphs.captures == warm
    assert ("spec_verify", gamma, False, False) in gb.cengine.graphs
    L = CFG.num_layers
    assert gb.spec_rounds == eb.spec_rounds > 0
    assert counts == eager_counts
    assert counts["paged_prefill_append"] == L * (gb.spec_rounds + gb.slices)
    assert counts["decode_attention"] == L * (gamma + 1) * gb.spec_rounds
    assert counts["paged_decode_attention"] == 0
