"""A live weight reload under the card's CUDA graphs. Every test here is
marked `cuda` and skips without an NVIDIA card: the paged kernels the
graphs replay have no CPU mode. This file imports no JAX, so the card
machine runs it with

    python -m pytest --noconftest tests/test_torch_cuda_reload.py

A small llama (two layers, llama3-1b's 16 / 8 heads of 128, bf16)
serves through `create_serving_app` in continuous mode with `warmup`,
which captures every decode-step and prefill-slice graph. `POST
/v1/reload {"source": {"seed": 7}}` (the CLI's reloader: drawn on the
card, staged on the host) must keep every parameter's `data_ptr()`, the
per-layer views' and every graph runner, capture nothing, and the
replayed graphs must then give the tokens and logprobs of an eager
batcher (no graphs) on a fresh engine built from `init(cfg, 7)`, and
other tokens than before the reload: a rebound param dict would leave
the graphs replaying the old weights.
"""

import asyncio

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.train.checkpoint import flatten

MAX_LEN = 512
PROMPT = list(range(5, 5 + 150))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cfg():
    return llama.LlamaConfig(vocab_size=1024, hidden_size=2048,
                             intermediate_size=1024, num_layers=2,
                             num_heads=16, num_kv_heads=8, head_dim=128)


def _engine(dev, seed):
    cfg = _cfg()
    return InferenceEngine(llama.init(cfg, seed, dev), cfg, LLAMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [False, True])
def test_reload_under_cuda_graphs_keeps_pointers(cuda_device, chunked):
    dev = cuda_device
    cfg = _cfg()
    eng = _engine(dev, 0)
    ptrs = {n: t.data_ptr() for n, t in flatten(eng.params).items()}
    views = [{n: t.data_ptr() for n, t in layer.items()}
             for layer in eng.layers]
    app = server.create_serving_app(
        {"m": eng}, continuous=True, warmup=True, max_batch=4,
        prefill_chunk_tokens=64 if chunked else None, seed=0,
        reloader=cli._make_reloader(llama.init, cfg, dev))

    async def script():
        async with TestClient(TestServer(app)) as client:
            b = app[server.BATCHERS_KEY]["m"]
            graphs = b.cengine.graphs
            runners, captures = dict(graphs._runners), graphs.captures
            body = {"tokens": [PROMPT], "max_new": 24, "logprobs": True}
            before = await (await client.post("/v1/models/m:generate",
                                              json=body)).json()
            r = await client.post("/v1/reload", json={
                "version": "v2", "source": {"seed": 7}})
            assert r.status == 200, await r.text()
            after = await (await client.post("/v1/models/m:generate",
                                             json=body)).json()
            same = (graphs._runners == runners
                    and all(graphs._runners[k] is v
                            for k, v in runners.items()),
                    graphs.captures == captures)
            return before, after, same

    before, after, same = asyncio.run(script())
    assert same == (True, True)
    assert {n: t.data_ptr()
            for n, t in flatten(eng.params).items()} == ptrs
    assert [{n: t.data_ptr() for n, t in layer.items()}
            for layer in eng.layers] == views

    async def control():
        fresh = _engine(dev, 7)
        b = ContinuousBatcher(fresh, asyncio.Lock(), max_slots=4, seed=0,
                              cuda_graphs=False,
                              prefill_chunk_tokens=64 if chunked else None)
        try:
            return await b.submit(PROMPT, 24, with_logprobs=True)
        finally:
            await b.close()

    toks, lps = asyncio.run(control())
    assert after["tokens"][0] == toks
    assert after["tokens"][0] != before["tokens"][0]
    err = max(abs(a - b) for a, b in zip(after["logprobs"][0], lps))
    assert err <= 1e-3, err
