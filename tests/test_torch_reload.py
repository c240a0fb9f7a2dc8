"""The port's live weight reload (`POST /v1/reload`) against the JAX
reference, on the CPU (the counterpart of tests/test_rollout.py's
replica-side cases).

The same LLAMA_TINY weights (the reference's init at seeds 0 and 1,
lm_head x50 so that greedy argmax cannot flip) serve through both
frameworks' apps. After a reload to seed 1 the port emits exactly the
tokens of the reference engine on seed 1, while a generation in flight
during the reload finishes on seed 0's; the validation answers (400,
404), a reloader that raises (400, 500), an incompatible tree or leaf
(400), a drain that times out (409) all leave the old weights serving
with the door open, as the reference's do; a defect is planted and
healed; the forced fleet registration carries the new version before
the response returns; one-shot mode reloads too.

Port-specific: the weights are copied into the live tensors, so every
parameter's `data_ptr()` and every captured graph runner survive a
reload (a rebound dict would leave the card's graphs replaying the old
weights, which no CPU token check can see); the flush forgets the spill
tier and the registered prefixes' states as well as the radix tree, so
a registered-prefix request and a request whose blocks were spilled
give a fresh replica's tokens after the swap; a checkpoint source loads
through train/checkpoint.py; and gemma's tied head (the live
embedding's transpose) follows the copy to the reference's tokens and
logprobs at the new seed.
"""

import asyncio
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.train import checkpoint

MAX_LEN = 64
BS = 8
PROMPT = [3, 5, 7, 11, 13, 17]
GEN = "/v1/models/m:generate"


def _jparams(seed):
    params = dict(jllama.init(jax.random.key(seed), jllama.LLAMA_TINY))
    params["lm_head"] = params["lm_head"] * 50.0   # argmax can't flip
    return params


_CACHE: dict = {}


def _tparams(seed):
    """The port's params of the reference's seed (host, fp32)."""
    if seed not in _CACHE:
        _CACHE[seed] = bridge.from_jax(jax.tree.map(np.asarray,
                                                    _jparams(seed)),
                                       tllama.LLAMA_TINY, "cpu")
    return {k: ({n: t.clone() for n, t in v.items()} if k == "blocks"
                else v.clone()) for k, v in _CACHE[seed].items()}


def _teng(seed=0):
    return InferenceEngine(_tparams(seed), tllama.LLAMA_TINY, LLAMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device="cpu")


def _jeng(seed=0):
    return JEngine(_jparams(seed), jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN))


def _oracle(seed, prompt, max_new):
    return np.asarray(_jeng(seed).generate(
        jnp.asarray([prompt], jnp.int32), max_new=max_new))[0].tolist()


def _t_reloader(name, engine, source):
    if "seed" not in source:
        raise ValueError("reload source needs 'seed'")
    return _tparams(int(source["seed"]))


def _j_reloader(name, engine, source):
    if "seed" not in source:
        raise ValueError("reload source needs 'seed'")
    return _jparams(int(source["seed"]))


def _run(app, script):
    async def go():
        async with TestClient(TestServer(app)) as client:
            return await script(client, app)

    return asyncio.run(go())


async def _gen(client, prompt=PROMPT, max_new=12, **kw):
    r = await client.post(GEN, json={"tokens": [prompt], "max_new": max_new,
                                     **kw})
    assert r.status == 200, await r.text()
    return (await r.json())["tokens"][0]


def test_reload_swaps_weights_token_exact():
    """After a reload to seed 1 the port emits exactly the reference's
    seed-1 tokens; a generation in flight during the reload finishes on
    seed 0's."""
    old, new = _oracle(0, PROMPT, 12), _oracle(1, PROMPT, 12)
    assert old != new

    async def script(client, app):
        inflight = asyncio.ensure_future(_gen(client))
        b = app[server.BATCHERS_KEY]["m"]
        for _ in range(500):
            if b._active:
                break
            await asyncio.sleep(0.005)
        assert b._active, "the generation never reached a slot"
        r = await client.post("/v1/reload",
                              json={"version": "v1", "source": {"seed": 1}})
        body = await r.json()
        assert r.status == 200, body
        assert body["reloaded"] and body["model"] == "m"
        assert body["version"] == "v1" and body["reload_s"] >= 0
        got_old = await inflight
        assert app[server.MODEL_VERSION_KEY] == "v1"
        assert app[server.DRAIN_KEY]["draining"] is False
        return got_old, await _gen(client)

    app = server.create_serving_app(
        {"m": _teng(0)}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_t_reloader, model_version="v0", seed=0)
    got_old, got_new = _run(app, script)
    assert got_old == old
    assert got_new == new


async def _validation_script(client, app):
    out = []

    async def post(body, **kw):
        r = await client.post("/v1/reload", json=body, **kw)
        out.append((r.status, await r.json()))

    await post({"version": "bad ver"})
    await post({"version": "v1", "model": "ghost"})
    await post({"version": "v1", "source": {"seed": 1},
                "defect": {"ttft_delay_s": 99}})
    await post({"version": "v1", "source": ["x"]})
    await post(["not", "an", "object"])
    await post({"version": "x" * 65})
    r = await client.post("/v1/reload", data=b"{nope")
    out.append((r.status, await r.json()))
    # the reloader's ValueError: 400, the replica still serves
    await post({"version": "v1", "source": {}})
    out.append(app[jserver.MODEL_VERSION_KEY]
               if jserver.MODEL_VERSION_KEY in app
               else app[server.MODEL_VERSION_KEY])
    out.append(await _gen(client, max_new=4))
    # an incompatible tree: 400, the old weights stay live
    reloader_key = (jserver.RELOADER_KEY if jserver.RELOADER_KEY in app
                    else server.RELOADER_KEY)
    app[reloader_key] = lambda name, engine, source: {"nonsense": 1}
    await post({"version": "v2", "source": {}})
    out.append(await _gen(client, max_new=4))
    return out


def test_reload_validation_matches_reference_and_keeps_old_weights():
    want = _run(jserver.create_serving_app(
        {"m": _jeng(0)}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_j_reloader), _validation_script)
    got = _run(server.create_serving_app(
        {"m": _teng(0)}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_t_reloader, seed=0), _validation_script)
    assert got == want
    statuses = [x[0] for x in got if isinstance(x, tuple)]
    assert statuses == [400, 404, 400, 400, 400, 400, 400, 400, 400]
    assert "incompatible" in got[-2][1]["error"]
    assert got[-1] == _oracle(0, PROMPT, 4)


def _mismatch_reloader(kind):
    def reload(name, engine, source):
        p = _tparams(1)
        if kind == "shape":
            p["final_norm"] = torch.zeros(7)
        elif kind == "dtype":
            p["blocks"]["wq"] = p["blocks"]["wq"].double()
        elif kind == "missing":
            del p["blocks"]["w_up"]
        else:
            raise RuntimeError("checkpoint store unreachable")
        return p

    return reload


@pytest.mark.parametrize("kind,status,text", [
    ("shape", 400, "leaf final_norm: incoming (7,)/torch.float32 vs live "
                   "(128,)/torch.float32"),
    ("dtype", 400, "leaf blocks.wq: incoming"),
    ("missing", 400, "parameter tree structure differs"),
    ("raises", 500, "RuntimeError: checkpoint store unreachable")])
def test_reload_failure_paths_keep_old_weights(kind, status, text):
    eng = _teng(0)
    before = {n: t.clone() for n, t in checkpoint.flatten(eng.params).items()}

    async def script(client, app):
        r = await client.post("/v1/reload", json={"version": "v9",
                                                  "source": {"seed": 1}})
        body = await r.json()
        draining = app[server.DRAIN_KEY]["draining"]
        return r.status, body, draining, await _gen(client, max_new=4)

    app = server.create_serving_app(
        {"m": eng}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_mismatch_reloader(kind), seed=0, model_version="v0")
    st, body, draining, toks = _run(app, script)
    assert st == status and text in body["error"], body
    assert app[server.MODEL_VERSION_KEY] == "v0"
    assert draining is False
    assert toks == _oracle(0, PROMPT, 4)
    for n, t in checkpoint.flatten(eng.params).items():
        assert torch.equal(t, before[n]), n


def test_reload_drain_timeout_answers_409_with_old_weights():
    async def script(client, app):
        inflight = asyncio.ensure_future(_gen(client, max_new=40))
        b = app[server.BATCHERS_KEY]["m"]
        for _ in range(500):
            if b._active:
                break
            await asyncio.sleep(0.005)
        r = await client.post("/v1/reload",
                              json={"version": "v1", "source": {"seed": 1}})
        status, body = r.status, await r.json()
        return status, body, await inflight, await _gen(client, max_new=4)

    app = server.create_serving_app(
        {"m": _teng(0)}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_t_reloader, seed=0, drain_grace_s=0.0)
    status, body, first, after = _run(app, script)
    assert status == 409 and "weights unchanged" in body["error"]
    assert first == _oracle(0, PROMPT, 40)
    assert after == _oracle(0, PROMPT, 4)
    assert app[server.MODEL_VERSION_KEY] == ""


def test_reload_plants_and_heals_defect():
    async def script(client, app):
        r = await client.post("/v1/reload", json={
            "version": "bad", "source": {"seed": 0},
            "defect": {"ttft_delay_s": 0.2}})
        assert r.status == 200
        planted = dict(app[server.DEFECT_KEY])
        t0 = asyncio.get_running_loop().time()
        await _gen(client, max_new=1)
        slow = asyncio.get_running_loop().time() - t0
        r = await client.post("/v1/reload",
                              json={"version": "good",
                                    "source": {"seed": 0}})
        assert r.status == 200
        return planted, slow, dict(app[server.DEFECT_KEY])

    app = server.create_serving_app(
        {"m": _teng(0)}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_t_reloader, seed=0)
    planted, slow, healed = _run(app, script)
    assert planted == {"ttft_delay_s": 0.2}
    assert slow >= 0.2
    assert healed == {}


def test_reload_forces_registration_with_the_new_version():
    """The stub router holds a registration carrying "v2" before the
    reload's response returns (the heartbeat period is far longer)."""
    bodies: list = []

    async def record(request):
        bodies.append((request.path, await request.json()))
        return web.json_response({"ok": True})

    async def go():
        router = web.Application()
        for path in ("/fleet/register", "/fleet/heartbeat",
                     "/fleet/deregister"):
            router.router.add_post(path, record)
        rs = TestServer(router)
        await rs.start_server()
        app = server.create_serving_app(
            {"m": _teng(0)}, continuous=True, max_batch=2,
            kv_block_size=BS, reloader=_t_reloader, seed=0,
            model_version="v1")
        server.enable_fleet_registration(
            app, f"http://127.0.0.1:{rs.port}", "http://replica:1",
            replica_id="r0", period_s=60.0)
        try:
            async with TestClient(TestServer(app)) as client:
                first = [b["version"] for p, b in bodies
                         if p == "/fleet/register"]
                r = await client.post("/v1/reload", json={
                    "version": "v2", "source": {"seed": 1}})
                assert r.status == 200
                regs = [b["version"] for p, b in bodies
                        if p == "/fleet/register"]
                version = server.fleet_stats(app)["version"]
            return first, regs, version
        finally:
            await rs.close()

    first, regs, version = asyncio.run(go())
    assert first == ["v1"]
    assert regs == ["v1", "v2"] and version == "v2"
    assert [p for p, _ in bodies][-1] == "/fleet/deregister"


@pytest.mark.parametrize("window_ms", [0.0, 5.0])
def test_reload_one_shot_mode(window_ms):
    async def script(client, app):
        before = await _gen(client, max_new=8)
        r = await client.post("/v1/reload",
                              json={"version": "v1", "source": {"seed": 1}})
        assert r.status == 200, await r.text()
        return before, await _gen(client, max_new=8)

    app = server.create_serving_app({"m": _teng(0)},
                                    batch_window_ms=window_ms,
                                    reloader=_t_reloader)
    before, after = _run(app, script)
    assert before == _oracle(0, PROMPT, 8)
    assert after == _oracle(1, PROMPT, 8)


def test_reload_keeps_every_pointer_and_graph_runner():
    """The swap copies into the live tensors: every parameter keeps its
    storage (and the per-layer views theirs), the graph cache keeps its
    runners and captures nothing new, and the new weights' values are
    there."""
    eng = _teng(0)
    ptrs = {n: t.data_ptr() for n, t in checkpoint.flatten(eng.params).items()}
    views = [{n: t.data_ptr() for n, t in layer.items()}
             for layer in eng.layers]

    async def script(client, app):
        b = app[server.BATCHERS_KEY]["m"]
        await _gen(client)
        graphs = b.cengine.graphs
        runners = dict(graphs._runners)
        captures = graphs.captures
        r = await client.post("/v1/reload",
                              json={"version": "v1", "source": {"seed": 1}})
        assert r.status == 200
        toks = await _gen(client)
        return runners, captures, graphs, toks

    app = server.create_serving_app(
        {"m": eng}, continuous=True, max_batch=2, kv_block_size=BS,
        reloader=_t_reloader, seed=0)
    runners, captures, graphs, toks = _run(app, script)
    assert toks == _oracle(1, PROMPT, 12)
    assert {n: t.data_ptr()
            for n, t in checkpoint.flatten(eng.params).items()} == ptrs
    assert [{n: t.data_ptr() for n, t in layer.items()}
            for layer in eng.layers] == views
    assert graphs._runners == runners and graphs.captures == captures
    assert all(graphs._runners[k] is r for k, r in runners.items())
    for n, t in checkpoint.flatten(_tparams(1)).items():
        assert torch.equal(checkpoint.flatten(eng.params)[n], t), n


SYS = [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50]
SPILLED = [60 + i for i in range(24)]


def _cache_app(eng, **kw):
    return server.create_serving_app(
        {"m": eng}, continuous=True, max_batch=2, kv_block_size=BS,
        kv_pool_blocks=18, kv_spill_bytes=1 << 20, prefixes={"sys": SYS},
        seed=0, **kw)


async def _cache_requests(client):
    return [await _gen(client, prompt=PROMPT, max_new=6, prefix="sys"),
            await _gen(client, prompt=SPILLED, max_new=6)]


def test_reload_forgets_spilled_blocks_and_prefix_states():
    """A registered prefix's memoized state and a prompt's spilled
    blocks hold the old weights' KV: after the reload both requests give
    a fresh replica's tokens, and the three caches are empty."""

    async def script(client, app):
        b = app[server.BATCHERS_KEY]["m"]
        await _cache_requests(client)
        # push SPILLED's cached blocks out to the host tier
        for i in range(3):
            await _gen(client, prompt=[100 + 7 * i + t for t in range(40)],
                       max_new=20)
        spilled = b._spill_tier.spilled_blocks
        assert b._spill_tier.contains("", SPILLED[:BS])
        memo = len(b._prefix_states)
        r = await client.post("/v1/reload",
                              json={"version": "v1", "source": {"seed": 1}})
        assert r.status == 200
        emptied = (b._radix.cached_blocks, b._spill_tier.spilled_blocks,
                   len(b._prefix_states))
        conserved = b.cache_anatomy()["ledger"]["conserved"]
        return spilled, memo, emptied, conserved, await _cache_requests(
            client)

    spilled, memo, emptied, conserved, got = _run(
        _cache_app(_teng(0), reloader=_t_reloader), script)
    assert spilled > 0 and memo == 1
    assert emptied == (0, 0, 0) and conserved
    fresh = _run(_cache_app(_teng(1)),
                 lambda client, app: _cache_requests(client))
    assert got == fresh
    assert got[1] == _oracle(1, SPILLED, 6)
    assert got[0] == _oracle(1, SYS + PROMPT, 6)


def test_reload_from_a_checkpoint_through_the_loader(tmp_path):
    """The default reloader (no `reloader=`) loads `source["checkpoint"]`
    at `source["step"]` through train/checkpoint.py, as the CLI's
    `--checkpoint` boots; an uncommitted step is a 400."""
    for step, seed in ((3, 1), (5, 0)):
        d = tmp_path / str(step)
        d.mkdir()
        torch.save(checkpoint.flatten(_tparams(seed)),
                   d / checkpoint.PARAMS_FILE)
        (d / checkpoint.COMMIT_MARKER).write_text("")

    async def script(client, app):
        out = []
        for source in ({"checkpoint": str(tmp_path), "step": 3},
                       {"checkpoint": str(tmp_path)},
                       {"checkpoint": str(tmp_path), "step": 4},
                       {}):
            r = await client.post("/v1/reload",
                                  json={"version": "c", "source": source})
            out.append((r.status, await r.json()))
            out.append(await _gen(client, max_new=8))
        return out

    got = _run(server.create_serving_app(
        {"m": _teng(0)}, continuous=True, max_batch=2, kv_block_size=BS,
        seed=0), script)
    assert got[0][0] == 200 and got[1] == _oracle(1, PROMPT, 8)
    assert got[2][0] == 200 and got[3] == _oracle(0, PROMPT, 8)
    assert got[4][0] == 400 and "no committed step 4" in got[4][1]["error"]
    assert got[5] == _oracle(0, PROMPT, 8)
    assert got[6] == (400, {"error": "reload source needs a 'checkpoint' "
                                     "directory (no custom reloader is "
                                     "installed on this replica)"})


def test_cli_reloader_seed_and_checkpoint(tmp_path):
    """The CLI's reloader: `{"seed": n}` is the model's own init at seed
    n, staged on the host; a checkpoint goes through the boot loader;
    neither is a 400-class error."""
    cfg = tllama.LLAMA_TINY
    reload = cli._make_reloader(tllama.init, cfg, torch.device("cpu"))
    eng = _teng(0)
    got = reload("m", eng, {"seed": 7})
    want = tllama.init(cfg, 7, "cpu")
    assert checkpoint.flatten(got).keys() == checkpoint.flatten(want).keys()
    for n, t in checkpoint.flatten(want).items():
        assert torch.equal(checkpoint.flatten(got)[n], t), n
    assert server._params_mismatch(checkpoint.flatten(eng.params),
                                   checkpoint.flatten(got)) == ""
    d = tmp_path / "2"
    d.mkdir()
    torch.save(checkpoint.flatten(_tparams(1)), d / checkpoint.PARAMS_FILE)
    (d / checkpoint.COMMIT_MARKER).write_text("")
    ck = reload("m", eng, {"checkpoint": str(tmp_path), "step": 2})
    for n, t in checkpoint.flatten(_tparams(1)).items():
        assert torch.equal(checkpoint.flatten(ck)[n], t), n
    with pytest.raises(ValueError, match="'checkpoint' or 'seed'"):
        reload("m", eng, {})
    with pytest.raises(ValueError, match="no committed step 9"):
        reload("m", eng, {"checkpoint": str(tmp_path), "step": 9})
    assert os.path.isdir(tmp_path)


def _gemma_params(seed):
    # the init's own final norm: the logprobs must move with the weights
    return dict(jgemma.init(jax.random.key(seed), jgemma.GEMMA_TINY))


def test_reload_gemma_tied_head_follows_the_copy():
    """Gemma's head is the embedding's transpose, read from the live
    `embed` on every call: after a reload the tied head is the new
    embedding's, and the tokens and their logprobs are the reference's
    at the new seed."""
    cfg = tgemma.GEMMA_TINY

    def tparams(seed):
        return bridge.from_jax(jax.tree.map(np.asarray, _gemma_params(seed)),
                               cfg, "cpu")

    def oracle(seed):
        jeng = JEngine(_gemma_params(seed), jgemma.GEMMA_TINY, J_GEMMA,
                       JEngineConfig(max_len=MAX_LEN))
        toks, lps = jeng.generate(jnp.asarray([PROMPT], jnp.int32),
                                  max_new=10, return_logprobs=True)
        return np.asarray(toks)[0].tolist(), np.asarray(lps)[0]

    eng = InferenceEngine(tparams(1), cfg, GEMMA_FAMILY,
                          EngineConfig(max_len=MAX_LEN), device="cpu")
    embed = eng.params["embed"]

    async def gen(client):
        r = await client.post(GEN, json={"tokens": [PROMPT], "max_new": 10,
                                         "logprobs": True})
        body = await r.json()
        return body["tokens"][0], np.asarray(body["logprobs"][0])

    async def script(client, app):
        before = await gen(client)
        r = await client.post("/v1/reload",
                              json={"version": "g2", "source": {"seed": 2}})
        assert r.status == 200, await r.text()
        return before, await gen(client)

    app = server.create_serving_app(
        {"m": eng}, continuous=True, max_batch=2, kv_block_size=BS, seed=0,
        reloader=lambda name, engine, source: tparams(source["seed"]))
    before, after = _run(app, script)
    assert eng.params["embed"] is embed
    for got, want in ((before, oracle(1)), (after, oracle(2))):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1][:len(got[1])],
                                   atol=1e-4)
    assert np.abs(after[1] - before[1]).max() > 1e-2
