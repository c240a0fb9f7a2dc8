"""The port's disaggregated prefill handoff against the JAX reference,
on the CPU (the counterpart of tests/test_disagg.py's batcher and
router cases).

The same weights serve through both frameworks (the reference's init;
llama lm_head x50, gemma's final norm at 49, so that greedy argmax
cannot flip). A prompt prefilled on one port batcher (`submit` with
max_new 1, the `:prefill` route's submission), its full-block prefix
exported with `export_prefix` and imported on another, decodes exactly
the tokens of the reference's symmetric replica, on llama and gemma,
chunked and monolithic, reusing every handed-off cell. The route itself
answers what the JAX app answers, handoff by handoff: a short prompt
(nothing to ship), a multi-block prompt (the same block count and wire
bytes), no peer, a dead peer, a throttled tenant (429), the validation
400s and 404, a draining replica (503). Records cross frameworks both
ways; concurrent imports leak no block; and the JAX package's router
over a prefill-role and a decode-role port replica, both registered
through `enable_fleet_registration`, hands the prompt off and pins the
generation to the decode replica.
"""

import asyncio
import re
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu import tenancy as jten
from kubeflow_tpu.fleet import router as router_mod
from kubeflow_tpu.fleet.registry import DECODE, PREFILL, ReplicaRegistry
from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch import tenancy as tten
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_NEW = 24
MAX_LEN = 64
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4]
MODEL = "tiny"
TENANTS = {"tenants": {"limited": {"requests_per_s": 0.001,
                                   "request_burst": 1.0}}}


def _pair(family):
    """(reference engine, port engine) on the same weights."""
    if family == "llama":
        jcfg, tcfg = jllama.LLAMA_TINY, tllama.LLAMA_TINY
        params = dict(jllama.init(jax.random.key(0), jcfg))
        params["lm_head"] = params["lm_head"] * 50.0
        jfam, tfam = J_LLAMA, LLAMA_FAMILY
    else:
        jcfg, tcfg = jgemma.GEMMA_TINY, tgemma.GEMMA_TINY
        params = dict(jgemma.init(jax.random.key(1), jcfg))
        params["final_norm"] = jnp.full_like(params["final_norm"], 49.0)
        jfam, tfam = J_GEMMA, GEMMA_FAMILY
    jeng = JEngine(params, jcfg, jfam, JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"),
        tcfg, tfam, EngineConfig(max_len=MAX_LEN), device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def gemma():
    return _pair("gemma")


def _solo(jeng, prompt, max_new=MAX_NEW):
    return np.asarray(jeng.generate(jnp.asarray([prompt], jnp.int32),
                                    max_new=max_new))[0].tolist()


def _batcher(engine, chunked):
    return ContinuousBatcher(engine, asyncio.Lock(), max_slots=2,
                             kv_block_size=BS, seed=0,
                             prefill_chunk_tokens=8 if chunked else None)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_handoff_token_parity_vs_symmetric_oracle(family, chunked, request):
    """Prefill on A, ship the full-block prefix, decode on B: exactly the
    reference's symmetric tokens, every handed-off cell reused."""
    jeng, teng = request.getfixturevalue(family)
    oracle = _solo(jeng, PROMPT)

    async def go():
        pre, dec = _batcher(teng, chunked), _batcher(teng, chunked)
        try:
            await pre.submit(PROMPT, 1)
            rec = await pre.export_prefix(PROMPT)
            adopted = await dec.import_sequence(rec)
            out = await dec.submit(PROMPT, MAX_NEW)
            books = (dec.prefix_hits, dec.tokens_reused,
                     dec.tokens_prefilled,
                     dec.cache_anatomy()["ledger"]["conserved"])
            return rec, adopted, out, books
        finally:
            await pre.close()
            await dec.close()

    rec, adopted, out, books = asyncio.run(go())
    n_full = len(PROMPT) // BS
    assert rec["out"] == [] and rec["max_new"] == 0
    assert rec["kv"]["n_full"] == n_full == adopted
    assert rec["tokens"] == PROMPT[:n_full * BS]
    assert out == oracle
    assert books == (1, n_full * BS, len(PROMPT) - n_full * BS, True)


def test_export_prefix_skips_short_or_uncached_prompts(llama):
    _, teng = llama

    async def go():
        b = _batcher(teng, False)
        try:
            out = [await b.export_prefix(PROMPT)]   # no slot state yet
            await b.submit(PROMPT, 1)
            out.append(await b.export_prefix(PROMPT[:BS - 1]))
            out.append(await b.export_prefix([9] * (2 * BS)))
            return out
        finally:
            await b.close()

    assert asyncio.run(go()) == [None, None, None]


def test_concurrent_imports_leak_no_block(llama):
    _, teng = llama
    prompts = [[31 + i, 7] + [11 + (i + t) % 150 for t in range(2 * BS - 2)]
               for i in range(6)]

    async def go():
        pre, dec = _batcher(teng, True), _batcher(teng, True)
        try:
            records = []
            for p in prompts:
                await pre.submit(p, 1)
                records.append(await pre.export_prefix(p))
            adopted = await asyncio.gather(
                *(dec.import_sequence(r) for r in records))
            books = (dec.cengine.pool.in_use, dec._radix.cached_blocks,
                     dec.cache_anatomy()["ledger"]["conserved"])
            # a handed-off prompt decodes from its imported blocks
            out = await dec.submit(prompts[3], 4)
            return adopted, books, out, dec.tokens_reused
        finally:
            await pre.close()
            await dec.close()

    adopted, (in_use, cached, conserved), out, reused = asyncio.run(go())
    assert adopted == [len(p) // BS for p in prompts]
    assert in_use == cached == sum(adopted) and conserved
    assert out == _solo(llama[0], prompts[3], 4)
    assert reused == 2 * BS - 1


# -- the :prefill route -------------------------------------------------------


def _dead_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _apps(mod, eng, tenancy_mod, **kw):
    """A prefill-role app and a decode-role app of one framework."""
    kw = dict(continuous=True, max_batch=2, kv_block_size=BS, **kw)
    if mod is server:
        kw["seed"] = 0
    return (mod.create_serving_app(
                {MODEL: eng}, pool="prefill",
                tenancy=tenancy_mod.config_from_dict(TENANTS), **kw),
            mod.create_serving_app({MODEL: eng}, pool="decode", **kw))


def _metric(text: str, prefix: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith(prefix):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


async def _route_session(pre_app, dec_app):
    dead = _dead_url()
    url = f"/v1/models/{MODEL}:prefill"
    long_prompt = PROMPT + [7, 7, 2, 9, 1]
    out = []
    async with TestClient(TestServer(dec_app)) as dec, \
            TestClient(TestServer(pre_app)) as pre:
        peer = str(dec.make_url("")).rstrip("/")

        async def post(body, headers=None, path=url):
            hdrs = {"X-Request-Id": "rid-1", **(headers or {})}
            r = await pre.post(path, json=body, headers=hdrs)
            rec = await r.json()
            rec.pop("handoff_s", None)
            if "error" in rec:
                # a throttle's retry time runs on the wall clock: by form
                rec["error"] = re.sub(r"retry in [0-9.]+s", "retry in Ns",
                                      rec["error"])
            out.append((r.status, rec, r.headers.get("Retry-After")))

        await post({"tokens": [PROMPT[:BS - 2]], "peer": peer})
        await post({"tokens": [long_prompt], "peer": peer})
        await post({"tokens": [PROMPT]})
        await post({"tokens": [PROMPT[::-1]], "peer": dead})
        await post({"tokens": [PROMPT[1:]]}, {"X-Tenant": "limited"})
        await post({"tokens": [PROMPT[2:]]}, {"X-Tenant": "limited"})
        await post({"tokens": [PROMPT]}, path="/v1/models/ghost:prefill")
        await post({"tokens": [PROMPT, PROMPT]})
        await post({"tokens": [[1, 2, 9999]]})
        await post({"tokens": [list(range(3, 3 + MAX_LEN))]})
        await post({"tokens": [PROMPT], "peer": 7})
        await post({"nothing": 1})
        # the decode replica generates from the handed-off blocks
        r = await dec.post(f"/v1/models/{MODEL}:generate",
                           json={"tokens": [long_prompt],
                                 "max_new": MAX_NEW})
        out.append((r.status, (await r.json())["tokens"]))
        pm = _metric(await (await pre.get("/metrics")).text(),
                     "serving_migration")
        dm = _metric(await (await dec.get("/metrics")).text(),
                     "serving_migration")
        dreuse = _metric(await (await dec.get("/metrics")).text(),
                         'serving_prefill_tokens_sum{model="tiny",'
                         'source="reused"}')
        out.append((pm, dm, dreuse))
        await pre.post("/drain")
        await post({"tokens": [PROMPT], "peer": peer})
    return out


def test_prefill_route_matches_reference(llama):
    jeng, teng = llama
    want = asyncio.run(_route_session(*_apps(jserver, jeng, jten)))
    got = asyncio.run(_route_session(*_apps(server, teng, tten)))
    assert got == want
    short, long_, nopeer, dead, limited, throttled = got[:6]
    assert short[1] == {"prefilled": True, "handoff": False, "blocks": 0,
                        "bytes": 0, "request_id": "rid-1"}
    assert long_[1]["handoff"] and long_[1]["blocks"] == 3
    assert long_[1]["bytes"] > 0
    assert nopeer[1]["handoff"] is False and nopeer[1]["blocks"] == 2
    assert dead[1]["handoff"] is False and dead[1]["blocks"] == 2
    assert limited[0] == 200 and throttled[0] == 429
    assert throttled[1] == {"error": "tenant 'limited' throttled (rate); "
                                     "retry in Ns"}
    assert [x[0] for x in got[6:12]] == [404, 400, 400, 400, 400, 400]
    assert got[12] == (200, [_solo(jeng, PROMPT + [7, 7, 2, 9, 1])])
    pm, dm, reused = got[13]
    assert pm['serving_migration_out_total{model="tiny"}'] == 1
    assert pm['serving_migration_failed_total{direction="out",'
              'model="tiny"}'] == 1
    assert dm['serving_migration_in_total{model="tiny"}'] == 1
    assert dm['serving_migration_blocks_total{direction="in",'
              'model="tiny"}'] == 3
    assert reused == {'serving_prefill_tokens_sum{model="tiny",'
                      'source="reused"}': 3 * BS}
    assert got[14][:2] == (503, {"error": "server is draining"})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_records_cross_frameworks(llama, direction):
    """A JAX prefill replica hands off to a port decode replica, and a
    port prefill replica to a JAX one: either way the decode replica
    reuses the handed-off cells and gives the reference's tokens."""
    jeng, teng = llama
    kw = dict(continuous=True, max_batch=2, kv_block_size=BS)
    japp = jserver.create_serving_app({MODEL: jeng}, **kw)
    tapp = server.create_serving_app({MODEL: teng}, seed=0, **kw)
    pre_app, dec_app = (japp, tapp) if direction == "jax_to_port" \
        else (tapp, japp)
    prompt = PROMPT + [4, 4]

    async def go():
        async with TestClient(TestServer(dec_app)) as dec, \
                TestClient(TestServer(pre_app)) as pre:
            peer = str(dec.make_url("")).rstrip("/")
            r = await pre.post(f"/v1/models/{MODEL}:prefill",
                               json={"tokens": [prompt], "peer": peer})
            handed = await r.json()
            r = await dec.post(f"/v1/models/{MODEL}:generate",
                               json={"tokens": [prompt], "max_new": MAX_NEW})
            toks = (await r.json())["tokens"][0]
            b = dec_app[jserver.BATCHERS_KEY if dec_app is japp
                        else server.BATCHERS_KEY][MODEL]
            return handed, toks, b.tokens_reused

    handed, toks, reused = asyncio.run(go())
    assert handed["handoff"] is True and handed["blocks"] == 2
    assert toks == _solo(jeng, prompt)
    assert reused == 2 * BS


def test_jax_router_pins_generation_to_port_decode_replica(llama):
    """The reference's router over two port replicas that registered
    themselves (pool roles in the payload): the prompt is prefilled on
    the prefill replica, its blocks handed to the decode replica, and
    the generation is served there from them."""
    jeng, teng = llama
    prompt = PROMPT + [6, 6, 6]

    async def go():
        reg = ReplicaRegistry()
        rs = TestServer(router_mod.create_router_app(
            reg, block_size=BS, hedge_after_s=0, backoff_s=0.001))
        await rs.start_server()
        router_url = f"http://127.0.0.1:{rs.port}"
        servers = {}
        for rid, pool in (("pre", "prefill"), ("dec", "decode")):
            app = server.create_serving_app(
                {MODEL: teng}, continuous=True, max_batch=2,
                kv_block_size=BS, seed=0, pool=pool)
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            server.enable_fleet_registration(
                app, router_url, f"http://127.0.0.1:{port}",
                replica_id=rid, period_s=0.05)
            servers[rid] = TestServer(app, port=port)
            await servers[rid].start_server()
        rc = TestClient(rs)
        try:
            pools = (reg.get("pre").pool, reg.get("dec").pool)
            r = await rc.post(f"/v1/models/{MODEL}:generate",
                              json={"tokens": [prompt], "max_new": MAX_NEW})
            assert r.status == 200, await r.text()
            served_by = r.headers["X-Fleet-Replica"]
            toks = (await r.json())["tokens"][0]
            stats = await (await rc.get("/fleet/stats")).json()
            dec_b = servers["dec"].app[server.BATCHERS_KEY][MODEL]
            pre_b = servers["pre"].app[server.BATCHERS_KEY][MODEL]
            return (pools, served_by, toks, stats, dec_b.tokens_reused,
                    pre_b.requests, dec_b.requests)
        finally:
            await rc.close()
            for srv in servers.values():
                await srv.close()
            await rs.close()

    pools, served_by, toks, stats, reused, pre_n, dec_n = asyncio.run(go())
    assert pools == (PREFILL, DECODE)
    assert served_by == "dec"
    assert toks == _solo(jeng, prompt)
    assert stats["handoff"]["ok"] == 1 and stats["handoff"]["failed"] == 0
    assert stats["handoff_bytes"] > 0
    assert reused == 2 * BS and (pre_n, dec_n) == (1, 1)
