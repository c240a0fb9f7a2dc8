"""The port's peer block fetch (the `X-KV-Peer` hint) against the JAX
reference, on the CPU (the counterpart of tests/test_cache_tier.py's
replica-side and router cases).

The same LLAMA_TINY weights (the reference's init, lm_head x50) serve
through port replicas on local ports. A hinted `:generate` pulls a warm
peer's cached blocks before admission and answers the reference
engine's tokens, booking `fleet_peer_fetch_total{outcome="ok"}` and
`serving_prefill_tokens{source="peer_fetched"}`; a second identical
request is cached locally and fetches nothing. Every failure falls back
to plain prefill with the same tokens: a dead peer and a peer of
another pool geometry are `failed`, an evicted prefix and a prefix the
peer never saw are `miss`. Records cross frameworks (a JAX peer serves a
port replica and the other way round). The reference's router attaches
the hint between two port replicas and stops once the cold replica's
own digest is hot. No fetch runs for a prompt without a full block and a
token, a `prefix` body, a multi-row body or a locally cached prefix,
and an isolated tenant's cached prefix never leaves its replica.
"""

import asyncio
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.fleet import router as router_mod
from kubeflow_tpu.fleet.registry import ReplicaRegistry, rendezvous
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs.cachestats import prefix_hash
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch import tenancy as tten
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_LEN = 64
MAX_NEW = 4
GEN = "/v1/models/tiny:generate"


@pytest.fixture(scope="module")
def engines():
    params = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    params["lm_head"] = params["lm_head"] * 50.0   # argmax can't flip
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tllama.LLAMA_TINY,
                        "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
        device="cpu")
    return jeng, teng


def _gemma_engine():
    cfg = tgemma.GEMMA_TINY
    return InferenceEngine(tgemma.init(cfg, 1, "cpu"), cfg, GEMMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device="cpu")


def _prompt(i: int) -> list[int]:
    # 12 tokens: one full block and a tail, a distinct first block per i
    return [40 + i] * 4 + [3, 5, 7, 11, 13, 17, 19, 23]


def _oracle(jeng, prompt):
    return np.asarray(jeng.generate(jnp.asarray([prompt], jnp.int32),
                                    max_new=MAX_NEW))[0].tolist()


async def _start(engine, mod=server, **kw):
    kw = dict(continuous=True, max_batch=2, kv_block_size=BS, **kw)
    if mod is server:
        kw["seed"] = 0
    app = mod.create_serving_app({"tiny": engine}, **kw)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = TestServer(app, port=port)
    await srv.start_server()
    return app, TestClient(srv), f"http://127.0.0.1:{port}"


async def _gen(client, prompt, peer=None, **headers):
    if peer is not None:
        headers["X-KV-Peer"] = peer
    r = await client.post(GEN, json={"tokens": [prompt], "max_new": MAX_NEW},
                          headers=headers)
    assert r.status == 200, await r.text()
    return (await r.json())["tokens"][0]


async def _metrics(client, prefix: str) -> dict:
    out = {}
    for line in (await (await client.get("/metrics")).text()).splitlines():
        if line.startswith(prefix) and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _fetches(m: dict) -> dict:
    return {o: m[f'fleet_peer_fetch_total{{model="tiny",outcome="{o}"}}']
            for o in ("ok", "miss", "failed")}


def _conserved(app) -> bool:
    return app[server.BATCHERS_KEY]["tiny"].cache_anatomy()["ledger"][
        "conserved"]


def test_peer_fetch_ok_books_sources_and_parity(engines):
    jeng, teng = engines
    p = _prompt(0)

    async def go():
        app_a, ca, _ = await _start(teng)
        app_b, cb, url_b = await _start(teng)
        try:
            warm = await _gen(cb, p)
            hinted = await _gen(ca, p, url_b)
            m1 = await _metrics(ca, "")
            again = await _gen(ca, p, url_b)
            m2 = await _metrics(ca, "fleet_peer_fetch_total")
            mb = await _metrics(cb, "serving_migration_blocks_total")
            return (warm, hinted, again, m1, m2, mb,
                    _conserved(app_a), _conserved(app_b))
        finally:
            await ca.close()
            await cb.close()

    warm, hinted, again, m1, m2, mb, ca_ok, cb_ok = asyncio.run(go())
    assert warm == hinted == again == _oracle(jeng, p)
    assert _fetches(m1) == {"ok": 1, "miss": 0, "failed": 0}
    assert m1['serving_prefill_tokens_count{model="tiny",'
              'source="peer_fetched"}'] == 1
    assert m1['serving_prefill_tokens_sum{model="tiny",'
              'source="peer_fetched"}'] == BS
    # the imported cells seeded the prefill as a radix hit
    assert m1['serving_prefill_tokens_sum{model="tiny",'
              'source="reused"}'] == BS
    # cached locally now: the stale hint fetches nothing
    assert _fetches(m2) == {"ok": 1, "miss": 0, "failed": 0}
    assert mb['serving_migration_blocks_total{direction="out",'
              'model="tiny"}'] == 1
    assert ca_ok and cb_ok


def test_peer_fetch_degradation_matrix(engines):
    """dead peer -> failed; evicted prefix -> miss; another pool
    geometry -> failed; a prefix the peer never saw -> miss. Each falls
    back to plain prefill with the reference's tokens."""
    jeng, teng = engines

    async def go():
        app_a, ca, _ = await _start(teng)
        app_b, cb, url_b = await _start(teng)
        _, cg, url_g = await _start(_gemma_engine())
        try:
            got = [await _gen(ca, _prompt(20), "http://127.0.0.1:9")]
            await _gen(cb, _prompt(21))
            app_b[server.BATCHERS_KEY]["tiny"]._radix.clear()
            got.append(await _gen(ca, _prompt(21), url_b))
            await _gen(cg, _prompt(22))
            got.append(await _gen(ca, _prompt(22), url_g))
            got.append(await _gen(ca, _prompt(23), url_b))
            m = await _metrics(ca, "")
            return got, m, _conserved(app_a)
        finally:
            for c in (ca, cb, cg):
                await c.close()

    got, m, conserved = asyncio.run(go())
    assert got == [_oracle(jeng, _prompt(i)) for i in (20, 21, 22, 23)]
    assert _fetches(m) == {"ok": 0, "miss": 2, "failed": 2}
    assert m['serving_prefill_tokens_count{model="tiny",'
             'source="peer_fetched"}'] == 0
    assert conserved


@pytest.mark.parametrize("direction", ["jax_peer", "port_peer"])
def test_peer_fetch_crosses_frameworks(engines, direction):
    """A port replica pulls a JAX peer's blocks, and a JAX replica a port
    peer's: the same wire record, the reference's tokens."""
    jeng, teng = engines
    p = _prompt(5)
    puller, peer = ((teng, server), (jeng, jserver)) \
        if direction == "jax_peer" else ((jeng, jserver), (teng, server))

    async def go():
        _, ca, _ = await _start(puller[0], puller[1])
        _, cb, url_b = await _start(peer[0], peer[1])
        try:
            await _gen(cb, p)
            toks = await _gen(ca, p, url_b)
            return toks, await _metrics(ca, "fleet_peer_fetch_total")
        finally:
            await ca.close()
            await cb.close()

    toks, m = asyncio.run(go())
    assert toks == _oracle(jeng, p)
    assert _fetches(m) == {"ok": 1, "miss": 0, "failed": 0}


def test_router_peer_hint_two_replicas(engines):
    """The reference's router: rb is hot (its heartbeat digest carries
    the prefix), affinity routes the request to cold ra, the router
    attaches X-KV-Peer naming rb, ra pulls the blocks and answers the
    same tokens. Once ra's own digest is hot, the hint stops."""
    jeng, teng = engines
    prompt = None
    for s in range(3, 2000):
        toks = [s, 1, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29]
        key = router_mod.affinity_key({"tokens": [toks]}, BS)
        if rendezvous(key, ["ra", "rb"]) == "ra":
            prompt = toks
            break
    assert prompt is not None

    async def go():
        app_a, ca, url_a = await _start(teng)
        app_b, cb, url_b = await _start(teng)
        reg = ReplicaRegistry()
        reg.register(url_a, replica_id="ra", models=["tiny"])
        reg.register(url_b, replica_id="rb", models=["tiny"])
        rs = TestServer(router_mod.create_router_app(reg, block_size=BS))
        await rs.start_server()
        rc = TestClient(rs)
        try:
            want = await _gen(cb, prompt)
            dg = server.fleet_stats(app_b)["cache_digest"]
            reg.heartbeat("rb", cache_digest=dg)
            reg.heartbeat("ra", cache_digest=[])
            r = await rc.post(GEN, json={"tokens": [prompt],
                                         "max_new": MAX_NEW})
            first = (r.status, r.headers["X-Fleet-Replica"],
                     (await r.json())["tokens"][0])
            m1 = await _metrics(ca, "fleet_peer_fetch_total")
            dg_a = server.fleet_stats(app_a)["cache_digest"]
            reg.heartbeat("ra", cache_digest=dg_a)
            hdrs = {"Content-Type": "application/json"}
            hint = router_mod._with_peer_hint(
                rs.app[router_mod.FLEET_KEY], {"tokens": [prompt]},
                reg.get("ra"), hdrs)
            r = await rc.post(GEN, json={"tokens": [prompt],
                                         "max_new": MAX_NEW})
            second = (r.status, (await r.json())["tokens"][0])
            m2 = await _metrics(ca, "fleet_peer_fetch_total")
            return want, dg, first, m1, hint is hdrs, second, m2, dg_a
        finally:
            await rc.close()
            await rs.close()
            await ca.close()
            await cb.close()

    want, dg, first, m1, unhinted, second, m2, dg_a = asyncio.run(go())
    h = prefix_hash(prompt[:BS])
    assert any(e["prefix"] == h for e in dg)
    assert any(e["prefix"] == h for e in dg_a)
    assert first == (200, "ra", want) and want == _oracle(jeng, prompt)
    assert _fetches(m1) == {"ok": 1, "miss": 0, "failed": 0}
    assert unhinted
    assert second == (200, want)
    assert _fetches(m2) == {"ok": 1, "miss": 0, "failed": 0}


def test_peer_fetch_skip_rules(engines):
    """No fetch for a prompt without one full block and a token, a
    `prefix` body, a multi-row body, or a prefix cached here already."""
    jeng, teng = engines
    calls: list = []

    async def export(request):
        calls.append(await request.json())
        return web.json_response({"error": "prefix not cached"}, status=404)

    async def go():
        stub = web.Application()
        stub.router.add_post("/v1/blocks/export", export)
        ss = TestServer(stub)
        await ss.start_server()
        peer = f"http://127.0.0.1:{ss.port}"
        _, ca, _ = await _start(teng, prefixes={"sys": [9, 8, 7]})
        try:
            hdr = {"X-KV-Peer": peer}
            await _gen(ca, _prompt(0)[:BS], peer)
            r = await ca.post(GEN, json={"tokens": [_prompt(1)],
                                         "max_new": 2, "prefix": "sys"},
                              headers=hdr)
            assert r.status == 200
            r = await ca.post(GEN, json={"tokens": [_prompt(2), _prompt(3)],
                                         "max_new": 2}, headers=hdr)
            assert r.status == 200
            await _gen(ca, _prompt(4))
            await _gen(ca, _prompt(4), peer)
            skipped = (len(calls), await _metrics(ca,
                                                  "fleet_peer_fetch_total"))
            await _gen(ca, _prompt(6), peer)   # eligible: one miss
            return skipped, len(calls), await _metrics(
                ca, "fleet_peer_fetch_total")
        finally:
            await ca.close()
            await ss.close()

    (n0, m0), n1, m1 = asyncio.run(go())
    assert n0 == 0 and _fetches(m0) == {"ok": 0, "miss": 0, "failed": 0}
    assert n1 == 1 and _fetches(m1) == {"ok": 0, "miss": 1, "failed": 0}


def test_isolated_tenant_prefix_never_leaves_its_replica(engines):
    """A prefix cached under an isolated tenant's namespace is not in the
    shared tree a peer fetch reads: the fetch misses, the answer is the
    plain prefill's."""
    jeng, teng = engines
    p = _prompt(7)
    qos = tten.config_from_dict({"tenants": {
        "iso": {"prefix_isolation": True}}})

    async def go():
        _, ca, _ = await _start(teng)
        app_b, cb, url_b = await _start(teng, tenancy=qos)
        try:
            await _gen(cb, p, **{"X-Tenant": "iso"})
            cached = app_b[server.BATCHERS_KEY]["tiny"]._radix.match(
                p, ns="iso")[0]
            toks = await _gen(ca, p, url_b)
            return bool(cached), toks, await _metrics(
                ca, "fleet_peer_fetch_total")
        finally:
            await ca.close()
            await cb.close()

    cached, toks, m = asyncio.run(go())
    assert cached
    assert toks == _oracle(jeng, p)
    assert _fetches(m) == {"ok": 0, "miss": 1, "failed": 0}
