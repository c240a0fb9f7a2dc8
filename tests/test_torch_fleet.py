"""The port's fleet heartbeats against the JAX reference, on the CPU
(the counterpart of tests/test_fleet.py's registration handshake and
the replica-side `fleet_stats`).

A port replica registers with the JAX package's router at start-up,
heartbeats, re-registers when the router has forgotten it (a 404 on the
heartbeat), serves a generate the router routes to it, and deregisters
at cleanup. `fleet_stats` gives the JAX app's keys and values in the
same state (the same traffic on the same weights; phase seconds through
profilers on a frozen clock, then the same recorded phases), and every
heartbeat payload, taken mid-generation with sequence checkpoints in
it, is plain JSON. `pool` is refused without continuous batching, or
when unknown, with the reference's messages, and the CLI's fleet flags
check as the reference's do.
"""

import asyncio
import json
import socket

import jax
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.fleet import router as router_mod
from kubeflow_tpu.fleet.registry import READY, ReplicaRegistry
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs import profiling as jprof
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import profiling as tprof
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_LEN = 64
PROMPTS = [[3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37],
           [4, 6, 8, 10, 12, 14, 16, 18, 20]]


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fleet_registration_handshake_with_the_jax_router(engines):
    """Register at start-up, heartbeat, re-register after the router
    forgot the replica, take routed traffic, deregister at cleanup."""
    _, teng = engines

    async def go():
        reg = ReplicaRegistry()
        rs = TestServer(router_mod.create_router_app(reg, block_size=BS))
        await rs.start_server()
        port = _free_port()
        app = server.create_serving_app(
            {"tiny": teng}, continuous=True, max_batch=2, kv_block_size=BS,
            seed=0, model_version="v7")
        server.enable_fleet_registration(
            app, f"http://127.0.0.1:{rs.port}", f"http://127.0.0.1:{port}",
            replica_id="r0", period_s=0.05)
        rep_server = TestServer(app, port=port)
        await rep_server.start_server()
        rc = TestClient(rs)
        out = {}
        try:
            rep = reg.get("r0")
            out["registered"] = (rep is not None and rep.state == READY,
                                 rep.models, rep.max_slots, rep.pool,
                                 rep.version)
            hb0 = rep.last_heartbeat
            await asyncio.sleep(0.25)
            out["beating"] = reg.get("r0").last_heartbeat > hb0
            reg.deregister("r0")          # the router restarted
            for _ in range(100):
                await asyncio.sleep(0.02)
                if reg.get("r0") is not None:
                    break
            out["re_registered"] = reg.get("r0") is not None
            r = await rc.post("/v1/models/tiny:generate",
                              json={"tokens": [[1, 2, 3]], "max_new": 2})
            out["routed"] = (r.status, r.headers.get("X-Fleet-Replica"),
                             len((await r.json())["tokens"][0]))
        finally:
            await rep_server.close()      # cleanup deregisters first
            out["deregistered"] = reg.get("r0") is None
            await rc.close()
            await rs.close()
        return out

    out = asyncio.run(go())
    assert out == {"registered": (True, ["tiny"], 2, "mixed", "v7"),
                   "beating": True, "re_registered": True,
                   "routed": (200, "r0", 2), "deregistered": True}


def _frozen(mod):
    return mod.PhaseProfiler(clock=lambda: 0.0)


async def _stats_session(app, mod, profiler_mod):
    b = app[mod.BATCHERS_KEY]["tiny"]
    b.profiler = _frozen(profiler_mod)
    async with TestClient(TestServer(app)) as client:
        for p in PROMPTS + PROMPTS[:1]:
            r = await client.post("/v1/models/tiny:generate",
                                  json={"tokens": [p], "max_new": 6})
            assert r.status == 200
        quiet = mod.fleet_stats(app)
        for phase, s in (("prefill", 1.25), ("prefill_chunk", 0.5),
                         ("decode", 2.0), ("draft", 0.25),
                         ("verify", 0.5), ("admit", 9.0),
                         ("host_gap", 3.0)):
            b.profiler.record(phase, s)
        busy = mod.fleet_stats(app)
        await client.post("/drain")
        return quiet, busy, mod.fleet_stats(app)


@pytest.mark.parametrize("chunked", [False, True])
def test_fleet_stats_matches_the_jax_app(engines, chunked):
    jeng, teng = engines
    kw = dict(continuous=True, max_batch=2, kv_block_size=BS,
              pool="decode", model_version="step-3",
              prefill_chunk_tokens=8 if chunked else None)
    want = asyncio.run(_stats_session(
        jserver.create_serving_app({"tiny": jeng}, **kw), jserver, jprof))
    got = asyncio.run(_stats_session(
        server.create_serving_app({"tiny": teng}, seed=0, **kw), server,
        tprof))
    assert got == want
    quiet, busy, drained = got
    assert quiet["phase_seconds"] == {"prefill": 0.0, "decode": 0.0}
    assert busy["phase_seconds"] == {"prefill": 1.75, "decode": 2.75}
    assert quiet["cache_digest"] and quiet["pool"] == "decode"
    assert drained["draining"] is True


def _plain(x) -> bool:
    """Only JSON's own types, all the way down."""
    if isinstance(x, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in x.items())
    if isinstance(x, list):
        return all(_plain(v) for v in x)
    return x is None or type(x) in (bool, int, float, str)


def test_heartbeat_payload_is_plain_json_mid_generation(engines):
    """Heartbeats taken while generations decode carry sequence
    checkpoints and live stats: every value a plain JSON type (a 0-d
    tensor would make the beat loop raise), and the router's registry
    takes them."""
    _, teng = engines
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
            {"tiny": teng}, continuous=True, max_batch=2, kv_block_size=BS,
            seed=0)
        server.enable_fleet_registration(
            app, f"http://127.0.0.1:{rs.port}", "http://replica:9",
            period_s=0.01)
        try:
            async with TestClient(TestServer(app)) as client:
                b = app[server.BATCHERS_KEY]["tiny"]
                futs = [asyncio.ensure_future(client.post(
                    "/v1/models/tiny:generate",
                    json={"tokens": [p], "max_new": 40})) for p in PROMPTS]
                live = None
                for _ in range(400):
                    await asyncio.sleep(0.005)
                    if b._active and all(r.out for r in b._active.values()):
                        live = server.sequence_checkpoints(app)
                        payload_now = {**server.fleet_stats(app),
                                       "checkpoints": live}
                        break
                for f in futs:
                    assert (await f).status == 200
                await asyncio.sleep(0.05)
            return live, payload_now
        finally:
            await rs.close()

    live, payload_now = asyncio.run(go())
    assert live and all(ck["model"] == "tiny" and ck["out"] for ck in live)
    assert _plain(payload_now)
    json.dumps(payload_now)
    beats = [b for p, b in bodies if p == "/fleet/heartbeat"]
    assert beats and all(_plain(b) for b in beats)
    assert any(b["checkpoints"] for b in beats)
    assert bodies[0][0] == "/fleet/register"
    assert bodies[-1] == ("/fleet/deregister", {"id": "http://replica:9"})
    keys = set(beats[0])
    assert keys == {"id", "url", "models", "checkpoints", "queue_depth",
                    "active_slots", "max_slots", "kv_blocks_free",
                    "kv_blocks_total", "draining", "pool", "version",
                    "phase_seconds", "cache_digest"}
    reg = ReplicaRegistry()
    for b in beats[:3]:
        reg.register(b["url"], replica_id=b["id"],
                     **{k: v for k, v in b.items() if k not in ("url", "id")})


def test_pool_refusals_match_the_reference(engines):
    jeng, teng = engines
    for kw in ({"pool": "gpu"}, {"pool": "prefill"},
               {"pool": "decode", "continuous": False}):
        msgs = []
        for mod, eng in ((jserver, jeng), (server, teng)):
            with pytest.raises(ValueError) as info:
                mod.create_serving_app({"tiny": eng}, **kw)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def test_cli_fleet_flags(capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--random", "--advertise", "http://x:1"])
    assert "--advertise requires --fleet-router" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.parse_args(["--random", "--pool", "decode"])
    assert "--pool prefill/decode requires --continuous" \
        in capsys.readouterr().err
    args = cli.parse_args(["--cpu", "--model", "llama-tiny", "--random",
                           "--continuous", "--pool", "prefill",
                           "--fleet-router", "http://router:8080",
                           "--model-version", "v1", "--host", "10.0.0.5",
                           "--port", "8123", "--max-len", "64"])
    app = cli.build_app(args)
    assert app[server.POOL_KEY] == "prefill"
    assert app[server.MODEL_VERSION_KEY] == "v1"
    state = app[server.FLEET_REG_KEY]
    assert state["router"] == "http://router:8080"
    assert state["advertise"] == "http://10.0.0.5:8123"
    assert app[server.RELOADER_KEY] is not None
