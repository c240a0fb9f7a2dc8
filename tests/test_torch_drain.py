"""The port's multi-tenant app, drain and migration routes against the
JAX reference app, on the CPU.

The same LLAMA_TINY weights (the reference's init, lm_head x50 so that
greedy argmax cannot flip) serve through both frameworks'
`create_serving_app` in continuous mode, and the same scripted sessions
run against each: `X-Tenant` routing (a rate-limited tenant's 429 with
the bucket's Retry-After, `/v1/models`' tenant stats, the zero-seeded
`serving_tenant_*` series), a tenant-blind app exporting no tenant
series, `tenancy` refused without `continuous`, the bodyless `/drain`
(admission closed, `/healthz` 503, in-flight work finishing), `/drain`
with migrate between two live servers (streams ending with their
terminal error, a plain `:generate` answered 503 `migrated`, the peer's
migration counters), the 400, 404 and 500 answers of `/v1/migrate/in`
and `/v1/blocks/export`, and a shutdown that drains before it closes.
Statuses, error texts and metric samples compare exactly (a
throttle's retry time, which runs on the wall clock, compares by
form); tokens compare to the reference engine's greedy tokens.
"""

import asyncio
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu import tenancy as jten
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import migration as jmigration
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch import tenancy as tten
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving import migration, server
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

MODEL = "tiny"
GEN = f"/v1/models/{MODEL}:generate"
BS = 8
MAX_LEN = 256
TENANTS = {"tenants": {"live": {"priority": "interactive"},
                       "limited": {"requests_per_s": 0.001,
                                   "request_burst": 1.0},
                       "iso": {"prefix_isolation": True}}}
PROMPT = [3, 5, 7, 11]


@pytest.fixture(scope="module")
def engines():
    cfg = jllama.LLAMA_TINY
    params = dict(jllama.init(jax.random.key(0), cfg))
    params["lm_head"] = params["lm_head"] * 50.0  # argmax can't flip
    jeng = JEngine(params, cfg, J_LLAMA, JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tllama.LLAMA_TINY,
                        "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
        device="cpu")
    return jeng, teng


def _solo(jeng, prompt, max_new):
    return np.asarray(jeng.generate(jnp.asarray([prompt], jnp.int32),
                                    max_new=max_new))[0].tolist()


def _apps(engines, tenancy=True, **kw):
    """(reference app, port app) on the same weights and knobs."""
    jeng, teng = engines
    kw = dict(continuous=True, max_batch=2, kv_block_size=BS, **kw)
    return (
        jserver.create_serving_app(
            {MODEL: jeng},
            tenancy=jten.config_from_dict(TENANTS) if tenancy else None,
            **kw),
        server.create_serving_app(
            {MODEL: teng},
            tenancy=tten.config_from_dict(TENANTS) if tenancy else None,
            seed=0, **kw))


async def _events(resp) -> list[dict]:
    out = []
    async for line in resp.content:
        line = line.strip()
        if line.startswith(b"data: "):
            out.append(json.loads(line[len(b"data: "):]))
    return out


async def _post(client, path, body, headers=None) -> dict:
    async with client.post(path, json=body, headers=headers) as r:
        rec = {"status": r.status, "retry_after": r.headers.get("Retry-After")}
        if r.content_type == "text/event-stream":
            rec["events"] = await _events(r)
        elif r.content_type == "application/json":
            rec["body"] = await r.json()
        else:
            rec["text"] = await r.text()
        return rec


async def _get(client, path) -> dict:
    async with client.get(path) as r:
        if r.content_type == "application/json":
            return {"status": r.status, "body": await r.json()}
        return {"status": r.status, "text": await r.text()}


def _run(app, script):
    async def go():
        async with TestClient(TestServer(app)) as client:
            return await script(client)

    return asyncio.run(go())


def _samples(text: str, prefix: str) -> dict:
    """{sample line without its value: value} of families under prefix"""
    out = {}
    for line in text.splitlines():
        if line.startswith(prefix):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


# -- tenancy through the app ----------------------------------------------------


async def _tenant_session(client):
    body = {"tokens": [PROMPT], "max_new": 4}
    out = {"live": await _post(client, GEN, body, {"X-Tenant": "live"}),
           "default": await _post(client, GEN, body),
           "limited": await _post(client, GEN, body,
                                  {"X-Tenant": "limited"}),
           "throttled": await _post(client, GEN, body,
                                    {"X-Tenant": "limited"}),
           "throttled_stream": await _post(
               client, GEN, {**body, "stream": True},
               {"X-Tenant": "limited"}),
           "stranger": await _post(client, GEN, body,
                                   {"X-Tenant": "who-knows"}),
           "iso": await _post(client, GEN, {"tokens": [list(range(17))],
                                            "max_new": 4},
                              {"X-Tenant": "iso"}),
           "models": await _get(client, "/v1/models")}
    out["metrics"] = (await _get(client, "/metrics"))["text"]
    return out


def _retry(body: dict) -> dict:
    """A throttle's error text with its wall-clock retry time blanked."""
    return {**body, "error": re.sub(r"retry in [0-9.]+s", "retry in Xs",
                                    body["error"])}


def test_tenant_header_routes_and_metrics_match_reference(engines):
    jeng, _ = engines
    japp, tapp = _apps(engines)
    want, got = _run(japp, _tenant_session), _run(tapp, _tenant_session)
    oracle = _solo(jeng, PROMPT, 4)
    for key in ("live", "default", "limited", "stranger"):
        assert got[key]["status"] == want[key]["status"] == 200, key
        assert got[key]["body"]["tokens"] == [oracle]
    assert got["iso"]["body"] == want["iso"]["body"]
    for key in ("throttled", "throttled_stream"):
        assert got[key]["status"] == want[key]["status"] == 429
        assert got[key]["retry_after"] == want[key]["retry_after"] == "60"
        assert _retry(got[key]["body"]) == _retry(want[key]["body"])
        assert "throttled (rate)" in got[key]["body"]["error"]
    tstats = got["models"]["body"]["models"][0]["tenants"]
    assert tstats == want["models"]["body"]["models"][0]["tenants"]
    assert tstats["live"]["completed"] == 1
    assert tstats["default"]["completed"] == 2     # headerless + unknown
    assert tstats["limited"]["throttled"]["rate"] == 2
    for prefix in ("serving_tenant_", "serving_prefix_cache_hits_total",
                   "serving_prefix_cache_misses_total",
                   "serving_migration_"):
        assert _samples(got["metrics"], prefix) == \
            _samples(want["metrics"], prefix), prefix
    samples = _samples(got["metrics"], "serving_tenant_")
    assert samples['serving_tenant_tokens_total{model="tiny",'
                   'tenant="live"}'] == 4
    assert samples['serving_tenant_throttled_total{model="tiny",'
                   'reason="rate",tenant="limited"}'] == 2
    assert samples['serving_tenant_preemptions_total{model="tiny",'
                   'tenant="default"}'] == 0


def test_tenant_blind_app_exports_no_tenant_series(engines):
    japp, tapp = _apps(engines, tenancy=False)

    async def script(client):
        r = await _post(client, GEN, {"tokens": [PROMPT], "max_new": 4},
                        {"X-Tenant": "whoever"})
        return (r["status"], (await _get(client, "/metrics"))["text"],
                (await _get(client, "/v1/models"))["body"])

    want, got = _run(japp, script), _run(tapp, script)
    for status, text, models in (want, got):
        assert status == 200
        assert not _samples(text, "serving_tenant_")
        assert models["models"][0].get("tenants") is None
    assert _samples(got[1], "serving_migration_") == \
        _samples(want[1], "serving_migration_")


def test_tenancy_requires_continuous(engines):
    jeng, teng = engines
    for mod, eng, ten in ((jserver, jeng, jten), (server, teng, tten)):
        with pytest.raises(ValueError, match="require continuous"):
            mod.create_serving_app({MODEL: eng},
                                   tenancy=ten.config_from_dict({}))


def test_cli_tenants_flag(engines, tmp_path):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(TENANTS))
    with pytest.raises(SystemExit):
        cli.parse_args(["--random", "--cpu", "--tenants", str(path)])
    args = cli.parse_args(["--model", "llama-tiny", "--random", "--cpu",
                           "--continuous", "--tenants", str(path),
                           "--drain-grace-s", "2.5", "--max-len", "64"])
    app = cli.build_app(args)
    assert app[server.TENANCY_KEY].names() == ["default", "iso", "limited",
                                               "live"]
    assert app[server.DRAIN_KEY]["grace_s"] == 2.5
    assert cli.parse_args(["--random"]).drain_grace_s == 30.0


# -- the wait-out drain -----------------------------------------------------------


async def _drain_session(client):
    """A stream in flight, then the bodyless drain: admission closes at
    the door, /healthz goes 503, the stream finishes."""
    app = client.server.app
    batchers = app[server.BATCHERS_KEY if server.BATCHERS_KEY in app
                   else jserver.BATCHERS_KEY]
    b = batchers[MODEL]
    stream = asyncio.ensure_future(_post(
        client, GEN, {"tokens": [PROMPT], "max_new": 160, "stream": True}))
    for _ in range(2000):
        if b._active:
            break
        await asyncio.sleep(0.005)
    drain = await _post(client, "/drain", None)
    out = {"drain": drain,
           "healthz": await _get(client, "/healthz"),
           "generate": await _post(client, GEN, {"tokens": [PROMPT]}),
           "score": await _post(client, f"/v1/models/{MODEL}:score",
                                {"tokens": [PROMPT]}),
           "stream": await stream}
    out["in_flight"] = b.in_flight()
    return out


def test_bodyless_drain_closes_the_door_and_finishes_work(engines):
    jeng, _ = engines
    japp, tapp = _apps(engines, tenancy=False)
    want, got = _run(japp, _drain_session), _run(tapp, _drain_session)
    for key in ("generate", "score"):
        assert got[key] == want[key], key
    assert got["generate"]["status"] == 503
    assert got["generate"]["body"] == {"error": "server is draining"}
    assert got["generate"]["retry_after"] == "5"
    assert got["healthz"]["status"] == want["healthz"]["status"] == 503
    assert got["healthz"]["body"]["status"] == "draining"
    assert got["drain"]["status"] == want["drain"]["status"] == 200
    assert got["drain"]["body"]["draining"] is True
    assert got["drain"]["body"]["in_flight"] == 1
    events = got["stream"]["events"]
    assert events[-1] == want["stream"]["events"][-1] == {"done": True,
                                                          "total": 160}
    assert [e["tokens"][0][0] for e in events[:-1]] == \
        _solo(jeng, PROMPT, 160)
    assert got["in_flight"] == want["in_flight"] == 0


# -- the instant drain between two servers ---------------------------------------


def _migrate_pair(app_a, app_b, batchers_key):
    """Two live servers: A streams two generations and holds a third
    (max_batch 2), then drains into B. -> what both answered."""

    async def go():
        async with TestClient(TestServer(app_a)) as a, \
                TestClient(TestServer(app_b)) as b:
            ba = app_a[batchers_key][MODEL]
            rng = np.random.default_rng(4)
            prompts = [rng.integers(0, 512, n).tolist() for n in (6, 13, 9)]
            streams = [asyncio.ensure_future(_post(
                a, GEN, {"tokens": [p], "max_new": 200, "stream": True},
                {"X-Request-Id": f"s-{i}"}))
                for i, p in enumerate(prompts[:2])]
            plain = asyncio.ensure_future(_post(
                a, GEN, {"tokens": [prompts[2]], "max_new": 16},
                {"X-Request-Id": "plain"}))
            for _ in range(4000):
                if len(ba._active) == 2 and len(ba._pending) == 1 and all(
                        len(r.out) >= 9 for r in ba._active.values()):
                    break
                await asyncio.sleep(0.005)
            peer = str(b.make_url("")).rstrip("/")
            drain = await _post(a, "/drain",
                                {"migrate": True, "peers": [peer]})
            out = {"drain": drain, "streams": await asyncio.gather(*streams),
                   "plain": await plain,
                   "healthz": await _get(a, "/healthz"),
                   "metrics_a": (await _get(a, "/metrics"))["text"],
                   "metrics_b": (await _get(b, "/metrics"))["text"],
                   "cached_b": app_b[batchers_key][MODEL]
                   .prefix_cache_stats()["cached_blocks"]}
            return out, prompts

    return asyncio.run(go())


def test_drain_with_migrate_moves_every_sequence(engines):
    jeng, _ = engines
    # two replicas of each framework: A drains into B
    (ja, ta), (jb, tb) = (_apps(engines, tenancy=False),
                          _apps(engines, tenancy=False))
    want, _ = _migrate_pair(ja, jb, jserver.BATCHERS_KEY)
    got, prompts = _migrate_pair(ta, tb, server.BATCHERS_KEY)
    for ans in (want, got):
        assert ans["drain"]["status"] == 200
        body = ans["drain"]["body"]
        assert (body["migrated"], body["failed"], body["in_flight"]) == \
            (3, 0, 0)
        assert ans["healthz"]["status"] == 503
        assert ans["plain"]["status"] == 503
        assert ans["plain"]["retry_after"] == "0"
        b = _samples(ans["metrics_b"], "serving_migration_")
        assert b['serving_migration_in_total{model="tiny"}'] == 3
        blocks = b['serving_migration_blocks_total{direction="in",'
                   'model="tiny"}']
        assert blocks >= 2 and ans["cached_b"] == blocks
        a = _samples(ans["metrics_a"], "serving_migration_")
        assert a['serving_migration_out_total{model="tiny"}'] == 3
        assert a['serving_migration_blocks_total{direction="out",'
                 'model="tiny"}'] == blocks
    assert got["plain"]["body"] == want["plain"]["body"] == {
        "error": "request plain migrated to a peer replica",
        "migrated": True}
    for i, (g, w) in enumerate(zip(got["streams"], want["streams"])):
        assert g["status"] == w["status"] == 200
        assert g["events"][-1]["error"] == w["events"][-1]["error"] == (
            f"MigratedAway: request s-{i} migrated to a peer replica")
        toks = [e["tokens"][0][0] for e in g["events"][:-1]]
        assert g["events"][-1]["total"] == len(toks) >= 9
        assert toks == _solo(jeng, prompts[i], len(toks))


# -- /v1/migrate/in and /v1/blocks/export -----------------------------------------


def _record(teng, n_full=2, **over):
    """A wire record of this pool's geometry with deterministic KV."""
    cfg = teng.cfg
    rng = np.random.default_rng(8)
    shape = (cfg.num_layers, n_full, BS, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    tokens = rng.integers(0, 512, n_full * BS + 3).tolist()
    geometry = {"block_size": BS, "num_kv_heads": cfg.num_kv_heads,
                "head_dim": cfg.head_dim, "num_layers": cfg.num_layers}
    rec = migration.pack_record(
        request_id="m-1", tenant="", ns="", tokens=tokens, out=tokens[-2:],
        lps=[-0.5, -0.5], max_new=8, sampling={}, geometry=geometry,
        kv=(k, v))
    return {**rec, **over}


def test_migrate_in_and_blocks_export_answers_match_reference(engines):
    _, teng = engines
    rec = _record(teng)
    cached = list(range(40, 40 + 3 * BS))

    async def script(client):
        out = {}
        out["bad_json"] = await _post(client, "/v1/migrate/in", None)
        out["no_model"] = await _post(client, "/v1/migrate/in",
                                      {"model": "nope", "record": rec})
        out["version"] = await _post(client, "/v1/migrate/in", {
            "model": MODEL, "record": {**rec, "version": 99}})
        out["geometry"] = await _post(client, "/v1/migrate/in", {
            "model": MODEL, "record": {**rec, "geometry": {
                **rec["geometry"], "num_kv_heads": 1, "head_dim": 256}}})
        out["wedge"] = await _post(client, "/v1/migrate/in", {
            "model": MODEL, "record": rec, "wedge": True})
        out["ok"] = await _post(client, "/v1/migrate/in",
                                {"model": MODEL, "record": rec})
        out["dup"] = await _post(client, "/v1/migrate/in",
                                 {"model": MODEL, "record": rec})
        await _post(client, GEN, {"tokens": [cached], "max_new": 4})
        fetch = migration.prefix_fetch_request(MODEL, cached,
                                               block_size=BS)
        out["export"] = await _post(client, "/v1/blocks/export", fetch)
        out["export_imported"] = await _post(
            client, "/v1/blocks/export", migration.prefix_fetch_request(
                MODEL, rec["tokens"], block_size=BS))
        out["uncached"] = await _post(
            client, "/v1/blocks/export", migration.prefix_fetch_request(
                MODEL, list(range(300, 320)), block_size=BS))
        out["bad_hash"] = await _post(client, "/v1/blocks/export",
                                      {**fetch, "prefix": "0" * 16})
        out["short"] = await _post(client, "/v1/blocks/export",
                                   {**fetch, "tokens": [1, 2]})
        out["export_no_model"] = await _post(client, "/v1/blocks/export",
                                             {**fetch, "model": "nope"})
        out["export_bad_json"] = await _post(client, "/v1/blocks/export",
                                             None)
        out["metrics"] = (await _get(client, "/metrics"))["text"]
        return out

    japp, tapp = _apps(engines, tenancy=False)
    want, got = _run(japp, script), _run(tapp, script)
    for key in ("bad_json", "no_model", "version", "geometry", "wedge",
                "ok", "dup", "uncached", "bad_hash", "short",
                "export_no_model", "export_bad_json"):
        assert got[key] == want[key], key
    assert [got[k]["status"] for k in ("bad_json", "no_model", "version",
                                       "geometry", "wedge", "ok", "dup",
                                       "uncached", "bad_hash")] == [
        400, 404, 400, 400, 500, 200, 200, 404, 400]
    assert got["wedge"]["body"]["error"] == (
        "RuntimeError: migration transfer wedged (fault injection)")
    assert got["ok"]["body"] == {"imported": True, "blocks": 2,
                                 "request_id": "m-1"}
    assert got["dup"]["body"]["blocks"] == 0
    assert _samples(got["metrics"], "serving_migration_") == \
        _samples(want["metrics"], "serving_migration_")
    # the exported prefixes: the imported one comes back bit for bit, the
    # computed one within fp32 noise of the reference's
    back = got["export_imported"]["body"]["record"]
    assert back["tokens"] == rec["tokens"][:2 * BS]
    assert back["kv"]["k"] == rec["kv"]["k"]
    assert back["kv"]["v"] == rec["kv"]["v"]
    g, w = got["export"]["body"], want["export"]["body"]
    assert g["blocks"] == w["blocks"] == 3
    assert g["record"]["tokens"] == w["record"]["tokens"] == cached
    for a, b in zip(migration.decode_kv(g["record"]["kv"]),
                    jmigration.decode_kv(w["record"]["kv"])):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


# -- shutdown ----------------------------------------------------------------------


def test_shutdown_drains_in_flight_work_before_closing(engines):
    """A generation in flight when the server shuts down finishes (the
    drain within drain_grace_s) instead of failing "shut down"."""
    jeng, _ = engines
    oracle = _solo(jeng, PROMPT, 64)

    async def go(app, key, sampling):
        srv = TestServer(app)
        await srv.start_server()
        b = app[key][MODEL]
        fut = asyncio.ensure_future(b.submit(PROMPT, 64, sampling))
        for _ in range(2000):
            if b._active:
                break
            await asyncio.sleep(0.005)
        await srv.close()
        return list(await fut), b.in_flight()

    japp, tapp = _apps(engines, tenancy=False)
    assert asyncio.run(go(japp, jserver.BATCHERS_KEY, ())) == (oracle, 0)
    assert asyncio.run(go(tapp, server.BATCHERS_KEY, None)) == (oracle, 0)


def test_migrate_in_reads_records_past_the_default_body_limit(engines):
    """A record's body at real widths is megabytes (a llama3-1b block is
    8 MiB on the wire); aiohttp's default limit is 1 MiB, which the
    reference keeps. The port reads `/v1/migrate/in` up to the largest
    record its pool can import (`_record_limit`), and answers 413 past
    it."""
    _, teng = engines
    _, tapp = _apps(engines, tenancy=False)
    b = tapp[server.BATCHERS_KEY][MODEL]
    limit = server._record_limit(b)
    cfg = teng.cfg
    assert limit == (2 * cfg.num_layers * MAX_LEN * cfg.num_kv_heads
                     * cfg.head_dim * 4 * 4 // 3 + (1 << 20)) > 1 << 20
    rec = _record(teng)
    # padding in the sampling channel takes the body past 1 MiB but not
    # past the limit, then past the limit
    fits = {**rec, "sampling": {"pad": "x" * ((1 << 20) + 4096)}}
    over = {**rec, "sampling": {"pad": "x" * (limit + 1)}}

    async def script(client):
        return (await _post(client, "/v1/migrate/in",
                            {"model": MODEL, "record": fits}),
                await _post(client, "/v1/migrate/in",
                            {"model": MODEL, "record": over}))

    ok, too_big = _run(tapp, script)
    assert ok["status"] == 200 and ok["body"]["blocks"] == 2
    assert too_big["status"] == 413
    assert too_big["body"] == {"error": f"migration record over {limit} "
                                        "bytes"}
