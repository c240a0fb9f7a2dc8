"""The port's tracer doors, compile watch, counter tracks and KV
observatory families against the JAX reference, on the CPU.

Unit parity first: `abstract_signature` renders numpy and torch inputs
of one shape and dtype as the reference renders them; `CompileWatch`
counts the same recompiles on one call sequence (a `recompile` span
carries the same signature); `PhaseProfiler.counter_events` and
`CacheLedger.counter_events` give the same events, timestamps aside, on
one `note_*` sequence, and the ledger's hooks fire as the reference's.

Then the apps, LLAMA_TINY with the same weights in both frameworks: the
new families (`serving_recompiles_total`, `serving_kv_evictions_total`,
`serving_kv_admission_defers_total`, the reuse-distance and block-age
histograms) are zero-seeded with the reference's label sets; one script
of traffic (generate, SSE, a peer block fetch and a prefill handoff
across the two frameworks' replicas, a reload, an instant drain; and on
one-shot apps a direct generate, an SSE stream, `:score` and
speculative decoding) opens the same set of spans on the port's apps as
on the reference's, and `/debug/profile` answers with the same keys.
Port-only: after `warmup` the compile watch stands at the graph runner's
warmed sets less one a fn and traffic leaves it flat, `/metrics` mirrors
it; `/debug/traces` carries the counter tracks under the model's name,
answers 400 (with `X-Trace-Id`) on a bad limit; a valid `X-Trace-Id` /
`X-Parent-Span` pair is adopted and a malformed one starts a new trace.
"""

import asyncio
import json
import re
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs import cachestats as jcs
from kubeflow_tpu.obs import profiling as jprof
from kubeflow_tpu.obs import tracing as jtr
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch import obs as tobs
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import cachestats as tcs
from kubeflow_tpu_torch.obs import profiling as tprof
from kubeflow_tpu_torch.obs import tracing as ttr
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_LEN = 64
MAX_NEW = 4
MODEL = "tiny"
GEN = f"/v1/models/{MODEL}:generate"
NEW_FAMILIES = ("serving_recompiles_total", "serving_kv_evictions_total",
                "serving_kv_admission_defers_total",
                "serving_kv_reuse_distance_admissions",
                "serving_kv_block_age_admissions")


# -- unit parity -------------------------------------------------------------


SIG_CASES = [((2, 3), np.float32, torch.float32),
             ((4,), np.int64, torch.int64),
             ((1, 8, 2), np.bool_, torch.bool),
             ((), np.int32, torch.int32),
             ((5, 0), np.float16, torch.float16)]


@pytest.mark.parametrize("shape,npt,tt", SIG_CASES)
def test_abstract_signature_numpy_and_torch_agree(shape, npt, tt):
    a = np.zeros(shape, npt)
    t = torch.zeros(shape, dtype=tt)
    args = (a, 3, "x", None, [a, 1.5], {"k": a, "b": True})
    targs = (t, 3, "x", None, [t, 1.5], {"k": t, "b": True})
    want = jprof.abstract_signature(args, {"kw": a})
    assert tprof.abstract_signature(args, {"kw": a}) == want
    assert tprof.abstract_signature(targs, {"kw": t}) == want


def test_abstract_signature_bfloat16_reads_as_the_reference():
    spec = jax.ShapeDtypeStruct((2, 16), jnp.bfloat16)
    t = torch.zeros(2, 16, dtype=torch.bfloat16)
    assert tprof.abstract_signature((t,), {}) == \
        jprof.abstract_signature((spec,), {}) == "(bfloat16[2,16])"
    assert tprof.abstract_signature((object(),), {}) == \
        jprof.abstract_signature((object(),), {})


def _calls(torch_side: bool):
    mk = ((lambda s: torch.zeros(s)) if torch_side
          else (lambda s: np.zeros(s, np.float32)))
    return [(mk((2, 4)), 1), (mk((2, 4)), 1), (mk((4, 4)), 1),
            (mk((2, 4)), 2), (mk((4, 4)), 1), (mk((8, 4)), 3)]


def test_compile_watch_counts_and_spans_agree():
    got = []
    for mod, tmod, torch_side in ((jprof, jtr, False), (tprof, ttr, True)):
        tracer = tmod.Tracer()
        hooks = []
        watch = mod.CompileWatch(
            tracer=tracer, on_recompile=lambda fn, sig: hooks.append(fn))
        f = watch.watch(lambda x, n: n, "decode_step")
        g = watch.watch(lambda x, n: n, "prefill")
        for x, n in _calls(torch_side):
            f(x, n)
        g(*_calls(torch_side)[0])
        sigs = [t["spans"][0]["attrs"]["signature"]
                for t in tracer.traces(name="recompile")]
        got.append((watch.counts(), hooks, watch.watched(), sigs))
    assert got[0] == got[1]
    assert got[1][0] == {"decode_step": 3, "prefill": 0}
    assert got[1][3][0] == "(float32[8,4],3)"


def test_compile_watch_key_and_a_raising_hook():
    seen = []

    def boom(fn, sig):
        seen.append(sig)
        raise RuntimeError("hook")

    watch = tprof.CompileWatch(on_recompile=boom)
    f = watch.watch(lambda buf, steps, key: steps, "decode_step",
                    key=lambda buf, steps, key: (steps, *key))
    buf = torch.zeros(8)
    for steps, key in [(1, (False, False)), (1, (False, False)),
                       (2, (False, False)), (1, (True, False))]:
        assert f(buf, steps, key) == steps
    assert watch.counts() == {"decode_step": 2}
    assert seen == ["(2,False,False)", "(1,True,False)"]


def _profiler_script(p):
    p.begin_iteration()
    with p.phase("admit"):
        with p.phase("prefill", tokens=16):
            pass
    with p.phase("decode", tokens=8):
        pass
    for n in (3, 3, 5, 2):
        p.note_pool(n, 8)
    for n in (1, 2, 2, 0):
        p.note_occupancy(n, 4)
    p.end_iteration()
    p.begin_iteration()
    p.record("sample", 0.5)
    p.end_iteration()


def _no_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _phase_free(events):
    # phase totals are wall times; their names and the other tracks are
    # what two runs can share
    return [e if not e["name"].endswith("phase_seconds")
            else {**e, "args": sorted(e["args"])} for e in events]


@pytest.mark.parametrize("prefix", ["", "llama3-1b"])
def test_profiler_counter_events_agree(prefix):
    evs = []
    for mod in (jprof, tprof):
        p = mod.PhaseProfiler(wall_clock=lambda: 7.0)
        _profiler_script(p)
        evs.append(_phase_free(_no_ts(p.counter_events(prefix=prefix))))
    assert evs[0] == evs[1]
    names = [e["name"].split(".")[-1] for e in evs[1]]
    assert names.count("kv_blocks") == 3
    assert names.count("batch_occupancy") == 3
    assert names.count("phase_seconds") == 2
    if prefix:
        assert all(e["name"].startswith(prefix + ".") for e in evs[1])


def _ledger_script(led):
    led.note_alloc([1, 2, 3, 4])
    led.note_admission()
    led.note_reuse([1, 2, 9])
    led.note_admission()
    led.note_admission()
    led.note_reuse([1])
    led.note_free([3], "refdrop")
    led.note_free([], "lru")
    led.note_free([4], "spill")
    led.note_restore(1)
    led.note_alloc([5])
    led.note_free([2, 5], None)
    led.note_spill_drop(0)
    led.note_defer("kv_quota")
    led.note_defer("weird")


def test_ledger_counter_events_and_hooks_agree():
    got = []
    for mod in (jcs, tcs):
        led = mod.CacheLedger(wall=lambda: 3.0)
        calls = []
        led.on_free = lambda c, n: calls.append(("free", c, n))
        led.on_reuse = lambda d: calls.append(("reuse", d))
        led.on_age = lambda a: calls.append(("age", a))
        led.on_defer = lambda c: calls.append(("defer", c))
        led.on_spill = lambda k, n: calls.append(("spill", k, n))
        _ledger_script(led)
        snap = led.snapshot()
        got.append((_no_ts(led.counter_events(prefix="m")), calls,
                    led.frees_total(), led.live_blocks(),
                    {k: snap[k] for k in ("frees", "frees_total",
                                          "live_blocks", "defers",
                                          "spill", "conserved")}))
    assert got[0] == got[1]
    evs = got[1][0]
    assert len(evs) == 4 and evs[0]["args"] == dict.fromkeys(
        tcs.EVICTION_CAUSES, 0)
    assert tcs.REUSE_BUCKETS == jcs.REUSE_BUCKETS
    assert tobs.REUSE_BUCKETS == jcs.REUSE_BUCKETS


def test_merge_counter_tracks_agrees():
    ev = [{"name": "m.kv_blocks", "ph": "C", "ts": 1.0, "pid": 1,
           "tid": 0, "args": {"in_use": 2}}]
    for payload in ({"traceEvents": []}, {"traces": []}, []):
        a = json.loads(json.dumps(payload))
        b = json.loads(json.dumps(payload))
        assert tprof.merge_counter_tracks(a, ev) == \
            jprof.merge_counter_tracks(b, ev)
    assert tprof.WATCHED_SERVING_FNS == jprof.WATCHED_SERVING_FNS
    assert tprof.WATCHED_TRAIN_FNS == jprof.WATCHED_TRAIN_FNS


# -- the apps ----------------------------------------------------------------


def _jparams(seed=0):
    params = dict(jllama.init(jax.random.key(seed), jllama.LLAMA_TINY))
    params["lm_head"] = params["lm_head"] * 50.0   # argmax can't flip
    return params


@pytest.fixture(scope="module")
def engines():
    params = _jparams()
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN))
    host = jax.tree.map(np.asarray, params)

    def teng():
        return InferenceEngine(
            bridge.from_jax(host, tllama.LLAMA_TINY, "cpu"),
            tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
            device="cpu")

    return jeng, teng, params


async def _start(mod, engine, **kw):
    if mod is server:
        kw.setdefault("seed", 0)
    app = mod.create_serving_app({MODEL: engine}, **kw)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = TestServer(app, port=port)
    await srv.start_server()
    return app, TestClient(srv), f"http://127.0.0.1:{port}"


def _families(text: str) -> dict:
    """{family: sorted label sets} of the new families' samples."""
    out: dict = {}
    for line in text.splitlines():
        m = re.match(r"([a-z_]+?)(_bucket|_sum|_count)?(\{[^}]*\})? ", line)
        if m is None or line.startswith("#"):
            continue
        fam = m.group(1)
        if fam in NEW_FAMILIES:
            labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                             m.group(3) or "")))
            out.setdefault(fam, set()).add((m.group(2) or "", labels))
    return {k: sorted(v) for k, v in out.items()}


def _metric(text: str, name: str, **labels) -> float:
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    for line in text.splitlines():
        if line.startswith(f"{name}{{{want}}} "):
            return float(line.rsplit(" ", 1)[1])
    raise KeyError((name, labels))


def test_new_families_are_zero_seeded_as_the_reference(engines):
    jeng, teng, _ = engines

    async def go():
        texts = []
        for mod, eng in ((jserver, jeng), (server, teng())):
            app, client, _ = await _start(mod, eng, continuous=True,
                                          max_batch=2, kv_block_size=BS)
            try:
                texts.append(await (await client.get("/metrics")).text())
            finally:
                await client.close()
        return texts

    jtext, ttext = asyncio.run(go())
    assert _families(ttext) == _families(jtext)
    assert set(_families(ttext)) == set(NEW_FAMILIES)
    for fn in tprof.WATCHED_SERVING_FNS:
        assert _metric(ttext, "serving_recompiles_total", model=MODEL,
                       fn=fn) == 0
    assert _metric(ttext, "serving_kv_evictions_total", model=MODEL,
                   cause="unattributed") == 0


def _reloader(params):
    def reload(name, engine, source):
        return params
    return reload


def _span_names(app, mod) -> set:
    tracer = app[mod.OBS_KEY].tracer
    return {s["name"] for t in tracer.traces(limit=None)
            for s in t["spans"]}


async def _post(client, path, body, status=200, **headers):
    r = await client.post(path, json=body, headers=headers)
    assert r.status == status, await r.text()
    return r


async def _continuous_script(replicas, reload_body):
    """Each replica in turn, stage by stage (a reload flushes the cache
    its peer fetches from, a drain closes the door): a generate, an SSE
    stream, a hinted generate that fetches its prompt's blocks from the
    peer, a prefill handoff to the peer; then a reload, `/debug/profile`
    and an instant drain. `replicas`: (client, peer url, fetched prompt,
    handed-off prompt) a replica."""
    for mine, peer_url, prompt, handoff_prompt in replicas:
        await _post(mine, GEN, {"tokens": [[9, 8, 7]], "max_new": MAX_NEW})
        r = await _post(mine, GEN, {"tokens": [[9, 8, 6]],
                                    "max_new": MAX_NEW, "stream": True})
        assert r.headers.get("X-Trace-Id")
        await r.read()
        await _post(mine, GEN, {"tokens": [prompt], "max_new": MAX_NEW},
                    **{"X-KV-Peer": peer_url})
        body = await (await _post(
            mine, f"/v1/models/{MODEL}:prefill",
            {"tokens": [handoff_prompt], "peer": peer_url})).json()
        assert body["handoff"] and body["blocks"] == 1
    profiles = []
    for mine, *_ in replicas:
        await _post(mine, "/v1/reload", reload_body)
        profiles.append(await (await mine.get("/debug/profile")).json())
    for mine, peer_url, *_ in replicas:
        await _post(mine, "/drain", {"migrate": True, "peers": [peer_url]})
    return profiles


def _keys(d, depth=0):
    if not isinstance(d, dict) or depth > 3:
        return None
    return {k: _keys(v, depth + 1) for k, v in d.items()
            if k not in ("heat",)}


def test_every_path_opens_the_reference_spans(engines):
    """A continuous replica of each framework serves the other as its
    peer (block fetch, handoff, migration records cross frameworks), so
    each opens both sides' spans; then a one-shot app of each."""
    jeng, teng, params = engines
    host = bridge.from_jax(jax.tree.map(np.asarray, params),
                           tllama.LLAMA_TINY, "cpu")
    p_j = [21] * BS + [1, 2, 3]      # warm on the port, fetched by jax
    p_t = [22] * BS + [1, 2, 3]      # warm on jax, fetched by the port
    h_j, h_t = [23] * BS + [4], [24] * BS + [5]
    reload_body = {"version": "v2", "source": {}}

    async def go():
        kw = dict(continuous=True, max_batch=2, kv_block_size=BS)
        japp, jc, jurl = await _start(jserver, jeng,
                                      reloader=_reloader(params), **kw)
        tapp, tc, turl = await _start(server, teng(),
                                      reloader=_reloader(host), **kw)
        try:
            await _post(tc, GEN, {"tokens": [p_j], "max_new": MAX_NEW})
            await _post(jc, GEN, {"tokens": [p_t], "max_new": MAX_NEW})
            jprofile, tprofile = await _continuous_script(
                [(jc, turl, p_j, h_j), (tc, jurl, p_t, h_t)], reload_body)
            cont = (_span_names(japp, jserver), _span_names(tapp, server))
        finally:
            await jc.close()
            await tc.close()
        jdraft = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                         JEngineConfig(max_len=MAX_LEN))
        one = []
        for mod, eng, draft in ((jserver, jeng, jdraft),
                                (server, teng(), teng())):
            app, c, _ = await _start(mod, eng, drafts={MODEL: draft})
            try:
                await _post(c, GEN, {"tokens": [[5, 6, 7]],
                                     "max_new": MAX_NEW})
                r = await _post(c, GEN, {"tokens": [[5, 6, 7]],
                                         "max_new": MAX_NEW,
                                         "stream": True})
                await r.read()
                await _post(c, f"/v1/models/{MODEL}:score",
                            {"tokens": [[5, 6, 7, 8]]})
                await _post(c, GEN, {"tokens": [[5, 6, 7]],
                                     "max_new": MAX_NEW,
                                     "speculative": True, "gamma": 2})
                one.append(_span_names(app, mod))
            finally:
                await c.close()
        return cont, one, jprofile, tprofile

    (jcont, tcont), (jone, tone), jprofile, tprofile = asyncio.run(go())
    assert tcont == jcont
    assert tcont >= {"http.request", "batcher.submit", "decode.attention",
                     "stream.continuous", "peer.fetch", "blocks.export",
                     "prefill.handoff", "migrate.in", "weights.reload",
                     "migrate.out"}
    assert tone == jone
    assert tone >= {"http.request", "engine.generate", "device.generate",
                    "stream.decode", "engine.score", "device.score",
                    "engine.speculative"}
    assert _keys(tprofile) == _keys(jprofile)
    assert set(tprofile["models"][MODEL]["recompiles"]) == set(
        jprofile["models"][MODEL]["recompiles"])


def _runner_keys(batcher) -> dict:
    """The graph runner's warmed keys by the watch's fn name."""
    kinds = {"step": "decode_step", "slice": "prefill_append",
             "spec_draft": "spec_draft", "spec_verify": "spec_verify"}
    out: dict = {}
    for key in batcher.cengine.graphs._runners:
        fn = kinds[key[0]]
        out[fn] = out.get(fn, 0) + 1
    return out


@pytest.mark.parametrize("chunked", [True, False])
def test_recompiles_follow_the_warmed_graphs_and_stay_flat(engines,
                                                           chunked):
    _, teng, _ = engines
    kw = dict(continuous=True, warmup=True, max_batch=4, kv_block_size=BS)
    if chunked:
        kw["prefill_chunk_tokens"] = 8
    # prompts in the warmed bucket (16): 9..16 tokens
    prompts = [[30 + i] * (9 + i) for i in range(6)]

    async def go():
        app, c, _ = await _start(server, teng(), **kw)
        try:
            b = app[server.BATCHERS_KEY][MODEL]
            graphs = b.cengine.graphs
            warmed = b.compile_watch.counts()
            captures = graphs.captures
            runners = _runner_keys(b)
            text0 = await (await c.get("/metrics")).text()
            await asyncio.gather(*(
                _post(c, GEN, {"tokens": [p], "max_new": MAX_NEW,
                               **({"temperature": 0.7, "top_k": 5}
                                  if i % 2 else {})})
                for i, p in enumerate(prompts)))
            after = (await (await c.get("/debug/profile")).json())[
                "models"][MODEL]["recompiles"]
            text1 = await (await c.get("/metrics")).text()
            return (warmed, runners, captures, graphs.captures, after,
                    text0, text1)
        finally:
            await c.close()

    warmed, runners, cap0, cap1, after, text0, text1 = asyncio.run(go())
    for fn, n in runners.items():
        assert warmed[fn] == n - 1, (fn, warmed, runners)
    assert cap0 == sum(runners.values())
    # prefill and insert: every group size of 4 slots at bucket 16
    assert warmed["prefill"] == warmed["insert_many"] == 2
    assert warmed["reset_slots"] == 0
    assert after == warmed and cap1 == cap0
    for fn, n in warmed.items():
        assert _metric(text0, "serving_recompiles_total", model=MODEL,
                       fn=fn) == n
        assert _metric(text1, "serving_recompiles_total", model=MODEL,
                       fn=fn) == n


def test_a_novel_graph_key_in_traffic_is_a_recompile(engines):
    """A chunk size the warmup did not run is a new graph: the watch
    counts it, `/metrics` mirrors it and a `recompile` span names it."""
    _, teng, _ = engines
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

    async def go():
        b = ContinuousBatcher(teng(), asyncio.Lock(), max_slots=2,
                              kv_block_size=BS, chunk=4, seed=0)
        tracer = ttr.Tracer()
        b.compile_watch.tracer = tracer
        b.cengine.warmup(step_sizes=(1, 2))
        n0 = b.compile_watch.counts()["decode_step"]
        try:
            await b.submit([3, 4, 5], 8)
        finally:
            await b.close()
        return n0, b.compile_watch.counts()["decode_step"], tracer

    n0, n1, tracer = asyncio.run(go())
    assert n0 == 2 * 3 - 1 and n1 > n0
    sigs = {t["spans"][0]["attrs"]["signature"]
            for t in tracer.traces(name="recompile")}
    assert "(4,False,False)" in sigs


def _tiny_engine():
    cfg = tllama.LLAMA_TINY
    return InferenceEngine(tllama.init(cfg, 0, "cpu"), cfg, LLAMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device="cpu")


def test_debug_doors_and_propagation():
    good_tid, good_psid = "ab" * 16, "cd" * 8

    async def go():
        app, c, _ = await _start(server, _tiny_engine(), continuous=True,
                                 max_batch=2, kv_block_size=BS)
        try:
            r = await _post(c, GEN, {"tokens": [[1, 2, 3]],
                                     "max_new": MAX_NEW})
            tid = r.headers["X-Trace-Id"]
            doc = await (await c.get(
                "/debug/traces", params={"name": "http.request",
                                         "trace_id": tid})).json()
            r = await _post(c, GEN, {"tokens": [[1, 2, 4]],
                                     "max_new": MAX_NEW},
                            **{"X-Trace-Id": good_tid,
                               "X-Parent-Span": good_psid})
            adopted = r.headers["X-Trace-Id"]
            r = await _post(c, GEN, {"tokens": [[1, 2, 5]],
                                     "max_new": MAX_NEW},
                            **{"X-Trace-Id": "NOT-HEX!",
                               "X-Parent-Span": good_psid})
            fresh = r.headers["X-Trace-Id"]
            remote = await (await c.get(
                "/debug/traces", params={"trace_id": good_tid})).json()
            bad = await c.get("/debug/traces", params={"limit": "x"})
            bad_text = await bad.text()
            missing = await c.post("/v1/models/nope:generate",
                                   json={"tokens": [[1]]})
            summary = await (await c.get(
                "/debug/traces", params={"format": "summary",
                                         "limit": "2"})).json()
            return (tid, doc, adopted, fresh, remote, bad, bad_text,
                    missing, summary)
        finally:
            await c.close()

    (tid, doc, adopted, fresh, remote, bad, bad_text, missing,
     summary) = asyncio.run(go())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    root = next(e for e in spans if e["name"] == "http.request")
    assert root["args"]["trace_id"] == tid
    assert root["args"]["route"] == "/v1/models/{name}:generate"
    assert root["args"]["status"] == 200
    submit = next(e for e in spans if e["name"] == "batcher.submit")
    assert submit["args"]["parent_id"] == root["args"]["span_id"]
    assert "decode.attention" in {e["name"] for e in spans}
    tracks = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert tracks == {f"{MODEL}.kv_blocks", f"{MODEL}.batch_occupancy",
                      f"{MODEL}.phase_seconds", f"{MODEL}.kv_evictions"}
    assert adopted == good_tid
    (rroot,) = [e for e in remote["traceEvents"]
                if e["ph"] == "X" and e["name"] == "http.request"]
    assert rroot["args"]["parent_id"] == good_psid
    assert fresh not in (good_tid, "NOT-HEX!") and len(fresh) == 32
    assert bad.status == 400 and bad.headers.get("X-Trace-Id")
    assert bad_text.startswith("limit must be an integer")
    assert missing.status == 404 and missing.headers.get("X-Trace-Id")
    assert len(summary["traces"]) == 2


def test_slo_overrides_reach_the_burn_rate_engine():
    app = server.create_serving_app(
        {MODEL: _tiny_engine()}, continuous=True, max_batch=2,
        kv_block_size=BS, slo_ttft_s={"interactive": 0.05},
        slo_spec_acceptance=0.8, seed=0)
    slos = app[server.OBS_KEY].slo.slos
    assert slos["serving_ttft_interactive"].threshold_s == 0.05
    assert slos["serving_ttft_standard"].threshold_s == 2.0
    assert slos["serving_spec_acceptance"].objective == 0.8
    tracer, reg = ttr.Tracer(), tobs.metrics.Registry()
    app = server.create_serving_app({MODEL: _tiny_engine()},
                                    registry=reg, tracer=tracer)
    assert app[server.OBS_KEY].tracer is tracer
    assert app[server.OBS_KEY].registry is reg
