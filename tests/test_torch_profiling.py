"""The port's step-anatomy profiler against the JAX reference, on the
CPU (the counterpart of tests/test_profiling.py, without its
CompileWatch and counter-event cases).

`PhaseProfiler` runs the reference's fake-clock scripts beside the
reference's own profiler and must give the same totals, tokens,
goodput ledger and snapshot: exclusive nesting with the host_gap
residual, an unknown phase collapsing to `other`, idle leaving goodput's
books, token-only attributions, a raising hook swallowed, the rolling
percentiles (`sample_quantile`). Then the batcher's anatomy: on a real
workload of the LLAMA_TINY port every phase of `SERVING_PHASES` is
booked, the busy phases fit inside the observed wall, decode tokens are
the tokens emitted; a preempted and resumed request marks its preempt
and resume phases and re-counts none of its replayed tokens, in chunked
and monolithic admission. Last, the app zero-seeds the step families
over the closed phase set and derives the goodput gauges at scrape
time; a one-shot app carries none of those series, as the reference's.
"""

import asyncio

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs import profiling as jprof
from kubeflow_tpu.obs.metrics import sample_quantile as jquantile
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import profiling as tprof
from kubeflow_tpu_torch.obs.metrics import sample_quantile
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.tenancy import config_from_dict


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _nesting(p, clk):
    p.begin_iteration()
    with p.phase("admit"):
        clk.t = 1.0
        with p.phase("prefill", tokens=16):
            clk.t = 3.0
        clk.t = 3.5
    with p.phase("decode", tokens=8):
        clk.t = 5.5
    clk.t = 6.0
    p.end_iteration()


def _idle_and_pool(p, clk):
    with p.phase("idle"):
        clk.t = 10.0
    with p.phase("decode", tokens=4):
        clk.t = 13.0
    p.record("host_gap", 1.0)
    for n in (3, 5, 2):
        p.note_pool(n, 8)
    p.note_occupancy(2, 4)


def _unknown_phase(p, clk):
    p.record("decode", 1.0)
    p.record("surprise_phase", 2.0)


def _tokens_only(p, clk):
    p.add_tokens("decode", 7)
    p.add_tokens("verify", 0)


def _percentiles(p, clk):
    for i in range(1, 11):
        clk.t += 0.5
        p.record("decode", 0.01 * i)


def _speculative_iterations(p, clk):
    for k in range(3):
        p.begin_iteration()
        with p.phase("admit"):
            clk.t += 0.25
            with p.phase("prefill_chunk", tokens=64):
                clk.t += 1.0
        with p.phase("draft", tokens=4 * (k + 1)):
            clk.t += 0.125
        with p.phase("verify"):
            clk.t += 0.5
        with p.phase("detokenize"):
            clk.t += 0.0625
        p.add_tokens("verify", 5)
        p.record("resume", 0.0)
        clk.t += 0.375
        p.end_iteration()


SCRIPTS = {"nesting": _nesting, "idle_and_pool": _idle_and_pool,
           "unknown_phase": _unknown_phase, "tokens_only": _tokens_only,
           "percentiles": _percentiles,
           "speculative_iterations": _speculative_iterations}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_profiler_matches_reference_on_fake_clock_scripts(script):
    out = []
    for mod, extra in ((jprof, {"wall_clock": None}), (tprof, {})):
        clk = FakeClock()
        phases = ("decode",) if script == "unknown_phase" \
            else mod.SERVING_PHASES
        kw = {k: clk for k in extra}
        p = mod.PhaseProfiler(phases=phases, clock=clk, **kw)
        seen = []
        p.on_phase = lambda *a, seen=seen: seen.append(a)
        SCRIPTS[script](p, clk)
        out.append((p.totals(), p.phase_tokens(), p.goodput(),
                    p.snapshot(), p.wall_s(), seen))
    assert out[1] == out[0]


def test_exclusive_nesting_and_host_gap_residual():
    clk = FakeClock()
    p = tprof.PhaseProfiler(clock=clk)
    _nesting(p, clk)
    t = p.totals()
    assert t["admit"] == pytest.approx(1.5)    # 3.5 wall - 2.0 child
    assert t["prefill"] == pytest.approx(2.0)
    assert t["host_gap"] == pytest.approx(0.5)
    assert sum(t.values()) == pytest.approx(6.0) == p.wall_s()


def test_phase_constants_are_the_reference_sets():
    assert tprof.SERVING_PHASES == jprof.SERVING_PHASES
    assert tprof.TRAIN_PHASES == jprof.TRAIN_PHASES
    assert tprof.GOODPUT_PHASES == jprof.GOODPUT_PHASES
    assert tprof.IDLE_PHASES == jprof.IDLE_PHASES


def test_on_phase_hook_exceptions_are_swallowed():
    p = tprof.PhaseProfiler()
    p.on_phase = lambda *a: (_ for _ in ()).throw(RuntimeError("boom"))
    p.record("decode", 0.5)
    p.add_tokens("decode", 3)
    assert p.totals()["decode"] == pytest.approx(0.5)
    assert p.phase_tokens()["decode"] == 3


@pytest.mark.parametrize("n", [0, 1, 2, 7, 10])
def test_sample_quantile_matches_reference(n):
    xs = [float((i * 37) % 11) for i in range(n)]
    for q in (0.0, 0.5, 0.9, 0.95, 1.0):
        assert sample_quantile(xs, q) == jquantile(xs, q)


# -- the batcher's anatomy ----------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    cfg = jllama.LLAMA_TINY
    params = dict(jllama.init(jax.random.key(0), cfg))
    params["lm_head"] = params["lm_head"] * 50.0   # argmax can't flip
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tllama.LLAMA_TINY,
                        "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=128),
        device="cpu")
    return params, teng


@pytest.mark.parametrize("chunked", [False, True])
def test_batcher_anatomy_reconciles(engine, chunked):
    """Every serving phase is booked, the busy phases fit inside the
    observed wall (exclusive times, host_gap the residual), and decode
    tokens are the tokens emitted, each once."""
    _, teng = engine
    gen = np.random.default_rng(4)
    prompts = [gen.integers(0, 256, n).tolist() for n in (4, 7, 19)]

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=8, seed=0,
                              prefill_chunk_tokens=8 if chunked else None)
        try:
            for _ in range(2):
                await asyncio.gather(*(b.submit(p, 6) for p in prompts))
            return b, b.profiler.snapshot()
        finally:
            await b.close()

    b, snap = asyncio.run(go())
    assert set(tprof.SERVING_PHASES) <= set(snap["phases"])
    busy = sum(v["total_s"] for p, v in snap["phases"].items()
               if p != "idle")
    assert 0 < busy <= snap["wall_s"] + 1e-6
    assert snap["phases"]["decode"]["tokens"] == b.tokens_emitted > 0
    assert snap["phases"]["decode"]["count"] > 0
    pf = "prefill_chunk" if chunked else "prefill"
    assert snap["phases"][pf]["tokens"] == b.tokens_prefilled > 0
    assert snap["phases"]["prefill_chunk" if not chunked
                          else "prefill"]["count"] == 0
    assert snap["phases"]["sample"]["count"] \
        == snap["phases"]["detokenize"]["count"] > 0
    assert snap["phases"]["host_gap"]["count"] > 0
    g = snap["goodput"]
    assert 0 < g["goodput_ratio"] <= 1
    assert g["kv_blocks_high_water"] > 0 and g["slots"] == 2
    assert g["occupancy_high_water"] == 2


@pytest.mark.parametrize("chunked", [False, True])
def test_preempt_resume_phases_no_double_counted_decode(engine, chunked):
    """A preempted and resumed request marks preempt and resume phases,
    and its replayed tokens are not counted again: decode tokens ==
    tokens_emitted == every timeline stamp less one first token per
    (re)admission."""
    _, teng = engine
    qos = {"tenants": {"live": {"priority": "interactive"},
                       "bulk": {"priority": "batch"}}}
    p1, p2, p3 = [3, 5, 7, 11], [4, 6, 8, 10], [9, 2, 4, 8]

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=8, seed=0,
                              tenancy=config_from_dict(qos),
                              prefill_chunk_tokens=8 if chunked else None)
        try:
            f1 = asyncio.ensure_future(b.submit(p1, 24, {"tenant": "bulk"}))
            f2 = asyncio.ensure_future(b.submit(p2, 24, {"tenant": "bulk"}))
            for _ in range(400):
                if len(b._active) == 2 and all(
                        r.out for r in b._active.values()):
                    break
                await asyncio.sleep(0.01)
            got3 = await b.submit(p3, 8, {"tenant": "live"})
            await f1
            await f2
            assert len(got3) == 8
            return b
        finally:
            await b.close()

    b = asyncio.run(go())
    assert b.preemptions >= 1
    snap = b.profiler.snapshot()
    tls = [b.timelines.get(rid) for rid in b.timelines.ids()]
    kinds = [kind for tl in tls for (_t, kind, _d) in tl.events]
    assert snap["phases"]["preempt"]["count"] == b.preemptions \
        == kinds.count("preempt")
    resumes = kinds.count("resume")
    assert snap["phases"]["resume"]["count"] == resumes >= 1
    stamps = sum(len(tl.tokens) for tl in tls)
    assert stamps == 24 + 24 + 8
    assert b.tokens_emitted == stamps - 3 - resumes
    assert snap["phases"]["decode"]["tokens"] == b.tokens_emitted


# -- the app's families ------------------------------------------------------


def _families(text: str) -> dict:
    """family -> set of label strings of its samples"""
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, _, rest = line.partition("{")
        out.setdefault(name, set()).add(rest.rpartition("}")[0])
    return out


def _phase_label_set(fams, sample):
    return {lbl.split('phase="')[1].split('"')[0]
            for lbl in fams.get(sample, ()) if 'phase="' in lbl}


def test_zero_seeded_step_families_and_goodput_gauges(engine):
    params, teng = engine
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=128))

    async def session(app):
        async with TestClient(TestServer(app)) as client:
            before = await (await client.get("/metrics")).text()
            rs = [await client.post("/v1/models/m:generate",
                                    json={"tokens": [[3, 5, 7, 11, 13]],
                                          "max_new": 4})
                  for _ in range(2)]
            assert all(r.status == 200 for r in rs)
            return before, await (await client.get("/metrics")).text()

    texts = {}
    for label, mod, eng in (("jax", jserver, jeng), ("port", server, teng)):
        app = mod.create_serving_app({"m": eng}, continuous=True,
                                     max_batch=2, kv_block_size=8)
        texts[label] = asyncio.run(session(app))
    for label, (before, after) in texts.items():
        fb, fa = _families(before), _families(after)
        for fam in ("serving_step_phase_seconds_count",
                    "serving_step_tokens_count"):
            assert _phase_label_set(fb, fam) == set(tprof.SERVING_PHASES), \
                (label, fam)
        for fam in ("serving_goodput_ratio", "serving_bubble_fraction",
                    "serving_kv_blocks_high_water",
                    "serving_kv_spill_demotions_total",
                    "serving_kv_spill_restores_total",
                    "serving_kv_spill_bytes"):
            assert fam in fb, (label, fam)
        assert {lbl for lbl in fb["fleet_peer_fetch_total"]} == {
            f'model="m",outcome="{o}"' for o in ("failed", "miss", "ok")}
        for line in after.splitlines():
            if line.startswith('serving_goodput_ratio{model="m"}'):
                assert 0 < float(line.split()[-1]) <= 1, label
            if line.startswith('serving_kv_blocks_high_water{model="m"}'):
                assert float(line.split()[-1]) > 0, label
        phases = {}
        for line in after.splitlines():
            if line.startswith("serving_step_tokens_sum{"):
                phases[line.split('phase="')[1].split('"')[0]] = float(
                    line.split()[-1])
        # 2 requests x 3 decode tokens (the first comes from prefill)
        assert phases["decode"] == 6, label
        assert phases["prefill"] > 0, label


def test_one_shot_app_seeds_no_batcher_series(engine):
    params, teng = engine
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=128))

    async def scrape(app):
        async with TestClient(TestServer(app)) as client:
            return await (await client.get("/metrics")).text()

    for mod, eng in ((jserver, jeng), (server, teng)):
        fams = _families(asyncio.run(scrape(
            mod.create_serving_app({"m": eng}))))
        for fam in ("serving_step_phase_seconds_count",
                    "serving_goodput_ratio", "fleet_peer_fetch_total",
                    "serving_kv_spill_bytes"):
            assert fam not in fams, (mod.__name__, fam)
