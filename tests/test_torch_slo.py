"""The port's SLO burn-rate engine (obs/slo.py) and the `/v1/spec` door
against the JAX reference's, on the CPU.

Both `SloEngine`s get the same stream of events (numpy seeds) under one
injected clock: the burn rates and every exposition line of their
registries must be identical, at checkpoints through the stream (windows
filling, then pruning). `/v1/spec` GET and POST (a valid body, a
non-bool, invalid JSON, a non-object) go to the reference's app and to
the port's, both continuous with a llama-tiny draft: statuses and bodies
must be identical. After one speculative request on the CPU, the port's
`/metrics` carries the `serving_spec_acceptance` series, fed with one
event per proposed draft token, and the same SLO names as the
reference's app.
"""

import asyncio

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.controlplane.metrics import Registry as JRegistry
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs import slo as jslo
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import slo
from kubeflow_tpu_torch.obs.metrics import Registry
from kubeflow_tpu_torch.serving import server
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_LEN = 64
NAMES = ("ttft", "errors", "spec")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _slos(mod):
    return [mod.Slo("ttft", 0.95, threshold_s=0.5, description="p95 TTFT"),
            mod.Slo("errors", 0.99, description="availability"),
            mod.Slo("spec", 0.5, description="draft acceptance")]


def _events(seed, n=600):
    """(dt, kind, name, value): gaps of 0-4 s, so the 60 s and 600 s
    windows both fill and prune; an unknown name and a latency sample
    against a threshold-free SLO, which both engines drop."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dt = float(rng.uniform(0, 4))
        name = str(rng.choice(NAMES + ("unknown",)))
        if rng.random() < 0.5:
            out.append((dt, "observe", name, float(rng.exponential(0.4))))
        else:
            out.append((dt, "record", name, bool(rng.random() < 0.8)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_engine_matches_reference(seed):
    clock = Clock()
    reg, jreg = Registry(), JRegistry()
    eng = slo.get_or_create_slo_engine(reg, _slos(slo), clock=clock)
    jeng = jslo.get_or_create_slo_engine(jreg, _slos(jslo), clock=clock)
    assert reg.render() == jreg.render()   # zero-seeded: burn 0, budget 1
    for i, (dt, kind, name, value) in enumerate(_events(seed)):
        clock.t += dt
        getattr(eng, kind)(name, value)
        getattr(jeng, kind)(name, value)
        if i % 50 == 49:
            assert eng.burn_rates() == jeng.burn_rates()
            assert reg.render() == jreg.render()
    # past the long window everything prunes back to 0
    clock.t += 601.0
    assert eng.burn_rates() == jeng.burn_rates()
    assert set(eng.burn_rates().values()) == {0.0}
    assert reg.render() == jreg.render()


def test_slo_engine_registry_sharing_and_refusals_match_reference():
    """A second owner on one registry merges into the first engine (first
    definition wins) and the budget gauge is registered once; bad
    objectives, thresholds, windows and duplicate names are refused with
    the reference's words."""
    reg, jreg = Registry(), JRegistry()
    for mod, r in ((slo, reg), (jslo, jreg)):
        a = mod.get_or_create_slo_engine(r, _slos(mod))
        b = mod.get_or_create_slo_engine(
            r, [mod.Slo("spec", 0.9), mod.Slo("extra", 0.9)])
        assert a is b and sorted(a.slos) == ["errors", "extra", "spec",
                                             "ttft"]
        assert a.slos["spec"].objective == 0.5
    assert reg.render() == jreg.render()
    bad = [lambda m: m.Slo("x", 1.0), lambda m: m.Slo("x", 0.0),
           lambda m: m.Slo("x", 0.9, threshold_s=0),
           lambda m: m.SloEngine([m.Slo("x", 0.9), m.Slo("x", 0.8)]),
           lambda m: m.SloEngine([], short_window_s=60, long_window_s=60)]
    for make in bad:
        with pytest.raises(ValueError) as got:
            make(slo)
        with pytest.raises(ValueError) as want:
            make(jslo)
        assert str(got.value) == str(want.value)


# -- the serving apps --------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """A llama-tiny target (seed 0) and draft (seed 5) in both
    frameworks."""
    cfg = jllama.LLAMA_TINY
    out = {}
    for name, seed in (("target", 0), ("draft", 5)):
        params = dict(jllama.init(jax.random.key(seed), cfg))
        params["lm_head"] = params["lm_head"] * 50.0
        out["j" + name] = JEngine(params, cfg, J_LLAMA,
                                  JEngineConfig(max_len=MAX_LEN))
        out["t" + name] = InferenceEngine(
            bridge.from_jax(jax.tree.map(np.asarray, params),
                            tllama.LLAMA_TINY, "cpu"),
            tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
            device="cpu")
    return out


def _apps(engines, spec: bool):
    """(reference app, port app): continuous, with the draft folded in
    when `spec`."""
    kw = dict(continuous=True, kv_block_size=BS)
    jkw, tkw = dict(kw), dict(kw)
    if spec:
        jkw.update(drafts={"m": engines["jdraft"]}, spec_decode=True,
                   spec_gamma=2)
        tkw.update(drafts={"m": engines["tdraft"]}, spec_decode=True,
                   spec_gamma=2)
    return (jserver.create_serving_app({"m": engines["jtarget"]}, **jkw),
            server.create_serving_app({"m": engines["ttarget"]}, **tkw))


SPEC_SCRIPT = [
    ("GET", None), ("POST", {"enabled": False}), ("GET", None),
    ("POST", {"enabled": "no"}), ("POST", "not json"), ("POST", [1, 2]),
    ("POST", {}), ("POST", {"enabled": True}), ("GET", None)]


async def _spec_session(app):
    out = []
    async with TestClient(TestServer(app)) as client:
        for method, body in SPEC_SCRIPT:
            if method == "GET":
                r = await client.get("/v1/spec")
            elif isinstance(body, str):
                r = await client.post("/v1/spec", data=body)
            else:
                r = await client.post("/v1/spec", json=body)
            out.append((r.status, await r.json()))
    return out


@pytest.mark.parametrize("spec", [True, False])
def test_spec_door_matches_reference(engines, spec):
    japp, tapp = _apps(engines, spec)
    want = asyncio.run(_spec_session(japp))
    got = asyncio.run(_spec_session(tapp))
    assert got == want
    assert [s for s, _ in got] == [200, 200, 200, 400, 400, 400, 400, 200,
                                   200]
    assert got[2][1] == {"models": {"m": {"draft": spec,
                                          "spec_enabled": False}}}


def _slo_series(text: str) -> set:
    return {line.split(" ")[0] for line in text.splitlines()
            if line.startswith(("slo_burn_rate{",
                                "slo_error_budget_remaining{"))}


def test_spec_request_feeds_the_acceptance_slo(engines):
    japp, tapp = _apps(engines, spec=True)

    async def session(app, generate):
        async with TestClient(TestServer(app)) as client:
            if generate:
                r = await client.post("/v1/models/m:generate", json={
                    "tokens": [[3, 1, 4, 1, 5, 9, 2, 6]], "max_new": 6})
                assert r.status == 200
                body = await r.json()
            r = await client.get("/metrics")
            text = await r.text()
            return text, body if generate else None

    want, _ = asyncio.run(session(japp, False))
    got, body = asyncio.run(session(tapp, True))
    assert _slo_series(got) == _slo_series(want)
    assert 'slo_burn_rate{slo="serving_spec_acceptance",window="short"}' \
        in got
    b = tapp[server.BATCHERS_KEY]["m"]
    sobs = tapp[server.OBS_KEY]
    events = list(sobs.slo._events["serving_spec_acceptance"])
    assert len(events) == b.spec_proposed > 0
    assert sum(bad for _, bad in events) == b.spec_proposed - \
        b.spec_accepted
    burn = (1 - b.spec_accepted / b.spec_proposed) / 0.5
    assert sobs.slo.burn_rates()[("serving_spec_acceptance", "long")] == \
        pytest.approx(burn)
    # one inference request answered: one good availability event
    assert [bad for _, bad in sobs.slo._events["serving_errors_standard"]] \
        == [0]
    assert len(body["tokens"][0]) == 6
