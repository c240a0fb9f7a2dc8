"""The port's elastic coordinator, goodput ledger and metrics federation
against the JAX package's, on the CPU.

Each scripted case drives the reference's `ElasticCoordinator` (or
`GoodputLedger`) and the port's under the same fake clock through the
same register / heartbeat / sweep / evict / ledger calls, and compares
every answer: `world()` dicts, generations, restarts, raised errors,
SLO burn rates, ledger snapshots and counter events, and each
registry's whole `/metrics` text. The federation and trace merge are
compared through the coordinators' `/elastic/metrics` and
`/elastic/traces` math, and `federate` / `parse_exposition` /
`render_families` directly on the same scrapes. Last, the port's
coordinator app is served on a local port and answers the reference's
worker client (`_CoordinatorClient`) and plain HTTP on its six routes.
Everything is exact: both sides do the same float arithmetic in the
same order.
"""

import asyncio
import json
import math
import threading
import urllib.request

import pytest

from kubeflow_tpu import obs as jobs
from kubeflow_tpu.controlplane.metrics import Registry as JRegistry
from kubeflow_tpu.fleet import registry as jfleet
from kubeflow_tpu.train import elastic as jelastic
from kubeflow_tpu.train import goodput as jgoodput
from kubeflow_tpu_torch import obs as tobs
from kubeflow_tpu_torch.fleet import registry as tfleet
from kubeflow_tpu_torch.obs.metrics import Registry as TRegistry
from kubeflow_tpu_torch.train import elastic as telastic
from kubeflow_tpu_torch.train import goodput as tgoodput

SIDES = {"ref": (jelastic, jgoodput, JRegistry, jobs),
         "port": (telastic, tgoodput, TRegistry, tobs)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Side:
    """One implementation under its own fake clocks; `out` collects what
    a script observes."""

    def __init__(self, name):
        self.el, self.gp, self.Registry, self.obs = SIDES[name]
        self.clock = FakeClock()
        self.out = []

    def coord(self, **kw):
        kw.setdefault("min_replicas", 2)
        kw.setdefault("degraded_after_s", 5.0)
        kw.setdefault("dead_after_s", 10.0)
        return self.el.ElasticCoordinator(clock=self.clock,
                                          registry=self.Registry(), **kw)

    def ledger(self, **kw):
        clk = FakeClock()
        return self.gp.GoodputLedger(clock=clk, wall=clk, **kw), clk

    def note(self, *xs):
        self.out.extend(xs)

    def call(self, fn, *a, **kw):
        """fn's result, or its error's type name and message."""
        try:
            return fn(*a, **kw)
        except (KeyError, RuntimeError) as e:
            return (type(e).__name__, str(e))


# -- coordinator scripts ----------------------------------------------------


def formation(s):
    coord = s.coord()
    s.note(coord.register("tr0", step=0), coord.register("tr1", step=0),
           coord.restarts_total.value(), coord.registry.render())


def death(s):
    coord = s.coord()
    coord.register("tr0", step=0)
    coord.register("tr1", step=0)
    s.clock.advance(11.0)  # past dead_after_s; only tr1 beats
    s.note(coord.heartbeat("tr1", step=3, loss=2.5, phase="step"),
           coord.world(include_stats=True), coord.restarts_total.value(),
           coord.replicas_gauge.value(state="dead"),
           coord.heartbeat("ghost", step=1), coord.registry.render())


def rejoin(s):
    coord = s.coord()
    coord.register("tr0")
    coord.register("tr1")
    s.clock.advance(7.0)        # degraded, still live
    s.note(coord.world())
    s.clock.advance(4.0)
    coord.heartbeat("tr1")
    s.note(coord.register("tr0"), coord.restarts_total.value(),
           coord.registry.render())


def evictions(s):
    coord = s.coord(min_replicas=1)
    for rid in ("tr0", "tr1", "tr2"):
        coord.register(rid, step=0)
    s.note(s.call(coord.evict))  # no step time yet: nothing to pick
    for rid, ss in (("tr0", 0.1), ("tr1", 0.3), ("tr2", 0.2)):
        coord.heartbeat(rid, step=1, step_seconds=ss)
    s.note(coord.evict(), s.call(coord.evict, "ghost"),
           coord.evict("tr0"), s.call(coord.evict, "tr2"),
           coord.heartbeat("tr1", step=2), coord.world(include_stats=True),
           coord.registry.render())


def stragglers(s):
    coord = s.coord(min_replicas=3)
    for rid in ("tr0", "tr1", "tr2"):
        coord.register(rid, step=0)
    for step in (1, 2):
        s.clock.advance(0.5)
        coord.heartbeat("tr0", step=step, step_seconds=0.1)
        coord.heartbeat("tr1", step=step, step_seconds=0.2)
        coord.heartbeat("tr2", step=step, step_seconds=0.6)
    s.clock.advance(11.0)
    coord.heartbeat("tr0", step=3, step_seconds=0.1)
    s.note(coord.world(include_stats=True), coord.registry.render())


def goodput_ingestion(s):
    coord = s.coord(min_replicas=1)
    led, wclk = s.ledger()
    coord.register("tr0", step=0)
    wclk.advance(2.0)
    led.note_step(0, 2.0)
    s.clock.advance(0.5)
    coord.heartbeat("tr0", step=1, goodput=led.snapshot())
    led2, wclk2 = s.ledger()    # incarnation 2: its wall rewinds
    led2.note_restore(0)
    wclk2.advance(1.0)
    s.clock.advance(0.5)
    coord.heartbeat("tr0", step=1, goodput=led2.snapshot())
    s.note(coord.world(), coord.registry.render())


def burn_windows(s):
    coord = s.coord(min_replicas=1, slo_short_window_s=10.0,
                    slo_long_window_s=600.0, slo_step_time_s=0.5,
                    restart_burn_hold_s=5.0)
    led, wclk = s.ledger()
    coord.register("tr0", step=0)
    coord.register("tr1", step=0)

    def beat(rid, step):
        coord.heartbeat(rid, step=step, goodput=led.snapshot(),
                        step_seconds=1.0, saves=step // 2,
                        save_seconds=float(step))
        s.note(coord.slo.burn_rates())

    for i in range(3):
        wclk.advance(1.0)
        led.note_step(i, 1.0)
        s.clock.advance(1.0)
        beat("tr0", i + 1)
        beat("tr1", i + 1)
    led.note_restore(0)
    for i in range(3):
        wclk.advance(1.0)
        led.note_step(i, 1.0)
        s.clock.advance(4.0)    # tr1 falls silent: dead at 10 s
        beat("tr0", 3)
    s.clock.advance(12.0)
    for i in range(3, 6):
        wclk.advance(1.0)
        led.note_step(i, 1.0)
        s.clock.advance(1.0)
        beat("tr0", i + 1)
    s.note(coord.world(), coord.registry.render())


def federation(s):
    coord = s.coord()
    workers = {}
    for rid in ("tr0", "tr1"):
        led, wclk = s.ledger()
        wreg = s.Registry()
        s.gp.bind_ledger_metrics(wreg, led)
        workers[rid] = (led, wclk, wreg)
        coord.register(rid, step=0)
    coord.register("tr2", step=0)   # never sends metrics: up 0
    for i in range(3):
        for rid, (led, wclk, wreg) in workers.items():
            with led.book("checkpoint_save"):
                wclk.advance(0.125)
            wclk.advance(0.5)
            led.note_step(i, 0.5, tokens=32, flops=1e6)
            s.clock.advance(0.25)
            coord.heartbeat(rid, step=i + 1, step_seconds=0.5,
                            goodput=led.snapshot(), metrics=wreg.render(),
                            trace={"displayTimeUnit": "ms", "traceEvents": [
                                {"name": f"step-{rid}", "ph": "X", "ts": i,
                                 "dur": 500, "pid": 1, "tid": 1},
                                *led.counter_events(prefix="train")]})
        coord.heartbeat("tr2", step=i + 1)
    s.note(coord.federated_metrics(), coord.merged_traces(),
           coord.world(include_stats=True))


SCRIPTS = [formation, death, rejoin, evictions, stragglers,
           goodput_ingestion, burn_windows, federation]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__)
def test_coordinator_matches_reference(script):
    got = {}
    for name in SIDES:
        side = Side(name)
        script(side)
        got[name] = side.out
    assert got["port"] == got["ref"]


# -- ledger scripts ---------------------------------------------------------


def ledger_trace(s):
    led, clk = s.ledger(peak_flops_per_s=1e6)
    with led.book("compile"):
        clk.advance(3.0)
    for i in range(6):
        clk.advance(1.0)
        led.note_step(i, 1.0, tokens=128, flops=4e5)
    led.note_restore(2)
    for i in range(2, 8):
        clk.advance(1.0)
        led.note_step(i, 1.0, tokens=128, flops=4e5)
    with led.book("checkpoint_save"):
        clk.advance(1.0)
        with led.book("stall"):
            clk.advance(2.0)
        mid = led.snapshot()         # a frame still open
        clk.advance(0.5)
    with led.book("coffee"):         # unknown cause: unattributed
        clk.advance(0.25)
    clk.advance(0.5)
    led.note_step(8, 1.0)            # booked without wall: a breach
    s.note(mid, led.snapshot(), led.cause_seconds(), led.wall_seconds(),
           led.counter_events(prefix="train"))


def ledger_compile_and_restore(s):
    led, clk = s.ledger()
    clk.advance(30.0)
    led.note_step(0, 30.0, tokens=10, compiling=True)
    clk.advance(1.0)
    led.note_step(1, 1.0, tokens=10)
    led.note_restore(2)              # at the high-water mark: no replay
    clk.advance(1.0)
    led.note_step(2, 1.0, tokens=10)
    s.note(led.snapshot(), led.counter_events())


def ledger_families(s):
    led, clk = s.ledger()
    reg = s.Registry()
    first = s.gp.bind_ledger_metrics(reg, led)
    s.note(reg.render())
    with led.book("compile"):
        clk.advance(3.0)
    clk.advance(1.0)
    led.note_step(0, 1.0, tokens=50)
    led.note_restore(0)
    clk.advance(1.0)
    led.note_step(0, 1.0, tokens=50)
    s.gp.checkpoint_histograms(reg)
    again = s.gp.goodput_metrics(reg)
    s.note(reg.render(), all(a is b for a, b in zip(first, again)),
           s.gp.GOODPUT_CAUSES, s.gp.LOST_CAUSES)


@pytest.mark.parametrize("script", [ledger_trace, ledger_compile_and_restore,
                                    ledger_families],
                         ids=lambda f: f.__name__)
def test_ledger_matches_reference(script):
    got = {}
    for name in SIDES:
        side = Side(name)
        script(side)
        got[name] = side.out
    assert got["port"] == got["ref"]


# -- exposition and federation ----------------------------------------------


def _scrapes(Registry, Counter, Gauge, get_hist):
    """Three replicas' expositions over one family catalog: counters and
    gauges with labels, histograms on two bucket grids, a label value
    needing escapes; plus a down replica and an unparseable one."""
    out = {}
    for i, buckets in enumerate(((0.1, 1.0), (0.5, 1.0, 5.0), (0.1, 1.0))):
        reg = Registry()
        c = Counter("req_total", "requests", reg)
        c.inc(3 + i, code="200")
        c.inc(i, code='5"0\\0\n')
        Gauge("depth", "queue depth", reg).set(1.5 * i, pool="a")
        h = get_hist(reg, "lat_seconds", "latency", buckets=buckets)
        for v in (0.05, 0.7, 3.0)[:i + 1]:
            h.observe(v, route="/x")
        out[f"r{i}"] = reg.render()
    out["down"] = None
    out["bad"] = "# TYPE x counter\nx 1\n"
    return out


def test_federation_matches_reference():
    from kubeflow_tpu.controlplane.metrics import Counter as JC
    from kubeflow_tpu.controlplane.metrics import Gauge as JG
    from kubeflow_tpu_torch.obs.metrics import Counter as TC
    from kubeflow_tpu_torch.obs.metrics import Gauge as TG

    ref = _scrapes(JRegistry, JC, JG, jobs.get_or_create_histogram)
    port = _scrapes(TRegistry, TC, TG, tobs.get_or_create_histogram)
    assert port == ref   # the port's registry renders the same text
    versions = {"r0": "v1", "r1": "v2", "down": "v1"}
    want = jobs.federate(ref, versions=versions)
    assert tobs.federate(port, versions=versions) == want
    parsed = [tobs.parse_exposition(t) for t in port.values()
              if t is not None and t != port["bad"]]
    assert parsed == [jobs.parse_exposition(t) for t in ref.values()
                      if t is not None and t != ref["bad"]]
    assert tobs.render_families(tobs.merge_families(parsed)) == \
        jobs.render_families(jobs.merge_families(parsed))
    assert tobs.parse_exposition(want) == jobs.parse_exposition(want)
    for bad in (ref["bad"], "# HELP y y\n# TYPE y histogram\ny_sum 1\n"
                "y_count 1\n", '# HELP z z\n# TYPE z gauge\nz{a="1} 2\n'):
        errors = []
        for mod in (jobs, tobs):
            with pytest.raises(mod.ExpositionError) as e:
                mod.parse_exposition(bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_registry_state_machine_matches_reference():
    out = {}
    for name, mod in (("ref", jfleet), ("port", tfleet)):
        clk = FakeClock()
        reg = mod.ReplicaRegistry(degraded_after_s=1.0, dead_after_s=2.0,
                                  clock=clk)
        seen = []
        for rid in ("a", "b", "c"):
            reg.register(f"trainer://{rid}", replica_id=rid,
                         models=("trainer",))
        for dt, beats in ((0.5, "abc"), (1.2, "a"), (0.9, "ab"), (3.0, "b")):
            clk.advance(dt)
            for rid in beats:
                seen.append(reg.heartbeat(rid))
            reg.sweep()
            seen.append((reg.counts(), sorted(
                (r.id, r.state) for r in reg.replicas())))
        seen += [reg.heartbeat("ghost"), reg.deregister("c"),
                 reg.counts(), mod.STATES,
                 [mod.rendezvous(bytes([k]), ["a", "b", "c", "d"])
                  for k in range(32)]]
        out[name] = seen
    assert out["port"] == out["ref"]
    with pytest.raises(ValueError, match="must be <"):
        tfleet.ReplicaRegistry(degraded_after_s=2.0, dead_after_s=2.0)


# -- the app, against the reference's worker client -------------------------


@pytest.fixture
def served_coordinator():
    """The port's coordinator app on a local port, in a thread of its
    own event loop."""
    from aiohttp import web

    clock = FakeClock()
    coord = telastic.ElasticCoordinator(
        min_replicas=1, degraded_after_s=5.0, dead_after_s=10.0,
        clock=clock, registry=TRegistry())
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(telastic.create_coordinator_app(coord))
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = runner.addresses[0][1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield coord, clock, f"http://127.0.0.1:{port}"
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    loop.run_until_complete(runner.cleanup())
    loop.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _post(url, body=None):
    req = urllib.request.Request(
        url, data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_app_answers_the_reference_client(served_coordinator):
    coord, clock, url = served_coordinator
    client = jelastic._CoordinatorClient(url)
    led, wclk = Side("ref").ledger()
    wreg = JRegistry()
    jgoodput.bind_ledger_metrics(wreg, led)
    w = client.register("tr0", phase="restoring")
    assert w["ready"] and w["chief"] == "tr0" and w["generation"] == 1
    wclk.advance(1.0)
    led.note_step(0, 1.0, tokens=8)
    w = client.heartbeat("tr0", step=4, loss=1.25, phase="saving",
                         step_seconds=0.5, goodput=led.snapshot(),
                         metrics=wreg.render(),
                         trace={"traceEvents": [{"name": "s", "ph": "X",
                                                 "ts": 0, "dur": 1,
                                                 "pid": 1, "tid": 1}]})
    assert w["known"] and w["steps"] == {"tr0": 4}
    assert w["phases"] == {"tr0": "saving"}
    assert w["goodput"]["seconds"]["productive"] == 1.0
    assert client.heartbeat("ghost")["known"] is False
    client.register("tr1", step=0)
    status, world = _get(url + "/elastic/world")
    world = json.loads(world)
    assert status == 200 and world == coord.world(include_stats=True)
    assert world["replicas"]["tr0"]["loss"] == 1.25
    status, text = _get(url + "/elastic/metrics")
    fams = tobs.parse_exposition(text)
    up = {dict(k[1])["replica"]: v
          for k, v in fams["fleet_federation_up"]["samples"].items()}
    assert up == {"coordinator": 1.0, "tr0": 1.0, "tr1": 0.0}
    assert sum(fams["train_goodput_seconds_total"]["samples"].values()) \
        == 1.0
    status, traces = _get(url + "/elastic/traces")
    tracks = {e["args"]["name"] for e in json.loads(traces)["traceEvents"]
              if e.get("ph") == "M"}
    assert tracks == {"tr0"}
    status, text = _get(url + "/metrics")
    for fam in ("train_replicas", "train_generation", "train_restarts_total",
                "train_checkpoint_save_seconds", "train_goodput_fraction"):
        assert f"# TYPE {fam} " in text, fam
    assert _post(url + "/elastic/evict", {"replica_id": "nobody"})[0] == 404
    status, w = _post(url + "/elastic/evict")
    assert status == 200 and w["evicted"] == "tr0"
    assert w["members"] == ["tr1"]
    assert _post(url + "/elastic/evict", {})[0] == 409   # min_replicas
    assert coord.restarts_total.value() == 1.0
    assert math.isclose(coord.generation_gauge.value(), 3.0)
