"""The port's span tracer (kubeflow_tpu_torch/obs/tracing.py) against the
JAX package's (kubeflow_tpu/obs/tracing.py), on the same span programs.

Both tracers run on one fake clock and must give the same tree of span
names, parents and attributes (ids are random in both: the tree is
compared by structure), the same ring eviction, the same per-trace span
cap, the same accept / reject verdict of `span_from_remote` over a list
of header values, the same `traces_response_payload` keys and 400 text,
and the same `merge_chrome_traces` document on fixed inputs.
"""

import concurrent.futures

import pytest

from kubeflow_tpu.obs import tracing as jtr
from kubeflow_tpu_torch import obs as tobs
from kubeflow_tpu_torch.obs import tracing as ttr


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 0.25
        return self.t


def _program(tracer):
    """Nested spans, an error span, a span in an executor thread through
    `wrap`, then a second root."""
    with tracer.span("http.request", method="POST", route="/r") as root:
        root.attrs["status"] = 200
        with tracer.span("batcher.submit", model="m", max_new=4):
            with tracer.span("decode.attention", impl="torch", steps=2):
                pass
        with pytest.raises(KeyError):
            with tracer.span("engine.score", model="m", batch=1):
                raise KeyError("x")
        fn = tracer.wrap(lambda a: a + 1, "device.generate")
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            assert ex.submit(fn, 1).result() == 2
    with tracer.span("train.step", batch=2, compile=True):
        pass


def _tree(tracer):
    """Every trace as (root name, duration, spans as (name, parent name,
    attrs, durationMs)), ids replaced by names."""
    out = []
    for t in tracer.traces():
        by_id = {s["spanId"]: s["name"] for s in t["spans"]}
        out.append((t["name"], t["durationMs"], [
            (s["name"], by_id.get(s["parentId"]), s["attrs"],
             s["durationMs"]) for s in t["spans"]]))
    return out


def test_span_program_gives_the_same_tree():
    jt, tt = jtr.Tracer(clock=FakeClock()), ttr.Tracer(clock=FakeClock())
    _program(jt)
    _program(tt)
    assert _tree(tt) == _tree(jt)
    names = [s[0] for s in _tree(tt)[1][2]]
    assert names == ["decode.attention", "batcher.submit", "engine.score",
                     "device.generate", "http.request"]
    assert _tree(tt)[1][2][2][2]["error"] == "KeyError"


def test_chrome_trace_events_agree():
    jt, tt = jtr.Tracer(clock=FakeClock()), ttr.Tracer(clock=FakeClock())
    _program(jt)
    _program(tt)
    ids = ("trace_id", "span_id", "parent_id")

    def strip(doc):
        return [{**e, "args": {k: v for k, v in e["args"].items()
                               if k not in ids}}
                for e in doc["traceEvents"]]

    jd, td = jt.chrome_trace(), tt.chrome_trace()
    assert td["displayTimeUnit"] == jd["displayTimeUnit"]
    assert strip(td) == strip(jd)
    root = next(e for e in td["traceEvents"] if e["name"] == "http.request")
    kids = [e for e in td["traceEvents"]
            if e["args"]["parent_id"] == root["args"]["span_id"]]
    assert {e["name"] for e in kids} == {"batcher.submit", "engine.score",
                                         "device.generate"}


@pytest.mark.parametrize("max_traces,n", [(3, 5), (1, 2), (4, 4)])
def test_ring_evicts_the_oldest_trace(max_traces, n):
    got = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(max_traces=max_traces, clock=FakeClock())
        for i in range(n):
            with tracer.span(f"root-{i}"):
                pass
        got.append([t["name"] for t in tracer.traces()])
    assert got[0] == got[1]
    assert got[1] == [f"root-{i}" for i in reversed(range(n))][:max_traces]


def test_spans_per_trace_are_capped():
    assert ttr.MAX_SPANS_PER_TRACE == jtr.MAX_SPANS_PER_TRACE == 512
    counts = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(clock=FakeClock())
        with tracer.span("root"):
            for i in range(600):
                with tracer.span("child", i=i):
                    pass
        (t,) = tracer.traces()
        counts.append((len(t["spans"]), t["spans"][-1]["attrs"]))
    assert counts[0] == counts[1]
    assert counts[1][0] == 512


HEADERS = [
    ("0123456789abcdef0123456789abcdef", "0123456789abcdef"),
    ("deadbeef", "cafef00d"),
    ("DEADBEEF", "cafef00d"),            # uppercase hex
    ("deadbee", "cafef00d"),             # too short
    ("a" * 64, "b" * 64),
    ("a" * 65, "b" * 8),                 # too long
    ("zz" * 8, "cafef00d"),              # not hex
    ("", "cafef00d"),
    ("deadbeefdeadbeef", ""),
    ("dead beef", "cafef00dcafef00d"),
]


@pytest.mark.parametrize("tid,psid", HEADERS)
def test_span_from_remote_accepts_what_the_reference_accepts(tid, psid):
    got = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(clock=FakeClock())
        with tracer.span_from_remote("http.request", tid, psid,
                                     route="/r") as s:
            with tracer.span("child"):
                pass
        (t,) = tracer.traces()
        adopted = t["traceId"] == tid
        got.append((adopted, s.parent_id == psid if adopted
                    else s.parent_id is None, len(t["spans"]),
                    mod._valid_span_id(tid), mod._valid_span_id(psid)))
    assert got[0] == got[1]
    assert got[1][0] == (got[1][3] and got[1][4])


def test_span_from_remote_under_an_open_span_nests_locally():
    for mod in (jtr, ttr):
        tracer = mod.Tracer(clock=FakeClock())
        with tracer.span("outer") as outer:
            with tracer.span_from_remote("inner", "ab" * 8,
                                         "cd" * 8) as inner:
                pass
        assert inner.trace_id == outer.trace_id
        assert inner.parent_id == outer.span_id


@pytest.mark.parametrize("query", [
    {}, {"format": "summary"}, {"name": "train.step"}, {"limit": "1"},
    {"limit": "0"}, {"name": "nope"}])
def test_traces_response_payload_matches(query):
    payloads = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(clock=FakeClock())
        _program(tracer)
        payloads.append(mod.traces_response_payload(tracer, query))
    j, t = payloads

    def shape(p):
        if "traces" in p:
            return [(x["name"], [s["name"] for s in x["spans"]])
                    for x in p["traces"]]
        return [e["name"] for e in p["traceEvents"]]

    assert sorted(t) == sorted(j)
    assert shape(t) == shape(j)


def test_traces_response_payload_by_trace_id():
    tracer = ttr.Tracer(clock=FakeClock())
    _program(tracer)
    tid = tracer.traces(name="http.request")[0]["traceId"]
    doc = ttr.traces_response_payload(tracer, {"trace_id": tid})
    assert {e["args"]["trace_id"] for e in doc["traceEvents"]} == {tid}


def test_bad_limit_is_the_same_value_error():
    msgs = []
    for mod in (jtr, ttr):
        with pytest.raises(ValueError) as e:
            mod.traces_response_payload(mod.Tracer(), {"limit": "x"})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("limit must be an integer")


SEGMENTS = [
    ("router", {"displayTimeUnit": "ms", "traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 9, "tid": 1,
         "args": {"name": "old"}},
        {"name": "route", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 1,
         "tid": 1, "args": {"trace_id": "ab" * 8}}]}),
    ("replica-0", {"traceEvents": [
        {"name": "http.request", "ph": "X", "ts": 1.5, "dur": 1.0,
         "pid": 1, "tid": 1, "args": {"trace_id": "ab" * 8}},
        {"name": "m.kv_blocks", "ph": "C", "ts": 1.6, "pid": 1, "tid": 0,
         "args": {"in_use": 3}}]}),
    ("replica-1", {}),
]


def test_merge_chrome_traces_on_fixed_inputs():
    got = ttr.merge_chrome_traces(SEGMENTS)
    assert got == jtr.merge_chrome_traces(SEGMENTS)
    assert [e["pid"] for e in got["traceEvents"]] == [1, 1, 2, 2, 2, 3]


def test_obs_exports_the_default_tracer():
    assert isinstance(tobs.DEFAULT_TRACER, ttr.Tracer)
    assert tobs.Tracer is ttr.Tracer
    with tobs.DEFAULT_TRACER.span("probe") as s:
        assert tobs.DEFAULT_TRACER.current_trace_id() == s.trace_id
    assert tobs.DEFAULT_TRACER.current_trace_id() is None


def test_mounted_doors_answer_as_the_reference():
    """`mount_observability` on a bare app: `/metrics` renders the
    registry, `/debug/traces` the tracer, 400 on a bad limit, in both."""
    import asyncio

    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    from kubeflow_tpu.controlplane import metrics as jmetrics
    from kubeflow_tpu.obs import endpoints as jend
    from kubeflow_tpu_torch.obs import endpoints as tend
    from kubeflow_tpu_torch.obs import metrics as tmetrics

    async def go(mod, reg, tracer):
        app = web.Application()
        mod.mount_observability(app, registry=reg, tracer=tracer)
        with tracer.span("probe", k=1):
            pass
        async with TestClient(TestServer(app)) as c:
            m = await (await c.get("/metrics")).text()
            doc = await (await c.get("/debug/traces")).json()
            bad = await c.get("/debug/traces", params={"limit": "x"})
            return m, [e["name"] for e in doc["traceEvents"]], \
                bad.status, await bad.text()

    regs = []
    for metrics in (jmetrics, tmetrics):
        regs.append(metrics.Registry())
        metrics.Counter("probe_total", "probes", regs[-1]).inc(2, route="/x")
    want = asyncio.run(go(jend, regs[0], jtr.Tracer()))
    got = asyncio.run(go(tend, regs[1], ttr.Tracer()))
    assert got == want
    assert got[1] == ["probe"] and got[2] == 400
