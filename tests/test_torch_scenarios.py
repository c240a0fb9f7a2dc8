"""The port's scenario engine (kubeflow_tpu_torch/scenarios/) against the
JAX package's (kubeflow_tpu/scenarios/), on the CPU.

Every generator writes a byte-identical trace file for seeds 0, 1 and 7
in both; `prompt_ids_for` derives the same prompts; an open-loop replay
on a fake clock with one deterministic submit gives equal records and
equal `summarize` output, and `check_expect` the same verdicts; the CLI
(`generate`, `describe`) prints the same; the recorder folds the same
timeline payloads into the same trace. Last, `HttpTarget` replays two
small traces (shared prefixes; hang-ups and retries) open-loop against
the port's continuous app on a local port: each meets its `expect`
block, every slot is free after, the block ledger is conserved, and
`record` of the run gives a trace that `describe` reads with every
replayed request in it.
"""

import asyncio
import contextlib
import io
import json
import math
import socket
import threading
import time

import pytest

from kubeflow_tpu import scenarios as jsc
from kubeflow_tpu.scenarios import __main__ as jcli
from kubeflow_tpu_torch import scenarios as tsc
from kubeflow_tpu_torch.scenarios import __main__ as tcli

SEEDS = (0, 1, 7)
SHAPES = sorted(jsc.GENERATORS)


def test_the_same_generators():
    assert sorted(tsc.GENERATORS) == SHAPES
    assert tsc.TRACE_VERSION == jsc.TRACE_VERSION


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_generators_write_byte_identical_traces(shape, seed, tmp_path):
    tsc.write_trace(tsc.generate(shape, seed), tmp_path / "t.jsonl")
    jsc.write_trace(jsc.generate(shape, seed), tmp_path / "j.jsonl")
    got = (tmp_path / "t.jsonl").read_bytes()
    assert got == (tmp_path / "j.jsonl").read_bytes()
    assert tsc.read_trace(tmp_path / "t.jsonl").dumps().encode() == got


@pytest.mark.parametrize("shape", SHAPES)
def test_prompt_ids_match(shape):
    tr = tsc.generate(shape, 7)
    jtr = jsc.generate(shape, 7)
    for treq, jreq in zip(tr.requests, jtr.requests):
        for seed in (0, 7):
            assert tsc.prompt_ids_for(treq, seed) == \
                jsc.prompt_ids_for(jreq, seed)


class _FakeTime:
    """A deterministic clock for `replay`: `sleep` advances time only once
    every arrival due so far has reached its submit. A sleep below 1e-9 s
    is the float residue of an arrival's own offset (the replayer has
    not submitted that arrival yet): it advances at once, by at least
    one ulp."""

    def __init__(self, arrivals, speed):
        self.t = 100.0
        self.t0 = self.t
        self.arrivals = sorted(a / speed for a in arrivals)
        self.landed = 0
        self.lock = threading.Lock()

    def clock(self):
        with self.lock:
            return self.t

    def sleep(self, dt):
        if dt < 1e-9:
            with self.lock:
                self.t = max(self.t + dt, math.nextafter(self.t, math.inf))
            return
        due = sum(1 for a in self.arrivals
                  if a <= self.t - self.t0 + 1e-12)
        while True:
            with self.lock:
                if self.landed >= due:
                    self.t += dt
                    return
            time.sleep(0.0005)


def _submit(ft):
    def submit(req, t0):
        with ft.lock:
            ft.landed += 1
        h = sum(map(ord, req.id))
        if req.abandon_at is not None:
            return {"ok": True, "abandoned": True, "tokens": h % 3,
                    "ttft_s": None, "wall_s": 0.05}
        if h % 11 == 0:
            return {"ok": False, "abandoned": False, "tokens": 0,
                    "ttft_s": None, "error": f"boom {req.id}"}
        return {"ok": True, "abandoned": False, "tokens": req.max_new,
                "ttft_s": (h % 97) / 1000, "wall_s": 0.1}
    return submit


@pytest.mark.parametrize("speed", [1.0, 8.0])
@pytest.mark.parametrize("shape", ["abandon_retry", "agent_swarm",
                                   "flash_crowd"])
def test_fake_clock_replay_agrees(shape, speed):
    out = []
    for mod in (jsc, tsc):
        tr = mod.generate(shape, 1)
        ft = _FakeTime([r.at for r in tr.requests], speed)
        records = mod.replay(tr, _submit(ft), speed=speed, clock=ft.clock,
                             sleep=ft.sleep)
        result = mod.summarize(tr, records, speed=speed)
        out.append((records, result, mod.check_expect(tr.expect, result)))
    assert out[0] == out[1]
    records, result, _ = out[1]
    assert all(r["dispatched_at"] == r["scheduled_at"] for r in records)
    assert result["offered"] == len(records)


def _cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("shape", SHAPES)
def test_cli_generate_and_describe_print_the_same(shape, tmp_path):
    outs = []
    for name, main in (("j", jcli.main), ("t", tcli.main)):
        path = str(tmp_path / f"{name}.jsonl")
        gen = json.loads(_cli(main, ["generate", shape, "--seed", "7",
                                     "--out", path]))
        gen["written"] = None
        outs.append((gen, _cli(main, ["describe", path])))
    assert outs[0] == outs[1]
    assert (tmp_path / "j.jsonl").read_bytes() == \
        (tmp_path / "t.jsonl").read_bytes()


def _payloads():
    return [
        {"request_id": "a", "enqueue_monotonic_s": 1000.5,
         "prompt_tokens": 8, "max_new": 4, "tenant": "live", "done": True,
         "token_times": [0.1], "events": []},
        {"request_id": "b", "enqueue_monotonic_s": 1002.0,
         "prompt_tokens": 12, "max_new": 9, "tenant": "", "done": False,
         "token_times": [0.1, 0.7], "events": [{"t": 0.9, "kind": "x"}]},
        {"request_id": "warm", "enqueue_monotonic_s": 999.0,
         "prompt_tokens": 0, "max_new": 4},
    ]


def test_recorder_folds_payloads_the_same():
    got = tsc.trace_from_timeline_payloads(_payloads(), name="cap")
    want = jsc.trace_from_timeline_payloads(_payloads(), name="cap")
    assert got.dumps() == want.dumps()
    for mod in (jsc, tsc):
        with pytest.raises(ValueError, match="recorder fields"):
            mod.trace_from_timeline_payloads([{"request_id": "a"}])


# -- one open-loop replay against the port's app -----------------------------


def _engine():
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )

    cfg = llama.LLAMA_TINY
    return InferenceEngine(llama.init(cfg, 0, "cpu"), cfg, LLAMA_FAMILY,
                           EngineConfig(max_len=160), device="cpu")


def test_http_replay_against_the_port_meets_expect(tmp_path):
    from aiohttp.test_utils import TestServer

    from kubeflow_tpu_torch.serving import server

    traces = [tsc.generate("agent_swarm", 0, agents=3, steps_per_agent=3,
                           think_s=0.1, stagger_s=0.05),
              tsc.generate("abandon_retry", 0, n=6, rps=20.0,
                           abandon_max_new=120, max_new=8)]

    async def go():
        app = server.create_serving_app(
            {"tiny": _engine()}, continuous=True, max_batch=4,
            kv_block_size=8, prefill_chunk_tokens=16, seed=0)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        srv = TestServer(app, port=port)
        await srv.start_server()
        base = f"http://127.0.0.1:{port}"
        loop = asyncio.get_running_loop()
        results = []
        try:
            for tr in traces:
                target = tsc.HttpTarget(base, model="tiny", seed=tr.seed)
                records = await loop.run_in_executor(
                    None, lambda: tsc.replay(tr, target))
                results.append(tsc.summarize(tr, records))
            b = app[server.BATCHERS_KEY]["tiny"]
            for _ in range(200):      # hung-up slots release on the loop
                if not b._active:
                    break
                await asyncio.sleep(0.01)
            held = len(b._active)
            ledger = b.cache_anatomy()["ledger"]
            rec = await loop.run_in_executor(
                None, lambda: tsc.record_from_server(base, name="cap"))
        finally:
            await srv.close()
        return results, held, ledger, rec

    results, held, ledger, rec = asyncio.run(go())
    for tr, result in zip(traces, results):
        assert tsc.check_expect(tr.expect, result) == [], (tr.name, result)
    assert results[1]["abandoned"] > 0
    assert held == 0
    assert ledger["conserved"] and ledger["frees"]["unattributed"] == 0
    path = tmp_path / "cap.jsonl"
    tsc.write_trace(rec, path)
    desc = json.loads(_cli(tcli.main, ["describe", str(path)]))
    assert desc["requests"] == sum(len(t.requests) for t in traces)
    assert desc["generator"] == "recorded"
    assert desc["by_tenant"].get("swarm") == len(traces[0].requests)
