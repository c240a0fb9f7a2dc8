"""The port's profiling utilities (kubeflow_tpu_torch/utils/profiling.py)
against the reference's (kubeflow_tpu/utils/profiling.py) on the CPU:
StepTimer's summary over given durations is the reference's, exactly;
steps feed the profiler, the tracer and a histogram; the pod start time
comes from KFTPU_POD_START_TIME; `trace` writes a Chrome trace under a
span; `time_to_first_compile` returns the call's result."""

import json
import os
import time

import pytest
import torch

from kubeflow_tpu.utils import profiling as jprof
from kubeflow_tpu_torch.obs.metrics import Histogram, Registry
from kubeflow_tpu_torch.obs.tracing import Tracer
from kubeflow_tpu_torch.utils import profiling


@pytest.mark.parametrize("durations", [
    [0.5], [0.1, 0.3], [0.2, 0.05, 0.9, 0.4, 0.31, 0.07, 0.6, 0.11],
    [0.01 * i for i in range(1, 101)]])
def test_step_timer_summary_matches_reference(durations):
    got, want = profiling.StepTimer(), jprof.StepTimer()
    for d in durations:
        got.record(d)
        want.record(d)
    assert got.summary() == want.summary()
    assert got.profiler.totals()["train.step"] == \
        pytest.approx(sum(durations))


def test_empty_summary():
    assert profiling.StepTimer().summary() == {} == jprof.StepTimer().summary()


def test_step_feeds_tracer_and_histogram():
    tracer = Tracer()
    hist = Histogram("t_step_seconds", "step", registry=Registry())
    timer = profiling.StepTimer(tracer=tracer, histogram=hist)
    for i in range(3):
        with timer.step(i=i):
            time.sleep(0.002)
    assert timer.summary()["count"] == 3
    assert min(timer.durations) >= 0.002
    assert len(tracer.traces(name="train.step")) == 3
    assert hist.count() == 3


def test_pod_start_time(monkeypatch):
    monkeypatch.setenv(profiling.POD_START_ENV, "1234.5")
    assert profiling.pod_start_time() == 1234.5 == jprof.pod_start_time()
    monkeypatch.setenv(profiling.POD_START_ENV, "junk")
    assert profiling.pod_start_time() == profiling._PROCESS_START
    assert profiling.POD_START_ENV == jprof.POD_START_ENV


def test_time_to_first_compile(monkeypatch):
    monkeypatch.setenv(profiling.POD_START_ENV, str(time.time() - 5.0))
    secs, out = profiling.time_to_first_compile(
        lambda a, b=1: a * b, torch.ones(3), b=2)
    assert 5.0 <= secs < 60.0
    torch.testing.assert_close(out, 2 * torch.ones(3))


def test_trace_writes_a_chrome_trace(tmp_path):
    tracer = Tracer()
    with profiling.trace(str(tmp_path / "prof"), tracer=tracer):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    doc = json.loads((tmp_path / "prof" / files[0]).read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert [t["name"] for t in tracer.traces()] == ["torch.profile"]
