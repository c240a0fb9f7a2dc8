"""Resize-on-restore and the elastic gang, on the CPU.

Resize-on-restore runs in one 4-rank gloo gang (tests/torch_dist.py),
as tests/test_elastic.py runs it on the reference's virtual devices:
LLAMA_TINY (fp32) trains 3 steps on a (data 2, fsdp 2) mesh with ZeRO
moments and saves; the step is restored on a (data 4, fsdp 1) mesh and
on one device. The restored moments equal the saved ones bit for bit,
the stamp reads 2 where saved and 4 or 1 where restored (each resize
logged), and 5 more steps reproduce the uninterrupted
run's losses within 1e-5 (the meshes sum the batch and the gradients
in other orders). `resize_state` moves a live state from the first mesh
to the second and to one device, bit for bit, and the next step's loss
agrees within 1e-5. The commit markers hold with one writing rank:
async markers land on the next save and on close, a crash's
uncommitted step is skipped by restore and re-saved over, a committed
step is never re-saved, and a directory of only uncommitted steps
initialises fresh.

The gang: the port's coordinator on a local port (min_replicas 2) and
two worker processes (`python -m kubeflow_tpu_torch.train.elastic
worker --cpu`, the reference's defaults: LLAMA_TINY, batch 12, seq 16,
16 steps, a save every 4, with a slow save to widen its window). The
chief is killed (SIGKILL) while the coordinator shows it saving step 8;
the survivor restarts from the last committed step, finishes 16 steps
and saves them. Every loss line it wrote equals an uninterrupted
one-worker run's at the same step exactly (one CPU thread on both
sides, the same batches: the same arithmetic), the coordinator counts
one restart and a later generation, and its ledger books the re-run
steps to replay and conserves.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs.metrics import Registry
from kubeflow_tpu_torch.train import elastic
from torch_dist import ROOT, run_gang

TOTAL, SAVE_EVERY, KILL_AT = 16, 4, 8


@pytest.fixture(scope="module")
def resize(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    batches = []
    for step in range(8):
        rng = np.random.default_rng(1000 + step)
        batches.append(tuple(rng.integers(0, 512, (8, 16)).astype(np.int64)
                             for _ in range(2)))
    return run_gang("elastic_resize_cases", 4,
                    {"dir": str(d), "batches": batches})


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("world", [4, 1])
def test_resize_restore_matches_uninterrupted_run(resize, world):
    for out in resize:
        assert out["saved"]
        got = out[("restore", world)]
        assert got["step"] == 3
        assert got["stamp"] == world
        assert got["meta"] == {"run": "resize-test", "virtual_replicas": 2}
        assert _equal(got["opt"], out["saved_opt"])
        np.testing.assert_allclose(got["losses"], out["oracle"], atol=1e-5,
                                   rtol=0)
    # the ZeRO moments were sliced on the saving mesh (a rank held a
    # quarter of attn_norm's [2, 128] moment: fsdp cuts the embed dim,
    # data the layers), and each resize was logged
    assert resize[0]["mu_local"] == (1, 64)
    assert any(f"saved at 2 virtual replicas, restored at {world}" in line
               for line in resize[0]["log"])


def test_resize_state_moves_a_live_state(resize):
    for out in resize:
        r = out["resize"]
        assert _equal(r["to4"], r["src"]) and _equal(r["to1"], r["src"])
        np.testing.assert_allclose(r["losses"][1:], [r["losses"][0]] * 2,
                                   atol=1e-5, rtol=0)


def test_commit_markers_with_one_writer(resize):
    for out in resize:
        m = out["marks"]
        assert m["after_second_save"] == [1]
        assert m["after_close"] == [1, 2]
        assert m["latest_path"].endswith(os.path.join("markers", "2"))
        assert m["latest_committed"] == 2 and m["restored_step"] == 2
        assert m["resaved"] and m["junk_gone"] and m["marker"]
        assert m["skip_committed"] is False
        assert m["fresh_step"] == 0


# -- the gang with a killed worker ----------------------------------------


@pytest.fixture
def coordinator():
    """The port's coordinator app on a local port (real clock), in a
    thread of its own event loop. Its staleness limits are 2.5x the CLI's
    defaults (degraded after 2.5 s, dead after 5 s): on a loaded test
    machine a heartbeat thread can stall past 2 s and read as a death.
    The survivor waits out the longer limit in soft lockstep (it may not
    run more than 2 steps ahead of a member the coordinator still
    counts live)."""
    from aiohttp import web

    coord = elastic.ElasticCoordinator(min_replicas=2, degraded_after_s=2.5,
                                       dead_after_s=5.0,
                                       registry=Registry())
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(elastic.create_coordinator_app(coord))
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield coord, f"http://127.0.0.1:{runner.addresses[0][1]}"
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    loop.run_until_complete(runner.cleanup())
    loop.close()


def _oracle():
    """One worker's uninterrupted losses: the worker's trainer and
    batches, in this process on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = elastic._build_trainer(1, llama.LLAMA_TINY,
                                         registry=Registry(), device="cpu")
        state = trainer.init(0)
        losses = []
        for step in range(TOTAL):
            toks, tgts = elastic._deterministic_batch(
                llama.LLAMA_TINY.vocab_size, 12, 16, 0, step)
            state, loss = trainer.step(state, torch.as_tensor(toks),
                                       torch.as_tensor(tgts))
            losses.append(float(loss))
        return losses
    finally:
        torch.set_num_threads(threads)


def test_killed_worker_gang_replays_the_same_losses(coordinator, tmp_path):
    coord, url = coordinator
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for rid in ("tr0", "tr1"):
        procs[rid] = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.train.elastic",
             "worker", "--cpu", "--coordinator", url, "--replica-id", rid,
             "--ckpt-dir", str(tmp_path / "ckpt"), "--steps", str(TOTAL),
             "--save-every", str(SAVE_EVERY), "--slow-save-s", "0.5",
             "--loss-log", str(tmp_path / f"{rid}.jsonl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    try:
        want = _oracle()
        deadline = time.monotonic() + 120
        while True:
            w = coord.world()
            if w["phases"].get("tr0") == "saving" and \
                    w["steps"].get("tr0") == KILL_AT:
                break
            assert procs["tr0"].poll() is None, procs["tr0"].communicate()
            assert time.monotonic() < deadline, w
            time.sleep(0.01)
        gen_at_kill = w["generation"]
        procs["tr0"].send_signal(signal.SIGKILL)
        out, err = procs["tr1"].communicate(timeout=120)
        assert procs["tr1"].returncode == 0, err[-4000:]
    finally:
        for p in procs.values():
            p.kill()
            p.communicate()
    result = json.loads(out.strip().splitlines()[-1])
    lines = [json.loads(x) for x in
             (tmp_path / "tr1.jsonl").read_text().splitlines()]
    assert {x["step"] for x in lines} == set(range(1, TOTAL + 1))
    for x in lines:
        assert x["loss"] == want[x["step"] - 1], x
    assert result["final_step"] == TOTAL and result["restores"] == 2
    assert result["world_size"] == 1
    assert result["generation"] > gen_at_kill
    assert coord.restarts_total.value() == 1.0
    book = result["goodput"]
    assert book["replay_steps"] >= 1 and book["seconds"]["replay"] > 0
    assert book["conserved"]
    ck = tmp_path / "ckpt"
    for step in (12, 16):
        assert (ck / str(step) / "COMMITTED").exists()
    # the dead chief's uncommitted step 8 was re-saved over and pruned
    # with the oldest (max_to_keep 3: 8, 12, 16)
    assert (ck / "8" / "COMMITTED").exists()
