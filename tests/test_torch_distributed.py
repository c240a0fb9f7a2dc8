"""The port's multi-process bootstrap (kubeflow_tpu_torch/distributed.py)
against the reference's env rules (tests/test_distributed.py), on the
CPU: the same no-op for one process, the same ValueErrors for a
half-injected or multi-slice env without the global id, and a real gang
of 2 processes wearing exactly the webhook's env that forms a gloo
group, lays a mesh over it from KFTPU_MESH and sums across it."""

import os
import socket
import subprocess
import sys

import pytest

from kubeflow_tpu import distributed as jdist
from kubeflow_tpu_torch import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import torch
from kubeflow_tpu_torch import distributed
from kubeflow_tpu_torch.parallel import comm, mesh_from_env

assert distributed.initialize_from_env(timeout_secs=120, device="cpu")
assert distributed.initialize_from_env(device="cpu")   # a no-op again
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = mesh_from_env(device_type="cpu")
assert mesh.shape == {"data": 1, "fsdp": 2, "tensor": 1}, mesh.shape
assert mesh.device_mesh is not None
g = mesh.axis_group("fsdp")
total = comm.psum(torch.tensor([float(g.index + 1)]), g)
assert float(total) == 3.0, float(total)
print("CHILD-OK", dist.get_rank(), flush=True)
distributed.shutdown()
"""

ENV_NAMES = ("JAX_COORDINATOR_ADDRESS", "KFTPU_NUM_PROCESSES",
             "KFTPU_PROCESS_ID", "TPU_WORKER_ID", "KFTPU_NUM_SLICES",
             "MEGASCALE_NUM_SLICES", "KFTPU_MESH", "KFTPU_TOPOLOGY")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_env_names_are_the_webhooks():
    assert distributed.COORDINATOR_ENV == jdist.COORDINATOR_ENV
    assert distributed.NUM_PROCESSES_ENV == jdist.NUM_PROCESSES_ENV
    assert distributed.PROCESS_ID_ENV == jdist.PROCESS_ID_ENV
    assert (distributed.WORKER_ID_FALLBACK_ENV
            == jdist.WORKER_ID_FALLBACK_ENV)


def test_single_process_env_is_noop(clean_env):
    assert distributed.initialize_from_env() is False
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    clean_env.setenv("KFTPU_NUM_PROCESSES", "1")
    clean_env.setenv("TPU_WORKER_ID", "0")
    assert distributed.initialize_from_env() is False
    assert jdist.initialize_from_env() is False
    assert not distributed.is_initialized()


def test_half_injected_env_fails_loudly(clean_env):
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    for mod in (distributed, jdist):
        with pytest.raises(ValueError, match="half-injected"):
            mod.initialize_from_env()
    clean_env.setenv("KFTPU_NUM_PROCESSES", "two")
    for mod in (distributed, jdist):
        with pytest.raises(ValueError, match="non-integer"):
            mod.initialize_from_env()


def test_multislice_requires_global_process_id(clean_env):
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    clean_env.setenv("KFTPU_NUM_PROCESSES", "8")
    clean_env.setenv("KFTPU_NUM_SLICES", "2")
    clean_env.setenv("TPU_WORKER_ID", "0")
    for mod in (distributed, jdist):
        with pytest.raises(ValueError, match="KFTPU_PROCESS_ID"):
            mod.initialize_from_env()
    clean_env.setenv("KFTPU_PROCESS_ID", "5")
    assert distributed.gang_from_env() == ("127.0.0.1:1", 8, 5)


def test_backend_follows_the_device():
    assert distributed.default_backend() == "nccl"
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"


def test_two_process_gang_forms_a_group_and_a_mesh():
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ)
        for name in ENV_NAMES:
            env.pop(name, None)
        env.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "KFTPU_NUM_PROCESSES": "2", "TPU_WORKER_ID": str(i),
                    "KFTPU_MESH": "data=1,fsdp=2,tensor=1",
                    "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"CHILD-OK {i}" in out
