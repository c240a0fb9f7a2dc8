"""Spawns a gang of CPU processes in one gloo group for the port's
distributed tests (no JAX in the children).

`run_gang(case, world, payload)` starts `world` Python processes; each
forms a gloo group over a `file://` store, runs
`torch_dist_workers.<case>(payload, rank, world)` and saves what it
returns; the parent gets the per-rank results in rank order. A test
module spawns once (a module-scoped fixture) and runs all its torch-side
cases in that one gang; the JAX side is computed in the parent.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

CHILD = r"""
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp, case = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        world_size=world, rank=rank)
import torch_dist_workers
payload = torch.load(f"{tmp}/payload.pt", weights_only=False)
out = getattr(torch_dist_workers, case)(payload, rank, world)
torch.save(out, f"{tmp}/out{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""


def run_gang(case: str, world: int, payload, timeout: float = 240.0):
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(payload, f"{tmp}/payload.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(HERE), str(ROOT), env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), str(world), tmp, case],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
        finally:
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {case} failed:\n{out}")
        return [torch.load(f"{tmp}/out{r}.pt", weights_only=False)
                for r in range(world)]
