"""Multi-process bootstrap: the webhook's gang env -> a torch.distributed
process group (counterpart: kubeflow_tpu/distributed.py).

The admission webhook injects `JAX_COORDINATOR_ADDRESS`,
`KFTPU_NUM_PROCESSES`, `KFTPU_PROCESS_ID` and `TPU_WORKER_ID` onto every
gang pod (controlplane/webhook.py). The names stay as the webhook
injects them, and the rules are the reference's: no env, or a gang of
one, is a no-op; a half-injected env (a coordinator without a process
count, a non-integer id) raises `ValueError` at startup instead of
hanging the other ranks in the rendezvous; a multi-slice gang must carry
the global `KFTPU_PROCESS_ID` (the per-slice `TPU_WORKER_ID` repeats
across slices).

The env feeds `torch.distributed.init_process_group` over
`tcp://<coordinator>`: the NCCL backend when the ranks hold CUDA devices
(the default), gloo when the caller asks for the CPU (`device="cpu"`)
or names a backend itself (`backend="gloo"`: several ranks on one card,
where NCCL refuses two ranks of one device; parallel/comm.py stages
their CUDA tensors through host memory). `parallel.mesh_from_env()`
then lays the ranks out as a mesh.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = "KFTPU_NUM_PROCESSES"
# Global process id. TPU_WORKER_ID is the fallback for single-slice
# gangs only: worker ids are PER SLICE, so in a multi-slice gang they
# repeat across slices and cannot serve as the rank.
PROCESS_ID_ENV = "KFTPU_PROCESS_ID"
WORKER_ID_FALLBACK_ENV = "TPU_WORKER_ID"
NUM_SLICES_ENVS = ("KFTPU_NUM_SLICES", "MEGASCALE_NUM_SLICES")

_initialized = False


def is_initialized() -> bool:
    return _initialized


def gang_from_env() -> tuple[str, int, int] | None:
    """(coordinator, num_processes, process_id) from the webhook env, or
    None when it describes one process (or is absent). Raises
    ValueError on half-injected env."""
    coordinator = os.environ.get(COORDINATOR_ENV, "")
    raw_num = os.environ.get(NUM_PROCESSES_ENV, "")
    raw_id = (os.environ.get(PROCESS_ID_ENV, "")
              or os.environ.get(WORKER_ID_FALLBACK_ENV, ""))
    if not coordinator and not raw_num:
        return None
    if not coordinator or not raw_num:
        raise ValueError(
            f"half-injected gang env: {COORDINATOR_ENV}={coordinator!r} "
            f"{NUM_PROCESSES_ENV}={raw_num!r} — the TPU webhook injects "
            "both or neither")
    multi_slice = any(os.environ.get(v) not in (None, "", "1")
                      for v in NUM_SLICES_ENVS)
    if multi_slice and not os.environ.get(PROCESS_ID_ENV):
        raise ValueError(
            f"multi-slice gang without {PROCESS_ID_ENV}: the per-slice "
            f"{WORKER_ID_FALLBACK_ENV} repeats across slices and cannot "
            "be the global process id")
    try:
        num_processes = int(raw_num)
        process_id = int(raw_id or "0")
    except ValueError as e:
        raise ValueError(f"non-integer gang env: {e}") from e
    if num_processes <= 1:
        return None
    return coordinator, num_processes, process_id


def default_backend(device: torch.device | str | None = None) -> str:
    """NCCL for ranks on CUDA devices (`device` None or "cuda"), gloo
    for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize_from_env(timeout_secs: int | None = None, *,
                        device: torch.device | str | None = None,
                        backend: str | None = None) -> bool:
    """Form the global process group from the webhook env. Returns True
    when `init_process_group` ran (a gang of several processes), False
    when the env describes one process or is absent. Safe to call more
    than once: later calls are no-ops."""
    global _initialized
    if _initialized:
        return True
    gang = gang_from_env()
    if gang is None:
        return False
    coordinator, num_processes, process_id = gang
    backend = backend or default_backend(device)
    kwargs = {}
    if timeout_secs is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_secs)
    log.info("init_process_group backend=%s coordinator=%s process=%d/%d",
             backend, coordinator, process_id, num_processes)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    _initialized = True
    return True


def shutdown() -> None:
    global _initialized
    if _initialized:
        dist.destroy_process_group()
        _initialized = False


def global_mesh_from_env(devices=None, **kwargs):
    """initialize_from_env() + parallel.mesh_from_env() in one call: the
    two-line prologue of a gang training script. `kwargs` go to
    `initialize_from_env`."""
    initialize_from_env(**kwargs)
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_env

    return mesh_from_env(devices)
