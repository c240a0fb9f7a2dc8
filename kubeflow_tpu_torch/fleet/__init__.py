"""The fleet layer's replica registry (counterpart: kubeflow_tpu/fleet/),
as far as the elastic trainer fleet (train/elastic.py) stands on it:
heartbeat-driven health states and the rendezvous hash. The serving
router, autoscaler, control loop and rollout plane are not ported."""

from kubeflow_tpu_torch.fleet.registry import (
    DEAD,
    DEGRADED,
    DRAINING,
    READY,
    STATES,
    Replica,
    ReplicaRegistry,
    rendezvous,
)

__all__ = ["DEAD", "DEGRADED", "DRAINING", "READY", "STATES", "Replica",
           "ReplicaRegistry", "rendezvous"]
