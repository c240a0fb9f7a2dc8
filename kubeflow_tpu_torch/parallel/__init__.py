"""Parallel layers of the port (counterpart: kubeflow_tpu/parallel/).

Only the single-device half is ported: `moe.py`'s routed expert layer.
Meshes, sharding rules and expert parallelism wait for the distributed
queue (ROADMAP Queue 1).
"""
