"""Observability helpers of the port (counterpart: kubeflow_tpu/obs/):
the KV block lifecycle ledger and the prefix hashing that the
continuous batcher's radix prefix cache reports through."""
