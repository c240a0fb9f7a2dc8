"""Serving layer of the port (counterpart: kubeflow_tpu/serving/):
continuous batching over a paged KV pool behind an aiohttp app."""
