"""Observability helpers of the port (counterpart: kubeflow_tpu/obs/):
the KV block lifecycle ledger and the prefix hashing that the
continuous batcher's radix prefix cache reports through
(`cachestats`), per-request token timelines (`timeline`), and the
metric registry, counters, gauges and histograms behind the serving
app's `/metrics` (`metrics`), and the SLO burn-rate engine whose gauges
it renders (`slo`)."""
