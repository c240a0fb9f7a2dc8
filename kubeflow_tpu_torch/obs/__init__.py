"""Observability helpers of the port (counterpart: kubeflow_tpu/obs/):
the KV block lifecycle ledger and the prefix hashing that the
continuous batcher's radix prefix cache reports through
(`cachestats`), per-request token timelines (`timeline`), and the
metric registry, counters, gauges and histograms behind the serving
app's `/metrics` (`metrics`), the SLO burn-rate engine whose gauges it
renders (`slo`), the label guard that caps the values a client's
`X-Tenant` header can put into a label (`cardinality`), and the step
anatomy of the batcher's worker loop (`profiling`)."""
