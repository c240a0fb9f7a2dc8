"""Cross-cutting utilities of the port (counterpart:
kubeflow_tpu/utils/): profiling hooks. The reference's hot-reloaded
`WatchedConfig` is not ported yet."""

from kubeflow_tpu_torch.utils.profiling import (
    StepTimer,
    pod_start_time,
    time_to_first_compile,
    trace,
)
