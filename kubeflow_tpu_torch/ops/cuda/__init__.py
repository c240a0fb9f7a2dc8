"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version and a launch counter.

- `paged_attention.paged_decode_attention` (csrc/paged_decode_attention.cu)
- `prefill_append.paged_prefill_append` (csrc/paged_prefill_append.cu)
"""

from __future__ import annotations

from kubeflow_tpu_torch.ops.cuda import paged_attention, prefill_append

_MODULES = {"paged_decode_attention": paged_attention,
            "paged_prefill_append": prefill_append}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
