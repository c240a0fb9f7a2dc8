"""Hand-written CUDA kernels, each beside its plain PyTorch version and
a launch counter.

Serving:
- `paged_attention.paged_decode_attention` (csrc/paged_decode_attention.cu)
- `prefill_append.paged_prefill_append` (csrc/paged_prefill_append.cu)
- `decode_attention.decode_attention` (csrc/decode_attention.cu)
- `int8_proj.int8_proj` (csrc/int8_proj.cu): the weight-only int8
  projection of `serving/quant.py::qdot`, which no Pallas kernel has

Training:
- `flash_attention.flash_block_fwd` (csrc/flash_attention_fwd.cu)
- `flash_attention.flash_dq` (csrc/flash_attention_dq.cu)
- `flash_attention.flash_dkv` (csrc/flash_attention_dkv.cu)
"""

from __future__ import annotations

from kubeflow_tpu_torch.ops.cuda import (
    decode_attention,
    flash_attention,
    int8_proj,
    paged_attention,
    prefill_append,
)

# kernel name -> (module, name of its launch counter)
_COUNTERS = {
    "paged_decode_attention": (paged_attention, "launches"),
    "paged_prefill_append": (prefill_append, "launches"),
    "flash_attention_fwd": (flash_attention, "fwd_launches"),
    "flash_attention_dq": (flash_attention, "dq_launches"),
    "flash_attention_dkv": (flash_attention, "dkv_launches"),
    "decode_attention": (decode_attention, "launches"),
    "int8_proj": (int8_proj, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add `delta` (kernel name -> launches) to the counters: what a CUDA
    graph replay launched without calling the wrappers
    (serving/graphs.py)."""
    for name, n in delta.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)
