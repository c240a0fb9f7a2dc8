"""LoRA's adapter schema, for serving adapter packs (counterpart:
kubeflow_tpu/train/lora.py).

Only what the port needs today: `LoraConfig` (rank, alpha, targets,
the reference's checks), `_TARGET_DIMS` (each adaptable block weight's
in and out widths, as attributes of the model config: llama and gemma
share the schema) and `merge_lora`, which folds adapters into the block
weights: the oracle the tests and the card's smoke run hold the
unmerged adapter path to. Adapter trees keep the reference's layout,
`{"blocks": {name: {"A": [L, d_in, r], "B": [L, r, d_out]}}}`. Training
with adapters (the reference's `init_lora`, `lora_loss_fn` and frozen
base) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Params = dict

_TARGET_DIMS = {
    "wq": ("hidden_size", "q_dim"),
    "wk": ("hidden_size", "kv_dim"),
    "wv": ("hidden_size", "kv_dim"),
    "wo": ("q_dim", "hidden_size"),
    "w_gate": ("hidden_size", "intermediate_size"),
    "w_up": ("hidden_size", "intermediate_size"),
    "w_down": ("intermediate_size", "hidden_size"),
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # which block weights get adapters; the default adapts every one
    targets: tuple[str, ...] = (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def __post_init__(self):
        unknown = set(self.targets) - set(_TARGET_DIMS)
        if unknown:
            raise ValueError(f"unknown LoRA targets {sorted(unknown)} "
                             f"(known: {sorted(_TARGET_DIMS)})")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def merge_lora(base: Params, adapters: Params,
               lora_cfg: LoraConfig) -> Params:
    """`base` with W <- W + (alpha / r) A @ B for every adapted block
    weight, summed in fp32 and cast back to W's dtype (the reference's
    arithmetic). Leaves other than the adapted weights are shared with
    `base`; the merged ones are new tensors on W's device."""
    blocks = dict(base["blocks"])

    def f32(x, device):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(device=device, dtype=torch.float32)

    for name, ab in adapters["blocks"].items():
        w = blocks[name]
        delta = torch.einsum("lir,lro->lio", f32(ab["A"], w.device),
                             f32(ab["B"], w.device))
        blocks[name] = (w.float() + lora_cfg.scaling * delta).to(w.dtype)
    out = dict(base)
    out["blocks"] = blocks
    return out
