"""Multi-LoRA serving: K fine-tuned adapters resident over one base
(counterpart: kubeflow_tpu/serving/multilora.py).

Fine-tunes of one base differ by rank-r adapters, so instead of K merged
models the adapters are stacked into one pack and every request names
one; a batch mixes requests for different fine-tunes and the plain base
in one pass:

    y = qdot(h, W) + scaling * (h @ A[id]) @ B[id]

- The pack is layer-leading (`[L, K+1, d_in, r]`, `[L, K+1, r, d_out]`),
  so the engine's per-layer views slice adapters beside the block
  weights.
- `A[id]` is a per-row gather over the adapter axis: each row reads its
  own adapter.
- Index 0 is the all-zero adapter: base rows ride the same ops and their
  delta is exactly zero (one program, no branch).
- The low-rank delta is applied unmerged, two skinny products per
  target (`torch.bmm`; the reference computes them in XLA, not in a
  Pallas kernel). The base products go through `qdot_many`, grouped as
  the block groups them (one `int8_proj` launch for wq, wk, wv), so an
  int8 base composes.

Under CUDA graphs the pack's tensors and the per-row ids are static
inputs: the pack never moves, and the ids are state tensors the host
refills before a replay (`SlotState.aid`, a lane's `aid`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubeflow_tpu_torch.serving.quant import qdot_many
from kubeflow_tpu_torch.train.lora import _TARGET_DIMS, LoraConfig

Params = dict


@dataclasses.dataclass(frozen=True)
class AdapterPack:
    """K named adapters stacked per target: A [L, K+1, d_in, r], B [L,
    K+1, r, d_out]; id 0 is the reserved zero adapter ("")."""

    blocks: Params
    scaling: float
    names: dict          # adapter name -> pack index (1-based)

    def resolve(self, name: str) -> int:
        """'' or None -> the zero adapter; unknown names raise."""
        if not name:
            return 0
        try:
            return self.names[name]
        except KeyError:
            raise ValueError(
                f"unknown adapter {name!r}; loaded: "
                f"{sorted(self.names)}") from None

    def layer(self, li: int) -> Params:
        """Layer li's slice of the pack (views): {target: {"A": [K+1,
        d_in, r], "B": [K+1, r, d_out]}}."""
        return {t: {"A": ab["A"][li], "B": ab["B"][li]}
                for t, ab in self.blocks.items()}

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for ab in self.blocks.values() for x in ab.values())


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def build_pack(cfg, lora_cfg: LoraConfig, adapters: dict,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cpu") -> AdapterPack:
    """Stack adapter trees in the reference's layout ({"blocks": {name:
    {"A": [L, d_in, r], "B": [L, r, d_out]}}}, numpy arrays or tensors)
    into one pack on `device`, in `dtype` (default cfg.dtype). Every
    adapter must cover the same targets at the same rank (one gather
    index addresses one homogeneous tensor)."""
    if not adapters:
        raise ValueError("need at least one adapter")
    names = sorted(adapters)
    L = cfg.num_layers
    dt = dtype if dtype is not None else cfg.dtype
    blocks: Params = {}
    for t in lora_cfg.targets:
        d_in = getattr(cfg, _TARGET_DIMS[t][0])
        d_out = getattr(cfg, _TARGET_DIMS[t][1])
        a_stack = [np.zeros((L, d_in, lora_cfg.rank), np.float32)]
        b_stack = [np.zeros((L, lora_cfg.rank, d_out), np.float32)]
        for n in names:
            try:
                ab = adapters[n]["blocks"][t]
            except KeyError:
                raise ValueError(
                    f"adapter {n!r} missing target {t!r}") from None
            a, b = _np32(ab["A"]), _np32(ab["B"])
            if a.shape != a_stack[0].shape or b.shape != b_stack[0].shape:
                raise ValueError(
                    f"adapter {n!r} target {t!r}: shape "
                    f"{a.shape}/{b.shape} != expected "
                    f"{a_stack[0].shape}/{b_stack[0].shape} "
                    "(same rank/targets required across the pack)")
            a_stack.append(a)
            b_stack.append(b)
        # [K+1, L, ...] -> layer-leading [L, K+1, ...]
        blocks[t] = {
            "A": torch.from_numpy(np.ascontiguousarray(
                np.stack(a_stack, axis=1))).to(device=device, dtype=dt),
            "B": torch.from_numpy(np.ascontiguousarray(
                np.stack(b_stack, axis=1))).to(device=device, dtype=dt),
        }
    return AdapterPack(blocks=blocks, scaling=lora_cfg.scaling,
                       names={n: i + 1 for i, n in enumerate(names)})


def lora_proj(layer_pack: Params, ids: torch.Tensor, scaling: float, cfg):
    """The `proj` hook of `engine.transformer_block`: the base products
    of the weights that read one h, grouped through `qdot_many` (one
    `int8_proj` launch for int8 weights), then each target's low-rank
    delta per row. `layer_pack` is one layer's slice
    (`AdapterPack.layer`), `ids` [b] the rows' adapter ids. Targets
    without adapters keep the base product."""

    def proj(names, h: torch.Tensor, ws) -> list:
        out = []
        for name, y in zip(names, qdot_many(h, ws, cfg.dtype)):
            ab = layer_pack.get(name)
            if ab is not None:
                a = ab["A"][ids].to(cfg.dtype)      # [b, d_in, r]
                b = ab["B"][ids].to(cfg.dtype)      # [b, r, d_out]
                delta = torch.bmm(torch.bmm(h.to(cfg.dtype), a), b)
                y = y + torch.tensor(scaling, dtype=cfg.dtype) * delta
            out.append(y)
        return out

    return proj
