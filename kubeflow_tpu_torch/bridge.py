"""Weight bridge between the reference's parameter tree and the port's.

The reference (`kubeflow_tpu/models/llama.py::init`) and the port lay
parameters out the same way (stacked `[L, ...]` block leaves under
"blocks"), so the bridge only moves arrays and sets dtypes. It takes
the tree with every leaf already converted to a numpy array (the
caller does `jax.tree.map(np.asarray, params)`), so this module needs
no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import MATRICES, LlamaConfig, leaf_dtype


def from_jax(params: dict, cfg: LlamaConfig,
             device: torch.device | str,
             dtype: torch.dtype | None = None) -> dict:
    """numpy param tree -> torch params on `device`. Block matrices go
    to `dtype` (default: cfg.dtype, the dtype the reference casts them
    to at every use), every other leaf to fp32."""

    def conv(name, arr):
        want = leaf_dtype(cfg, name)
        if dtype is not None and name in MATRICES:
            want = dtype
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=want)

    out = {k: conv(k, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: conv(k, v) for k, v in params["blocks"].items()}
    return out


def to_numpy(params: dict) -> dict:
    """torch param tree -> the same nested dict of fp32 numpy arrays
    (the inverse of `from_jax`, for comparing trained params with the
    reference's)."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy()
            for k, v in params.items()}
