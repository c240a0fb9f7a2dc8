"""Normalization ops (counterpart: kubeflow_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to the input dtype. Llama
    convention of a (1 + w) scale, so zero-init weights are identity."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)
