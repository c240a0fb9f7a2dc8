"""Normalization ops (counterpart: kubeflow_tpu/ops/norms.py): RMSNorm
for the language models, LayerNorm for ViT."""

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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (mean-centred, population variance) in fp32, cast back
    to the input dtype. ViT style: the weight multiplies and the bias
    adds, so ones/zeros init is identity."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
