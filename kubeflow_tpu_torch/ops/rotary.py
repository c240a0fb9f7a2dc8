"""Rotary position embeddings (counterpart: kubeflow_tpu/ops/rotary.py).

Same pairs-split (first half / second half) convention and the same
constant signed permutation for rotate_half, so the arithmetic matches
the reference element for element.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 500000.0,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] in fp32. Llama-3 uses
    theta=500000."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor,          # [batch, seq, heads, head_dim]
               positions: torch.Tensor,  # [batch, seq] int
               inv_freq: torch.Tensor,   # [head_dim // 2]
               ) -> torch.Tensor:
    """fp32 sin/cos, result cast back to x.dtype."""
    hd = x.shape[-1]
    hd2 = hd // 2
    idx = torch.arange(hd, device=x.device)
    angles = positions[..., None].float() * inv_freq[idx % hd2]  # [b, s, hd]
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    xf = x.float()
    sign = torch.where(idx < hd2, -1.0, 1.0).to(torch.float32)
    rotated_half = xf[..., (idx + hd2) % hd] * sign
    return (xf * cos + rotated_half * sin).to(x.dtype)
