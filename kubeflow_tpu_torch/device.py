"""Device resolution: CUDA unless the caller asks for the CPU.

There is no silent fallback. Asking for CUDA on a machine without it
raises, so a run that was meant for the card can never quietly measure
PyTorch's CPU kernels instead.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card. Raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
