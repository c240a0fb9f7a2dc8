"""Embedding lookup (counterpart: kubeflow_tpu/ops/embedding.py).

Only the gather path: the port runs on one card, where the reference
also gathers (its one-hot contraction serves sharded meshes).
"""

from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """tokens [..., s] int -> activations [..., s, embed] in `dtype`.
    Rows are gathered first and cast after, which gives the same values
    as the reference's cast-then-gather."""
    return table[tokens.long()].to(dtype)
