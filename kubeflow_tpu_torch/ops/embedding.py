"""Embedding lookup (counterpart: kubeflow_tpu/ops/embedding.py).

On one device, a gather. Under tensor parallelism (parallel/tensor.py)
each rank holds a block of the vocab: it gathers the rows of the tokens
inside its block, zeroes the rest, and the psum over the axis gives
every rank the whole lookup. That is the reference's sharded path,
where a one-hot contraction against the vocab-sharded table lets XLA
insert the same all-reduce.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.parallel import comm, tensor


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """tokens [..., s] int -> activations [..., s, embed] in `dtype`.
    Rows are gathered first and cast after, which gives the same values
    as the reference's cast-then-gather. Under tensor parallelism
    `table` is this rank's vocab block; the sum over the ranks runs in
    the table's dtype, where one rank's row meets zeros: exact."""
    g = tensor.group()
    if g is None:
        return table[tokens.long()].to(dtype)
    n = table.shape[0]
    local = tokens.long() - tensor.vocab_start(n)
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], table[local.clamp(0, n - 1)], 0.0)
    return comm.psum(rows, g).to(dtype)
