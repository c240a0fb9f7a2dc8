"""Attention: plain PyTorch paths + dispatch to the CUDA kernels
(counterpart: kubeflow_tpu/ops/attention.py).

`dot_product_attention` is grouped-query attention; its plain path is
the reference's `_xla_attention`: fp32 logits, finite `NEG_INF` masking,
KV heads never repeated. `paged_attention` (one decode token per row)
and `paged_prefill_attention` (append s tokens per row, then attend)
work on the paged KV pool `[num_blocks, block_size, n_kv, hd]` through
per-row block tables.

Paged paths, impl = "auto" | "torch" | "cuda":
- "auto": the CUDA kernel for a CUDA tensor, the plain version for a
  CPU tensor (the kernel wrappers decide by the tensor's device);
- "torch": the plain version, on whatever device the tensors are on;
- "cuda": the kernel; raises for a CPU tensor.

`dot_product_attention`, impl = "auto" | "torch" | "flash" | "decode":
"auto" (`auto_impl`) takes, for CUDA tensors and under exactly the
reference's conditions, the flash kernels (ops/cuda/flash_attention.py)
for long equal-length causal sequences with no kv_mask and positions
declared contiguous, else the dense decode kernel
(ops/cuda/decode_attention.py) for one query token against a cache of
at least 256 cells, causal, positions declared contiguous (kv_mask
allowed); everything else takes the plain path. "flash" and "decode"
raise for CPU tensors. `impl_counts()` counts the calls that took each
(the reference counts traced call sites; PyTorch has no trace, so here
every call counts; a CUDA graph's replay adds what its capture
counted).

Fully masked rows: a row with no visible cell gets mean(V) from the
plain path (finite NEG_INF softmaxes to uniform) but zeros from the
kernels (their online softmax keeps l == 0 and writes 0, as the Pallas
kernels do). Serving never produces such a row: a row's own new cell is
always visible.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0**30  # large-but-finite: avoids NaNs from (-inf) - (-inf)

IMPLS = ("auto", "torch", "cuda")
DENSE_IMPLS = ("auto", "torch", "flash", "decode")
# cache cells from which a single-token step takes the decode kernel
DECODE_MIN_CELLS = 256

# Calls of `dot_product_attention` per impl taken: how a run proves that
# training routed through the flash kernels, and one-shot decode through
# the decode kernel, instead of the plain path.
_impl_counts = {"flash": 0, "decode": 0, "torch": 0}


def reset_impl_counts() -> None:
    for key in _impl_counts:
        _impl_counts[key] = 0


def impl_counts() -> dict[str, int]:
    return dict(_impl_counts)


def add_impl_counts(delta: dict[str, int]) -> None:
    """Add `delta` to the counts: the calls a CUDA graph replay made
    without running this module (serving/graphs.py)."""
    for key, n in delta.items():
        _impl_counts[key] += n


def _check_impl(impl: str, device: torch.device) -> str:
    if impl not in IMPLS:
        raise ValueError(
            f"attention impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got tensors on {device}")
    return impl


def auto_impl(device_type: str, sq: int, skv: int, *, causal: bool,
              has_kv_mask: bool, contiguous_positions: bool) -> str:
    """The "auto" choice of `dot_product_attention`: the reference's rule
    (kubeflow_tpu/ops/attention.py), with "on a TPU" read as "on a CUDA
    tensor". Flash first: a long equal-length causal batch with no
    kv_mask and contiguous positions. Then decode: one query token
    against >= DECODE_MIN_CELLS cells, causal, contiguous positions
    (the kernel masks by cell index); a kv_mask is allowed."""
    if device_type != "cuda":
        return "torch"
    if (sq >= 1024 and sq % 512 == 0 and sq == skv and causal
            and not has_kv_mask and contiguous_positions):
        return "flash"
    if sq == 1 and skv >= DECODE_MIN_CELLS and causal \
            and contiguous_positions:
        return "decode"
    return "torch"


def dot_product_attention(
    q: torch.Tensor,             # [b, sq, n_q, hd]
    k: torch.Tensor,             # [b, skv, n_kv, hd]
    v: torch.Tensor,             # [b, skv, n_kv, hd]
    q_positions: torch.Tensor,   # [b, sq]
    kv_positions: torch.Tensor,  # [b, skv]
    *,
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,  # [b, skv] bool, False = invalid
    window: int | None = None,
    impl: str = "auto",
    contiguous_positions: bool = False,
) -> torch.Tensor:
    """Grouped-query attention. `window` limits each query to its last
    `window` positions (requires causal). The flash kernels mask by
    row/column index, so they need the caller's declaration that
    positions are 0..s-1 in every row (`contiguous_positions=True`);
    packed sequences with position resets must take the plain path,
    which masks by the position tensors."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if impl not in DENSE_IMPLS:
        raise ValueError(
            f"attention impl must be one of {DENSE_IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = auto_impl(q.device.type, q.shape[1], k.shape[1],
                         causal=causal, has_kv_mask=kv_mask is not None,
                         contiguous_positions=contiguous_positions)
    if impl == "decode":
        if q.shape[1] != 1:
            raise ValueError("impl='decode' is for single-token steps "
                             f"(s=1), got s={q.shape[1]}")
        if not contiguous_positions:
            raise ValueError(
                "impl='decode' masks by cache cell index: the caller "
                "must declare cell index == token position "
                "(contiguous_positions=True); packed/rotated caches "
                "must use impl='torch'")
        if not causal:
            raise ValueError("impl='decode' is causal-only")
        if q.device.type != "cuda":
            raise ValueError(
                f"impl='decode' needs CUDA tensors, got tensors on "
                f"{q.device}; use impl='torch'")
        from kubeflow_tpu_torch.ops.cuda.decode_attention import (
            decode_attention,
        )

        _impl_counts["decode"] += 1
        cursor = q_positions[:, 0].to(torch.int32).contiguous()
        return decode_attention(q, k, v, cursor, kv_mask, window=window)
    if impl == "flash":
        if q.device.type != "cuda":
            raise ValueError(
                f"impl='flash' needs CUDA tensors, got tensors on "
                f"{q.device}; use impl='torch'")
        if kv_mask is not None or not contiguous_positions:
            raise ValueError(
                "impl='flash' masks by row/col index only: it supports "
                "neither kv_mask nor non-contiguous positions (pass "
                "contiguous_positions=True for plain causal batches, or "
                "use impl='torch')")
        from kubeflow_tpu_torch.ops.cuda.flash_attention import (
            flash_attention,
        )

        _impl_counts["flash"] += 1
        return flash_attention(q, k, v, causal=causal, window=window)
    _impl_counts["torch"] += 1
    return _torch_attention(q, k, v, q_positions, kv_positions,
                            causal=causal, kv_mask=kv_mask, window=window)


def _torch_attention(q, k, v, q_positions, kv_positions, *, causal,
                     kv_mask, window):
    """The plain path: the reference's `_xla_attention`."""
    b, sq, n_q, hd = q.shape
    n_kv = k.shape[2]
    if n_q % n_kv:
        raise ValueError(f"{n_q} query heads not grouped by {n_kv} kv")
    group = n_q // n_kv
    qg = q.reshape(b, sq, n_kv, group, hd)
    logits = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          k.float()) * hd**-0.5
    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool,
                      device=q.device)
    qp = q_positions[:, :, None]
    kp = kv_positions[:, None, :]
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    if kv_mask is not None:
        mask &= kv_mask[:, None, :]
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, v.float())
    return out.reshape(b, sq, n_q, hd).to(q.dtype)


def _gather_window(pool: torch.Tensor, block_table: torch.Tensor
                   ) -> torch.Tensor:
    """[num_blocks, bs, n_kv, hd] through [b, nb] -> [b, nb*bs, n_kv, hd]."""
    b, nb = block_table.shape
    return pool[block_table.long()].reshape(b, nb * pool.shape[1],
                                            *pool.shape[2:])


def paged_attention(
    q: torch.Tensor,             # [b, 1, n_q, hd] — one decode step
    k_pool: torch.Tensor,        # [num_blocks, block_size, n_kv, hd]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # [b, blocks_per_slot] int32
    q_positions: torch.Tensor,   # [b, 1]
    kv_positions: torch.Tensor,  # [b, blocks_per_slot * block_size]
    *,
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,
    window: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention against the paged KV pool. The plain path
    gathers each row's full window through its table and runs
    `dot_product_attention`; the kernel (ops/cuda/paged_attention.py)
    walks the table itself and reads only live blocks. Cell index ==
    token position is a precondition of the kernel path."""
    b = q.shape[0]
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(
            f"block_table must be [b={b}, blocks_per_slot], got "
            f"{tuple(block_table.shape)}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"k_pool/v_pool shapes disagree: {tuple(k_pool.shape)} vs "
            f"{tuple(v_pool.shape)}")
    width = block_table.shape[1] * k_pool.shape[1]
    if tuple(kv_positions.shape) != (b, width):
        raise ValueError(
            f"kv_positions shape {tuple(kv_positions.shape)} does not "
            f"match blocks_per_slot * block_size = {width}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, width):
        raise ValueError(
            f"kv_mask shape {tuple(kv_mask.shape)} does not match "
            f"blocks_per_slot * block_size = {width}")
    impl = _check_impl(impl, q.device)
    if impl != "torch":
        if not causal:
            raise ValueError("the paged decode kernel is causal-only; "
                             "use impl='torch'")
        from kubeflow_tpu_torch.ops.cuda.paged_attention import (
            paged_decode_attention,
        )

        return paged_decode_attention(
            q, k_pool, v_pool, block_table, q_positions[:, 0], kv_mask,
            window=window)
    k = _gather_window(k_pool, block_table)
    v = _gather_window(v_pool, block_table)
    return _torch_attention(q, k, v, q_positions, kv_positions,
                            causal=causal, kv_mask=kv_mask, window=window)


def paged_prefill_attention(
    q: torch.Tensor,             # [b, s, n_q, hd] — s new tokens per row
    k_new: torch.Tensor,         # [b, s, n_kv, hd]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,        # [num_blocks, block_size, n_kv, hd]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # [b, blocks_per_slot] int32
    q_start: torch.Tensor,       # [b] int32 — append cursor per row
    q_lens: torch.Tensor | None = None,  # [b] int32 — valid new tokens
    *,
    kv_mask: torch.Tensor | None = None,
    window: int | None = None,
    impl: str = "auto",
):
    """Append s new tokens per row into the paged pool and attend them
    against everything written so far. Returns `(out, k_pool, v_pool)`
    with the pools updated IN PLACE on every path.

    Row r's token t lands at logical cell `q_start[r] + t` (physical:
    through the row's table) and attends causally by cell index. Tokens
    with `t >= q_lens[r]` are group padding: the plain path routes their
    K/V to trash block 0 (the reference's convention), the kernel writes
    nothing for them; their outputs are garbage the caller discards.
    Precondition: `q_start + q_lens <= blocks_per_slot * block_size`
    (the reference clamps positions to the window's last cell; a valid
    token past it would be silently misplaced there)."""
    b, s = q.shape[:2]
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"k_pool/v_pool shapes disagree: {tuple(k_pool.shape)} vs "
            f"{tuple(v_pool.shape)}")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(
            f"block_table must be [b={b}, blocks_per_slot], got "
            f"{tuple(block_table.shape)}")
    block_size = k_pool.shape[1]
    width = block_table.shape[1] * block_size
    if q_lens is None:
        q_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if kv_mask is not None and tuple(kv_mask.shape) != (b, width):
        raise ValueError(
            f"kv_mask shape {tuple(kv_mask.shape)} does not match "
            f"blocks_per_slot * block_size = {width}")
    impl = _check_impl(impl, q.device)
    if impl != "torch":
        from kubeflow_tpu_torch.ops.cuda.prefill_append import (
            paged_prefill_append,
        )

        return paged_prefill_append(
            q, k_new, v_new, k_pool, v_pool, block_table, q_start,
            q_lens, kv_mask, window=window)
    if q.device.type == "cpu" and bool((q_start + q_lens > width).any()):
        raise ValueError(
            f"append past the window: q_start + q_lens exceeds "
            f"blocks_per_slot * block_size = {width}")
    ar = torch.arange(s, dtype=torch.int32, device=q.device)
    pos = q_start[:, None].to(torch.int32) + ar[None, :]
    valid = ar[None, :] < q_lens[:, None]
    safe = torch.clamp(pos, max=width - 1)
    blk = torch.gather(block_table, 1, (safe // block_size).long())
    blk = torch.where(valid, blk, torch.zeros_like(blk)).long()
    off = (safe % block_size).long()
    k_pool[blk, off] = k_new.to(k_pool.dtype)
    v_pool[blk, off] = v_new.to(v_pool.dtype)
    k = _gather_window(k_pool, block_table)
    v = _gather_window(v_pool, block_table)
    kv_positions = torch.arange(width, dtype=torch.int32,
                                device=q.device).expand(b, width)
    out = _torch_attention(q, k, v, pos, kv_positions, causal=True,
                           kv_mask=kv_mask, window=window)
    return out, k_pool, v_pool
