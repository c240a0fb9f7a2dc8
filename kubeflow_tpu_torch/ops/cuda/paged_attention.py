"""Paged decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel
`kubeflow_tpu/ops/pallas/paged_attention.py::paged_decode_attention`.
The kernel (csrc/paged_decode_attention.cu) splits each row's cells
across CUDA blocks of `split_cells` cells (`default_split_cells`: 128
at llama3-1b's heads, 64 at gemma-2b's), one per (kv head, row,
split), each looping over its share of the row's live cells only, and
merges their partial softmax sums in a second launch; the source note
there gives its bound (device-memory bytes) and what its design does
about it. One wrapper call is one count in `launches`, though it makes
the two launches. The plain version gathers the row's full window
through its table and attends it (ops/attention.py) — what the CPU
tests run and what the card compares the kernel with.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops.cuda import _build

# Calls that launched the CUDA kernel (split and combine count as one;
# never the plain version).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (128, 256)  # llama, gemma-2b (gemma-tiny's 32: CPU only)
MAX_GROUP = 16
CHUNK = 64          # split sizes are multiples of this
# q, k_pool, v_pool, table, pos, mask, out, scratch; b, nb, bs, n_kv,
# group, hd, window; scale; split_cells, dtype; stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def default_split_cells(group: int, hd: int) -> int:
    """Cells per block of the split launch, from the head geometry alone
    (graph-safe: no cursor is read). A split block's work per cell is
    its GQA group's rows times the head dim: 128 cells while that is at
    most 2 x 128 (llama3-1b), else 64, which halves the longest block's
    serial chunk chain and doubles the blocks in flight. On an H100
    (chip_smoke.py phase 2; PERF.md): llama3-1b 0.0159 ms at 128
    against 0.0181 at 64; gemma-2b (group 8, hd 256, one kv head)
    0.0226 ms at 64 against 0.0369 at 128."""
    return 128 if group * hd <= 256 else CHUNK


def split_count(width: int, split_cells: int) -> int:
    """Blocks the kernel gives each (kv head, row): from the shapes
    alone, so the launch reads no cursor on the host."""
    return -(-width // split_cells)


def paged_decode_attention_plain(q, k_pool, v_pool, block_table,
                                 q_positions, kv_mask=None, *,
                                 window=None) -> torch.Tensor:
    """Plain PyTorch version: same arguments and result as the kernel."""
    from kubeflow_tpu_torch.ops.attention import paged_attention

    b = q.shape[0]
    width = block_table.shape[1] * k_pool.shape[1]
    kv_positions = torch.arange(width, dtype=torch.int32,
                                device=q.device).expand(b, width)
    return paged_attention(q, k_pool, v_pool, block_table,
                           q_positions[:, None], kv_positions, causal=True,
                           kv_mask=kv_mask, window=window, impl="torch")


def _check(q, k_pool, v_pool, block_table, q_positions, kv_mask, window):
    b, sq, n_q, hd = q.shape
    if sq != 1:
        raise ValueError(f"paged_decode_attention is s=1 only, got sq={sq}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"k_pool/v_pool shapes disagree: {tuple(k_pool.shape)} vs "
            f"{tuple(v_pool.shape)}")
    _, bs, n_kv, hd_kv = k_pool.shape
    if hd_kv != hd:
        raise ValueError(f"head dim mismatch: q has {hd}, pool has {hd_kv}")
    if n_q % n_kv:
        raise ValueError(f"{n_q} query heads not grouped by {n_kv} kv")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(
            f"block_table must be [b={b}, blocks_per_slot], got "
            f"{tuple(block_table.shape)}")
    if tuple(q_positions.shape) != (b,):
        raise ValueError(
            f"q_positions must be [b={b}], got {tuple(q_positions.shape)}")
    width = block_table.shape[1] * bs
    if kv_mask is not None and tuple(kv_mask.shape) != (b, width):
        raise ValueError(
            f"kv_mask must be [b={b}, {width}], got "
            f"{tuple(kv_mask.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return b, n_q, hd, bs, n_kv, width


def paged_decode_attention(q, k_pool, v_pool, block_table, q_positions,
                           kv_mask=None, *, window=None,
                           split_cells=None) -> torch.Tensor:
    """One query token per row against its paged cells.

    q [b, 1, n_q, hd]; pools [num_blocks, bs, n_kv, hd]; block_table
    [b, blocks_per_slot] int32; q_positions [b] int32 (each row's
    cursor); kv_mask [b, blocks_per_slot * bs] bool or None;
    split_cells: cells per block of the kernel's split launch, a
    multiple of 64 (None: `default_split_cells`; the plain version has
    no split). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global launches
    b, n_q, hd, bs, n_kv, width = _check(q, k_pool, v_pool, block_table,
                                         q_positions, kv_mask, window)
    group = n_q // n_kv
    if split_cells is None:
        split_cells = default_split_cells(group, hd)
    if split_cells < CHUNK or split_cells % CHUNK:
        raise ValueError(f"split_cells must be a positive multiple of "
                         f"{CHUNK}, got {split_cells}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_table, q_positions, kv_mask,
            window=window)
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(
            f"kernel takes float32 or bfloat16 q and pools of one dtype, "
            f"got q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    if group > MAX_GROUP:
        raise ValueError(f"kernel takes a GQA group <= {MAX_GROUP}, "
                         f"got {group}")
    if block_table.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise ValueError("block_table and q_positions must be int32")
    if kv_mask is not None and kv_mask.dtype != torch.bool:
        raise ValueError(f"kv_mask must be bool, got {kv_mask.dtype}")
    tensors = [q, k_pool, v_pool, block_table, q_positions]
    if kv_mask is not None:
        tensors.append(kv_mask)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(
                "kernel inputs must be contiguous tensors on one CUDA "
                "device")
    out = torch.empty_like(q)
    # each split's partial accumulator [hd] and its (m, l), fp32
    scratch = torch.empty(
        b * n_q * split_count(width, split_cells) * (hd + 2),
        dtype=torch.float32, device=q.device)
    lib = _build.load("paged_decode_attention", _ARGTYPES)
    err = lib.kft_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), q_positions.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), scratch.data_ptr(), b, block_table.shape[1], bs,
        n_kv, group, hd, window or 0, hd**-0.5, split_cells,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_decode_attention")
    launches += 1
    return out
