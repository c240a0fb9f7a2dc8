"""Paged prefill-append attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel
`kubeflow_tpu/ops/pallas/prefill_append.py::paged_prefill_append`.
The kernel (csrc/paged_prefill_append.cu) is two launches on one
stream: a scatter of the valid new K/V cells into the pool, then a
paged causal attention with one CUDA block per (query tile, kv head,
row); the source note there gives its bound and design. The plain
version is the reference's scatter-then-gather (ops/attention.py).

Pools are updated IN PLACE on both paths. The plain version routes
padding tokens (t >= q_lens) to trash block 0, as the reference does;
the kernel writes nothing there, so compare pools with block 0
excluded.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops.cuda import _build
from kubeflow_tpu_torch.ops.cuda.paged_attention import (
    _DTYPES,
    _HEAD_DIMS,
    MAX_GROUP,
)

# Launches of the CUDA kernel pair (never of the plain version).
launches = 0
# q, k_new, v_new, k_pool, v_pool, table, q_start, q_lens, mask, out;
# b, s, nb, bs, n_kv, group, hd, window; scale; dtype; stream
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_prefill_append_plain(q, k_new, v_new, k_pool, v_pool,
                               block_table, q_start, q_lens, kv_mask=None,
                               *, window=None):
    """Plain PyTorch version: same arguments and result as the kernel."""
    from kubeflow_tpu_torch.ops.attention import paged_prefill_attention

    return paged_prefill_attention(q, k_new, v_new, k_pool, v_pool,
                                   block_table, q_start, q_lens,
                                   kv_mask=kv_mask, window=window,
                                   impl="torch")


def paged_prefill_append(q, k_new, v_new, k_pool, v_pool, block_table,
                         q_start, q_lens, kv_mask=None, *, window=None):
    """Append `q_lens[r]` new cells per row at `q_start[r]` and attend
    all s queries. q [b, s, n_q, hd]; k_new/v_new [b, s, n_kv, hd];
    pools [num_blocks, bs, n_kv, hd]; block_table [b, nb] int32;
    q_start/q_lens [b] int32; kv_mask [b, nb * bs] bool or None.
    Returns `(out, k_pool, v_pool)`. Precondition: q_start + q_lens <=
    nb * bs. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global launches
    b, s, n_q, hd = q.shape
    if tuple(k_new.shape) != tuple(v_new.shape) \
            or tuple(k_new.shape[:2]) != (b, s):
        raise ValueError(
            f"k_new/v_new must be [b={b}, s={s}, n_kv, hd], got "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"k_pool/v_pool shapes disagree: {tuple(k_pool.shape)} vs "
            f"{tuple(v_pool.shape)}")
    _, bs, n_kv, hd_kv = k_pool.shape
    if hd_kv != hd or tuple(k_new.shape[2:]) != (n_kv, hd):
        raise ValueError(
            f"head geometry mismatch: q {tuple(q.shape)}, k_new "
            f"{tuple(k_new.shape)}, pool {tuple(k_pool.shape)}")
    if n_q % n_kv:
        raise ValueError(f"{n_q} query heads not grouped by {n_kv} kv")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(
            f"block_table must be [b={b}, blocks_per_slot], got "
            f"{tuple(block_table.shape)}")
    if tuple(q_start.shape) != (b,) or tuple(q_lens.shape) != (b,):
        raise ValueError(
            f"q_start/q_lens must be [b={b}], got {tuple(q_start.shape)} "
            f"/ {tuple(q_lens.shape)}")
    nb = block_table.shape[1]
    if kv_mask is not None and tuple(kv_mask.shape) != (b, nb * bs):
        raise ValueError(
            f"kv_mask must be [b={b}, {nb * bs}], got "
            f"{tuple(kv_mask.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return paged_prefill_append_plain(
            q, k_new, v_new, k_pool, v_pool, block_table, q_start, q_lens,
            kv_mask, window=window)
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (k_new, v_new, k_pool, v_pool)):
        raise ValueError(
            f"kernel takes float32 or bfloat16 tensors of one dtype, got "
            f"q {q.dtype}, new {k_new.dtype}/{v_new.dtype}, pools "
            f"{k_pool.dtype}/{v_pool.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    group = n_q // n_kv
    if group > MAX_GROUP:
        raise ValueError(f"kernel takes a GQA group <= {MAX_GROUP}, "
                         f"got {group}")
    if any(t.dtype != torch.int32 for t in (block_table, q_start, q_lens)):
        raise ValueError("block_table, q_start and q_lens must be int32")
    if kv_mask is not None and kv_mask.dtype != torch.bool:
        raise ValueError(f"kv_mask must be bool, got {kv_mask.dtype}")
    tensors = [q, k_new, v_new, k_pool, v_pool, block_table, q_start,
               q_lens]
    if kv_mask is not None:
        tensors.append(kv_mask)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(
                "kernel inputs must be contiguous tensors on one CUDA "
                "device")
    out = torch.empty_like(q)
    lib = _build.load("paged_prefill_append", _ARGTYPES)
    err = lib.kft_paged_prefill_append(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        q_start.data_ptr(), q_lens.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), b, s, nb, bs, n_kv, group, hd, window or 0,
        hd**-0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_prefill_append")
    launches += 1
    return out, k_pool, v_pool
