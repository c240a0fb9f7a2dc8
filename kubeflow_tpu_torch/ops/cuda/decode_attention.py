"""Dense-cache decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel
`kubeflow_tpu/ops/pallas/decode_attention.py::decode_attention`: one
query token per row against that row's cells of a dense KV cache
`[b, max_len, n_kv, hd]`, causal by cell index against the row's
cursor, with per-cell validity (left-pad holes) and an optional sliding
window. The kernel (csrc/decode_attention.cu) shares the paged decode
kernel's split-KV launches (csrc/decode_split.cuh): one CUDA block per
(kv head, row, split of `split_cells` cells), each looping over its
share of the row's live cells, skipping a split the kv_mask hides
entirely (left-pad), then a combine launch; the source note there gives
its bound (device-memory bytes) and design. One wrapper call is one
count in `launches`, though it makes the two launches. The plain
version is the reference oracle's `_torch_attention` over
`kv_positions = arange(max_len)` (ops/attention.py) — what the CPU
tests run and what the card compares the kernel with.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops.cuda import _build
from kubeflow_tpu_torch.ops.cuda.paged_attention import (
    _DTYPES,
    _HEAD_DIMS,
    CHUNK,
    MAX_GROUP,
    split_count,
)

# Calls that launched the CUDA kernel (split and combine count as one;
# never the plain version).
launches = 0

# q, k, v, pos, mask, out, scratch; b, max_len, n_kv, group, hd, window;
# scale; split_cells, dtype; stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# Cells per block of the split launch. 64 was faster than 128 on an
# H100 at every one-shot shape measured (llama3-8b's window batch, whose
# left-pad runs it skips at a finer grain, the draft's batch 1, whose
# grid it widens, and gemma-2b's window batch and batch 1, one kv head
# of 256 for 8 query heads); see PERF.md.
SPLIT_CELLS = 64


def decode_attention_plain(q, k, v, q_positions, kv_mask=None, *,
                           window=None) -> torch.Tensor:
    """Plain PyTorch version: same arguments and result as the kernel,
    except that a row with no visible cell gives mean(V) here (finite
    NEG_INF softmaxes to uniform) where the kernel gives 0."""
    from kubeflow_tpu_torch.ops.attention import _torch_attention

    b, max_len = k.shape[0], k.shape[1]
    kv_positions = torch.arange(max_len, dtype=torch.int32,
                                device=q.device).expand(b, max_len)
    return _torch_attention(q, k, v, q_positions[:, None].to(torch.int32),
                            kv_positions, causal=True, kv_mask=kv_mask,
                            window=window)


def _check(q, k, v, q_positions, kv_mask, window):
    b, sq, n_q, hd = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention is s=1 only, got sq={sq}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes disagree: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if k.ndim != 4 or k.shape[0] != b:
        raise ValueError(f"k/v must be [b={b}, max_len, n_kv, hd], got "
                         f"{tuple(k.shape)}")
    _, max_len, n_kv, hd_kv = k.shape
    if hd_kv != hd:
        raise ValueError(f"head dim mismatch: q has {hd}, cache has {hd_kv}")
    if n_q % n_kv:
        raise ValueError(f"{n_q} query heads not grouped by {n_kv} kv")
    if tuple(q_positions.shape) != (b,):
        raise ValueError(
            f"q_positions must be [b={b}], got {tuple(q_positions.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, max_len):
        raise ValueError(f"kv_mask must be [b={b}, {max_len}], got "
                         f"{tuple(kv_mask.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return b, n_q, hd, max_len, n_kv


def decode_attention(q, k, v, q_positions, kv_mask=None, *,
                     window=None, split_cells=SPLIT_CELLS) -> torch.Tensor:
    """One query token per row against its dense cache prefix.

    q [b, 1, n_q, hd]; k, v [b, max_len, n_kv, hd]; q_positions [b]
    int32 (each row's cursor); kv_mask [b, max_len] bool or None;
    split_cells: cells per block of the kernel's split launch, a
    multiple of 64 (the plain version has no split). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    global launches
    b, n_q, hd, max_len, n_kv = _check(q, k, v, q_positions, kv_mask,
                                       window)
    if split_cells < CHUNK or split_cells % CHUNK:
        raise ValueError(f"split_cells must be a positive multiple of "
                         f"{CHUNK}, got {split_cells}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_positions, kv_mask,
                                      window=window)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"kernel takes float32 or bfloat16 q and a cache of the same "
            f"dtype, got q {q.dtype}, cache {k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    group = n_q // n_kv
    if group > MAX_GROUP:
        raise ValueError(f"kernel takes a GQA group <= {MAX_GROUP}, "
                         f"got {group}")
    if q_positions.dtype != torch.int32:
        raise ValueError(f"q_positions must be int32, got "
                         f"{q_positions.dtype}")
    if kv_mask is not None and kv_mask.dtype != torch.bool:
        raise ValueError(f"kv_mask must be bool, got {kv_mask.dtype}")
    tensors = [q, k, v, q_positions]
    if kv_mask is not None:
        tensors.append(kv_mask)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(
                "kernel inputs must be contiguous tensors on one CUDA "
                "device")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k and v must be 16-byte aligned "
                             "(the kernel copies 16-byte vectors)")
    out = torch.empty_like(q)
    # each split's partial accumulator [hd] and its (m, l), fp32
    scratch = torch.empty(
        b * n_q * split_count(max_len, split_cells) * (hd + 2),
        dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention", _ARGTYPES)
    err = lib.kft_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), scratch.data_ptr(), b, max_len, n_kv, group, hd,
        window or 0, hd**-0.5, split_cells, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    launches += 1
    return out
