"""Weight-only int8 projection: the CUDA kernel's wrapper and its plain
PyTorch version.

`y = (h @ q) * scale` with bf16 activations h [..., K], int8 weights q
[K, N] (the reference's [in, out] layout) and a bf16 per-output-channel
scale [1, N]: the product `serving/quant.py::qdot` makes of a `QTensor`
leaf. It replaces no Pallas kernel. The reference gets "device memory
sees int8" from XLA, which fuses the int8 -> bf16 convert into the dot's
operand read (`kubeflow_tpu/serving/quant.py:77-94`); PyTorch does no
such fusion, so the card needs a kernel of its own for the module to do
what it is for. The kernel (csrc/int8_proj.cu) converts each weight tile
in registers and multiplies on the tensor cores (`mma.sync` bf16, fp32
accumulators), split over K where the output tiles alone would leave the
SMs idle, with a second, deterministic combine launch; the source note
gives its bound and design. One wrapper call is one count in
`launches`, though a split product makes two launches.

The plain version is the reference's right-hand form, `(h @ q.to(dt)) *
scale.to(dt)[..., 0, :]`: the CPU tests run it, and the card compares the
kernel with it. The kernel accumulates in fp32 and rounds once, after
the scale; the plain version rounds the product to bf16 and again after
the scale.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops.cuda import _build

# Calls that launched the CUDA kernel (tile and combine launches count as
# one; never the plain version).
launches = 0

# h, q, scale, y, ws; M, N, K, lda, splits; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
BLOCK_N = 128   # N must be a multiple of this
BLOCK_K = 64    # and K of this


def int8_proj_plain(h: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """(h @ q) * scale in h's dtype, the reference's `qdot` of a QTensor.
    Leading axes of q and scale broadcast as matmul broadcasts them."""
    dt = h.dtype
    return (h @ q.to(dt)) * scale.to(dt)[..., 0, :]


def _check(h, q, scale):
    if q.ndim != 2:
        raise ValueError(f"int8_proj takes one [K, N] weight, got q shape "
                         f"{tuple(q.shape)}")
    K, N = q.shape
    if h.shape[-1] != K:
        raise ValueError(f"int8_proj: h has {h.shape[-1]} features, q "
                         f"takes {K}")
    if tuple(scale.shape) != (1, N):
        raise ValueError(f"int8_proj: scale must be [1, {N}], got "
                         f"{tuple(scale.shape)}")
    return K, N


def _lib():
    # kft_int8_proj_splits(M, N, K): the split-K count of a product on
    # this card (a function of the shape and the SM count)
    return _build.load("int8_proj", _ARGTYPES,
                       {"kft_int8_proj_splits": [ctypes.c_int] * 3})


def int8_proj(h: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """y [..., N] = (h [..., K] @ q [K, N]) * scale [1, N].

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel or raises: it takes bf16 h whose flattened rows have unit
    stride along K and a row stride that is a multiple of 8, int8 q and
    bf16 scale, contiguous, with N a multiple of 128 and K of 64."""
    global launches
    K, N = _check(h, q, scale)
    if h.device.type == "cpu":
        return int8_proj_plain(h, q, scale)
    if h.dtype != torch.bfloat16:
        raise ValueError(f"int8_proj kernel takes bfloat16 activations, "
                         f"got {h.dtype}")
    if q.dtype != torch.int8:
        raise ValueError(f"int8_proj kernel takes int8 weights, got "
                         f"{q.dtype}")
    if scale.dtype != torch.bfloat16:
        raise ValueError(f"int8_proj kernel takes a bfloat16 scale, got "
                         f"{scale.dtype}")
    if N % BLOCK_N or K % BLOCK_K:
        raise ValueError(f"int8_proj kernel takes N a multiple of "
                         f"{BLOCK_N} and K of {BLOCK_K}, got N {N}, K {K}")
    for t in (q, scale):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError("int8_proj kernel inputs must be contiguous "
                             "tensors on one CUDA device")
    lead = h.shape[:-1]
    h2 = h.reshape(-1, K)
    M = h2.shape[0]
    if M == 0:
        return h.new_empty(*lead, N)
    lda = h2.stride(0) if M > 1 else K
    if h2.stride(1) != 1 or lda % 8 or lda < K:
        raise ValueError(
            f"int8_proj kernel takes rows with unit stride along K and a "
            f"row stride that is a multiple of 8, got strides "
            f"{tuple(h2.stride())}")
    for t in (h2, q):
        if t.data_ptr() % 16:
            raise ValueError("int8_proj kernel takes 16-byte aligned h "
                             "and q (it copies 16-byte vectors)")
    lib = _lib()
    splits = lib.kft_int8_proj_splits(M, N, K)
    y = torch.empty(M, N, dtype=torch.bfloat16, device=h.device)
    ws = (torch.empty(splits * M * N, dtype=torch.float32, device=h.device)
          if splits > 1 else None)
    err = lib.kft_int8_proj(
        h2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, M, N, K, lda, splits,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "int8_proj")
    launches += 1
    return y.reshape(*lead, N)
