"""Weight-only int8 projection: the CUDA kernel's wrapper and its plain
PyTorch version.

`y = (h @ q) * scale` with bf16 activations h [..., K], int8 weights q
[K, N] (the reference's [in, out] layout) and a bf16 per-output-channel
scale [1, N]: the product `serving/quant.py::qdot` makes of a `QTensor`
leaf. It replaces no Pallas kernel. The reference gets "device memory
sees int8" from XLA, which fuses the int8 -> bf16 convert into the dot's
operand read (`kubeflow_tpu/serving/quant.py:77-94`); PyTorch does no
such fusion, so the card needs a kernel of its own for the module to do
what it is for.

`int8_proj_many(h, [(q, scale), ...])` computes up to three such
products of the same h in one launch (a layer's wq, wk, wv, and its
w_gate, w_up), each into its own tensor; `int8_proj` is one of them. The
kernel (csrc/int8_proj.cu) takes one of two paths, which `plan` reports:
at decode sizes (up to 16 rows) a streaming `mma.sync` read, above them
`wgmma` fed by a TMA ring, the weights converted to bf16 in registers on
both. Each splits K over a thread-block cluster where the output tiles
alone would leave the SMs idle and reduces the split inside the same
launch, in a fixed order, the same for a weight alone and in a group.
The source note gives its bound and design. One wrapper call is one
launch and one count in `launches`.

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

# Calls that launched the CUDA kernel (one launch each, grouped or not;
# never the plain version).
launches = 0

MAX_GROUP = 3   # weights one launch takes
# h, M, K, lda; (q, scale, y, N) for each of MAX_GROUP weights; force,
# stream
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3
             + ([ctypes.c_void_p] * 3 + [ctypes.c_int]) * MAX_GROUP
             + [ctypes.c_int, ctypes.c_void_p])
BLOCK_N = 128   # N must be a multiple of this
BLOCK_K = 64    # and K of this
PATHS = ("mma", "wgmma")


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
    # kft_int8_proj_plan(M, N, K): path * 256 + cluster size
    return _build.load("int8_proj", _ARGTYPES,
                       {"kft_int8_proj_plan": [ctypes.c_int] * 3})


def plan(M: int, N: int, K: int) -> tuple[str, int]:
    """(path, split) the kernel takes for h [M, K] @ q [K, N] on this
    card, alone or in a group: "mma" (M <= 16) or "wgmma" (M >= 17), and
    the blocks of a thread-block cluster that split K (1: no split). A
    function of the shape and the SM count alone."""
    code = _lib().kft_int8_proj_plan(M, N, K)
    if code == 0:
        raise ValueError(f"int8_proj takes no [{M} x {K}] @ [{K} x {N}]")
    return PATHS[code >> 8], code & 255


def int8_proj(h: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """y [..., N] = (h [..., K] @ q [K, N]) * scale [1, N].

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel or raises: it takes bf16 h whose flattened rows have unit
    stride along K and a row stride that is a multiple of 8, int8 q and
    bf16 scale, contiguous, with N a multiple of 128 and K of 64."""
    return int8_proj_many(h, [(q, scale)])[0]


def int8_proj_many(h: torch.Tensor, weights, *,
                   _force: str | None = None) -> list[torch.Tensor]:
    """[(h @ q) * scale for q, scale in weights]: up to three products of
    the same h, in one kernel launch on a CUDA tensor (the plain version
    of each on a CPU tensor). Each weight as `int8_proj` takes it; the
    outputs are separate tensors. `_force` ("mma" or "wgmma") overrides
    the path switch, so that the card tests hold either path to the
    plain version at any shape."""
    global launches
    weights = list(weights)
    if not 1 <= len(weights) <= MAX_GROUP:
        raise ValueError(f"int8_proj takes 1 to {MAX_GROUP} weights, got "
                         f"{len(weights)}")
    shapes = [_check(h, q, scale) for q, scale in weights]
    K = shapes[0][0]
    if h.device.type == "cpu":
        return [int8_proj_plain(h, q, scale) for q, scale in weights]
    if h.dtype != torch.bfloat16:
        raise ValueError(f"int8_proj kernel takes bfloat16 activations, "
                         f"got {h.dtype}")
    for q, scale in weights:
        if q.dtype != torch.int8:
            raise ValueError(f"int8_proj kernel takes int8 weights, got "
                             f"{q.dtype}")
        if scale.dtype != torch.bfloat16:
            raise ValueError(f"int8_proj kernel takes a bfloat16 scale, "
                             f"got {scale.dtype}")
        N = q.shape[1]
        if N % BLOCK_N or K % BLOCK_K:
            raise ValueError(f"int8_proj kernel takes N a multiple of "
                             f"{BLOCK_N} and K of {BLOCK_K}, got N {N}, "
                             f"K {K}")
        for t in (q, scale):
            if t.device != h.device or not t.is_contiguous():
                raise ValueError("int8_proj kernel inputs must be "
                                 "contiguous tensors on one CUDA device")
        if q.data_ptr() % 16:
            raise ValueError("int8_proj kernel takes 16-byte aligned h "
                             "and q (it copies 16-byte vectors)")
    Ns = [n for _, n in shapes]
    lead = h.shape[:-1]
    h2 = h.reshape(-1, K)
    M = h2.shape[0]
    if M == 0:
        return [h.new_empty(*lead, n) for n in Ns]
    lda = h2.stride(0) if M > 1 else K
    if h2.stride(1) != 1 or lda % 8 or lda < K:
        raise ValueError(
            f"int8_proj kernel takes rows with unit stride along K and a "
            f"row stride that is a multiple of 8, got strides "
            f"{tuple(h2.stride())}")
    if h2.data_ptr() % 16:
        raise ValueError("int8_proj kernel takes 16-byte aligned h and q "
                         "(it copies 16-byte vectors)")
    force = -1 if _force is None else PATHS.index(_force)
    lib = _lib()
    ys = [torch.empty(M, n, dtype=torch.bfloat16, device=h.device)
          for n in Ns]
    slots = []
    for g in range(MAX_GROUP):
        if g < len(weights):
            q, scale = weights[g]
            slots += [q.data_ptr(), scale.data_ptr(), ys[g].data_ptr(),
                      Ns[g]]
        else:
            slots += [None, None, None, 0]
    err = lib.kft_int8_proj(
        h2.data_ptr(), M, K, lda, *slots, force,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "int8_proj")
    launches += 1
    return [y.reshape(*lead, n) for y, n in zip(ys, Ns)]
