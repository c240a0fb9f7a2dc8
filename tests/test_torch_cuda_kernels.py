"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without an NVIDIA
card: a CUDA kernel has no CPU mode. This file imports no JAX, so the
card machine runs it with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures JAX for the CPU tests).

Tolerance: fp32 atol = rtol = 1e-5 (online softmax vs single-pass
softmax); bf16 atol 1e-4 + rtol 2**-7: the kernel and the plain version
both accumulate in fp32 and round the result once, so they differ by at
most one bf16 ulp of it (<= 2**-7 of its value), and the absolute floor
covers fp32 summation order near zero. Pools are copied, not computed:
exact, block 0 excluded (the plain version routes padding tokens there,
the kernel writes nothing).

Flash kernels (forward o and lse, dQ, dK/dV) hold |err| <= c * max|ref|
+ rtol * |ref|: sums over up to 2 * s terms in another order than the
plain version's err by a small multiple of fp32 epsilon times the size
of the terms, which max|ref| bounds (c = 1e-5 fp32, 1e-4 bf16); bf16
results are rounded once by both, so they may differ by one bf16 ulp
(rtol 2**-7); fp32 rtol 1e-4. lse is fp32 in both cases: 1e-5 * max.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from kubeflow_tpu_torch.ops.cuda.prefill_append import (
    paged_prefill_append,
    paged_prefill_append_plain,
)
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.cuda import flash_attention as tflash
from torch_cases import mk_decode, mk_prefill


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


DTYPES = [(torch.float32, (1e-5, 1e-5)), (torch.bfloat16, (1e-4, 2**-7))]
# bs 8: several blocks per 64-cell chunk; bs 64: one chunk per block
GEOMETRY = [dict(bs=8, nb=6), dict(bs=64, nb=3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("geom", GEOMETRY)
@pytest.mark.parametrize("window,masked", [(None, True), (13, True),
                                           (None, False)])
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                             geom, window, masked):
    q, kp, vp, table, pos, mask = (_t(a).to(cuda_device) for a in mk_decode(
        3, b=5, n_q=16, n_kv=8, hd=128, pos=[3, 7, 8, 33, 47], **geom))
    q, kp, vp = (a.to(dtype) for a in (q, kp, vp))
    mask = mask if masked else None
    want = paged_decode_attention_plain(q, kp, vp, table, pos, mask,
                                        window=window)
    got = paged_decode_attention(q, kp, vp, table, pos, mask,
                                 window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("geom", GEOMETRY)
@pytest.mark.parametrize("window", [None, 13])
def test_prefill_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                              geom, window):
    q, kn, vn, kp, vp, table, starts, lens = (
        _t(a).to(cuda_device) for a in mk_prefill(
            4, b=4, s=6, n_q=16, n_kv=8, hd=128, lens=[6, 3, 1, 0],
            **geom))
    q, kn, vn, kp, vp = (a.to(dtype) for a in (q, kn, vn, kp, vp))
    wo, wk, wv = paged_prefill_append_plain(
        q, kn, vn, kp.clone(), vp.clone(), table, starts, lens,
        window=window)
    go, gk, gv = paged_prefill_append(q, kn, vn, kp.clone(), vp.clone(),
                                      table, starts, lens, window=window)
    torch.cuda.synchronize()
    for i, n in enumerate(lens.tolist()):
        torch.testing.assert_close(go[i, :n].float(), wo[i, :n].float(),
                                   atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(gk[1:], wk[1:], atol=0, rtol=0)
    torch.testing.assert_close(gv[1:], wv[1:], atol=0, rtol=0)


FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-4, 2**-7)}


def _flash_close(got, want, c, rtol):
    got, want = got.float(), want.float()
    bound = c * want.abs().max() + rtol * want.abs()
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= bound).all()), \
        float(((got - want).abs() / bound).max())


# (b, s, n_q, n_kv, causal, window): small odd and llama3-1b shapes
FLASH_SHAPES = [(1, 200, 4, 2, True, None), (1, 200, 4, 2, True, 37),
                (1, 131, 4, 4, False, None), (2, 2048, 16, 8, True, None),
                (2, 2048, 16, 8, True, 700), (2, 1000, 16, 8, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,n_q,n_kv,causal,window", FLASH_SHAPES)
def test_flash_kernels_match_plain_on_card(cuda_device, dtype, b, s, n_q,
                                           n_kv, causal, window):
    gen = torch.Generator().manual_seed(s + n_q)
    q, do = (torch.randn(b, s, n_q, 128, generator=gen).to(cuda_device,
                                                            dtype)
             for _ in range(2))
    k, v = (torch.randn(b, s, n_kv, 128, generator=gen).to(cuda_device,
                                                           dtype)
            for _ in range(2))
    c, rtol = FLASH_TOL[dtype]
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_block_fwd(q, k, v, **kw)
    wo, wlse = tflash.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _flash_close(o, wo, c, rtol)
    _flash_close(lse, wlse, 1e-5, 0.0)
    delta = tflash.flash_delta(wo, do)
    args = (q, k, v, do, wlse, delta)
    _flash_close(tflash.flash_dq(*args, **kw),
                 tflash.flash_dq_plain(*args, **kw), c, rtol)
    for got, want in zip(tflash.flash_dkv(*args, **kw),
                         tflash.flash_dkv_plain(*args, **kw)):
        _flash_close(got, want, c, rtol)


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(cuda_device):
    """The autograd Function launches one forward, one dQ and one dK/dV
    kernel, and its gradients match autograd through the plain path."""
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 1024, n, 128, generator=gen).to(cuda_device)
               .requires_grad_(True) for n in (4, 2, 2))
    pos = torch.arange(1024, device=cuda_device).expand(1, 1024)
    reset_launch_counts()
    o = tattn.dot_product_attention(q, k, v, pos, pos,
                                    contiguous_positions=True)
    grads = torch.autograd.grad((o * o).sum(), (q, k, v))
    counts = launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_dq"],
            counts["flash_attention_dkv"]) == (1, 1, 1)
    wo = tattn.dot_product_attention(q, k, v, pos, pos, impl="torch")
    want = torch.autograd.grad((wo * wo).sum(), (q, k, v))
    _flash_close(o.detach(), wo.detach(), *FLASH_TOL[torch.float32])
    for g, w in zip(grads, want):
        _flash_close(g, w, *FLASH_TOL[torch.float32])


def test_flash_impl_raises_on_cpu_tensors():
    q = torch.zeros(1, 1024, 4, 128)
    k = torch.zeros(1, 1024, 2, 128)
    pos = torch.arange(1024).expand(1, 1024)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn.dot_product_attention(q, k, k, pos, pos, impl="flash",
                                    contiguous_positions=True)
