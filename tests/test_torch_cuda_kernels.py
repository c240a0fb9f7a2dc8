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
