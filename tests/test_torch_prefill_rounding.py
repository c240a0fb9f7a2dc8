"""The bf16 paged prefill-append kernel's rounding, emulated in plain
PyTorch on the CPU, against the Pallas kernel in interpret mode and the
bound the card holds the kernel to.

The tensor-core kernel (csrc/paged_prefill_append.cu,
`prefill_attention_tc_kernel`) takes bf16 q, new K/V and pools, scatters
the valid new cells, and attends in 64-row tiles of (token, group
member) query rows per kv head: S = Q K^T accumulated in fp32 over
64-cell chunks from the window's first chunk to the tile's last valid
query's cell, an online softmax, and P rounded to bf16 before O += P V
(fp32 accumulation); l sums the unrounded P, and the result is rounded
to bf16 once. `emulate_prefill_tc` walks the same tiles and chunks and
rounds at the same points. Against the Pallas kernel's fp32 result on
the same (bf16-valued) inputs it must meet the flash kernels' bf16
bound, |err| <= 1e-4 max|ref| + 2**-7 |ref| + 2**-8 mag, with mag =
|P| |V| from `prefill_bf16_slack`; without the 2**-8 mag term it
exceeds the bound, and a plain version that leaves each query's own
cell out exceeds it too. Only valid tokens (t < q_lens) are compared.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas.prefill_append import (
    paged_prefill_append as pallas_prefill,
)
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.cuda import prefill_append as tprefill
from torch_cases import flash_err_ratio, mk_prefill, prefill_dropped_diagonal

TILE = 64                      # query rows of a tile, cells of a chunk
C, RTOL = 1e-4, 2**-7          # the bf16 bound's first two terms
NEG_INF = -2.0**30             # the kernel's initial row max

# name: (starts, lens, window, shared first block, kv_mask hole at cell
# 5 below every row's start); s 40 x group 2 = 80 query rows, 2 tiles
CASES = {
    "ragged_lens": ([0, 70, 150], [40, 25, 0], None, False, False),
    "window_37": ([0, 70, 150], [40, 25, 33], 37, False, False),
    "cow_shared_prefix": ([40, 50, 100], [40, 40, 17], None, True, False),
    "kv_mask_hole": ([20, 90, 140], [40, 31, 40], None, False, True),
    "gemma_heads_ragged_lens": ([0, 70, 150], [40, 25, 0], None, False,
                                False),
    "gemma_heads_window_hole": ([20, 90, 140], [40, 31, 40], 37, False,
                                True),
}
# (n_q, n_kv, hd) of a case: 4 query heads over 2 kv heads of 128, or
# gemma-2b's 8 over one of 256 (s 40 x group 8 = 320 rows, 5 tiles of 8
# tokens, each row of Q, K and V two 128-column halves in the kernel)
HEADS = {name: (8, 1, 256) for name in CASES if name.startswith("gemma")}


def _bf16(x):
    return x.bfloat16().float()


@functools.lru_cache(maxsize=None)
def _case(name):
    """bf16 inputs (as fp32 arrays), the Pallas kernel's fp32 output,
    and the bound's magnitudes."""
    starts, lens, window, shared, hole = CASES[name]
    n_q, n_kv, hd = HEADS.get(name, (4, 2, 128))
    arrays = mk_prefill(21, b=3, s=40, n_q=n_q, n_kv=n_kv, hd=hd, bs=16,
                        nb=12, num_blocks=48, starts=starts, lens=lens,
                        shared=shared)
    q, kn, vn, kp, vp = (_bf16(torch.from_numpy(a)).numpy()
                         for a in arrays[:5])
    table, starts, lens = arrays[5:]
    mask = np.ones((3, 12 * 16), bool)
    if hole:
        mask[starts > 5, 5] = False
    args = (q, kn, vn, kp, vp, table, starts, lens, mask)
    want, _, _ = pallas_prefill(*(jnp.asarray(a) for a in args),
                                window=window, interpret=True)
    t = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    mag = tprefill.prefill_bf16_slack(*t, window=window)
    return t, window, torch.from_numpy(np.array(want)), mag


def emulate_prefill_tc(q, k_new, v_new, k_pool, v_pool, table, starts,
                       lens, mask, window):
    """The bf16 tensor-core kernel's arithmetic (pools left as they
    are): the scatter, then per (row, kv head, 64-row tile) the online
    softmax over 64-cell chunks with P rounded to bf16 before P V."""
    b, s, n_q, hd = q.shape
    _, bs, n_kv, _ = k_pool.shape
    group = n_q // n_kv
    width = table.shape[1] * bs
    kp, vp = k_pool.float().clone(), v_pool.float().clone()
    for r in range(b):                        # launch 1: the scatter
        for t in range(int(lens[r])):
            c = int(starts[r]) + t
            kp[table[r, c // bs], c % bs] = k_new[r, t].float()
            vp[table[r, c // bs], c % bs] = v_new[r, t].float()
    out = torch.zeros(b, s, n_q, hd)
    for r in range(b):
        start, n = int(starts[r]), int(lens[r])
        kc = kp[table[r].long()].reshape(width, n_kv, hd)
        vc = vp[table[r].long()].reshape(width, n_kv, hd)
        for h in range(n_kv):
            for r0 in range(0, s * group, TILE):
                f = torch.arange(r0, min(r0 + TILE, s * group))
                t, g = f // group, f % group
                qt = q[r, t, h * group + g].float()
                qpos = start + t
                t_last = min(int(t[-1]), n - 1)
                hi = -1 if t_last < int(t[0]) \
                    else min(start + t_last, width - 1)
                lo = max(start + int(t[0]) - window + 1, 0) if window else 0
                m = torch.full((len(f),), NEG_INF)
                l = torch.zeros(len(f))
                acc = torch.zeros(len(f), hd)
                for c0 in range(lo // TILE * TILE, hi + 1, TILE):
                    idx = torch.arange(c0, min(c0 + TILE, hi + 1))
                    x = qt @ kc[idx, h].T * hd**-0.5
                    vis = (idx[None] <= torch.clamp(qpos, max=hi)[:, None]) \
                        & mask[r, idx][None]
                    if window:
                        vis &= (qpos[:, None] - idx[None]) < window
                    x = torch.where(vis, x, -torch.inf)
                    m_new = torch.maximum(m, x.amax(-1))
                    p = torch.exp(x - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + _bf16(p) @ vc[idx, h]
                    m = m_new
                out[r, t, h * group + g] = torch.where(
                    l[:, None] > 0, acc / l.clamp(min=1e-30)[:, None], 0.0)
    return out.to(q.dtype)


def _valid(x, lens):
    return torch.cat([x[r, :n] for r, n in enumerate(lens.tolist())])


def _ratio(got, want, mag, lens):
    return flash_err_ratio(_valid(got, lens), _valid(want, lens), C, RTOL,
                           None if mag is None else _valid(mag, lens))


@pytest.mark.parametrize("case", list(CASES))
def test_tc_rounding_meets_bf16_bound(case):
    args, window, want, mag = _case(case)
    lens = args[7]
    got = emulate_prefill_tc(*(a.bfloat16() if a.is_floating_point() else a
                               for a in args), window)
    assert got.dtype == torch.bfloat16
    assert _ratio(got, want, mag, lens) <= 1
    assert _ratio(got, want, None, lens) > 1   # the rounding needs mag


@pytest.mark.parametrize("case", list(CASES))
def test_dropped_diagonal_exceeds_bf16_bound(case):
    args, window, want, mag = _case(case)
    pools = tuple(p.clone() for p in args[3:5])
    with prefill_dropped_diagonal(tattn):
        bad, _, _ = tprefill.paged_prefill_append_plain(
            *args[:3], *pools, *args[5:], window=window)
    assert _ratio(bad, want, mag, args[7]) > 1


@pytest.mark.parametrize("case", list(CASES))
def test_slack_is_plain_attention_of_abs_v(case):
    """mag is the plain version with |V| (new cells and pools), in fp32,
    and leaves the pools it was given as they were."""
    args, window, _, mag = _case(case)
    q, kn, vn, kp, vp, *rest = args
    before = (kp.clone(), vp.clone())
    again = tprefill.prefill_bf16_slack(*args, window=window)
    assert torch.equal(kp, before[0]) and torch.equal(vp, before[1])
    want, _, _ = tprefill.paged_prefill_append_plain(
        q, kn, vn.abs(), kp.clone(), vp.abs(), *rest, window=window)
    assert again.dtype == torch.float32
    torch.testing.assert_close(again, want, atol=0, rtol=0)
    torch.testing.assert_close(mag, want, atol=0, rtol=0)
