"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without an NVIDIA
card: a CUDA kernel has no CPU mode. This file imports no JAX, so the
card machine runs it with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures JAX for the CPU tests).

Tolerance (paged and dense decode, fp32 prefill): fp32 atol = rtol =
1e-5 (online softmax vs single-pass softmax); bf16 atol 1e-4 + rtol
2**-7: the kernel and the plain version both accumulate in fp32 and
round the result once, so they differ by at most one bf16 ulp of it
(<= 2**-7 of its value), and the absolute floor covers fp32 summation
order near zero. The bf16 prefill kernel runs on the tensor cores and
rounds P to bf16 before P V, so it holds the flash kernels' bf16 bound
below, with mag = |P| |V| (`prefill_bf16_slack`); a plain version that
leaves each query's own cell out must exceed it. Pools are copied, not
computed: exact, block 0 excluded (the plain version routes padding
tokens there, the kernel writes nothing).

Flash kernels (forward o and lse, dQ, dK/dV) hold |err| <= c * max|ref|
+ rtol * |ref|: sums over up to 2 * s terms in another order than the
plain version's err by a small multiple of fp32 epsilon times the size
of the terms, which max|ref| bounds (c = 1e-5 fp32, 1e-4 bf16); bf16
results are rounded once by both, so they may differ by one bf16 ulp
(rtol 2**-7); fp32 rtol 1e-4. lse is fp32 in both cases: 1e-5 * max.
The bf16 forward, dQ and dK/dV kernels run on the tensor cores and
round P, dS, P^T and dS^T to bf16 before their products; each rounded
term errs by at most 2**-8 of itself, so their bf16 bound adds 2**-8 *
mag, the sum of the product's absolute terms (`flash_bf16_slack`). A
plain version that leaves each query's own key out must exceed that
bound, and the fp32 bound at head dims 128 and 256. The fp32 forward
runs 128 query rows a block as two warpgroups of 64 with their own
key-tile ranges: its edge cases (a last block of one row, an empty
second warpgroup, windows that end inside a block, GQA groups 1 to 8)
hold the fp32 bound at both head dims.

Every kernel is held at llama's heads (hd 128) and at gemma-2b's (8
query heads over one kv head of 256; the fp32 CUDA-core kernels at 256
too); both dK/dV kernels with their head-subgroup split off, forced and
as the shapes pick it, and a sum of the split's partials with one left
out must exceed the fp32 bound; one card test holds the refusals: the
flash wrappers in fp32 and in bf16 at hd 64, every serving wrapper at
gemma-tiny's hd 32.

The paged and dense decode kernels split each row's cells across
blocks of `split_cells` cells (a block whose cells the kv_mask hides
entirely reads no K/V) and merge them in a second launch; their edge
cases (a cursor on the last cell, a cursor inside the first split, a
window that empties the leading splits, a kv_mask that blanks a whole
split, a left-pad run over the leading splits, several pool blocks per
split) hold the same tolerance.
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
    prefill_bf16_slack,
)
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.cuda import flash_attention as tflash
from kubeflow_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from torch_cases import (
    dropped_diagonal,
    flash_err_ratio,
    mk_decode,
    mk_dense,
    mk_prefill,
    prefill_dropped_diagonal,
)


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
# (n_q, n_kv, hd): llama3-1b's heads, and gemma-2b's (one kv head for 8
# query heads, head dim 256)
HEADS = [(16, 8, 128), (8, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("geom", GEOMETRY)
@pytest.mark.parametrize("window,masked", [(None, True), (13, True),
                                           (None, False)])
@pytest.mark.parametrize("n_q,n_kv,hd", HEADS)
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                             geom, window, masked, n_q,
                                             n_kv, hd):
    q, kp, vp, table, pos, mask = (_t(a).to(cuda_device) for a in mk_decode(
        3, b=5, n_q=n_q, n_kv=n_kv, hd=hd, pos=[3, 7, 8, 33, 47], **geom))
    q, kp, vp = (a.to(dtype) for a in (q, kp, vp))
    mask = mask if masked else None
    want = paged_decode_attention_plain(q, kp, vp, table, pos, mask,
                                        window=window)
    got = paged_decode_attention(q, kp, vp, table, pos, mask,
                                 window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


# name: (bs, nb, cursors, window, masked cell range); width 320 = 2.5
# splits of 128 cells, 5 of 64
SPLIT_CASES = {
    "cursor_on_last_cell": (64, 5, [319, 100, 0], None, None),
    "cursor_in_first_split": (64, 5, [5, 63, 127], None, None),
    "window_empties_leading_splits": (64, 5, [300, 319, 200], 13, None),
    "mask_blanks_a_split": (64, 5, [300, 200, 319], None, (128, 256)),
    "bs8_splits_span_blocks": (8, 40, [319, 130, 64], None, None),
    "left_pad_blanks_leading_splits": (64, 5, [319, 300, 200], None,
                                       (0, 150)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("split_cells", [64, 128])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("n_q,n_kv,hd", HEADS)
def test_decode_kernel_split_edges_on_card(cuda_device, dtype, tol,
                                           split_cells, case, n_q, n_kv,
                                           hd):
    bs, nb, pos, window, blank = SPLIT_CASES[case]
    q, kp, vp, table, pos, mask = (_t(a).to(cuda_device) for a in mk_decode(
        9, b=3, n_q=n_q, n_kv=n_kv, hd=hd, bs=bs, nb=nb,
        num_blocks=3 * nb + 2, pos=pos))
    q, kp, vp = (a.to(dtype) for a in (q, kp, vp))
    if blank is not None:
        mask[:, blank[0]:blank[1]] = False
    want = paged_decode_attention_plain(q, kp, vp, table, pos, mask,
                                        window=window)
    got = paged_decode_attention(q, kp, vp, table, pos, mask, window=window,
                                 split_cells=split_cells)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


def _prefill_close(got, want, lens, dtype, tol, mag):
    """Valid tokens only: fp32 within atol/rtol; bf16 (tensor cores, P
    rounded to bf16) within the flash kernels' bf16 bound with mag."""
    got, want = (torch.cat([x[i, :n] for i, n in enumerate(lens.tolist())])
                 for x in (got, want))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=tol[0], rtol=tol[1])
    else:
        mag = torch.cat([mag[i, :n] for i, n in enumerate(lens.tolist())])
        _flash_close(got, want, *FLASH_TOL[torch.bfloat16], mag)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("geom", GEOMETRY)
@pytest.mark.parametrize("window", [None, 13])
@pytest.mark.parametrize("n_q,n_kv,hd", HEADS)
def test_prefill_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                              geom, window, n_q, n_kv, hd):
    q, kn, vn, kp, vp, table, starts, lens = (
        _t(a).to(cuda_device) for a in mk_prefill(
            4, b=4, s=6, n_q=n_q, n_kv=n_kv, hd=hd, lens=[6, 3, 1, 0],
            **geom))
    q, kn, vn, kp, vp = (a.to(dtype) for a in (q, kn, vn, kp, vp))
    mag = prefill_bf16_slack(q, kn, vn, kp, vp, table, starts, lens,
                             window=window)
    wo, wk, wv = paged_prefill_append_plain(
        q, kn, vn, kp.clone(), vp.clone(), table, starts, lens,
        window=window)
    go, gk, gv = paged_prefill_append(q, kn, vn, kp.clone(), vp.clone(),
                                      table, starts, lens, window=window)
    torch.cuda.synchronize()
    _prefill_close(go, wo, lens, dtype, tol, mag)
    torch.testing.assert_close(gk[1:], wk[1:], atol=0, rtol=0)
    torch.testing.assert_close(gv[1:], wv[1:], atol=0, rtol=0)


# (s, n_q, n_kv, hd, bs, nb, starts, lens, window, hole): the serving
# path's slice (s 64, llama3-1b's group 2: two 64-row tiles per kv head)
# at a 300-token prompt's cursors, a group of 4 (llama3-8b), 16-cell
# blocks under 64-cell chunks, a window, a kv_mask hole, ragged lens with
# 0; then gemma-2b's head dim 256 and group 8 (a 64-row tile is 8
# tokens, a 64-token slice 8 tiles), its slice at the same cursors, two
# kv heads of group 8, and 16-cell blocks with a window and a hole
PREFILL_TC_CASES = [
    (64, 16, 8, 128, 64, 8, [0, 64, 256], [64, 64, 44], None, False),
    (64, 32, 8, 128, 64, 8, [128, 300, 0], [64, 20, 0], None, True),
    (40, 16, 8, 128, 16, 24, [0, 70, 150], [40, 25, 33], 37, False),
    (64, 16, 8, 128, 16, 32, [200, 7, 400], [64, 64, 50], None, True),
    (64, 8, 1, 256, 64, 8, [0, 64, 256], [64, 64, 44], None, False),
    (64, 16, 2, 256, 64, 8, [128, 300, 0], [64, 20, 0], None, True),
    (40, 8, 1, 256, 16, 24, [0, 70, 150], [40, 25, 33], 37, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,n_q,n_kv,hd,bs,nb,starts,lens,window,hole",
                         PREFILL_TC_CASES)
def test_prefill_tiles_match_plain_on_card(cuda_device, dtype, tol, s, n_q,
                                           n_kv, hd, bs, nb, starts, lens,
                                           window, hole):
    q, kn, vn, kp, vp, table, starts, lens = (
        _t(a).to(cuda_device) for a in mk_prefill(
            8, b=3, s=s, n_q=n_q, n_kv=n_kv, hd=hd, bs=bs, nb=nb,
            num_blocks=3 * nb + 2, starts=starts, lens=lens))
    q, kn, vn, kp, vp = (a.to(dtype) for a in (q, kn, vn, kp, vp))
    mask = None
    if hole:
        mask = torch.ones(3, nb * bs, dtype=torch.bool, device=cuda_device)
        mask[starts > 5, 5] = False
    mag = prefill_bf16_slack(q, kn, vn, kp, vp, table, starts, lens, mask,
                             window=window)
    wo, wk, wv = paged_prefill_append_plain(
        q, kn, vn, kp.clone(), vp.clone(), table, starts, lens, mask,
        window=window)
    go, gk, gv = paged_prefill_append(q, kn, vn, kp.clone(), vp.clone(),
                                      table, starts, lens, mask,
                                      window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(go.float()).all()
    _prefill_close(go, wo, lens, dtype, tol, mag)
    torch.testing.assert_close(gk[1:], wk[1:], atol=0, rtol=0)
    torch.testing.assert_close(gv[1:], wv[1:], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_kv,hd", HEADS)
def test_prefill_bf16_bound_sees_a_dropped_diagonal_on_card(cuda_device,
                                                            n_q, n_kv, hd):
    """At the serving path's bf16 slice shape, a plain prefill that
    leaves out each query's own cell exceeds the bound the kernel
    meets."""
    q, kn, vn, kp, vp, table, starts, lens = (
        _t(a).to(cuda_device) for a in mk_prefill(
            9, b=1, s=64, n_q=n_q, n_kv=n_kv, hd=hd, bs=64, nb=8,
            num_blocks=12, starts=[256], lens=[44]))
    q, kn, vn, kp, vp = (a.to(torch.bfloat16) for a in (q, kn, vn, kp, vp))
    mag = prefill_bf16_slack(q, kn, vn, kp, vp, table, starts, lens)
    wo, _, _ = paged_prefill_append_plain(q, kn, vn, kp.clone(), vp.clone(),
                                          table, starts, lens)
    go, _, _ = paged_prefill_append(q, kn, vn, kp.clone(), vp.clone(), table,
                                    starts, lens)
    with prefill_dropped_diagonal(tattn):
        bad, _, _ = paged_prefill_append_plain(
            q, kn, vn, kp.clone(), vp.clone(), table, starts, lens)
    torch.cuda.synchronize()
    c, rtol = FLASH_TOL[torch.bfloat16]
    n = int(lens[0])
    assert flash_err_ratio(go[0, :n], wo[0, :n], c, rtol, mag[0, :n]) <= 1
    assert flash_err_ratio(bad[0, :n], wo[0, :n], c, rtol, mag[0, :n]) > 1


# (b, max_len, n_q, n_kv, hd, cursors, holes, window): llama3-8b's group
# 4 and llama3-1b's group 2; a max_len that is no multiple of the 64-cell
# chunk; cursors 0, 63, 64, 255, 256 and the last cell; left-pad runs of
# a different length per row below a shared cursor (the window batch);
# a window; the speculative draft's batch 1; then gemma-2b's heads
# (group 8, head dim 256): the window batch, ragged cursors with a
# window, and batch 1
DENSE_CASES = [
    (6, 300, 32, 8, 128, [0, 63, 64, 255, 256, 299], None, None),
    (4, 1024, 32, 8, 128, [540, 540, 540, 540],
     {0: (0, 495), 1: (0, 17), 2: (0, 300), 3: (0, 1)}, None),
    (4, 1024, 16, 8, 128, [300, 700, 1000, 1023], None, 256),
    (1, 1024, 16, 8, 128, [300], None, None),
    (4, 1024, 8, 1, 256, [540, 540, 540, 540],
     {0: (0, 495), 1: (0, 17), 2: (0, 300), 3: (0, 1)}, None),
    (6, 300, 8, 1, 256, [0, 63, 64, 255, 256, 299], None, 100),
    (1, 1024, 8, 1, 256, [300], None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,max_len,n_q,n_kv,hd,pos,holes,window",
                         DENSE_CASES)
def test_dense_decode_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                   b, max_len, n_q, n_kv,
                                                   hd, pos, holes, window):
    q, k, v, pos, mask = (_t(a).to(cuda_device) for a in mk_dense(
        6, b=b, max_len=max_len, n_q=n_q, n_kv=n_kv, hd=hd, pos=pos,
        holes=holes))
    q, k, v = (a.to(dtype) for a in (q, k, v))
    for m in (mask, None):
        want = decode_attention_plain(q, k, v, pos, m, window=window)
        got = decode_attention(q, k, v, pos, m, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                                   rtol=tol[1])


# name: (max_len, cursors, window, masked cell ranges by row): 3 splits
# of 128 cells, 6 of 64; the window batch's left-pad runs below a shared
# cursor (pad-only splits), a cursor on the last cell and in the first
# split, a window that empties the leading splits, a kv_mask that blanks
# a whole split below the cursor
DENSE_SPLIT_CASES = {
    "window_batch_left_pad": (384, [271] * 4,
                              None, {0: (0, 239), 1: (0, 156), 2: (0, 56)}),
    "cursor_on_last_cell": (384, [383, 100, 0], None, {}),
    "cursor_in_first_split": (384, [5, 63, 127], None, {}),
    "window_empties_leading_splits": (384, [300, 383, 200], 13, {}),
    "mask_blanks_a_split": (384, [300, 200, 383], None,
                            {r: (128, 256) for r in range(3)}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("split_cells", [64, 128])
@pytest.mark.parametrize("case", list(DENSE_SPLIT_CASES))
@pytest.mark.parametrize("n_q,n_kv,hd", [(32, 8, 128), (8, 1, 256)])
def test_dense_decode_split_edges_on_card(cuda_device, dtype, tol,
                                          split_cells, case, n_q, n_kv, hd):
    max_len, pos, window, holes = DENSE_SPLIT_CASES[case]
    q, k, v, pos, mask = (_t(a).to(cuda_device) for a in mk_dense(
        10, b=len(pos), max_len=max_len, n_q=n_q, n_kv=n_kv, hd=hd,
        pos=pos, holes=holes))
    q, k, v = (a.to(dtype) for a in (q, k, v))
    want = decode_attention_plain(q, k, v, pos, mask, window=window)
    got = decode_attention(q, k, v, pos, mask, window=window,
                           split_cells=split_cells)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.cuda
def test_decode_door_launches_the_kernel_on_card(cuda_device):
    """impl="auto" takes the kernel for a single-token causal step over
    >= 256 cells with contiguous positions, and the plain path for 255."""
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    for max_len, want in ((256, 1), (255, 0)):
        q, k, v, pos, mask = (_t(a).to(cuda_device) for a in mk_dense(
            7, b=2, max_len=max_len, n_q=8, n_kv=2, hd=128, pos=[10, 200]))
        kv_pos = torch.arange(max_len, device=cuda_device).expand(2, max_len)
        reset_launch_counts()
        tattn.dot_product_attention(q, k, v, pos[:, None], kv_pos,
                                    kv_mask=mask, contiguous_positions=True)
        assert launch_counts()["decode_attention"] == want


@pytest.mark.cuda
def test_kernels_refuse_head_dims_they_lack_on_card(cuda_device):
    """Nothing falls back: the flash wrappers refuse head dim 64 in fp32
    and in bf16 (both take 128 and 256), naming dtype and head dim, and
    the serving wrappers refuse gemma-tiny's 32 (served on the CPU
    only)."""
    gen = torch.Generator().manual_seed(11)
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 64)):
        q, k, v, do = (torch.randn(1, 1024, n, hd, generator=gen)
                       .to(cuda_device, dtype) for n in (8, 1, 1, 8))
        msg = f"for {dtype}, got head_dim {hd}"
        with pytest.raises(ValueError, match=msg):
            tflash.flash_block_fwd(q, k, v, causal=True)
        # "auto" picks flash for a long mask-free causal pass: it raises
        pos = torch.arange(1024, device=cuda_device).expand(1, 1024)
        with pytest.raises(ValueError, match=msg):
            tattn.dot_product_attention(q, k, v, pos, pos,
                                        contiguous_positions=True)
        lse = torch.zeros(1, 8, 1024, device=cuda_device)
        args = (q, k, v, do, lse, lse)
        for fn in (tflash.flash_dq, tflash.flash_dkv):
            with pytest.raises(ValueError, match=msg):
                fn(*args)
    q, kp, vp, table, pos, mask = (_t(a).to(cuda_device) for a in mk_decode(
        12, n_q=4, n_kv=1, hd=32))
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q, kp, vp, table, pos, mask)
    q, k, v, pos, mask = (_t(a).to(cuda_device) for a in mk_dense(
        12, n_q=4, n_kv=1, hd=32))
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, v, pos, mask)
    q, kn, vn, kp, vp, table, starts, lens = (
        _t(a).to(cuda_device) for a in mk_prefill(12, n_q=4, n_kv=1, hd=32))
    with pytest.raises(ValueError, match="head_dim"):
        paged_prefill_append(q, kn, vn, kp, vp, table, starts, lens)


FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-4, 2**-7)}


def _flash_close(got, want, c, rtol, mag=None):
    assert torch.isfinite(got.float()).all()
    ratio = flash_err_ratio(got, want, c, rtol, mag)
    assert ratio <= 1, ratio


def _flash_inputs(device, dtype, b, s, n_q, n_kv, hd=128):
    gen = torch.Generator().manual_seed(s + n_q)
    q, do = (torch.randn(b, s, n_q, hd, generator=gen).to(device, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, s, n_kv, hd, generator=gen).to(device, dtype)
            for _ in range(2))
    return q, k, v, do


# (b, s, n_q, n_kv, causal, window): small odd and llama3-1b shapes, a
# llama3-8b-style group of 4 (the dK/dV group loop), s one past a tile
FLASH_SHAPES = [(1, 200, 4, 2, True, None), (1, 200, 4, 2, True, 37),
                (1, 131, 4, 4, False, None), (2, 2048, 16, 8, True, None),
                (2, 2048, 16, 8, True, 700), (2, 1000, 16, 8, True, None),
                (1, 1024, 32, 8, True, None), (1, 1025, 8, 2, True, None)]


def _forced_splits(n_q, n_kv):
    """A split the shapes would not pick: 2 subgroups where the group
    allows (1 otherwise)."""
    return 2 if (n_q // n_kv) % 2 == 0 else 1


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["off", "forced", "chosen"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,n_q,n_kv,causal,window", FLASH_SHAPES)
def test_flash_kernels_match_plain_on_card(cuda_device, dtype, b, s, n_q,
                                           n_kv, causal, window, split):
    """dK/dV with its head-subgroup split off (1), forced (2 where the
    group allows) and as the shapes pick it (None)."""
    head_splits = {"off": 1, "forced": _forced_splits(n_q, n_kv),
                   "chosen": None}[split]
    q, k, v, do = _flash_inputs(cuda_device, dtype, b, s, n_q, n_kv)
    c, rtol = FLASH_TOL[dtype]
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_block_fwd(q, k, v, **kw)
    wo, wlse = tflash.flash_fwd_plain(q, k, v, **kw)
    delta = tflash.flash_delta(wo, do)
    args = (q, k, v, do, wlse, delta)
    mags = [None] * 4
    if dtype == torch.bfloat16:
        mags = tflash.flash_bf16_slack(*args, **kw)
    torch.cuda.synchronize()
    _flash_close(o, wo, c, rtol, mags[0])
    _flash_close(lse, wlse, 1e-5, 0.0)
    _flash_close(tflash.flash_dq(*args, **kw),
                 tflash.flash_dq_plain(*args, **kw), c, rtol, mags[1])
    got = tflash.flash_dkv(*args, **kw, head_splits=head_splits)
    for g, want, mag in zip(got, tflash.flash_dkv_plain(*args, **kw),
                            mags[2:]):
        assert g.dtype == dtype
        _flash_close(g, want, c, rtol, mag)


# (b, s, n_q, n_kv, causal, window) at head dim 256, bf16: gemma-2b's
# heads (8 query heads over one KV head) with s off a tile multiple, a
# window, non-causal, and a group of 4 over two KV heads
FLASH_HD256_SHAPES = [(1, 200, 8, 1, True, None), (1, 200, 8, 1, True, 37),
                      (1, 131, 8, 1, False, None),
                      (1, 1025, 8, 2, True, None),
                      (2, 1024, 8, 1, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("head_splits", [1, 2, None])
@pytest.mark.parametrize("b,s,n_q,n_kv,causal,window", FLASH_HD256_SHAPES)
def test_flash_kernels_at_head_dim_256_match_plain_on_card(
        cuda_device, b, s, n_q, n_kv, causal, window, head_splits):
    """The bf16 kernels at head dim 256 within the bf16 bound; dK/dV with
    the head-subgroup split off (1), forced (2) and as the shapes pick
    it (None: 4 or 8 subgroups at these sizes)."""
    q, k, v, do = _flash_inputs(cuda_device, torch.bfloat16, b, s, n_q,
                                n_kv, hd=256)
    c, rtol = FLASH_TOL[torch.bfloat16]
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_block_fwd(q, k, v, **kw)
    wo, wlse = tflash.flash_fwd_plain(q, k, v, **kw)
    delta = tflash.flash_delta(wo, do)
    args = (q, k, v, do, wlse, delta)
    mags = tflash.flash_bf16_slack(*args, **kw)
    torch.cuda.synchronize()
    _flash_close(o, wo, c, rtol, mags[0])
    _flash_close(lse, wlse, 1e-5, 0.0)
    _flash_close(tflash.flash_dq(*args, **kw),
                 tflash.flash_dq_plain(*args, **kw), c, rtol, mags[1])
    got = tflash.flash_dkv(*args, **kw, head_splits=head_splits)
    for g, want, mag in zip(got, tflash.flash_dkv_plain(*args, **kw),
                            mags[2:]):
        assert g.dtype == torch.bfloat16
        _flash_close(g, want, c, rtol, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("head_splits", [1, 2, None])
@pytest.mark.parametrize("b,s,n_q,n_kv,causal,window", FLASH_HD256_SHAPES)
def test_fp32_flash_kernels_at_head_dim_256_match_plain_on_card(
        cuda_device, b, s, n_q, n_kv, causal, window, head_splits):
    """The fp32 CUDA-core kernels at head dim 256 (Q and dO resident in
    dQ, K and V in dK/dV, the other operands streamed in column chunks)
    within the fp32 bound; dK/dV with the head-subgroup split off (1),
    forced (2) and as the shapes pick it (None: 8 at these sizes)."""
    q, k, v, do = _flash_inputs(cuda_device, torch.float32, b, s, n_q,
                                n_kv, hd=256)
    c, rtol = FLASH_TOL[torch.float32]
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_block_fwd(q, k, v, **kw)
    wo, wlse = tflash.flash_fwd_plain(q, k, v, **kw)
    delta = tflash.flash_delta(wo, do)
    args = (q, k, v, do, wlse, delta)
    torch.cuda.synchronize()
    _flash_close(o, wo, c, rtol)
    _flash_close(lse, wlse, 1e-5, 0.0)
    _flash_close(tflash.flash_dq(*args, **kw),
                 tflash.flash_dq_plain(*args, **kw), c, rtol)
    for got, want in zip(tflash.flash_dkv(*args, **kw,
                                          head_splits=head_splits),
                         tflash.flash_dkv_plain(*args, **kw)):
        assert got.dtype == torch.float32
        _flash_close(got, want, c, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dkv_refuses_a_split_off_the_group_on_card(cuda_device,
                                                         dtype):
    """Nothing falls back: a query-head split that does not divide the
    group raises, in either dtype."""
    q, k, v, do = _flash_inputs(cuda_device, dtype, 1, 128, 8, 1, hd=256)
    lse = torch.zeros(1, 8, 128, device=cuda_device)
    for splits in (0, 3):
        with pytest.raises(ValueError, match="must divide the group 8"):
            tflash.flash_dkv(q, k, v, do, lse, lse, head_splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
def test_fp32_dkv_bound_sees_a_dropped_partial_on_card(cuda_device, hd):
    """The split's partials (plain) summed over every subgroup meet the
    fp32 bound against the group-summed plain dK and dV; left without
    one subgroup's partial they exceed it."""
    b, s, n_q, n_kv = 1, 1025, 8, 2
    q, k, v, do = _flash_inputs(cuda_device, torch.float32, b, s, n_q,
                                n_kv, hd=hd)
    c, rtol = FLASH_TOL[torch.float32]
    wo, wlse = tflash.flash_fwd_plain(q, k, v)
    args = (q, k, v, do, wlse, tflash.flash_delta(wo, do))
    splits = tflash.default_head_splits(b, s, n_q, n_kv, hd, torch.float32)
    assert splits == 4
    parts = tflash.flash_dkv_partials_plain(*args, splits)
    for part, want in zip(parts, tflash.flash_dkv_plain(*args)):
        assert flash_err_ratio(part.sum(3), want, c, rtol) <= 1
        assert flash_err_ratio(part[:, :, :, 1:].sum(3), want, c, rtol) > 1


@pytest.mark.cuda
def test_flash_bf16_bound_sees_a_dropped_diagonal_on_card(cuda_device):
    """At a causal bf16 shape, a plain forward, dQ and dK/dV that leave
    out each query's own key exceed the bound the kernels meet."""
    q, k, v, do = _flash_inputs(cuda_device, torch.bfloat16, 1, 1025, 8,
                                2)
    c, rtol = FLASH_TOL[torch.bfloat16]
    wo, wlse = tflash.flash_fwd_plain(q, k, v)
    args = (q, k, v, do, wlse, tflash.flash_delta(wo, do))
    o_mag, dq_mag, dk_mag, dv_mag = tflash.flash_bf16_slack(*args)
    wdq = tflash.flash_dq_plain(*args)
    wdk, wdv = tflash.flash_dkv_plain(*args)
    with dropped_diagonal(tflash):
        bad_o, _ = tflash.flash_fwd_plain(q, k, v)
        bad_dq = tflash.flash_dq_plain(*args)
        bad_dk, bad_dv = tflash.flash_dkv_plain(*args)
    assert flash_err_ratio(bad_o, wo, c, rtol, o_mag) > 1
    assert flash_err_ratio(bad_dq, wdq, c, rtol, dq_mag) > 1
    assert flash_err_ratio(bad_dk, wdk, c, rtol, dk_mag) > 1
    assert flash_err_ratio(bad_dv, wdv, c, rtol, dv_mag) > 1


# (b, s, n_q, n_kv, causal, window) at the fp32 forward's edges: its
# blocks are 128 query rows as two warpgroups of 64, so s 129 leaves one
# row in the last block and s 191 a partly full first warpgroup and an
# empty second; a window that ends inside a block gives the two
# warpgroups different key-tile ranges; GQA groups 1, 2, 4 and 8
FP32_FWD_EDGES = [(1, 129, 4, 2, True, None), (1, 129, 4, 2, False, None),
                  (2, 191, 4, 2, True, None), (1, 191, 4, 1, False, None),
                  (1, 300, 4, 2, True, 64), (1, 300, 4, 2, True, 65),
                  (1, 300, 4, 2, True, 127), (1, 320, 8, 8, True, None),
                  (1, 320, 8, 4, True, None), (1, 320, 8, 2, True, 100),
                  (1, 320, 8, 1, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("b,s,n_q,n_kv,causal,window", FP32_FWD_EDGES)
def test_fp32_flash_forward_edges_on_card(cuda_device, b, s, n_q, n_kv,
                                          causal, window, hd):
    """The fp32 forward's o and lse within the fp32 bound at the edges of
    its 128-row blocks, its warpgroups' key-tile ranges and the GQA
    group, at head dims 128 and 256; one launch a call."""
    q, k, v, _ = _flash_inputs(cuda_device, torch.float32, b, s, n_q, n_kv,
                               hd=hd)
    c, rtol = FLASH_TOL[torch.float32]
    kw = dict(causal=causal, window=window)
    before = tflash.fwd_launches
    o, lse = tflash.flash_block_fwd(q, k, v, **kw)
    assert tflash.fwd_launches == before + 1
    wo, wlse = tflash.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _flash_close(o, wo, c, rtol)
    _flash_close(lse, wlse, 1e-5, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
def test_flash_fp32_bound_sees_a_dropped_diagonal_on_card(cuda_device, hd):
    """At a causal fp32 shape, a plain forward, dQ and dK/dV that leave
    out each query's own key exceed the bound the fp32 kernels meet."""
    q, k, v, do = _flash_inputs(cuda_device, torch.float32, 1, 1025, 8, 2,
                                hd=hd)
    c, rtol = FLASH_TOL[torch.float32]
    wo, wlse = tflash.flash_fwd_plain(q, k, v)
    args = (q, k, v, do, wlse, tflash.flash_delta(wo, do))
    wdq = tflash.flash_dq_plain(*args)
    wdk, wdv = tflash.flash_dkv_plain(*args)
    with dropped_diagonal(tflash):
        bad_o, _ = tflash.flash_fwd_plain(q, k, v)
        bad_dq = tflash.flash_dq_plain(*args)
        bad_dk, bad_dv = tflash.flash_dkv_plain(*args)
    assert flash_err_ratio(bad_o, wo, c, rtol) > 1
    assert flash_err_ratio(bad_dq, wdq, c, rtol) > 1
    assert flash_err_ratio(bad_dk, wdk, c, rtol) > 1
    assert flash_err_ratio(bad_dv, wdv, c, rtol) > 1


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


def test_decode_impl_raises_on_cpu_tensors():
    q = torch.zeros(1, 1, 4, 128)
    k = torch.zeros(1, 256, 2, 128)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn.dot_product_attention(q, k, k, torch.zeros(1, 1),
                                    torch.arange(256)[None], impl="decode",
                                    contiguous_positions=True)


def test_flash_impl_raises_on_cpu_tensors():
    q = torch.zeros(1, 1024, 4, 128)
    k = torch.zeros(1, 1024, 2, 128)
    pos = torch.arange(1024).expand(1, 1024)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn.dot_product_attention(q, k, k, pos, pos, impl="flash",
                                    contiguous_positions=True)


# int8_proj: (K, N) of the seven block projections (wq, wk/wv, wo,
# w_gate/w_up, w_down; wq and wo share (D, q_dim) = (q_dim, D) at both
# llama widths) of llama3-1b and llama3-8b
INT8_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# rows: decode (1, 8), the mma.sync tiles' edges (16, 17), the spec
# verify (40), a slice (64), the path switch at 129 (127, 128, 129, 130),
# a prompt (300), eight slices (512), the 8 x 300 window prefill (2400)
INT8_MS = [1, 8, 16, 17, 40, 64, 127, 128, 129, 130, 300, 512, 513, 2400]
# the products of a layer that read the same h, grouped: (K, N of each)
INT8_GROUPS = {"llama3-1b": [(2048, (2048, 1024, 1024)), (2048, (8192, 8192))],
               "llama3-8b": [(4096, (4096, 1024, 1024)),
                             (4096, (14336, 14336))]}


def int8_case(M, K, N, device, seed=0):
    """Random bf16 h [M, K], int8 q [K, N] over the whole [-127, 127]
    range, bf16 scale [1, N] at quantize's size (amax / 127 of a fan-in
    scaled weight), and mag = (|h| @ |q|) * scale in fp32: the sum of the
    product's absolute terms. Drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    q = torch.randint(-127, 128, (K, N), generator=gen, device=device,
                      dtype=torch.int8)
    scale = (torch.rand(1, N, generator=gen, device=device) * 2 * K**-0.5
             / 127).to(torch.bfloat16)
    mag = int8_mag(h, q, scale)
    return h, q, scale, mag


def int8_mag(h, q, scale):
    return (h.float().abs() @ q.float().abs()) * scale.float()


def int8_err_ratio(got, want, mag):
    """max |got - want| / bound, bound = 1e-4 max|want| + 2^-7 |want| +
    2^-12 mag. No operand is rounded (int8 -> bf16 is exact): the kernel
    rounds its fp32 sum once, after the scale, the plain version rounds
    the bf16 product and then the scaled value, so the two land within
    one bf16 ulp, <= 2^-7 |want|; 2^-12 mag covers the fp32 sums' other
    orders."""
    got, want = got.float(), want.float()
    bound = 1e-4 * want.abs().max() + 2**-7 * want.abs() + 2**-12 * mag
    return float(((got - want).abs() / bound).max())


def int8_want(h, q, scale):
    """The plain version with cuBLAS held to fp32 reductions (no bf16
    split-K reduction), the reference the kernel is held to."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return ip.int8_proj_plain(h, q, scale)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _ranked_sum(h, q, step, ranks):
    """fp32 (h @ q) summed as the kernels sum it: K cut into `ranks`
    contiguous ranges of whole 64-wide stages (a cluster's blocks), each
    range accumulated in fp32 `step` columns of K at a time from zero,
    the ranges' partials then added in rank order."""
    K = q.shape[0]
    stages = K // 64
    per = -(-stages // ranks)
    total = None
    for r0 in range(0, stages, per):
        acc = torch.zeros(h.shape[0], q.shape[1])
        for k0 in range(r0 * 64, min(r0 + per, stages) * 64, step):
            acc = acc + h[:, k0:k0 + step].float() @ q[k0:k0 + step].float()
        total = acc if total is None else total + acc
    return total


def int8_plan(M, N, K, sms=132):
    """csrc/int8_proj.cu's `plan`: (path, split) of an [M x K] @ [K x N]
    product on a card of `sms` SMs. mma.sync (16-row tiles) up to 16
    rows, splitting K until about two blocks an SM have work; wgmma with
    64-row tiles up to 512 rows, splitting until about 0.7 blocks an SM
    do for each 256 rows; 256-row tiles above, split by M and K alone, at
    most 8 ways. A split is at least 4 stages of 64 and leaves none
    empty."""
    steps = K // 64

    def cdiv(a, b):
        return -(-a // b)

    def clamp(want, cap):
        s = max(min(want, steps // 4, cap), 1)
        return cdiv(steps, cdiv(steps, s))

    if M <= 16:
        return "mma", clamp(cdiv(2 * sms, cdiv(M, 16) * (N // 128)), 16)
    if M <= 512:
        want = 7 * sms // 10 * cdiv(M, 256)
        return "wgmma", clamp(cdiv(want, cdiv(M, 64) * (N // 128)), 16)
    return "wgmma", clamp(max(sms // (16 * cdiv(M, 256)), cdiv(steps, 128)),
                          8)


# The kernels' sum orders, emulated on the CPU: (name, M, K, N, step of K
# a product adds, ranks of the cluster). mma.sync and wgmma both add
# 16-wide steps; the ranks are the plans of a 132-SM card (int8_plan),
# but for a generic order of whole 64-wide stages unsplit (bk_tiles).
INT8_SUM_ORDERS = [("bk_tiles", 8, 2048, 1024, 64, 1),
                   ("cluster_ranks", 8, 2048, 1024, 16, 8),
                   ("cluster_ranks_k14336", 8, 14336, 1024, 16, 16),
                   ("large_tile", 256, 4096, 512, 16, 6),
                   ("large_tile_split", 300, 4096, 512, 16, 10),
                   ("large_tile_256", 600, 4096, 512, 16, 2)]


@pytest.mark.parametrize("order,M,K,N,step,ranks", INT8_SUM_ORDERS,
                         ids=[o[0] for o in INT8_SUM_ORDERS])
def test_int8_bound_sees_bf16_accumulators(order, M, K, N, step, ranks):
    """The bound holds each of the kernels' sum orders (fp32 sums, one
    rounding after the scale) and fails a product whose accumulators are
    rounded to bf16 after each K tile of 64."""
    if order != "bk_tiles":
        assert int8_plan(M, N, K)[1] == ranks
    h, q, scale, mag = int8_case(M, K, N, "cpu")
    want = int8_want(h, q, scale)
    got = (_ranked_sum(h, q, step, ranks) * scale.float()).to(
        torch.bfloat16)
    acc = torch.zeros(M, N, dtype=torch.bfloat16)
    for k0 in range(0, K, 64):
        acc = (acc.float() + h[:, k0:k0 + 64].float()
               @ q[k0:k0 + 64].float()).to(torch.bfloat16)
    bf16_acc = (acc.float() * scale.float()).to(torch.bfloat16)
    assert int8_err_ratio(got, want, mag) <= 1.0
    assert int8_err_ratio(bf16_acc, want, mag) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("M", INT8_MS)
@pytest.mark.parametrize("K,N", INT8_SHAPES)
def test_int8_proj_matches_plain_on_card(cuda_device, M, K, N):
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    h, q, scale, mag = int8_case(M, K, N, cuda_device)
    before = ip.launches
    got = ip.int8_proj(h, q, scale)
    torch.cuda.synchronize()
    assert ip.launches == before + 1
    want = int8_want(h, q, scale)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert int8_err_ratio(got, want, mag) <= 1.0
    # deterministic: the cluster's split-K sums in a fixed order
    assert torch.equal(ip.int8_proj(h, q, scale), got)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["mma", "wgmma"])
@pytest.mark.parametrize("M", [1, 17, 128, 129, 256, 300, 600])
@pytest.mark.parametrize("K,N", [(2048, 1024), (4096, 14336), (2048, 384)])
def test_int8_proj_both_paths_on_card(cuda_device, path, M, K, N):
    """Either path, forced, at rows around the switches (wgmma with 64-row
    tiles up to 512 rows, 256-row ones at 600) and an odd number of
    128-column tiles (N 384)."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    h, q, scale, mag = int8_case(M, K, N, cuda_device, seed=2)
    (got,) = ip.int8_proj_many(h, [(q, scale)], _force=path)
    torch.cuda.synchronize()
    assert int8_err_ratio(got, int8_want(h, q, scale), mag) <= 1.0


@pytest.mark.cuda
def test_int8_proj_plan_on_card(cuda_device):
    """The switch: mma.sync up to 16 rows, wgmma from 17; every split is
    1-16 blocks, at most 8 above 512 rows; and the kernel's plan is
    int8_plan's, the one the CPU emulation of the sum orders uses."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert ip.plan(16, 4096, 4096)[0] == "mma"
    assert ip.plan(17, 4096, 4096)[0] == "wgmma"
    for M in INT8_MS:
        for K in (2048, 4096, 14336):
            for N in (128, 1024, 4096, 14336):
                path, split = ip.plan(M, N, K)
                assert (path, split) == int8_plan(M, N, K, sms)
                assert path == ("mma" if M <= 16 else "wgmma")
                assert 1 <= split <= (8 if M > 512 else 16)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 512, 2400])
@pytest.mark.parametrize("model", sorted(INT8_GROUPS))
def test_int8_proj_many_matches_ungrouped_on_card(cuda_device, model, M):
    """A layer's grouped products (wq, wk, wv; w_gate, w_up) in one
    launch each, bit-identical to the products launched alone."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    for gi, (K, Ns) in enumerate(INT8_GROUPS[model]):
        h = int8_case(M, K, 128, cuda_device, seed=10 + gi)[0]
        ws = [int8_case(1, K, n, cuda_device, seed=20 + j)[1:3]
              for j, n in enumerate(Ns)]
        before = ip.launches
        got = ip.int8_proj_many(h, ws)
        assert ip.launches == before + 1
        for (q, scale), y in zip(ws, got):
            assert torch.equal(y, ip.int8_proj(h, q, scale))
            assert int8_err_ratio(y, int8_want(h, q, scale),
                                  int8_mag(h, q, scale)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 300])
def test_int8_proj_graph_replay_on_card(cuda_device, M):
    """Captured in a CUDA graph, a grouped call replays the eager result
    bit for bit, replay after replay (no counter or workspace to reset)."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    h = int8_case(M, 2048, 128, cuda_device, seed=3)[0]
    ws = [int8_case(1, 2048, n, cuda_device, seed=4 + j)[1:3]
          for j, n in enumerate((2048, 1024, 1024))]
    eager = ip.int8_proj_many(h, ws)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ip.int8_proj_many(h, ws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ip.int8_proj_many(h, ws)
    for _ in range(3):
        for y in out:
            y.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [24, 300])
def test_int8_proj_strided_rows_and_leading_axes_on_card(cuda_device, M):
    """A [b, s, K] activation and a row view with a stride past K (the
    last position of each row) give the rows' products, on both paths."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    h, q, scale, mag = int8_case(M, 2048, 1024, cuda_device, seed=1)
    hb = h.reshape(M // 6, 6, 2048)
    got = ip.int8_proj(hb, q, scale)
    assert got.shape == (M // 6, 6, 1024)
    want = int8_want(hb, q, scale)
    assert int8_err_ratio(got, want, mag.reshape(M // 6, 6, 1024)) <= 1.0
    last = hb[:, -1]            # stride (6 K, 1)
    got = ip.int8_proj(last, q, scale)
    assert int8_err_ratio(got, int8_want(last, q, scale),
                          mag.reshape(M // 6, 6, 1024)[:, -1]) <= 1.0


@pytest.mark.cuda
def test_int8_proj_refuses_what_it_does_not_take_on_card(cuda_device):
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    h, q, scale, _ = int8_case(8, 2048, 1024, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 activations"):
        ip.int8_proj(h.float(), q, scale)
    with pytest.raises(ValueError, match="int8 weights"):
        ip.int8_proj(h, q.to(torch.bfloat16), scale)
    with pytest.raises(ValueError, match="bfloat16 scale"):
        ip.int8_proj(h, q, scale.float())
    with pytest.raises(ValueError, match="multiple of 128"):
        ip.int8_proj(h, q[:, :1000].contiguous(), scale[:, :1000])
    with pytest.raises(ValueError, match="unit stride"):
        ip.int8_proj(h.t().contiguous().t(), q, scale)
    with pytest.raises(ValueError, match="1 to 3 weights"):
        ip.int8_proj_many(h, [(q, scale)] * 4)
    with pytest.raises(ValueError, match="features"):
        ip.int8_proj_many(h, [(q, scale), (q[:1024].contiguous(), scale)])
