"""The paged decode kernel's split-and-merge arithmetic, emulated in
plain PyTorch on the CPU, against the Pallas kernel in interpret mode.

The CUDA kernel (csrc/paged_decode_attention.cu) gives each (kv head,
row) `split_count(width, split_cells)` blocks. Block z attends only the
cells of [z split_cells, (z + 1) split_cells) that the row's live range
[window lo, cursor] holds, and writes its partial row max m, softmax
denominator l and unnormalised accumulator; an empty block writes
l = 0. A second launch merges the splits by their m (a split with
l == 0 weighs 0) and writes 0 for a row that sees no cell, as the
Pallas kernel does. `emulate_split` repeats that partition and merge on
the same numpy inputs, over block tables with several blocks per split
and one block per split, at the split's edges: a cursor on the table's
last cell and inside the first split, a window that empties the leading
splits, a kv_mask that blanks a whole split below the cursor, and a row
that sees no cell.

Tolerance: fp32, atol/rtol 1e-5 (per-split softmax merged afterwards
vs the Pallas kernel's per-block online softmax; different sum orders).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as pallas_decode,
)
from kubeflow_tpu_torch.ops.attention import NEG_INF
from kubeflow_tpu_torch.ops.cuda import paged_attention as tpaged
from torch_cases import mk_decode

TOL = dict(atol=1e-5, rtol=1e-5)

# name: (bs, nb, cursors, window, masked cell range, rows that see no
# cell); width 320 = 2.5 splits of 128 cells, 5 of 64, 1.25 of 256
CASES = {
    "cursor_on_last_cell": (64, 5, [319, 100, 0], None, None, ()),
    "cursor_in_first_split": (64, 5, [5, 63, 127], None, None, ()),
    "window_empties_leading_splits": (64, 5, [300, 319, 200], 13, None, ()),
    "mask_blanks_a_split": (64, 5, [300, 200, 319], None, (128, 256), ()),
    "bs8_splits_span_blocks": (8, 40, [319, 130, 64], None, None, ()),
    "row_sees_no_cell": (8, 40, [319, 70, 200], 50, None, (1,)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    bs, nb, pos, window, blank, blind = CASES[name]
    q, kp, vp, table, pos, mask = mk_decode(
        11, b=3, n_q=8, n_kv=2, hd=32, bs=bs, nb=nb, num_blocks=3 * nb + 2,
        pos=pos)
    if blank is not None:
        mask[:, blank[0]:blank[1]] = False
    for row in blind:
        mask[row] = False
    want = pallas_decode(*(jnp.asarray(a) for a in (q, kp, vp, table, pos,
                                                    mask)),
                         window=window, interpret=True)
    return (q, kp, vp, table, pos, mask), window, np.asarray(want)


def emulate_split(q, kp, vp, table, pos, mask, window, split_cells):
    """The kernel's partition and merge, in fp32: per (row, split) the
    partial (m, l, acc) of the split's share of the live range, then
    the weighted merge by m."""
    b, _, n_q, hd = q.shape
    _, bs, n_kv, _ = kp.shape
    width = table.shape[1] * bs
    group = n_q // n_kv
    out = torch.zeros(b, 1, n_q, hd)
    for row in range(b):
        p = int(pos[row])
        live_lo = max(p - window + 1, 0) if window else 0
        live_hi = min(p, width - 1)
        qg = q[row, 0].reshape(n_kv, group, hd)
        parts = []
        for z in range(tpaged.split_count(width, split_cells)):
            lo = max(z * split_cells, live_lo)
            hi = min((z + 1) * split_cells - 1, live_hi)
            if lo > hi:                       # an empty block: l = 0
                parts.append((torch.full((n_q,), NEG_INF),
                              torch.zeros(n_q), torch.zeros(n_q, hd)))
                continue
            cells = torch.arange(lo, hi + 1)
            phys = table[row, cells // bs].long()
            k = kp[phys, cells % bs]          # [n, n_kv, hd]
            v = vp[phys, cells % bs]
            x = torch.einsum("ngd,cnd->ngc", qg, k).reshape(n_q, -1)
            vis = mask[row, cells]
            x = torch.where(vis, x * hd**-0.5, -torch.inf)
            m = x.amax(-1).clamp(min=NEG_INF)  # NEG_INF where none visible
            e = torch.exp(x - m[:, None])
            acc = torch.einsum("ngc,cnd->ngd", e.reshape(n_kv, group, -1),
                               v).reshape(n_q, hd)
            parts.append((m, e.sum(-1), acc))
        ms = torch.stack([m for m, _, _ in parts])       # [n_split, n_q]
        ls = torch.stack([l for _, l, _ in parts])
        accs = torch.stack([a for _, _, a in parts])
        top = torch.where(ls > 0, ms, -torch.inf).amax(0)
        w = torch.where(ls > 0, torch.exp(ms - top), 0.0)
        total = (w * ls).sum(0)
        merged = (w[..., None] * accs).sum(0)
        out[row, 0] = torch.where(total[:, None] > 0,
                                  merged / total.clamp(min=1e-30)[:, None],
                                  0.0)
    return out


@pytest.mark.parametrize("split_cells", [64, 128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_matches_pallas(case, split_cells):
    args, window, want = _case(case)
    got = emulate_split(*(torch.from_numpy(np.ascontiguousarray(a))
                          for a in args), window, split_cells)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for row in CASES[case][5]:                # sees no cell: 0 in both
        assert not np.any(want[row]) and not torch.any(got[row])


@pytest.mark.parametrize("width,split_cells,want", [
    (1024, 128, 8), (1024, 256, 4), (320, 128, 3), (64, 128, 1)])
def test_split_count_follows_the_shapes(width, split_cells, want):
    assert tpaged.split_count(width, split_cells) == want


@pytest.mark.parametrize("split_cells", [0, 32, 100])
def test_split_cells_must_be_a_multiple_of_the_chunk(split_cells):
    args, window, _ = _case("cursor_in_first_split")
    q, kp, vp, table, pos, mask = (torch.from_numpy(np.ascontiguousarray(a))
                                   for a in args)
    with pytest.raises(ValueError, match="split_cells"):
        tpaged.paged_decode_attention(q, kp, vp, table, pos, mask,
                                      window=window, split_cells=split_cells)
