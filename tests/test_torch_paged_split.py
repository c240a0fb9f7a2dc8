"""The paged decode kernel's split-and-merge arithmetic, emulated in
plain PyTorch on the CPU, against the Pallas kernel in interpret mode.

The CUDA kernel (csrc/paged_decode_attention.cu) gives each (kv head,
row) `split_count(width, split_cells)` blocks. Block z attends only the
cells of [z split_cells, (z + 1) split_cells) that the row's live range
[window lo, cursor] holds, and writes its partial row max m, softmax
denominator l and unnormalised accumulator; an empty block writes
l = 0, and so does a block whose share the kv_mask hides entirely (the
pad-split skip, csrc/decode_split.cuh). A second launch merges the
splits by their m (a split with l == 0 weighs 0) and writes 0 for a row
that sees no cell, as the Pallas kernel does. `emulate_split`
(torch_cases.py) repeats that partition, skip and merge on the same
numpy inputs gathered through the table, over block tables with
several blocks per split and one block per split, at the split's edges:
a cursor on the table's last cell and inside the first split, a window
that empties the leading splits, a kv_mask that blanks a whole split
below the cursor, a left-pad run that blanks the leading splits, and a
row that sees no cell. Skipping a blanked split leaves the result as it
is without the skip.

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
from kubeflow_tpu_torch.ops.cuda import paged_attention as tpaged
from torch_cases import emulate_split, mk_decode

TOL = dict(atol=1e-5, rtol=1e-5)

# name: (bs, nb, cursors, window, masked cell range, rows that see no
# cell); width 320 = 2.5 splits of 128 cells, 5 of 64, 1.25 of 256
CASES = {
    "left_pad_blanks_leading_splits": (64, 5, [319, 300, 200], None,
                                       (0, 150), ()),
    "cursor_on_last_cell": (64, 5, [319, 100, 0], None, None, ()),
    "cursor_in_first_split": (64, 5, [5, 63, 127], None, None, ()),
    "window_empties_leading_splits": (64, 5, [300, 319, 200], 13, None, ()),
    "mask_blanks_a_split": (64, 5, [300, 200, 319], None, (128, 256), ()),
    "bs8_splits_span_blocks": (8, 40, [319, 130, 64], None, None, ()),
    "row_sees_no_cell": (8, 40, [319, 70, 200], 50, None, (1,)),
    "gemma_heads_left_pad": (64, 5, [319, 300, 200], None, (0, 150), ()),
    "gemma_heads_bs8_window": (8, 40, [319, 130, 64], 13, None, ()),
}
# (n_q, n_kv, hd) of a case: 8 query heads over 2 kv heads of 32, or
# gemma-2b's 8 over one of 256
HEADS = {name: (8, 1, 256) for name in CASES if name.startswith("gemma")}


@functools.lru_cache(maxsize=None)
def _case(name):
    bs, nb, pos, window, blank, blind = CASES[name]
    n_q, n_kv, hd = HEADS.get(name, (8, 2, 32))
    q, kp, vp, table, pos, mask = mk_decode(
        11, b=3, n_q=n_q, n_kv=n_kv, hd=hd, bs=bs, nb=nb,
        num_blocks=3 * nb + 2, pos=pos)
    if blank is not None:
        mask[:, blank[0]:blank[1]] = False
    for row in blind:
        mask[row] = False
    want = pallas_decode(*(jnp.asarray(a) for a in (q, kp, vp, table, pos,
                                                    mask)),
                         window=window, interpret=True)
    return (q, kp, vp, table, pos, mask), window, np.asarray(want)


def _gathered(kp, vp, table):
    """Each row's cells in order, through its table: [b, nb bs, n_kv, hd]."""
    b, nb = table.shape
    return tuple(p[table.long()].reshape(b, nb * p.shape[1], *p.shape[2:])
                 for p in (kp, vp))


@pytest.mark.parametrize("split_cells", [64, 128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_matches_pallas(case, split_cells):
    args, window, want = _case(case)
    q, kp, vp, table, pos, mask = (torch.from_numpy(np.ascontiguousarray(a))
                                   for a in args)
    k, v = _gathered(kp, vp, table)
    got, skipped = emulate_split(q, k, v, pos, mask, window, split_cells)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for row in CASES[case][5]:                # sees no cell: 0 in both
        assert not np.any(want[row]) and not torch.any(got[row])
    # the pad-split skip: blanked splits write l = 0, the result stays
    unskipped, none = emulate_split(q, k, v, pos, mask, window, split_cells,
                                    skip_pad=False)
    assert none == 0
    torch.testing.assert_close(got, unskipped, **TOL)
    blank = CASES[case][4]
    if blank is not None and \
            (-(-blank[0] // split_cells) + 1) * split_cells <= blank[1]:
        assert skipped > 0                    # a whole split is blanked


@pytest.mark.parametrize("width,split_cells,want", [
    (1024, 128, 8), (1024, 256, 4), (320, 128, 3), (64, 128, 1)])
def test_split_count_follows_the_shapes(width, split_cells, want):
    assert tpaged.split_count(width, split_cells) == want


# (group, hd) -> cells: llama3-1b's 2 x 128 keeps 128-cell splits;
# wider rows (llama3-8b's group 4, gemma-2b's 8 x 256) take 64
@pytest.mark.parametrize("group,hd,want", [
    (1, 128, 128), (2, 128, 128), (4, 128, 64), (8, 256, 64),
    (16, 128, 64)])
def test_default_split_follows_the_head_geometry(group, hd, want):
    assert tpaged.default_split_cells(group, hd) == want


@pytest.mark.parametrize("split_cells", [0, 32, 100])
def test_split_cells_must_be_a_multiple_of_the_chunk(split_cells):
    args, window, _ = _case("cursor_in_first_split")
    q, kp, vp, table, pos, mask = (torch.from_numpy(np.ascontiguousarray(a))
                                   for a in args)
    with pytest.raises(ValueError, match="split_cells"):
        tpaged.paged_decode_attention(q, kp, vp, table, pos, mask,
                                      window=window, split_cells=split_cells)
