"""The dense decode kernel's split-and-merge arithmetic, emulated in
plain PyTorch on the CPU, against the Pallas kernel in interpret mode.

The CUDA kernel (csrc/decode_attention.cu over csrc/decode_split.cuh)
gives each (kv head, row) ceil(max_len / split_cells) blocks. Block z
attends only the cells of [z split_cells, (z + 1) split_cells) that the
row's live range [window lo, cursor] holds; a block whose share is
empty, or hidden entirely by the kv_mask (the pad-split skip: a window
batch's left-pad run), writes l = 0 without reading K/V. A second
launch merges the splits by their m and writes 0 for a row that sees no
cell, as the Pallas kernel does. `emulate_split` (torch_cases.py)
repeats that partition, skip and merge on the same numpy inputs: the
window batch's left-pad shape (a cursor at the prompt bucket + 15,
prompts of several lengths), a cursor on the last cell and in the first
split, a window that empties the leading splits, a kv_mask that blanks
a whole split below the cursor, and a row that sees no cell (0 from
both). Splits of 64 and 128 cells.

Tolerance: fp32, atol/rtol 1e-5 (per-split softmax merged afterwards
vs the Pallas kernel's per-block online softmax; different sum orders).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas.decode_attention import (
    decode_attention as pallas_decode,
)
from kubeflow_tpu_torch.ops.cuda import decode_attention as tdense
from torch_cases import emulate_split, mk_dense

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN, BUCKET = 384, 256     # 3 splits of 128 cells, 6 of 64
PROMPTS = (17, 100, 200, 256)  # left-padded to the bucket

# name: (cursors, window, masked cell ranges by row, rows that see no
# cell)
CASES = {
    "window_batch_left_pad": ([BUCKET + 15] * 4, None,
                              {r: (0, BUCKET - n)
                               for r, n in enumerate(PROMPTS)}, ()),
    "cursor_on_last_cell": ([MAX_LEN - 1, 100, 0], None, {}, ()),
    "cursor_in_first_split": ([5, 63, 127], None, {}, ()),
    "window_empties_leading_splits": ([300, MAX_LEN - 1, 200], 13, {}, ()),
    "mask_blanks_a_split": ([300, 200, MAX_LEN - 1], None,
                            {r: (128, 256) for r in range(3)}, ()),
    "row_sees_no_cell": ([MAX_LEN - 1, 70, 200], 50, {1: (0, MAX_LEN)},
                         (1,)),
    "gemma_heads_window_batch": ([BUCKET + 15] * 4, None,
                                 {r: (0, BUCKET - n)
                                  for r, n in enumerate(PROMPTS)}, ()),
    "gemma_heads_window_empties_leading_splits": (
        [300, MAX_LEN - 1, 200], 13, {}, ()),
}
# (n_q, n_kv, hd) of a case: 8 query heads over 2 kv heads of 32, or
# gemma-2b's 8 over one of 256
HEADS = {name: (8, 1, 256) for name in CASES if name.startswith("gemma")}


@functools.lru_cache(maxsize=None)
def _case(name):
    pos, window, holes, _ = CASES[name]
    n_q, n_kv, hd = HEADS.get(name, (8, 2, 32))
    q, k, v, pos, mask = mk_dense(12, b=len(pos), max_len=MAX_LEN, n_q=n_q,
                                  n_kv=n_kv, hd=hd, pos=pos, holes=holes)
    want = pallas_decode(*(jnp.asarray(a) for a in (q, k, v, pos, mask)),
                         window=window, interpret=True)
    return (q, k, v, pos, mask), window, np.asarray(want)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("split_cells", [64, 128])
@pytest.mark.parametrize("case", list(CASES))
def test_dense_split_merge_matches_pallas(case, split_cells):
    args, window, want = _case(case)
    q, k, v, pos, mask = _torch(args)
    got, skipped = emulate_split(q, k, v, pos, mask, window, split_cells)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for row in CASES[case][3]:                # sees no cell: 0 in both
        assert not np.any(want[row]) and not torch.any(got[row])
    # skipping the blanked splits leaves the result as it is without
    unskipped, _ = emulate_split(q, k, v, pos, mask, window, split_cells,
                                 skip_pad=False)
    torch.testing.assert_close(got, unskipped, **TOL)


@pytest.mark.parametrize("split_cells,want", [(64, 5), (128, 2)])
def test_window_batch_skips_its_pad_only_splits(split_cells, want):
    """The left-pad runs (239, 156, 56 and 0 cells below the bucket, the
    cursor at cell 271) hide 3 + 2 of the 20 live 64-cell splits and
    1 + 1 of the 12 live 128-cell splits entirely."""
    args, window, _ = _case("window_batch_left_pad")
    q, k, v, pos, mask = _torch(args)
    _, skipped = emulate_split(q, k, v, pos, mask, window, split_cells)
    assert skipped == want


@pytest.mark.parametrize("split_cells", [0, 32, 100])
def test_split_cells_must_be_a_multiple_of_the_chunk(split_cells):
    args, window, _ = _case("cursor_in_first_split")
    with pytest.raises(ValueError, match="split_cells"):
        tdense.decode_attention(*_torch(args), window=window,
                                split_cells=split_cells)


@pytest.mark.parametrize("split_cells", [64, 128])
def test_cpu_path_ignores_the_split(split_cells):
    """On a CPU tensor the wrapper runs the plain version whatever the
    split: the same result as the default."""
    args, window, _ = _case("window_batch_left_pad")
    t = _torch(args)
    torch.testing.assert_close(
        tdense.decode_attention(*t, window=window, split_cells=split_cells),
        tdense.decode_attention(*t, window=window), atol=0, rtol=0)
