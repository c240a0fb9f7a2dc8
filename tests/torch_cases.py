"""Input builders for the paged-attention tests: random pools, block
tables and cursors in the serving engine's layout, from a numpy seed.
Shared by the CPU parity tests (against the JAX reference) and the card
tests (the CUDA kernels against their plain versions)."""

import numpy as np


def mk_decode(seed, b=3, n_q=8, n_kv=2, hd=32, bs=8, nb=6, num_blocks=32,
               pos=None, share=False):
    """Random pool + per-row table/cursor in the engine's layout: ragged
    cursors, exclusive live blocks (or, with share, a first block
    shared by every row), trash-padded table tails."""
    rng = np.random.default_rng(seed)
    width = nb * bs
    q = rng.normal(size=(b, 1, n_q, hd)).astype(np.float32)
    kp = rng.normal(size=(num_blocks, bs, n_kv, hd)).astype(np.float32)
    vp = rng.normal(size=(num_blocks, bs, n_kv, hd)).astype(np.float32)
    kp[0] = vp[0] = 0.0
    if pos is None:
        pos = rng.integers(0, width, size=(b,))
    pos = np.asarray(pos, np.int32)
    table = np.zeros((b, nb), np.int32)
    free = list(rng.permutation(np.arange(2, num_blocks)))
    for i in range(b):
        for j in range(pos[i] // bs + 1):
            table[i, j] = 1 if share and j == 0 else free.pop()
    # a pad hole at cell 3, except where it is the row's own cell: serving
    # never masks a row's own new cell, and a row with no visible cell
    # is where the plain path (mean(V)) and the kernels (0) differ
    mask = np.ones((b, width), bool)
    mask[pos != 3, 3] = False
    return q, kp, vp, table, pos, mask



def mk_prefill(seed, b=3, s=5, n_q=8, n_kv=2, hd=32, bs=8, nb=6,
                num_blocks=64, starts=None, lens=None, shared=False):
    """Random pool + per-row table/cursor: exclusive block chains
    covering [0, start + s) (write-disjoint by construction), or with
    `shared` a first block shared by every row, strictly below every
    row's start (the serving invariant)."""
    rng = np.random.default_rng(seed)
    width = nb * bs
    q = rng.normal(size=(b, s, n_q, hd)).astype(np.float32)
    kn = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    vn = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    kp = rng.normal(size=(num_blocks, bs, n_kv, hd)).astype(np.float32)
    vp = rng.normal(size=(num_blocks, bs, n_kv, hd)).astype(np.float32)
    kp[0] = vp[0] = 0.0
    if starts is None:
        starts = rng.integers(0, width - s + 1, size=(b,))
    starts = np.asarray(starts, np.int32)
    lens = np.full((b,), s, np.int32) if lens is None \
        else np.asarray(lens, np.int32)
    table = np.zeros((b, nb), np.int32)
    free = list(rng.permutation(np.arange(2, num_blocks)))
    for i in range(b):
        for j in range(max(-(-int(starts[i] + s) // bs), 1)):
            table[i, j] = 1 if shared and j == 0 else free.pop()
    return q, kn, vn, kp, vp, table, starts, lens
