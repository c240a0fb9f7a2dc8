"""Input builders for the paged-attention tests: random pools, block
tables and cursors in the serving engine's layout, from a numpy seed;
the decode kernels' split-and-merge arithmetic (`emulate_split`); the
flash kernels' error bound with its dropped-diagonal control; and
waves of traffic for either framework's continuous batcher
(`serve_waves`, `cache_books`). Shared by the CPU parity tests (against
the JAX reference) and the card tests (the CUDA kernels against their
plain versions)."""

import asyncio
from unittest import mock

import numpy as np
import torch

# a bf16 rounding of a term errs by at most 2**-8 of it
BF16_ROUNDING = 2.0**-8


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


def mk_dense(seed, b=3, max_len=96, n_q=8, n_kv=2, hd=32, pos=None,
             holes=None):
    """Random dense cache [b, max_len, n_kv, hd] + per-row cursors and
    kv_mask in the one-shot engine's layout. `holes` maps a row to the
    (lo, hi) cell range masked out (a left-pad run); by default cell 3
    is a hole in every row whose cursor is not 3 (a row's own cell is
    never masked in serving, and a row with no visible cell is where
    the plain path, mean(V), and the kernels, 0, differ)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, n_q, hd)).astype(np.float32)
    k = rng.normal(size=(b, max_len, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, max_len, n_kv, hd)).astype(np.float32)
    if pos is None:
        pos = rng.integers(0, max_len, size=(b,))
    pos = np.asarray(pos, np.int32)
    mask = np.ones((b, max_len), bool)
    if holes is None:
        mask[pos != 3, 3] = False
    else:
        for row, (lo, hi) in holes.items():
            mask[row, lo:hi] = False
    return q, k, v, pos, mask


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


def emulate_split(q, k, v, pos, mask, window, split_cells, skip_pad=True):
    """The split-KV decode kernels' partition and merge (csrc/
    decode_split.cuh), in fp32. q [b, 1, n_q, hd]; k, v [b, width, n_kv,
    hd], each row's cells in order (a dense cache, or a paged pool
    gathered through the table); pos [b]; mask [b, width] bool.

    Per (row, split of `split_cells` cells) the partial (m, l, acc) of
    the split's share of the live range [window lo, cursor]; a split
    with an empty share, or (with `skip_pad`) one whose cells the mask
    hides entirely, is skipped with l = 0. Then the merge by m (l == 0
    weighs 0); a row that sees no cell is 0. -> (out [b, 1, n_q, hd],
    splits skipped for the mask alone)."""
    neg_inf = -2.0**30                 # the kernels' initial row max
    b, _, n_q, hd = q.shape
    width, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    out = torch.zeros(b, 1, n_q, hd)
    skipped = 0
    for row in range(b):
        p = int(pos[row])
        live_lo = max(p - window + 1, 0) if window else 0
        live_hi = min(p, width - 1)
        qg = q[row, 0].float().reshape(n_kv, group, hd)
        parts = []
        for z in range(-(-width // split_cells)):
            lo = max(z * split_cells, live_lo)
            hi = min((z + 1) * split_cells - 1, live_hi)
            blank = lo > hi
            if not blank and skip_pad and not bool(mask[row, lo:hi + 1].any()):
                blank = True
                skipped += 1
            if blank:                         # l = 0: weighs 0
                parts.append((torch.full((n_q,), neg_inf),
                              torch.zeros(n_q), torch.zeros(n_q, hd)))
                continue
            kc = k[row, lo:hi + 1].float()   # [n, n_kv, hd]
            vc = v[row, lo:hi + 1].float()
            x = torch.einsum("ngd,cnd->ngc", qg, kc).reshape(n_q, -1)
            x = torch.where(mask[row, lo:hi + 1], x * hd**-0.5, -torch.inf)
            m = x.amax(-1).clamp(min=neg_inf)  # neg_inf where none visible
            e = torch.exp(x - m[:, None])
            acc = torch.einsum("ngc,cnd->ngd", e.reshape(n_kv, group, -1),
                               vc).reshape(n_q, hd)
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
    return out, skipped


def flash_err_ratio(got, want, c, rtol, mag=None):
    """max |got - want| / (c max|want| + rtol |want| + 2**-8 mag), <= 1
    within the flash kernels' bound. `mag` (`flash_bf16_slack`) adds the
    bf16 kernels' rounding of P, P^T and dS^T before their products."""
    got, want = got.float(), want.float()
    bound = c * want.abs().max() + rtol * want.abs()
    if mag is not None:
        bound = bound + BF16_ROUNDING * mag
    return float(((got - want).abs() / bound).max())


def dropped_diagonal(flash_module):
    """A context in which the plain flash versions of `flash_module`
    leave each query's own key out: a causal mask off by one, the fault
    the bound has to see."""
    mask = flash_module._mask

    def off_by_one(s, causal, window, device):
        eye = torch.eye(s, dtype=torch.bool, device=device)
        return mask(s, causal, window, device) & ~eye

    return mock.patch.object(flash_module, "_mask", off_by_one)


def prefill_dropped_diagonal(attention_module):
    """A context in which the plain attention of `attention_module`
    (kubeflow_tpu_torch.ops.attention) leaves each query's own cell out:
    the paged prefill's causal mask off by one, the fault the prefill's
    bf16 bound has to see. Query positions one lower drop the diagonal
    (qp - 1 >= kp iff kp < qp), and a window one shorter keeps the far
    edge where it was."""
    attend = attention_module._torch_attention

    def off_by_one(q, k, v, q_positions, kv_positions, *, causal, kv_mask,
                   window):
        return attend(q, k, v, q_positions - 1, kv_positions, causal=causal,
                      kv_mask=kv_mask,
                      window=None if window is None else window - 1)

    return mock.patch.object(attention_module, "_torch_attention",
                             off_by_one)


# -- continuous-batcher traffic --------------------------------------------


def _decoding(batcher) -> bool:
    """Some admitted request is past its prefill (either framework's
    batcher: both keep `_active` records with `prefilling` and `out`)."""
    return any(r.prefilling is None and r.out
               for r in batcher._active.values())


async def serve_waves(batcher, waves, *, reference: bool):
    """Serve `waves` through a continuous batcher (the reference's with
    `reference=True`, else the port's) and close it. A wave is a list of
    requests `{"tokens", "max_new", "prefix" (optional), "late"
    (optional)}`, submitted at once; each wave is awaited before the
    next. A `late` request waits until an earlier one of its wave
    decodes, so it is admitted while that one is still active (in-flight
    prefix sharing). -> [(tokens, logprobs)] in request order."""

    async def one(req):
        if req.get("late"):
            while not _decoding(batcher):
                await asyncio.sleep(0.001)
        sampling = {"prefix": req["prefix"]} if req.get("prefix") else {}
        toks, lps = await batcher.submit(
            req["tokens"], req["max_new"],
            tuple(sampling.items()) if reference else sampling,
            with_logprobs=True)
        return list(toks), list(lps)

    out = []
    try:
        for wave in waves:
            out += await asyncio.gather(*(one(r) for r in wave))
    finally:
        await batcher.close()
    return out


def cache_books(batcher) -> dict:
    """What both frameworks' batchers must agree on after the same
    traffic: prefix hits and misses, tokens reused and prefilled,
    cached and spilled blocks, the heat digest, and the lifecycle
    ledger's snapshot without its admission defers (a deferred request
    is planned again every worker iteration, whose count depends on the
    pipeline depth)."""
    stats = batcher.prefix_cache_stats()
    ledger = batcher.cache_ledger.snapshot()
    ledger.pop("defers")
    return {k: stats[k] for k in ("hits", "misses", "tokens_prefilled",
                                  "tokens_reused", "cached_blocks",
                                  "spilled_blocks", "heat")} | {
        "ledger": ledger}
