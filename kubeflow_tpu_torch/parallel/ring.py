"""Sequence parallelism: ring attention and Ulysses (counterpart:
kubeflow_tpu/parallel/ring.py).

The global sequence is the concatenation of the ranks' shards in axis
order; `group` is the sequence axis's `AxisGroup` (the reference's
`axis_name`), and each function runs on every rank of it, as the
reference's run inside `shard_map`. Layouts are the port's: q, o
`[b, s_local, n_q, hd]`, k, v `[b, s_local, n_kv, hd]`.

- `ring_attention`: the plain fp32 online-softmax ring. K/V blocks hop
  one rank up per step (size - 1 hops) and each block's masked
  contribution merges into the running (o, m, l); fully-future blocks
  run and contribute zero weight, as in the reference.
- `ring_flash_attention`: the ring over the flash kernels
  (ops/cuda/flash_attention.py; on the CPU their plain versions), an
  `autograd.Function` following the reference's custom VJP. Forward:
  the diagonal block (the rank's own K/V) runs causal, every other
  block `causal=False`, and the normalised per-block (o, lse) pairs
  merge -inf-safely in fp32. A rank skips a block that is entirely in
  its future with a Python `if` (the reference's `lax.cond`), so a rank
  r of a causal ring launches r + 1 forward kernels, and N when
  bidirectional. Backward: the dQ and dK/dV kernels rerun per visiting
  block against the MERGED (o, lse) totals (flash's backward splits
  over key blocks given the global row lse and delta = rowsum(dO o));
  the dK/dV accumulators travel with their block, and one more hop
  after the last step brings each home. Same skip, same launch counts.
- `ulysses_attention`: a tiled all-to-all swaps the sequence shard for
  a head shard, a full local attention runs over the whole sequence
  ("flash": the port's `flash_attention`; "xla": the plain fp32 block),
  and a second all-to-all swaps back.

Every block a kernel reads is contiguous: a received block is a fresh
tensor, and the all-to-all returns a contiguous result. The `*_sharded`
wrappers take the global tensors every rank holds alike, cut this
rank's sequence block (`comm.shard`, the `P(None, seq_axis, None,
None)` input) and all-gather the output, so each returns the global o.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.cuda import flash_attention as fa
from kubeflow_tpu_torch.parallel import comm
from kubeflow_tpu_torch.parallel import mesh as mesh_lib
from kubeflow_tpu_torch.parallel.comm import AxisGroup

NEG_INF = -2.0**30  # the reference's finite mask value


def _rotate(group: AxisGroup):
    return [(i, (i + 1) % group.size) for i in range(group.size)]


def _block_attend(qg, k, v, mask):
    """One blockwise accumulation step, grouped-query, fp32.
    qg [b, sq, n_kv, g, hd], k/v [b, sk, n_kv, hd], mask [b, sq, sk]
    (True = attend) -> unnormalised (o [b, sq, n_kv, g, hd], m, l
    [b, sq, n_kv, g])."""
    scale = qg.shape[-1] ** -0.5
    logits = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=logits.device))
    m = logits.amax(-1)                                 # [b, n, g, sq]
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bngst,btnh->bngsh", p, v.float())
    return (o.permute(0, 3, 1, 2, 4), m.permute(0, 3, 1, 2),
            l.permute(0, 3, 1, 2))


def ring_attention(q, k, v, *, group: AxisGroup, causal: bool = True):
    """Plain ring attention over sequence shards (differentiable through
    autograd and `comm.ppermute`)."""
    size, my = group.size, group.index
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    if n_q % n_kv:
        raise ValueError(f"n_q={n_q} not a multiple of n_kv={n_kv}")
    g = n_q // n_kv
    qg = q.reshape(b, s, n_kv, g, hd)
    local = torch.arange(s, device=q.device)
    q_pos = my * s + local
    o = q.new_zeros((b, s, n_kv, g, hd), dtype=torch.float32)
    m = torch.full((b, s, n_kv, g), NEG_INF, device=q.device)
    l = torch.zeros((b, s, n_kv, g), device=q.device)
    k_blk, v_blk = k, v
    for i in range(size):
        src = (my - i) % size
        kv_pos = src * s + local
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
        else:
            mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
        o_i, m_i, l_i = _block_attend(qg, k_blk, v_blk,
                                      mask.expand(b, s, s))
        m_new = torch.maximum(m, m_i)
        a, a_i = torch.exp(m - m_new), torch.exp(m_i - m_new)
        o = o * a[..., None] + o_i * a_i[..., None]
        l = l * a + l_i * a_i
        m = m_new
        if i + 1 < size:
            k_blk = comm.ppermute(k_blk, _rotate(group), group)
            v_blk = comm.ppermute(v_blk, _rotate(group), group)
    out = o / l[..., None]
    return out.reshape(b, s, n_q, hd).to(q.dtype)


def _merge_blocks(o, lse, o_i, lse_i):
    """Online merge of normalised per-block (o [b, s, n, hd] fp32, lse
    [b, n, s] fp32) pairs, -inf-safe (an empty side has weight 0)."""
    new = torch.logaddexp(lse, lse_i)
    w = torch.where(lse == NEG_INF, 0.0, torch.exp(lse - new))
    w_i = torch.where(lse_i == NEG_INF, 0.0, torch.exp(lse_i - new))
    rows = lambda t: t.transpose(1, 2)[..., None]  # noqa: E731
    return o * rows(w) + o_i * rows(w_i), new


def _visits(causal: bool, my: int, i: int) -> bool:
    """Whether step i's block (from rank my - i) is not all future."""
    return not causal or i == 0 or my >= i


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        size, my = group.size, group.index
        b, s, n_q, hd = q.shape
        o = torch.zeros((b, s, n_q, hd), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, n_q, s), NEG_INF, device=q.device)
        k_blk, v_blk = k, v
        for i in range(size):
            if _visits(causal, my, i):
                o_i, lse_i = fa.flash_block_fwd(
                    q, k_blk, v_blk, causal=causal and i == 0)
                o, lse = _merge_blocks(o, lse, o_i.float(), lse_i)
            if i + 1 < size:
                k_blk = comm._ppermute(k_blk, _rotate(group), group)
                v_blk = comm._ppermute(v_blk, _rotate(group), group)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        size, my = group.size, group.index
        do = do.contiguous()
        delta = fa.flash_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        perm = _rotate(group)
        for i in range(size):
            if _visits(causal, my, i):
                c = causal and i == 0
                dq += fa.flash_dq(q, k_blk, v_blk, do, lse, delta,
                                  causal=c).float()
                dk_i, dv_i = fa.flash_dkv(q, k_blk, v_blk, do, lse, delta,
                                          causal=c)
                dk_acc += dk_i.float()
                dv_acc += dv_i.float()
            # the accumulators travel with their block; after the last
            # step this hop brings each one home (the block itself is
            # dead by then)
            if i + 1 < size:
                k_blk = comm._ppermute(k_blk, perm, group)
                v_blk = comm._ppermute(v_blk, perm, group)
            dk_acc = comm._ppermute(dk_acc, perm, group)
            dv_acc = comm._ppermute(dv_acc, perm, group)
        return (dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype),
                None, None)


def ring_flash_attention(q, k, v, *, group: AxisGroup, causal: bool = True):
    """Ring attention with flash blocks, differentiable through the
    ring-flash backward; same contract as `ring_attention`."""
    fa._check_args(q, k, v, causal, None)
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            group, causal)


def ulysses_attention(q, k, v, *, group: AxisGroup, causal: bool = True,
                      impl: str = "xla"):
    """Ulysses sequence parallelism: all-to-all #1 [b, s/N, n, hd] ->
    [b, s, n/N, hd], full attention for the local head group, all-to-all
    #2 back. Needs n_q and n_kv divisible by the axis size."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"impl must be 'xla' or 'flash', got {impl!r}")
    size = group.size
    n_q, n_kv = q.shape[2], k.shape[2]
    if n_q % size or n_kv % size:
        raise ValueError(f"ulysses needs heads divisible by axis size: "
                         f"n_q={n_q} n_kv={n_kv} size={size}")
    qh, kh, vh = (comm.all_to_all(x, 2, 1, group) for x in (q, k, v))
    b, s, nh, hd = qh.shape
    if impl == "flash":
        out = fa.flash_attention(qh, kh, vh, causal=causal)
    else:
        pos = torch.arange(s, device=q.device)
        mask = (pos[:, None] >= pos[None, :] if causal
                else torch.ones((s, s), dtype=torch.bool, device=q.device))
        g = nh // kh.shape[2]
        o, _, l = _block_attend(qh.reshape(b, s, kh.shape[2], g, hd), kh,
                                vh, mask.expand(b, s, s))
        out = (o / l[..., None]).reshape(b, s, nh, hd).to(q.dtype)
    return comm.all_to_all(out, 1, 2, group)


def _sharded(fn, q, k, v, mesh, seq_axis, **kw):
    n = mesh.shape[seq_axis]
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"{seq_axis}={n}")
    group = mesh.axis_group(seq_axis)
    blocks = (comm.shard(x, 1, group) for x in (q, k, v))
    return comm.all_gather_invariant(fn(*blocks, group=group, **kw), 1,
                                     group)


def ring_attention_sharded(q, k, v, mesh, *,
                           seq_axis: str = mesh_lib.FSDP_AXIS,
                           causal: bool = True):
    """Global [b, s, n, hd] in and out, the sequence split over
    `seq_axis` (context parallelism reuses the fsdp axis)."""
    return _sharded(ring_attention, q, k, v, mesh, seq_axis, causal=causal)


def ring_flash_attention_sharded(q, k, v, mesh, *,
                                 seq_axis: str = mesh_lib.FSDP_AXIS,
                                 causal: bool = True):
    return _sharded(ring_flash_attention, q, k, v, mesh, seq_axis,
                    causal=causal)


def ulysses_attention_sharded(q, k, v, mesh, *,
                              seq_axis: str = mesh_lib.FSDP_AXIS,
                              causal: bool = True, impl: str = "xla"):
    return _sharded(ulysses_attention, q, k, v, mesh, seq_axis,
                    causal=causal, impl=impl)
