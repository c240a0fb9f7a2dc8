"""Flash attention: the CUDA forward, dQ and dK/dV kernels' wrappers,
their plain PyTorch versions, and the differentiable `flash_attention`.

Replaces the Pallas TPU kernels of
`kubeflow_tpu/ops/pallas/flash_attention.py`: `_fwd_kernel`
(csrc/flash_attention_fwd.cu), `_dq_kernel` (csrc/flash_attention_dq.cu)
and `_dkv_kernel` (csrc/flash_attention_dkv.cu); the source notes there
give each kernel's bound and design.

Layout differs from the reference's block entry points on purpose: q, o
and dO are `[b, s, n_q, hd]`, k and v `[b, s, n_kv, hd]` (the model's
own layout, which the kernels read without a transpose), and the row
logsumexp is `[b, n_q, s]` fp32 (the reference's `[b, n_q, s, 128]` is
the TPU's lane replication of the same numbers).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The plain versions materialise the [s, s] scores in fp32: the
CPU tests run them, and the card compares the kernels with them.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops.cuda import _build

# Launches of each CUDA kernel (never of a plain version).
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

NEG_INF = -2.0**30  # the reference's finite mask value
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims each dtype's kernels take: bf16 runs on the tensor cores, fp32
# on the CUDA cores, both at llama's 128 and gemma's 256
HEAD_DIMS = {torch.bfloat16: (128, 256), torch.float32: (128, 256)}
# the dK/dV grid (KV heads x batch rows x key tiles x 128-column parts)
# is split over query-head subgroups until it has this many blocks, about
# two waves of one block an SM: at gemma-2b's training shape 2 subgroups
# (256 blocks) beat 1, 4 and 8 on an H100 (chip_smoke.py phase 2 logs
# the sweep)
DKV_MIN_BLOCKS = 256
_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = [_I] * 7 + [ctypes.c_float, _I]  # b s n_q n_kv hd causal window
_FWD_ARGS = [_P] * 5 + _TAIL + [_P]      # q k v o lse ... stream
_DQ_ARGS = [_P] * 7 + _TAIL + [_P]       # q k v do lse delta dq ... stream
_DKV_ARGS = [_P] * 8 + _TAIL + [_I, _P]  # q k v do lse delta dk dv ...
#                                          splits stream


def _check_args(q, k, v, causal, window):
    """The reference `flash_attention`'s argument checks."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    if n_q % n_kv:
        raise ValueError(f"n_q={n_q} not a multiple of n_kv={n_kv}")
    if k.shape[1] != s:
        raise ValueError("flash kernel requires equal q/kv sequence lengths")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")


def _mask(s, causal, window, device):
    """[s, s] bool, True = key visible to query (index-based, as the
    reference's kernels mask)."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
        if window is not None:
            mask &= (qp - kp) < window
    return mask


def _logits(q, k, causal, window):
    """fp32 masked logits [b, n_kv, group, s, s]."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    qg = q.float().reshape(b, s, n_kv, n_q // n_kv, hd)
    logits = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * hd**-0.5
    return logits.masked_fill(~_mask(s, causal, window, q.device), NEG_INF)


def _rows(x, k):
    """[b, n_q, s] row statistic -> [b, n_kv, group, s, 1]."""
    b, n_q, s = x.shape
    n_kv = k.shape[2]
    return x.float().reshape(b, n_kv, n_q // n_kv, s)[..., None]


def flash_fwd_plain(q, k, v, *, causal=True, window=None):
    """Plain forward: -> (o in q's dtype, lse [b, n_q, s] fp32)."""
    _check_args(q, k, v, causal, window)
    b, s, n_q, hd = q.shape
    logits = _logits(q, k, causal, window)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bngst,btnh->bsngh", p, v.float())
    return o.reshape(b, s, n_q, hd).to(q.dtype), lse.reshape(b, n_q, s)


def _p_and_ds(q, k, v, do, lse, delta, causal, window):
    """P = exp(logits - lse) and dS = P * (dO V^T - delta), fp32
    [b, n_kv, group, s, s]."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    p = torch.exp(_logits(q, k, causal, window) - _rows(lse, k))
    dog = do.float().reshape(b, s, n_kv, n_q // n_kv, hd)
    dp = torch.einsum("bsngh,btnh->bngst", dog, v.float())
    return p, p * (dp - _rows(delta, k))


def flash_dq_plain(q, k, v, do, lse, delta, *, causal=True, window=None):
    """Plain dQ = dS K * scale, in q's dtype."""
    b, s, n_q, hd = q.shape
    _, ds = _p_and_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.einsum("bngst,btnh->bsngh", ds, k.float()) * hd**-0.5
    return dq.reshape(b, s, n_q, hd).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal=True, window=None):
    """Plain (dK, dV) = (dS^T Q * scale, P^T dO), group-summed onto the
    KV heads, in k's and v's dtype."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal, window)
    qg = q.float().reshape(b, s, n_kv, n_q // n_kv, hd)
    dog = do.float().reshape(b, s, n_kv, n_q // n_kv, hd)
    dk = torch.einsum("bngst,bsngh->btnh", ds, qg) * hd**-0.5
    dv = torch.einsum("bngst,bsngh->btnh", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bf16_slack(q, k, v, do, lse, delta, *, causal=True, window=None):
    """-> (o_mag, dq_mag [b, s, n_q, hd], dk_mag, dv_mag [b, s, n_kv,
    hd]) fp32: P |V|, scale |dS| |K|, scale |dS|^T |Q| and P^T |dO|, the
    last two group-summed like dK and dV.

    The bf16 kernels round P (forward), dS (dQ), and P^T and dS^T
    (dK/dV) to bf16 before their products; each rounded term errs by at
    most 2**-8 of itself, so a kernel differs from the fp32 plain
    version by at most 2**-8 times these sums of absolute terms. For the
    card's checks and the tests; no kernel path calls it."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal, window)
    o = torch.einsum("bngst,btnh->bsngh", p, v.float().abs())
    dq = torch.einsum("bngst,btnh->bsngh", ds.abs(),
                      k.float().abs()) * hd**-0.5
    qg = q.float().abs().reshape(b, s, n_kv, n_q // n_kv, hd)
    dog = do.float().abs().reshape(b, s, n_kv, n_q // n_kv, hd)
    dk = torch.einsum("bngst,bsngh->btnh", ds.abs(), qg) * hd**-0.5
    dv = torch.einsum("bngst,bsngh->btnh", p, dog)
    return (o.reshape(b, s, n_q, hd), dq.reshape(b, s, n_q, hd), dk, dv)


def flash_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [b, n_q, s] (the reference's
    `_bwd` computes it outside its kernels too)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _kernel_checks(q, tensors):
    b, s, n_q, hd = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS[q.dtype]} "
                         f"for {q.dtype}, got head_dim {hd}")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous, 16-byte "
                             "aligned tensors on one CUDA device")


def _same_dtype(q, *ts):
    if any(t.dtype != q.dtype for t in ts):
        raise ValueError("q, k, v and dO must share one dtype, got "
                         f"{[t.dtype for t in (q, *ts)]}")


def _stats(q, *ts):
    b, s, n_q, _ = q.shape
    for t in ts:
        if tuple(t.shape) != (b, n_q, s) or t.dtype != torch.float32:
            raise ValueError(f"lse/delta must be float32 [b, n_q, s] = "
                             f"{(b, n_q, s)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _tail(q, k, causal, window):
    b, s, n_q, hd = q.shape
    return (b, s, n_q, k.shape[2], hd, int(causal), window or 0, hd**-0.5,
            _DTYPES[q.dtype])


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def default_head_splits(b, s, n_q, n_kv, hd):
    """Query-head subgroups of each GQA group for the bf16 dK/dV kernel,
    from the shapes alone: the smallest power of two dividing the group
    that gives the grid DKV_MIN_BLOCKS blocks (or the whole group). 1 at
    llama3-1b's training shape (512 blocks: the in-kernel group sum), 2
    at gemma-2b's (one KV head: 128 blocks unsplit)."""
    group = n_q // n_kv
    blocks = n_kv * b * -(-s // 64) * (hd // 128)
    splits = 1
    while (blocks * splits < DKV_MIN_BLOCKS and group % (2 * splits) == 0):
        splits *= 2
    return splits


def flash_block_fwd(q, k, v, *, causal, window=None):
    """Forward: -> (normalised o [b, s, n_q, hd] in q's dtype, lse
    [b, n_q, s] fp32). CPU tensors take `flash_fwd_plain`."""
    global fwd_launches
    _check_args(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    _same_dtype(q, k, v)
    _kernel_checks(q, (q, k, v))
    b, s, n_q, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, n_q, s, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd", _FWD_ARGS)
    err = lib.kft_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_tail(q, k, causal, window), _stream(q))
    _build.check(lib, err, "flash_attention_fwd")
    fwd_launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, *, causal=True, window=None):
    """dQ [b, s, n_q, hd] in q's dtype. CPU tensors take
    `flash_dq_plain`."""
    global dq_launches
    _check_args(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal=causal,
                              window=window)
    _same_dtype(q, k, v, do)
    _stats(q, lse, delta)
    _kernel_checks(q, (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention_dq", _DQ_ARGS)
    err = lib.kft_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_tail(q, k, causal, window), _stream(q))
    _build.check(lib, err, "flash_attention_dq")
    dq_launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal=True, window=None,
              head_splits=None):
    """(dK, dV) [b, s, n_kv, hd], group-summed, in k's dtype. CPU
    tensors take `flash_dkv_plain`. `head_splits` (bf16 only; default
    `default_head_splits`) splits each group's query heads over that many
    blocks a key tile, whose fp32 partials are summed here."""
    global dkv_launches
    _check_args(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                               window=window)
    _same_dtype(q, k, v, do)
    _stats(q, lse, delta)
    _kernel_checks(q, (q, k, v, do, lse, delta))
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    splits = head_splits
    if splits is None:
        splits = (default_head_splits(b, s, n_q, n_kv, hd)
                  if q.dtype == torch.bfloat16 else 1)
    if splits < 1 or (n_q // n_kv) % splits or (
            splits > 1 and q.dtype != torch.bfloat16):
        raise ValueError(f"head_splits {splits} must divide the group "
                         f"{n_q // n_kv} (and be 1 for {q.dtype})")
    if splits == 1:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    else:
        dk, dv = (torch.empty(b, s, n_kv, splits, hd, dtype=torch.float32,
                              device=q.device) for _ in range(2))
    lib = _build.load("flash_attention_dkv", _DKV_ARGS)
    err = lib.kft_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, causal, window), splits, _stream(q))
    _build.check(lib, err, "flash_attention_dkv")
    dkv_launches += 1
    if splits > 1:  # the group sum, as the reference places it
        dk, dv = dk.sum(3).to(k.dtype), dv.sum(3).to(v.dtype)
    return dk, dv


def flash_block_bwd(res, do, *, causal, window=None):
    """res = (q, k, v, o, lse) -> (dq, dk, dv), dk and dv group-summed.
    With `flash_block_fwd` this is the reference's block-level contract
    (for a later ring-attention slice): o and lse may be merged totals."""
    q, k, v, o, lse = res
    delta = flash_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=causal,
                       window=window)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's custom VJP: forward saves (q, k, v, o, lse), the
    backward runs the dQ and dK/dV kernels on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_block_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_block_bwd(ctx.saved_tensors, do.contiguous(),
                                     causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=None):
    """Differentiable flash attention with GQA: [b, s, heads, hd] in and
    out, as `ops.attention.dot_product_attention`."""
    _check_args(q, k, v, causal, window)
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal, window)
