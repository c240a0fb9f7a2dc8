"""The bf16 flash kernels' rounding, emulated in plain PyTorch on the
CPU, against the bound the card holds them to.

The tensor-core kernels (csrc/flash_attention_fwd.cu,
csrc/flash_attention_dq.cu and csrc/flash_attention_dkv.cu) take bf16
q, k, v and dO, accumulate every product in fp32, and round P
(forward), dS (dQ), and P^T and dS^T (dK/dV) to bf16 before their
products. The emulations below walk the same 64-key tiles (forward and
dQ: `key_tiles` of each 64-query tile; the forward with its online
softmax) and 64-query tiles (dK/dV: `query_tiles` of each 64-key tile)
and round at the same points. They must meet |err| <= c max|ref| +
2**-7 |ref| + 2**-8 mag (c = 1e-4) against the fp32 plain versions,
with mag from `flash_bf16_slack`; without the 2**-8 mag term they
exceed it (the rounding is larger than one bf16 ulp of the result),
and a plain version that leaves each query's own key out exceeds it
too.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops.cuda import flash_attention as tflash
from torch_cases import dropped_diagonal, flash_err_ratio

TILE = 64
C, RTOL = 1e-4, 2**-7          # the bf16 bound's first two terms
SEQS = [131, 200, 256]         # a ragged tail, and whole tiles
MASKS = {"causal": (True, None), "window37": (True, 37),
         "noncausal": (False, None)}


def _inputs(s, seed=0, b=1, n_q=4, n_kv=2, hd=128):
    rng = np.random.default_rng(seed + s)
    q, do = (torch.from_numpy(rng.standard_normal((b, s, n_q, hd))
                              .astype(np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, n_kv, hd))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))
    return q, k, v, do


def _bf16(x):
    return x.bfloat16().float()


def _key_tiles(q0, n, causal, window):
    if not causal:
        return range(n)
    lo = max(0, q0 - window + 1) // TILE if window else 0
    return range(lo, min(n - 1, q0 // TILE) + 1)


def _query_tiles(k0, n, causal, window):
    if not causal:
        return range(n)
    hi = min(n - 1, (k0 + TILE - 1 + window - 1) // TILE) if window \
        else n - 1
    return range(k0 // TILE, hi + 1)


def _grouped(x, n_kv):
    """[b, s, n_q, hd] -> fp32 [b, n_kv, group, s, hd]."""
    b, s, n_q, hd = x.shape
    return x.float().reshape(b, s, n_kv, n_q // n_kv, hd).permute(
        0, 2, 3, 1, 4)


def emulate_fwd(q, k, v, causal, window):
    """The forward kernel's arithmetic: online softmax over the visited
    key tiles, P rounded to bf16 before P V, l summing unrounded P."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    n = -(-s // TILE)
    mask = tflash._mask(s, causal, window, q.device)
    qg = _grouped(q, n_kv)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # b n s d
    o = torch.zeros_like(qg)
    lse = torch.zeros(qg.shape[:-1])
    for q0 in range(0, s, TILE):
        qt = qg[..., q0:q0 + TILE, :]
        m = torch.full(qt.shape[:-1], tflash.NEG_INF)
        l = torch.zeros(qt.shape[:-1])
        acc = torch.zeros_like(qt)
        for ki in _key_tiles(q0, n, causal, window):
            k0 = ki * TILE
            x = torch.einsum("bngqd,bnkd->bngqk", qt,
                             kf[:, :, k0:k0 + TILE]) * hd**-0.5
            x = x.masked_fill(~mask[q0:q0 + TILE, k0:k0 + TILE],
                              tflash.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp(x - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bngqk,bnkd->bngqd", _bf16(p), vf[:, :, k0:k0 + TILE])
            m = m_new
        o[..., q0:q0 + TILE, :] = acc / l[..., None]
        lse[..., q0:q0 + TILE] = m + torch.log(l)
    return (o.permute(0, 3, 1, 2, 4).reshape(b, s, n_q, hd).to(q.dtype),
            lse.reshape(b, n_q, s))


def emulate_dq(q, k, v, do, lse, delta, causal, window):
    """The dQ kernel's arithmetic: P and dS per (query tile, key tile)
    in fp32, dS rounded to bf16 before dQ += dS K."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    n = -(-s // TILE)
    mask = tflash._mask(s, causal, window, q.device)
    qg, dog = _grouped(q, n_kv), _grouped(do, n_kv)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    lse_g, delta_g = (x.float().reshape(b, n_kv, n_q // n_kv, s)
                      for x in (lse, delta))
    dq = torch.zeros_like(qg)
    for q0 in range(0, s, TILE):
        qs = slice(q0, q0 + TILE)
        for ki in _key_tiles(q0, n, causal, window):
            ks = slice(ki * TILE, ki * TILE + TILE)
            x = torch.einsum("bngqd,bnkd->bngqk", qg[..., qs, :],
                             kf[:, :, ks])
            p = torch.exp(x * hd**-0.5 - lse_g[..., qs, None])
            p = p * mask[qs, ks]
            dp = torch.einsum("bngqd,bnkd->bngqk", dog[..., qs, :],
                              vf[:, :, ks])
            ds = p * (dp - delta_g[..., qs, None])
            dq[..., qs, :] += torch.einsum("bngqk,bnkd->bngqd", _bf16(ds),
                                           kf[:, :, ks])
    dq = dq * hd**-0.5
    return dq.permute(0, 3, 1, 2, 4).reshape(b, s, n_q, hd).to(q.dtype)


def emulate_dkv(q, k, v, do, lse, delta, causal, window):
    """The dK/dV kernel's arithmetic: key-major P^T and dS^T per (key
    tile, query tile) in fp32, rounded to bf16 before dV += P^T dO and
    dK += dS^T Q, summed over the group."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    n = -(-s // TILE)
    mask = tflash._mask(s, causal, window, q.device)
    qg, dog = _grouped(q, n_kv), _grouped(do, n_kv)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    lse_g, delta_g = (x.float().reshape(b, n_kv, n_q // n_kv, s)
                      for x in (lse, delta))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, s, TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        for qi in _query_tiles(k0, n, causal, window):
            qs = slice(qi * TILE, qi * TILE + TILE)
            st = torch.einsum("bnkd,bngqd->bngkq", kt, qg[..., qs, :])
            pt = torch.exp(st * hd**-0.5 - lse_g[..., None, qs])
            pt = pt * mask[qs, k0:k0 + TILE].T
            dpt = torch.einsum("bnkd,bngqd->bngkq", vt, dog[..., qs, :])
            dst = pt * (dpt - delta_g[..., None, qs])
            dv[:, :, k0:k0 + TILE] += torch.einsum(
                "bngkq,bngqd->bnkd", _bf16(pt), dog[..., qs, :])
            dk[:, :, k0:k0 + TILE] += torch.einsum(
                "bngkq,bngqd->bnkd", _bf16(dst), qg[..., qs, :])
    dk = dk * hd**-0.5
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _reference(s, mask):
    """Inputs, the plain versions' outputs and the bound's magnitudes."""
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(s)
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, lse, tflash.flash_delta(o, do))
    dq = tflash.flash_dq_plain(*args, **kw)
    dk, dv = tflash.flash_dkv_plain(*args, **kw)
    return args, kw, (o, dq, dk, dv), tflash.flash_bf16_slack(*args, **kw)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("s", SEQS)
def test_forward_rounding_meets_bf16_bound(s, mask):
    (q, k, v, _, lse, _), kw, (o, *_), (o_mag, *_) = _reference(s, mask)
    got_o, got_lse = emulate_fwd(q, k, v, **kw)
    assert flash_err_ratio(got_o, o, C, RTOL, o_mag) <= 1
    assert flash_err_ratio(got_o, o, C, RTOL) > 1
    assert flash_err_ratio(got_lse, lse, 1e-5, 0.0) <= 1


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("s", SEQS)
def test_dq_rounding_meets_bf16_bound(s, mask):
    args, kw, (_, dq, _, _), (_, dq_mag, _, _) = _reference(s, mask)
    got = emulate_dq(*args, **kw)
    assert flash_err_ratio(got, dq, C, RTOL, dq_mag) <= 1
    assert flash_err_ratio(got, dq, C, RTOL) > 1


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("s", SEQS)
def test_dkv_rounding_meets_bf16_bound(s, mask):
    args, kw, (_, _, dk, dv), (_, _, dk_mag, dv_mag) = _reference(s, mask)
    got_dk, got_dv = emulate_dkv(*args, **kw)
    for got, want, mag in ((got_dk, dk, dk_mag), (got_dv, dv, dv_mag)):
        assert flash_err_ratio(got, want, C, RTOL, mag) <= 1
        assert flash_err_ratio(got, want, C, RTOL) > 1


@pytest.mark.parametrize("mask", ["causal", "window37"])
@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_dropped_diagonal_exceeds_bf16_bound(kind, s, mask):
    args, kw, (o, dq, dk, dv), (o_mag, dq_mag, dk_mag, dv_mag) = \
        _reference(s, mask)
    with dropped_diagonal(tflash):
        if kind == "fwd":
            pairs = [(tflash.flash_fwd_plain(*args[:3], **kw)[0], o, o_mag)]
        elif kind == "dq":
            pairs = [(tflash.flash_dq_plain(*args, **kw), dq, dq_mag)]
        else:
            pairs = list(zip(tflash.flash_dkv_plain(*args, **kw), (dk, dv),
                             (dk_mag, dv_mag)))
    for bad, want, mag in pairs:
        assert flash_err_ratio(bad, want, C, RTOL, mag) > 1


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("s", SEQS)
def test_slack_o_mag_is_forward_of_abs_v(s, mask):
    causal, window = MASKS[mask]
    q, k, v, do = (x.float() for x in _inputs(s))
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_fwd_plain(q, k, v, **kw)
    o_mag, *_ = tflash.flash_bf16_slack(q, k, v, do, lse,
                                        tflash.flash_delta(o, do), **kw)
    want, _ = tflash.flash_fwd_plain(q, k, v.abs(), **kw)
    torch.testing.assert_close(o_mag, want, atol=1e-6, rtol=1e-6)
