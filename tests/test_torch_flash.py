"""The port's flash attention (its plain versions, which a CPU tensor
takes) against the JAX reference's Pallas flash kernels in interpret
mode, and the attention dispatcher's routing.

Same inputs from a numpy seed, fp32 on both sides. Tolerance: atol =
rtol = 1e-5 for the forward and lse (the reference's online softmax over
32/64-wide blocks against the port's one-pass softmax differ by fp32
rounding, ~1e-7 here); 2e-5 for gradients, which add two more fp32
contractions over s <= 256. Head dims 64 and, at gemma-2b's head
geometry (8 query heads over one KV head), 256. The dK/dV kernels'
head-subgroup split is emulated: fp32 partials per subgroup, each
through the plain version, summed, equal the group-summed plain version
to fp32 rounding (1e-5) and, in fp32 at head dim 128, the reference's
Pallas backward (2e-5; head dim 256 in test_torch_flash_fp32_hd256.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.cuda import flash_attention as tflash
from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

# the package re-exports the function under the module's name
jflash = importlib.import_module("kubeflow_tpu.ops.pallas.flash_attention")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)
# (n_q, n_kv, causal, window, (b, s, hd)); the gemma_heads cases have
# gemma-2b's head geometry (8 query heads over one KV head of 256)
SMALL, GEMMA_S128, GEMMA_S256 = (2, 128, 64), (1, 128, 256), (1, 256, 256)
CASES = [(4, 2, True, None, SMALL), (4, 2, False, None, SMALL),
         (4, 2, True, 9, SMALL), (4, 4, True, None, SMALL),
         (4, 1, True, 9, SMALL), (8, 1, True, None, GEMMA_S256),
         (8, 1, True, 100, GEMMA_S256), (8, 1, False, None, GEMMA_S128)]
IDS = ["gqa_causal", "gqa_noncausal", "gqa_window9", "mha_causal",
       "mqa_window9", "gemma_heads_causal", "gemma_heads_window100",
       "gemma_heads_noncausal"]


def _qkv(n_q, n_kv, b=2, s=128, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, hd)).astype(np.float32)
                 for n in (n_q, n_kv, n_kv))


def _t(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("n_q,n_kv,causal,window,shape", CASES, ids=IDS)
@pytest.mark.parametrize("block", [32, 64])
def test_forward_matches_reference(n_q, n_kv, causal, window, shape, block):
    b, s, hd = shape
    q, k, v = _qkv(n_q, n_kv, b, s, hd)
    want = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=block, block_k=block, interpret=True)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)


@pytest.mark.parametrize("n_q,n_kv,causal,window,shape", CASES, ids=IDS)
def test_gradients_match_reference(n_q, n_kv, causal, window, shape):
    b, s, hd = shape
    q, k, v = _qkv(n_q, n_kv, b, s, hd, seed=1)

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, causal=causal, window=window,
                                   block_q=32, block_k=64, interpret=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v)
    o = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    (o * torch.cos(o)).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"grad w.r.t. {name}")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, None)])
def test_block_entry_points_match_reference(causal, window):
    """flash_block_fwd's lse is the reference's lane-replicated lse
    column 0; flash_block_bwd matches the reference's on the same
    residuals and cotangent."""
    q, k, v = _qkv(4, 2, seed=2)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(
        np.float32)
    j4 = [jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v)]
    jo4, jlse = jflash.flash_block_fwd(*j4, causal=causal, window=window,
                                       interpret=True, block_q=32,
                                       block_k=32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tflash.flash_block_fwd(tq, tk, tv, causal=causal,
                                    window=window)
    assert lse.shape == (2, 4, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               **FWD_TOL)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jnp.transpose(jo4, (0, 2, 1, 3))), **FWD_TOL)
    want = jflash.flash_block_bwd(
        (*j4, jo4, jlse), jnp.transpose(jnp.asarray(do), (0, 2, 1, 3)),
        causal=causal, window=window, interpret=True, block_q=32,
        block_k=32)
    got = tflash.flash_block_bwd((tq, tk, tv, o, lse), torch.from_numpy(do),
                                 causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jnp.transpose(w, (0, 2, 1, 3))),
            **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,want", [
    ((2, 2048, 16, 8, 128), 1),   # llama3-1b training: 512 blocks
    ((2, 2048, 8, 1, 256), 2),    # gemma-2b training: 128 blocks unsplit
    ((1, 200, 8, 1, 256), 8),     # few blocks: the whole group
    ((1, 200, 4, 2, 128), 2),
    ((1, 1024, 8, 8, 128), 1),    # no group to split
    # the fp32 kernel's chooser (no column parts)
    ((2, 2048, 16, 8, 128, torch.float32), 1),   # llama3-1b: 512 blocks
    ((2, 2048, 8, 1, 256, torch.float32), 4),    # gemma-2b: 64 unsplit
    ((2, 2048, 32, 8, 128, torch.float32), 1),   # Mixtral: 512 blocks
    ((2, 1000, 8, 1, 256, torch.float32), 8),    # 32 blocks: the group
    ((1, 200, 4, 2, 128, torch.float32), 2),
])
def test_default_head_splits(shape, want):
    assert tflash.default_head_splits(*shape) == want


def split_partials(q, k, v, do, lse, delta, splits, **kw):
    """The dK/dV kernels' split, emulated: block (KV head hk, subgroup
    sub) takes query heads hk * group + sub * heads + [0, heads), each
    piece through the plain version -> fp32 partials [b, s, n_kv,
    splits, hd] of dK and dV."""
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    group, heads = n_q // n_kv, n_q // n_kv // splits
    parts = torch.zeros(2, b, s, n_kv, splits, hd)
    for hk in range(n_kv):
        for sub in range(splits):
            hs = slice(hk * group + sub * heads, hk * group + (sub + 1) * heads)
            got = tflash.flash_dkv_plain(
                q[:, :, hs], k[:, :, hk:hk + 1], v[:, :, hk:hk + 1],
                do[:, :, hs], lse[:, hs], delta[:, hs], **kw)
            for i, g in enumerate(got):
                parts[i, :, :, hk, sub] = g[:, :, 0]
    return parts


@pytest.mark.parametrize("n_q,n_kv,splits", [(8, 1, 4), (8, 2, 2)])
def test_head_split_partials_sum_to_the_group(n_q, n_kv, splits):
    """The split's partials sum over splits to the group-summed dK and
    dV; `flash_dkv_partials_plain` gives the same partials."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(n_q, n_kv, 1, 64, 32))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape).astype(np.float32))
    o, lse = tflash.flash_fwd_plain(q, k, v, causal=True)
    delta = tflash.flash_delta(o, do)
    parts = split_partials(q, k, v, do, lse, delta, splits)
    want = tflash.flash_dkv_plain(q, k, v, do, lse, delta)
    for got, w in zip(parts.sum(4), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)
    for got, w in zip(tflash.flash_dkv_partials_plain(
            q, k, v, do, lse, delta, splits), parts):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


def check_fp32_split(q, k, v, do, want_dkv, **kw):
    """The fp32 split at the chooser's pick and at 2 subgroups: partials
    summed against the reference's dK and dV [b, s, n_kv, hd]."""
    b, s, n_q, hd = q.shape
    o, lse = tflash.flash_block_fwd(q, k, v, **kw)
    delta = tflash.flash_delta(o, do)
    chosen = tflash.default_head_splits(b, s, n_q, k.shape[2], hd,
                                        torch.float32)
    assert chosen == n_q // k.shape[2]   # few blocks: the whole group
    for splits in (chosen, 2):
        parts = split_partials(q, k, v, do, lse, delta, splits, **kw)
        for name, got, w in zip(("dk", "dv"), parts.sum(4), want_dkv):
            np.testing.assert_allclose(got.numpy(), w, **GRAD_TOL,
                                       err_msg=f"{name} at {splits}")


@pytest.fixture(scope="module")
def fp32_hd128_cases():
    """Inputs at head dim 128, a group of 4 over one KV head, s 100 (off
    the 64-row tile), and the reference's dK and dV for each case."""
    rng = np.random.default_rng(23)
    q, k, v, do = (rng.standard_normal((1, 100, n, 128)).astype(np.float32)
                   for n in (4, 1, 1, 4))
    j4 = [jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v)]
    jdo = jnp.transpose(jnp.asarray(do), (0, 2, 1, 3))
    cases = {}
    for name, kw in (("window37", dict(causal=True, window=37)),
                     ("noncausal", dict(causal=False, window=None))):
        jo, jlse = jflash.flash_block_fwd(*j4, interpret=True, block_q=128,
                                          block_k=128, **kw)
        _, jdk, jdv = jflash.flash_block_bwd(
            (*j4, jo, jlse), jdo, interpret=True, block_q=128, block_k=128,
            **kw)
        cases[name] = (kw, [np.asarray(jnp.transpose(w, (0, 2, 1, 3)))
                            for w in (jdk, jdv)])
    return [torch.from_numpy(a) for a in (q, k, v, do)], cases


@pytest.mark.parametrize("case", ["window37", "noncausal"])
def test_fp32_head_split_matches_reference(fp32_hd128_cases, case):
    """The fp32 dK/dV kernel's split, emulated at head dim 128 (each
    subgroup through the plain version, partials summed), against the
    reference's Pallas backward in interpret mode."""
    tensors, cases = fp32_hd128_cases
    kw, want = cases[case]
    check_fp32_split(*tensors, want, **kw)


def test_cpu_tensors_take_plain_versions():
    reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, s=40))
    o, lse = tflash.flash_block_fwd(q, k, v, causal=True)
    want_o, want_lse = tflash.flash_fwd_plain(q, k, v, causal=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    delta = tflash.flash_delta(o, q)
    assert torch.equal(tflash.flash_dq(q, k, v, q, lse, delta),
                       tflash.flash_dq_plain(q, k, v, q, lse, delta))
    for got, want in zip(tflash.flash_dkv(q, k, v, q, lse, delta),
                         tflash.flash_dkv_plain(q, k, v, q, lse, delta)):
        assert torch.equal(got, want)
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("kwargs,shapes,msg", [
    (dict(causal=True, window=0), ((4, 2), 16), "window must be >= 1"),
    (dict(causal=False, window=4), ((4, 2), 16),
     "sliding window requires causal"),
    (dict(causal=True), ((3, 2), 16), "not a multiple of n_kv"),
    (dict(causal=True), ((4, 2), 8), "equal q/kv sequence lengths"),
])
def test_argument_checks(kwargs, shapes, msg):
    (n_q, n_kv), s_kv = shapes
    q = torch.zeros(1, 16, n_q, 8)
    k = torch.zeros(1, s_kv, n_kv, 8)
    with pytest.raises(ValueError, match=msg):
        tflash.flash_attention(q, k, k, **kwargs)


def _dpa_args(s=16, b=1):
    q = torch.zeros(b, s, 4, 8)
    k = torch.zeros(b, s, 2, 8)
    pos = torch.arange(s).expand(b, s)
    return q, k, k, pos, pos


def test_dispatch_routes_and_counts():
    tattn.reset_impl_counts()
    # auto on the CPU takes the plain path even where the card would
    # take flash (s >= 1024, s % 512 == 0, causal, contiguous)
    tattn.dot_product_attention(*_dpa_args(s=1024),
                                contiguous_positions=True)
    tattn.dot_product_attention(*_dpa_args(), impl="torch")
    assert tattn.impl_counts() == {"flash": 0, "decode": 0, "torch": 2}
    tattn.reset_impl_counts()
    assert tattn.impl_counts() == {"flash": 0, "decode": 0, "torch": 0}


@pytest.mark.parametrize("kwargs,msg", [
    (dict(contiguous_positions=True), "needs CUDA tensors"),
    (dict(impl="bogus"), "attention impl must be one of"),
])
def test_dispatch_rejects(kwargs, msg):
    kwargs.setdefault("impl", "flash")
    with pytest.raises(ValueError, match=msg):
        tattn.dot_product_attention(*_dpa_args(), **kwargs)
