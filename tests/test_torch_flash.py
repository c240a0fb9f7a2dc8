"""The port's flash attention (its plain versions, which a CPU tensor
takes) against the JAX reference's Pallas flash kernels in interpret
mode, and the attention dispatcher's routing.

Same inputs from a numpy seed, fp32 on both sides. Tolerance: atol =
rtol = 1e-5 for the forward and lse (the reference's online softmax over
32/64-wide blocks against the port's one-pass softmax differ by fp32
rounding, ~1e-7 here); 2e-5 for gradients, which add two more fp32
contractions over s = 128.
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
# (n_q, n_kv, causal, window)
CASES = [(4, 2, True, None), (4, 2, False, None), (4, 2, True, 9),
         (4, 4, True, None), (4, 1, True, 9)]
IDS = ["gqa_causal", "gqa_noncausal", "gqa_window9", "mha_causal",
       "mqa_window9"]


def _qkv(n_q, n_kv, b=2, s=128, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, hd)).astype(np.float32)
                 for n in (n_q, n_kv, n_kv))


def _t(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("n_q,n_kv,causal,window", CASES, ids=IDS)
@pytest.mark.parametrize("block", [32, 64])
def test_forward_matches_reference(n_q, n_kv, causal, window, block):
    q, k, v = _qkv(n_q, n_kv)
    want = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=block, block_k=block, interpret=True)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)


@pytest.mark.parametrize("n_q,n_kv,causal,window", CASES, ids=IDS)
def test_gradients_match_reference(n_q, n_kv, causal, window):
    q, k, v = _qkv(n_q, n_kv, seed=1)

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
    assert tattn.impl_counts() == {"flash": 0, "torch": 2}
    tattn.reset_impl_counts()
    assert tattn.impl_counts() == {"flash": 0, "torch": 0}


@pytest.mark.parametrize("kwargs,msg", [
    (dict(contiguous_positions=True), "needs CUDA tensors"),
    (dict(impl="bogus"), "attention impl must be one of"),
])
def test_dispatch_rejects(kwargs, msg):
    kwargs.setdefault("impl", "flash")
    with pytest.raises(ValueError, match=msg):
        tattn.dot_product_attention(*_dpa_args(), **kwargs)
