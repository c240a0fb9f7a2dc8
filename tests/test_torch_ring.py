"""The port's sequence parallelism (parallel/ring.py) against the JAX
reference, on the CPU: ring attention (plain and flash), Ulysses ("xla"
and "flash") over 4 gloo ranks, ring sizes 2 (a (data 2, fsdp 2) mesh)
and 4 (fsdp 4), causal and bidirectional, GQA (n_q 4, n_kv 2) and MHA.

All torch-side cases run in one spawn of a 4-rank gloo gang
(tests/torch_dist.py); the parent computes the reference: dense XLA
attention over the gathered sequence and its gradients, the
reference's own plain ring and Ulysses, and its ring over the Pallas
flash blocks in interpret mode (once, ring 4, causal). On the CPU the
port's flash blocks run their plain fp32 versions.

Tolerances (fp32, other summation orders): outputs within 2e-5, the
gradients of sum(o^2) within 1e-4 (the reference's ring tests use 2e-5
and, for flash, 2e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubeflow_tpu.ops.attention import dot_product_attention
from kubeflow_tpu.parallel import ring as jring
from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh
from kubeflow_tpu_torch.parallel import ring
from kubeflow_tpu_torch.parallel.comm import AxisGroup
from torch_dist import run_gang

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(n_q, n_kv, b=2, s=32, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, n_q, hd), (b, s, n_kv, hd), (b, s, n_kv, hd)))


QKV = {"gqa": _qkv(4, 2), "mha": _qkv(4, 4, seed=1)}
ULYSSES = _qkv(8, 4, seed=2)


def _dense(causal):
    def fn(q, k, v):
        b, s = q.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        return dot_product_attention(q, k, v, pos, pos, causal=causal,
                                     impl="xla")
    return fn


def _with_grads(fn, q, k, v):
    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    out = fn(q, k, v)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return [np.asarray(out), *(np.asarray(g) for g in grads)]


@functools.lru_cache(maxsize=None)
def _dense_ref(heads, causal):
    qkv = ULYSSES if heads == "ulysses" else QKV[heads]
    return _with_grads(_dense(causal), *qkv)


def _seq_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(1, n, 1),
                ("data", "fsdp", "tensor"))


@pytest.fixture(scope="module")
def gang():
    return run_gang("ring_cases", 4, {"qkv": QKV, "ulysses": ULYSSES})


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = OUT_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(np.asarray(g), w, err_msg=f"{what} {i}",
                                   **tol)


def test_every_rank_returns_the_same_global_result(gang):
    for key, val in gang[0].items():
        if key == "local":
            continue
        for other in gang[1:]:
            for a, b in zip(val, other[key]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["ring", "ring_flash"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("heads", ["gqa", "mha"])
def test_ring_matches_dense_attention(gang, name, causal, size, heads):
    """Output and q/k/v gradients equal dense attention over the whole
    sequence."""
    want = _dense_ref(heads, causal)
    _close(gang[0][(heads, size, causal, name)], want,
           f"{name} {heads} {size} {causal}")


def _jit_out(fn, q, k, v):
    return np.asarray(jax.jit(fn)(*(jnp.asarray(x) for x in (q, k, v))))


@pytest.mark.parametrize("size", [2, 4])
def test_plain_ring_matches_reference_ring(gang, size):
    """Outputs equal the reference's own ring (its gradients are held
    to dense attention above, as the port's are)."""
    want = _jit_out(lambda q, k, v: jring.ring_attention_sharded(
        q, k, v, _seq_mesh(size), causal=True), *QKV["gqa"])
    np.testing.assert_allclose(
        gang[0][("gqa", size, True, "ring")][0].numpy(), want, **OUT_TOL)


def test_ring_flash_matches_reference_ring_flash(gang):
    """The reference's ring over Pallas flash blocks (interpret mode)."""
    want = _jit_out(lambda q, k, v: jring.ring_flash_attention_sharded(
        q, k, v, _seq_mesh(4), causal=True), *QKV["gqa"])
    np.testing.assert_allclose(
        gang[0][("gqa", 4, True, "ring_flash")][0].numpy(), want,
        **OUT_TOL)


def test_per_rank_entry_point_gives_its_block(gang):
    """`ring_flash_attention` on each rank's own block returns that
    rank's block of the global output."""
    want = _dense_ref("gqa", True)[0]
    for r, res in enumerate(gang):
        np.testing.assert_allclose(res["local"].numpy(),
                                   np.split(want, 4, axis=1)[r], **OUT_TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_reference(gang, impl, causal):
    """Ulysses over 4 ranks (n_q 8, n_kv 4): output and gradients equal
    dense attention, and the output the reference's Ulysses."""
    got = gang[0][("ulysses", causal, impl)]
    _close(got, _dense_ref("ulysses", causal), f"dense {impl}")
    if impl == "xla":
        want = _jit_out(lambda q, k, v: jring.ulysses_attention_sharded(
            q, k, v, _seq_mesh(4), causal=causal, impl="xla"), *ULYSSES)
        np.testing.assert_allclose(got[0].numpy(), want, **OUT_TOL)


def test_refusals_name_the_problem():
    """The reference's refusals, in its words: heads not divisible by
    the axis, an unknown impl, a sequence not divisible by the ring."""
    group = AxisGroup("fsdp", (0, 1, 2, 3), 0)
    q, k, v = (torch.zeros(1, 8, h, 16) for h in (8, 2, 2))
    with pytest.raises(ValueError, match="divisible by axis size"):
        ring.ulysses_attention(q, k, v, group=group)
    with pytest.raises(ValueError, match="impl must be"):
        ring.ulysses_attention(q, k, v, group=group, impl="pallas")
    mesh = create_mesh(MeshSpec(data=1, fsdp=4), devices=range(4))
    q = torch.zeros(1, 6, 2, 16)
    with pytest.raises(ValueError, match="not divisible by fsdp=4"):
        ring.ring_flash_attention_sharded(q, q, q, mesh)
