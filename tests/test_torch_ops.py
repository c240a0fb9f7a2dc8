"""The port's plain ops (kubeflow_tpu_torch.ops) against the JAX
reference (kubeflow_tpu.ops) on the same numpy inputs, on the CPU.

Tolerances: fp32 inputs agree to 1e-5 (both sides accumulate in fp32;
only the order of the sums and the sin/cos/rsqrt implementations
differ). bf16 outputs agree to one bf16 ulp (rtol 2**-7): both round
the same fp32 value, which may sit on either side of a rounding
boundary after those fp32 differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops.embedding import embed_lookup as jembed
from kubeflow_tpu.ops.norms import rms_norm as jrms
from kubeflow_tpu.ops.rotary import apply_rope as jrope
from kubeflow_tpu.ops.rotary import rope_frequencies as jfreq
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.embedding import embed_lookup as tembed
from kubeflow_tpu_torch.ops.norms import rms_norm as trms
from kubeflow_tpu_torch.ops.rotary import apply_rope as trope
from kubeflow_tpu_torch.ops.rotary import rope_frequencies as tfreq

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-6, rtol=2**-7)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = jrms(jnp.asarray(x, dtype), jnp.asarray(w), 1e-5)
    got = trms(torch.from_numpy(x).to(getattr(torch, dtype)),
               torch.from_numpy(w), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("theta", [500000.0, 10000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    hd = 32
    x = rng.normal(size=(2, 7, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(np.asarray(tfreq(hd, theta=theta)),
                               np.asarray(jfreq(hd, theta=theta)), **F32)
    want = jrope(jnp.asarray(x), jnp.asarray(pos), jfreq(hd, theta=theta))
    got = trope(torch.from_numpy(x), torch.from_numpy(pos),
                tfreq(hd, theta=theta))
    # angles up to ~1000 rad: fp32 sin/cos of large arguments differ by
    # a few ulp of the angle between libraries
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_embedding_matches_reference():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    want = jembed(jnp.asarray(table), jnp.asarray(toks), jnp.bfloat16)
    got = tembed(torch.from_numpy(table), torch.from_numpy(toks),
                 torch.bfloat16)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("n_q,n_kv,window,masked", [
    (8, 2, None, False), (4, 4, None, True), (8, 1, 5, True),
    (6, 3, 1, False)])
def test_dot_product_attention_matches_reference(n_q, n_kv, window,
                                                 masked):
    rng = np.random.default_rng(3)
    b, sq, skv, hd = 2, 6, 11, 16
    q = rng.normal(size=(b, sq, n_q, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, n_kv, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(5, 5 + sq, dtype=np.int32), (b, sq))
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv))
    mask = np.ones((b, skv), bool)
    if masked:
        mask[:, 2] = False
    want = jattn._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), causal=True, kv_mask=jnp.asarray(mask),
        window=window)
    got = tattn.dot_product_attention(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (q, k, v, qpos, kpos)),
        causal=True, kv_mask=torch.from_numpy(mask), window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_attention_doors():
    q = torch.zeros(1, 1, 4, 8)
    k = torch.zeros(1, 3, 2, 8)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    kpos = torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="causal"):
        tattn.dot_product_attention(q, k, k, pos, kpos, causal=False,
                                    window=2)
    with pytest.raises(ValueError, match="grouped"):
        tattn.dot_product_attention(q[:, :, :3], k, k, pos, kpos)
    pool = torch.zeros(4, 2, 2, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        tattn.paged_attention(q, pool, pool, table, pos, kpos[:, :1].expand(
            1, 4), impl="pallas")
    # the kernel path needs CUDA tensors: no silent CPU stand-in
    with pytest.raises(ValueError, match="CUDA"):
        tattn.paged_attention(q, pool, pool, table, pos,
                              torch.zeros(1, 4, dtype=torch.int32),
                              impl="cuda")


def test_device_resolution_never_falls_back(monkeypatch):
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
