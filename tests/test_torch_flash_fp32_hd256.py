"""fp32 flash attention at head dim 256 (gemma-2b's heads: 8 query heads
over one KV head), through the block entry points whose CUDA kernels
take it now (`flash_block_fwd`, `flash_dq`, `flash_dkv` via
`flash_block_bwd`), against the JAX reference's Pallas flash kernels in
interpret mode, on the CPU (where the wrappers take their plain
versions), and the wrappers' head-dim table.

Same inputs from a numpy seed, fp32 on both sides, at a sequence off
the kernels' 64-row tile (s 200; the reference in 128-row blocks),
causal with a window (tests/test_torch_flash.py holds the full
`flash_attention` at this head geometry, causal and not). Tolerances are the existing fp32
cases' (tests/test_torch_flash.py): atol = rtol = 1e-5 for o and lse,
2e-5 for the gradients.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import torch

from kubeflow_tpu_torch.ops.cuda import flash_attention as tflash

jflash = importlib.import_module("kubeflow_tpu.ops.pallas.flash_attention")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def test_fp32_kernels_take_head_dim_256():
    """Both dtypes' kernels take llama's 128 and gemma's 256."""
    assert tflash.HEAD_DIMS[torch.float32] == (128, 256)
    assert tflash.HEAD_DIMS[torch.bfloat16] == (128, 256)


def test_block_entry_points_at_head_dim_256():
    causal, window = True, 70
    rng = np.random.default_rng(22)
    b, s, hd = 1, 200, 256
    q, k, v, do = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
                   for n in (8, 1, 1, 8))
    j4 = [jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v)]
    jo4, jlse = jflash.flash_block_fwd(*j4, causal=causal, window=window,
                                       interpret=True, block_q=128,
                                       block_k=128)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tflash.flash_block_fwd(tq, tk, tv, causal=causal,
                                    window=window)
    assert o.dtype == torch.float32 and lse.shape == (b, 8, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               **FWD_TOL)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jnp.transpose(jo4, (0, 2, 1, 3))), **FWD_TOL)
    want = jflash.flash_block_bwd(
        (*j4, jo4, jlse), jnp.transpose(jnp.asarray(do), (0, 2, 1, 3)),
        causal=causal, window=window, interpret=True, block_q=128,
        block_k=128)
    got = tflash.flash_block_bwd((tq, tk, tv, o, lse), torch.from_numpy(do),
                                 causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jnp.transpose(w, (0, 2, 1, 3))),
            **GRAD_TOL, err_msg=f"d{name}")
