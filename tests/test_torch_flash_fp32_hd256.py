"""fp32 flash attention at head dim 256 (gemma-2b's heads: 8 query heads
over one KV head), through the block entry points whose CUDA kernels
take it now (`flash_block_fwd`, `flash_dq`, `flash_dkv` via
`flash_block_bwd`), against the JAX reference's Pallas flash kernels in
interpret mode, on the CPU (where the wrappers take their plain
versions), and the wrappers' head-dim table.

Same inputs from a numpy seed, fp32 on both sides, at a sequence off
the kernels' 64-row tile (s 200; the reference in 128-row blocks),
causal with a window (tests/test_torch_flash.py holds the full
`flash_attention` at this head geometry, causal and not). The fp32
dK/dV kernel's head-subgroup split, emulated (each subgroup through the
plain version, partials summed), against the same reference backward,
and non-causal at a group of 4. Tolerances are the existing fp32
cases' (tests/test_torch_flash.py): atol = rtol = 1e-5 for o and lse,
2e-5 for the gradients.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash import check_fp32_split

from kubeflow_tpu_torch.ops.cuda import flash_attention as tflash

jflash = importlib.import_module("kubeflow_tpu.ops.pallas.flash_attention")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def test_fp32_kernels_take_head_dim_256():
    """Both dtypes' kernels take llama's 128 and gemma's 256."""
    assert tflash.HEAD_DIMS[torch.float32] == (128, 256)
    assert tflash.HEAD_DIMS[torch.bfloat16] == (128, 256)


def _reference(arrays, causal, window):
    """The reference's block forward and backward in interpret mode ->
    (o4, lse4, (dq4, dk4, dv4)), heads before sequence."""
    q, k, v, do = arrays
    j4 = [jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v)]
    jo4, jlse = jflash.flash_block_fwd(*j4, causal=causal, window=window,
                                       interpret=True, block_q=128,
                                       block_k=128)
    grads = jflash.flash_block_bwd(
        (*j4, jo4, jlse), jnp.transpose(jnp.asarray(do), (0, 2, 1, 3)),
        causal=causal, window=window, interpret=True, block_q=128,
        block_k=128)
    return jo4, jlse, grads


def _heads_last(w):
    return np.asarray(jnp.transpose(w, (0, 2, 1, 3)))


@pytest.fixture(scope="module")
def window_case():
    """gemma-2b's heads (8 over one KV head), s 200, causal, window 70:
    numpy inputs and the reference's outputs, shared by the tests."""
    rng = np.random.default_rng(22)
    b, s, hd = 1, 200, 256
    arrays = [rng.standard_normal((b, s, n, hd)).astype(np.float32)
              for n in (8, 1, 1, 8)]
    return arrays, dict(causal=True, window=70), _reference(arrays, True, 70)


@pytest.fixture(scope="module")
def noncausal_case():
    """A group of 4 over one KV head, s 72, non-causal."""
    rng = np.random.default_rng(24)
    arrays = [rng.standard_normal((1, 72, n, 256)).astype(np.float32)
              for n in (4, 1, 1, 4)]
    return (arrays, dict(causal=False, window=None),
            _reference(arrays, False, None))


def test_block_entry_points_at_head_dim_256(window_case):
    arrays, kw, (jo4, jlse, want) = window_case
    b, s, _, hd = arrays[0].shape
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    o, lse = tflash.flash_block_fwd(tq, tk, tv, **kw)
    assert o.dtype == torch.float32 and lse.shape == (b, 8, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               **FWD_TOL)
    np.testing.assert_allclose(o.numpy(), _heads_last(jo4), **FWD_TOL)
    got = tflash.flash_block_bwd((tq, tk, tv, o, lse), tdo, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _heads_last(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["window_case", "noncausal_case"])
def test_fp32_head_split_matches_reference_at_head_dim_256(request, case):
    """The split at the chooser's pick (the whole group at these sizes)
    and at 2 subgroups, partials summed, against the reference."""
    arrays, kw, (_, _, (_, jdk, jdv)) = request.getfixturevalue(case)
    check_fp32_split(*(torch.from_numpy(a) for a in arrays),
                     [_heads_last(w) for w in (jdk, jdv)], **kw)
