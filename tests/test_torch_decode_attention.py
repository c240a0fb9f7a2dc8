"""The port's dense decode attention against the JAX reference, on the
CPU.

`decode_attention` on CPU tensors runs its plain PyTorch version; it is
held against the Pallas `decode_attention` (interpret mode) over the
reference test's cases: ragged cursors with two GQA shapes, left-pad
holes, a sliding window, cursor 0, and the multi-token rejection. Rows
with no visible cell are left out: there the Pallas kernel (and the
port's CUDA kernel) give 0, the plain path mean(V) (ops/attention.py).
Tolerance: fp32, atol = rtol = 1e-5 (one softmax vs an online one, sums
in another order).

The `impl="decode"` door of `dot_product_attention` keeps the
reference's errors, and its "auto" rule (`auto_impl`) takes the kernel
exactly where the reference takes its Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas.decode_attention import (
    decode_attention as j_decode,
)
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.cuda.decode_attention import decode_attention
from torch_cases import mk_dense

TOL = dict(atol=1e-5, rtol=1e-5)


def _both(q, k, v, pos, mask, window=None, block_k=64):
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pos), jnp.asarray(mask), window=window,
                    block_k=block_k)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(pos),
                           torch.from_numpy(mask), window=window)
    return got.numpy(), np.asarray(want)


# gemma-2b's heads: 8 query heads over one kv head of 256
@pytest.mark.parametrize("n_q,n_kv,hd", [
    pytest.param(4, 4, 32, id="4-4"), pytest.param(8, 2, 32, id="8-2"),
    pytest.param(8, 1, 256, id="gemma-heads")])
def test_matches_reference_ragged_cursors(n_q, n_kv, hd):
    q, k, v, pos, mask = mk_dense(0, b=4, max_len=256, n_q=n_q, n_kv=n_kv,
                                  hd=hd, pos=[3, 77, 128, 255], holes={})
    got, want = _both(q, k, v, pos, mask)
    np.testing.assert_allclose(got, want, **TOL)


def test_matches_reference_with_pad_holes():
    """Left-pad runs and a hole mid-prefix are excluded exactly as the
    reference's kv_mask excludes them."""
    q, k, v, pos, mask = mk_dense(1, b=3, max_len=128, n_q=4, n_kv=2,
                                  pos=[40, 90, 127],
                                  holes={0: (0, 5), 1: (10, 20)})
    got, want = _both(q, k, v, pos, mask, block_k=32)
    np.testing.assert_allclose(got, want, **TOL)


def test_matches_reference_sliding_window():
    q, k, v, pos, mask = mk_dense(2, b=2, max_len=128, n_q=4, n_kv=4,
                                  pos=[100, 127], holes={})
    got, want = _both(q, k, v, pos, mask, window=16, block_k=32)
    np.testing.assert_allclose(got, want, **TOL)


def test_window_batch_shape_matches_reference():
    """The window batcher's shape: one shared cursor, a left-pad run of
    a different length in each row."""
    q, k, v, pos, mask = mk_dense(
        3, b=4, max_len=256, n_q=8, n_kv=2, pos=[140] * 4,
        holes={0: (0, 123), 1: (0, 5), 2: (0, 60), 3: (0, 1)})
    got, want = _both(q, k, v, pos, mask)
    np.testing.assert_allclose(got, want, **TOL)


def test_fresh_row_cursor_zero():
    """Cursor 0: only the just-written cell is visible, so the output is
    that cell's value for every query head of the group."""
    q, k, v, pos, mask = mk_dense(4, b=1, max_len=64, n_q=2, n_kv=2,
                                  pos=[0], holes={})
    got, want = _both(q, k, v, pos, mask, block_k=16)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0, 0], v[0, 0], atol=1e-6)


def test_rejects_multi_token_queries():
    q, k, v, pos, _ = mk_dense(5, b=1, max_len=64, n_q=2, n_kv=2, pos=[0])
    q2 = torch.from_numpy(np.concatenate([q, q], axis=1))
    with pytest.raises(ValueError, match="s=1 only"):
        decode_attention(q2, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pos))


def test_rejects_bad_shapes():
    q, k, v, pos, mask = (torch.from_numpy(a) for a in mk_dense(
        5, b=2, max_len=64, n_q=4, n_kv=2, pos=[0, 1]))
    with pytest.raises(ValueError, match="q_positions"):
        decode_attention(q, k, v, pos[:1])
    with pytest.raises(ValueError, match="kv_mask"):
        decode_attention(q, k, v, pos, mask[:, :10])
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, v, pos, mask, window=0)
    with pytest.raises(ValueError, match="grouped"):
        decode_attention(q[:, :, :3], k, v, pos)


def _door(impl, *, s=1, causal=True, contiguous=True):
    q = torch.zeros(1, s, 2, 16)
    k = torch.zeros(1, 256, 2, 16)
    return tattn.dot_product_attention(
        q, k, k, torch.full((1, s), 5), torch.arange(256)[None],
        causal=causal, impl=impl, contiguous_positions=contiguous)


def test_decode_door_errors_match_reference():
    with pytest.raises(ValueError, match="causal-only"):
        _door("decode", causal=False)
    with pytest.raises(ValueError, match="cell index"):
        _door("decode", contiguous=False)
    with pytest.raises(ValueError, match="s=1"):
        _door("decode", s=2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _door("decode")


def test_auto_on_cpu_takes_the_plain_path():
    tattn.reset_impl_counts()
    _door("auto")
    assert tattn.impl_counts() == {"flash": 0, "decode": 0, "torch": 1}


# (device, sq, skv, causal, has_kv_mask, contiguous_positions) -> impl
@pytest.mark.parametrize("args,want", [
    (("cuda", 1, 256, True, False, True), "decode"),
    (("cuda", 1, 255, True, False, True), "torch"),    # too few cells
    (("cuda", 2, 256, True, False, True), "torch"),    # not one token
    (("cpu", 1, 1024, True, False, True), "torch"),    # needs the card
    (("cuda", 1, 1024, False, False, True), "torch"),  # not causal
    (("cuda", 1, 1024, True, True, False), "torch"),   # not contiguous
    (("cuda", 1, 1024, True, True, True), "decode"),   # kv_mask allowed
    (("cuda", 1024, 1024, True, False, True), "flash"),
    (("cuda", 1024, 1024, True, True, True), "torch"),  # flash: no mask
])
def test_auto_impl_boundaries(args, want):
    device, sq, skv, causal, has_mask, contiguous = args
    assert tattn.auto_impl(device, sq, skv, causal=causal,
                           has_kv_mask=has_mask,
                           contiguous_positions=contiguous) == want
