"""The port's paged-attention paths against the JAX reference.

On the CPU the port's kernel wrappers (ops/cuda/paged_attention.py,
ops/cuda/prefill_append.py) run their plain PyTorch versions. Both the
dispatcher's plain path (`impl="torch"`) and the wrappers are held
against the reference's XLA gather path (`impl="xla"`) and against the
Pallas kernels in interpret mode, on the same numpy inputs, across GQA
ratios, ragged cursors and lengths, sliding windows, masked holes and
copy-on-write-shared tables — the cases of
tests/test_paged_attention_kernel.py and
tests/test_prefill_append_kernel.py.

Tolerance: fp32, atol/rtol 1e-5 (online-softmax merge vs single-pass
softmax, different sum orders). Pools: the new cells are copied, not
computed, so pools must agree exactly — on every block but trash block
0, where the reference routes padding tokens and the CUDA kernel writes
nothing.

The CUDA kernels themselves are held against these plain versions on
the card: tests/test_torch_cuda_kernels.py, and chip_smoke.py at
llama3-1b shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import paged_attention as j_paged
from kubeflow_tpu.ops.attention import paged_prefill_attention as j_prefill
from kubeflow_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as pallas_decode,
)
from kubeflow_tpu.ops.pallas.prefill_append import (
    paged_prefill_append as pallas_prefill,
)
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops.cuda import _build
from kubeflow_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
)
from kubeflow_tpu_torch.ops.cuda.prefill_append import (
    paged_prefill_append,
    paged_prefill_append_plain,
)
from torch_cases import mk_decode as _mk_decode
from torch_cases import mk_prefill as _mk_prefill

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- decode ----------------------------------------------------------------


def _decode_cases():
    return {
        "gqa4": dict(seed=0),
        "mha": dict(seed=1, n_q=4, n_kv=4),
        "mqa": dict(seed=2, n_q=8, n_kv=1),
        "ragged": dict(seed=3, b=5, pos=[3, 7, 8, 33, 47]),
        "cow_shared": dict(seed=4, pos=[9, 20, 40], share=True),
    }


@pytest.mark.parametrize("case", list(_decode_cases()))
@pytest.mark.parametrize("window", [None, 1, 4, 13])
def test_decode_plain_matches_reference(case, window):
    q, kp, vp, table, pos, mask = _mk_decode(**_decode_cases()[case])
    b, width = mask.shape
    kv_pos = np.broadcast_to(np.arange(width, dtype=np.int32), (b, width))
    want_xla = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(table), jnp.asarray(pos)[:, None],
                       jnp.asarray(kv_pos), causal=True,
                       kv_mask=jnp.asarray(mask), window=window,
                       impl="xla")
    want_pallas = pallas_decode(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.asarray(pos), jnp.asarray(mask),
                                window=window, interpret=True)
    got_torch = tattn.paged_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(pos)[:, None], _t(kv_pos),
        causal=True, kv_mask=_t(mask), window=window, impl="torch")
    got_wrapper = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(pos), _t(mask), window=window)
    np.testing.assert_allclose(got_torch.numpy(), np.asarray(want_xla),
                               **TOL)
    np.testing.assert_allclose(got_wrapper.numpy(),
                               np.asarray(want_pallas), **TOL)


def test_decode_wrapper_doors():
    q, kp, vp, table, pos, mask = (_t(a) for a in _mk_decode(6))
    with pytest.raises(ValueError, match="s=1"):
        paged_decode_attention(torch.cat([q, q], 1), kp, vp, table, pos)
    with pytest.raises(ValueError, match="q_positions"):
        paged_decode_attention(q, kp, vp, table, pos[:, None])
    with pytest.raises(ValueError, match="kv_mask"):
        paged_decode_attention(q, kp, vp, table, pos, mask[:, :-1])
    with pytest.raises(ValueError, match="grouped"):
        paged_decode_attention(q[:, :, :3], kp, vp, table, pos)
    with pytest.raises(ValueError, match="disagree"):
        paged_decode_attention(q, kp, vp[:-1], table, pos)


# -- prefill append ---------------------------------------------------------


def _prefill_cases():
    return {
        "gqa4": dict(seed=0),
        "mha": dict(seed=1, n_q=4, n_kv=4),
        "mqa": dict(seed=2, n_q=8, n_kv=1),
        "ragged_cursors": dict(seed=3, b=5, starts=[0, 7, 8, 30, 43]),
        "ragged_lens": dict(seed=4, b=4, s=6, lens=[6, 3, 1, 0]),
        "cow_shared": dict(seed=5, b=2, s=4, starts=[8, 10], shared=True),
    }


@pytest.mark.parametrize("case", list(_prefill_cases()))
@pytest.mark.parametrize("window,masked", [(None, False), (None, True),
                                           (4, False), (13, True)])
def test_prefill_plain_matches_reference(case, window, masked):
    q, kn, vn, kp, vp, table, starts, lens = _mk_prefill(
        **_prefill_cases()[case])
    mask = None
    if masked:
        # a pad hole at cell 3 in the rows whose prefix covers it (a
        # masked own cell would leave a query with nothing to see)
        mask = np.ones((q.shape[0], table.shape[1] * kp.shape[1]), bool)
        mask[starts > 3, 3] = False
    jmask = None if mask is None else jnp.asarray(mask)
    jargs = [jnp.asarray(a) for a in (q, kn, vn, kp, vp, table, starts,
                                      lens)]
    wo, wk, wv = j_prefill(*jargs, kv_mask=jmask, window=window,
                           impl="xla")
    po, pk, pv = pallas_prefill(*jargs, jmask, window=window,
                                interpret=True)
    tmask = None if mask is None else _t(mask)
    kp_t, vp_t = _t(kp.copy()), _t(vp.copy())
    to, tk, tv = tattn.paged_prefill_attention(
        _t(q), _t(kn), _t(vn), kp_t, vp_t, _t(table), _t(starts),
        _t(lens), kv_mask=tmask, window=window, impl="torch")
    assert tk is kp_t and tv is vp_t          # updated in place
    ko, kk, kv = paged_prefill_append(
        _t(q), _t(kn), _t(vn), _t(kp.copy()), _t(vp.copy()), _t(table),
        _t(starts), _t(lens), tmask, window=window)
    for got_o, got_k, got_v, ref_o, ref_k, ref_v in (
            (to, tk, tv, wo, wk, wv), (ko, kk, kv, po, pk, pv)):
        for i, n in enumerate(lens):
            np.testing.assert_allclose(got_o.numpy()[i, :n],
                                       np.asarray(ref_o)[i, :n], **TOL)
        np.testing.assert_array_equal(got_k.numpy()[1:],
                                      np.asarray(ref_k)[1:])
        np.testing.assert_array_equal(got_v.numpy()[1:],
                                      np.asarray(ref_v)[1:])


def test_prefill_rejects_append_past_window():
    q, kn, vn, kp, vp, table, _, lens = _mk_prefill(7, b=1, s=4,
                                                    starts=[40])
    starts = np.asarray([46], np.int32)   # 46 + 4 > 6 blocks * 8 cells
    with pytest.raises(ValueError, match="past the window"):
        paged_prefill_append_plain(
            _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(table), _t(starts),
            _t(lens))


def test_prefill_wrapper_doors():
    q, kn, vn, kp, vp, table, starts, lens = (_t(a)
                                              for a in _mk_prefill(8))
    with pytest.raises(ValueError, match="k_new"):
        paged_prefill_append(q, kn[:, :-1], vn, kp, vp, table, starts,
                             lens)
    with pytest.raises(ValueError, match="disagree"):
        paged_prefill_append(q, kn, vn, kp, vp[:-1], table, starts, lens)
    with pytest.raises(ValueError, match="q_start"):
        paged_prefill_append(q, kn, vn, kp, vp, table, starts[:-1], lens)
    with pytest.raises(ValueError, match="kv_mask"):
        paged_prefill_append(q, kn, vn, kp, vp, table, starts, lens,
                             torch.ones(3, 40, dtype=torch.bool))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No silent stand-in for a kernel that cannot be built."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("paged_decode_attention", [])
