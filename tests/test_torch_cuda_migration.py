"""Migrated KV blocks on the card. Every test here is marked `cuda` and
skips without an NVIDIA card: the paged decode kernel has no CPU mode.
This file imports no JAX, so the card machine runs it with

    python -m pytest --noconftest tests/test_torch_cuda_migration.py

A bf16 pool at a served model's heads (llama3-1b's 16 / 8 heads of 128,
gemma-2b's 8 / 1 of 256; two layers, block 64) exports random blocks,
which cross the float32 wire (serving/migration.py) into another pool's
other block ids: bit-equal to what was exported (bf16 -> fp32 -> bf16 is
exact). Then one paged-decode step over a block table seeded from the
imported blocks (a row per cursor, the chain shared by every row as a
radix hit shares it) equals its plain version within the bf16 decode
tolerance of tests/test_torch_cuda_kernels.py (atol 1e-4, rtol 2**-7).
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from kubeflow_tpu_torch.serving import migration
from kubeflow_tpu_torch.serving.continuous import ContinuousEngine
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 64
MAX_LEN = 512
HEADS = [(16, 8, 128), (8, 1, 256)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _engine(dev, n_q, n_kv, hd):
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=n_q * hd,
                            intermediate_size=1024, num_layers=2,
                            num_heads=n_q, num_kv_heads=n_kv, head_dim=hd)
    eng = InferenceEngine(llama.init(cfg, 0, dev), cfg, LLAMA_FAMILY,
                          EngineConfig(max_len=MAX_LEN), device=dev)
    return ContinuousEngine(eng, max_slots=4, block_size=BS, seed=0)


def _migrate(dev, n_q, n_kv, hd, src_ids, dst_ids):
    """Random bf16 blocks `src_ids` of one pool through the wire into
    blocks `dst_ids` of another. -> (source state, destination engine,
    destination state)."""
    src, dst = _engine(dev, n_q, n_kv, hd), _engine(dev, n_q, n_kv, hd)
    sst, dstt = src.slots(), dst.slots()
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.inference_mode():
        for pool in (sst.k, sst.v):
            pool.copy_(torch.randn(pool.shape, generator=gen, device=dev))
    k, v = src.export_blocks(sst, src_ids)
    assert k.dtype == torch.bfloat16
    wire = migration.encode_kv(k, v)
    dst.import_blocks(dstt, dst_ids, *migration.decode_kv(wire))
    torch.cuda.synchronize()
    return sst, dst, dstt


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_kv,hd", HEADS)
def test_imported_bf16_blocks_are_bit_equal_on_card(cuda_device, n_q, n_kv,
                                                    hd):
    src_ids, dst_ids = [3, 9, 1, 12], [20, 5, 7, 2]
    sst, _, dstt = _migrate(cuda_device, n_q, n_kv, hd, src_ids, dst_ids)
    for a, b in ((sst.k, dstt.k), (sst.v, dstt.v)):
        assert torch.equal(b[:, dst_ids], a[:, src_ids])
    # the blocks nobody imported into are untouched (still zero)
    rest = [i for i in range(dstt.k.shape[1]) if i not in dst_ids]
    assert not dstt.k[:, rest].any() and not dstt.v[:, rest].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_kv,hd", HEADS)
def test_paged_decode_over_imported_table_matches_plain_on_card(
        cuda_device, n_q, n_kv, hd):
    dst_ids = [20, 5, 7, 2]
    _, dst, dstt = _migrate(cuda_device, n_q, n_kv, hd, [3, 9, 1, 12],
                            dst_ids)
    b = 4
    table = np.zeros((b, dst.blocks_per_slot), np.int32)
    table[:, :len(dst_ids)] = dst_ids   # every row seeded from the chain
    cursors = [0, 63, 130, len(dst_ids) * BS - 1]
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(b, 1, n_q, hd)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    tab = torch.from_numpy(table).to(cuda_device)
    pos = torch.tensor(cursors, dtype=torch.int32, device=cuda_device)
    for layer in range(dstt.k.shape[0]):
        kp, vp = dstt.k[layer], dstt.v[layer]
        want = paged_decode_attention_plain(q, kp, vp, tab, pos)
        got = paged_decode_attention(q, kp, vp, tab, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2**-7)
