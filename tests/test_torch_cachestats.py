"""The port's KV block lifecycle ledger and prefix hashing
(kubeflow_tpu_torch/obs/) against the JAX package's, on the CPU.

- `canonical_prefix`, `prefix_hash` and `sample_quantile` give the
  reference's values exactly, and `prefix_hash` is the name the
  reference's hashed `LabelGuard` gives a prefix (the heat digest's).
- `CacheLedger` and a ledger-attached `BlockPool`, driven in both
  packages by the same random sequence of births, deaths by cause,
  admissions, reuses, spill restores and drops and defers from a numpy
  seed: every `snapshot()` is equal, and conserved.
- The port's batcher keeps the ledger conserved through retirement,
  close with requests still decoding, and `flush_cache`.
"""

import asyncio

import numpy as np
import pytest

from kubeflow_tpu.obs import cachestats as jcs
from kubeflow_tpu.obs import metrics as jmetrics
from kubeflow_tpu.obs.cardinality import LabelGuard as JLabelGuard
from kubeflow_tpu.serving.paged import BlockPool as JBlockPool
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import cachestats as tcs
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.paged import BlockPool

BS = 8


@pytest.mark.parametrize("seed", range(4))
def test_prefix_hash_and_hashed_guard_match_reference(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 200_000, int(rng.integers(1, 64))).tolist()
    for ns in ("", "acme", "t\x00x"):
        assert tcs.canonical_prefix(toks, ns) == jcs.canonical_prefix(
            toks, ns)
        h = tcs.prefix_hash(toks, ns)
        assert h == jcs.prefix_hash(toks, ns)
        assert h == JLabelGuard(hashed=True).admit(
            tcs.canonical_prefix(toks, ns))
    assert tcs.EVICTION_CAUSES == jcs.EVICTION_CAUSES
    assert tcs.DEFER_CAUSES == jcs.DEFER_CAUSES


def test_prefix_hash_names_prefixes_as_the_reference_guard():
    prefixes = [[1], [1, 2, 3], [3, 2, 1], [0], [7] * 64, [1, 2, 3]]
    want = JLabelGuard(hashed=True)
    got = [tcs.prefix_hash(p) for p in prefixes]
    assert got == [want.admit(jcs.canonical_prefix(p)) for p in prefixes]
    assert len(set(got)) == len(prefixes) - 1


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_sample_quantile_matches_reference(n):
    xs = np.random.default_rng(n).integers(0, 50, n).tolist()
    for q in (0.0, 0.1, 0.5, 0.95, 1.0, 1.5):
        assert tcs.sample_quantile(xs, q) == jmetrics.sample_quantile(xs, q)


def _ledger_script(rng, n_ops=300):
    causes = list(tcs.EVICTION_CAUSES) + [None, "bogus"]
    ops = []
    for _ in range(n_ops):
        kind = str(rng.choice(["alloc", "free", "admission", "reuse",
                               "restore", "drop", "defer"],
                              p=[.3, .25, .15, .1, .08, .07, .05]))
        ops.append((kind, int(rng.integers(1, 5)),
                    causes[int(rng.integers(len(causes)))],
                    str(rng.choice(["pool_exhausted", "kv_quota", "x"]))))
    return ops


@pytest.mark.parametrize("seed", range(5))
def test_ledger_and_pool_match_reference_under_random_operations(seed):
    """Both ledgers attached to pools of 40 blocks; frees take live
    blocks in a seeded order, restores and drops move only what the
    spill books hold."""
    rng = np.random.default_rng(seed)
    sides = []
    for pool_cls, ledger_cls in ((JBlockPool, jcs.CacheLedger),
                                 (BlockPool, tcs.CacheLedger)):
        pool, ledger = pool_cls(41, BS), ledger_cls()
        pool.attach_ledger(ledger)
        sides.append((pool, ledger))
    live: list[int] = []
    pick = np.random.default_rng(seed + 100)
    for i, (kind, n, cause, defer) in enumerate(_ledger_script(rng)):
        if kind == "alloc":
            got = [pool.alloc(n) for pool, _ in sides]
            assert got[0] == got[1]
            live += got[0] or []
        elif kind == "free" and live:
            idx = sorted(pick.choice(len(live), min(n, len(live)),
                                     replace=False), reverse=True)
            blocks = [live.pop(j) for j in idx]
            for pool, _ in sides:
                pool.free(blocks, cause=cause)
        elif kind == "admission":
            for _, ledger in sides:
                ledger.note_admission()
        elif kind == "reuse" and live:
            blocks = [live[j % len(live)] for j in range(n)]
            for _, ledger in sides:
                ledger.note_reuse(blocks)
        elif kind in ("restore", "drop"):
            k = min(n, sides[0][1].spilled)
            for _, ledger in sides:
                (ledger.note_restore if kind == "restore"
                 else ledger.note_spill_drop)(k)
        elif kind == "defer":
            for _, ledger in sides:
                ledger.note_defer(defer)
        want, got = (ledger.snapshot() for _, ledger in sides)
        assert got == want, i
        assert got["conserved"] == (got["frees"]["unattributed"] == 0)
        assert got["live_blocks"] == sides[1][0].in_use


def test_pool_ledger_guards():
    pool = BlockPool(9, BS)
    pool.alloc(1)
    with pytest.raises(ValueError, match="already live"):
        pool.attach_ledger(tcs.CacheLedger())
    pool = BlockPool(9, BS)
    ledger = tcs.CacheLedger()
    pool.attach_ledger(ledger)
    blocks = pool.alloc(3)
    pool.free(blocks[:1], cause="lru")
    with pytest.raises(ValueError, match="double-free"):
        pool.free(blocks[:1], cause="lru")
    with pytest.raises(ValueError, match="double-free"):
        pool.free([blocks[1], blocks[1]], cause="lru")
    with pytest.raises(ValueError, match="out-of-range"):
        pool.free([0], cause="lru")
    snap = ledger.snapshot()
    assert snap["births"] == 3 and snap["frees"]["lru"] == 1
    assert snap["live_blocks"] == pool.in_use == 2 and snap["conserved"]


def test_batcher_ledger_conserves_through_close_and_flush():
    """Requests retire (their full blocks donated to the tree), others
    are still decoding when the batcher closes (their blocks freed as
    refdrop); `flush_cache` then returns every cached block. The ledger
    balances at each point."""
    cfg = tllama.LLAMA_TINY
    eng = InferenceEngine(tllama.init(cfg, 0, "cpu"), cfg, LLAMA_FAMILY,
                          EngineConfig(max_len=64), device="cpu")
    b = ContinuousBatcher(eng, asyncio.Lock(), max_slots=2,
                          kv_block_size=BS, seed=0)
    prompt = list(range(1, 20))

    async def run():
        await b.submit(prompt, 4)
        await b.submit(prompt, 4)    # hits the donated blocks, as does
        # this one, still decoding at close
        long = asyncio.ensure_future(b.submit(prompt + [7, 7], 30))
        while not b._active:
            await asyncio.sleep(0.001)
        snap = b.cache_ledger.snapshot()
        await b.close()
        with pytest.raises(RuntimeError, match="shut down"):
            await long
        return snap

    during = asyncio.run(run())
    assert during["conserved"] and b.prefix_hits == 2
    assert b.prefix_misses == 1
    snap = b.cache_ledger.snapshot()
    assert snap["conserved"] and snap["frees"]["refdrop"] > 0
    assert snap["live_blocks"] == b._radix.cached_blocks > 0
    assert b.kv_blocks_in_use() == b._radix.cached_blocks
    b.flush_cache()
    snap = b.cache_anatomy()["ledger"]
    assert snap["conserved"] and snap["live_blocks"] == 0
    assert snap["births"] == snap["frees_total"]
