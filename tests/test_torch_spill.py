"""The port's host spill tier against the JAX reference, on the CPU.

- `HostSpillTier` in both packages under the same random puts, pops
  and probes from a numpy seed, under two tenant namespaces: returns,
  dropped `(ns, path)` keys and LRU order equal.
- A radix tree with the tier attached, evicting under the same
  operations: demotion keys, payloads and the ledger's spill books
  equal.
- `export_blocks` / `import_blocks` on the same pool contents: exports
  equal to the reference's exactly, a round trip restores the bits,
  and a payload of the wrong geometry raises ValueError in both.
- The batcher with a small pool and a spill budget against the
  reference's, both admission modes, dispatch-ahead depths 1 and 2: a
  budget that keeps every demotion (the repeated prompt restores) and
  one of two blocks (the budget drops, the repeat prefills again).
  Greedy tokens exactly, logprobs within 1e-4 (fp32 sums in another
  order), and every count of `torch_cases.cache_books` exactly.
- A failed restore degrades to plain prefill, books its lost payloads
  and keeps the ledger conserved.
- The CLI's `--kv-spill-bytes`.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs.cachestats import CacheLedger as JCacheLedger
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu.serving.paged import BlockPool as JBlockPool
from kubeflow_tpu.serving.paged import HostSpillTier as JHostSpillTier
from kubeflow_tpu.serving.paged import RadixPrefixCache as JRadix
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs.cachestats import CacheLedger
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
)
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.paged import (
    BlockPool,
    HostSpillTier,
    RadixPrefixCache,
)
from kubeflow_tpu_torch.serving.server import BATCHERS_KEY
from torch_cases import cache_books, serve_waves

BS = 8
MAX_LEN = 96
SLOTS = 4
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def engines():
    params = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    params["lm_head"] = params["lm_head"] * 50.0   # argmax can't flip
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
        device="cpu")
    return jeng, teng


# -- the tier itself ---------------------------------------------------------


def test_spill_tier_validates_and_reports_capacity():
    with pytest.raises(ValueError):
        HostSpillTier(-1, 100)
    with pytest.raises(ValueError):
        HostSpillTier(100, 0)
    t = HostSpillTier(350, 100)
    assert t.capacity_blocks == 3
    assert t.spilled_blocks == 0 and t.spilled_bytes == 0


@pytest.mark.parametrize("seed", range(5))
def test_spill_tier_matches_reference_under_random_operations(seed):
    rng = np.random.default_rng(seed)
    budget = int(rng.integers(0, 6)) * 100
    got, want = HostSpillTier(budget, 100), JHostSpillTier(budget, 100)
    for i in range(200):
        kind = rng.choice(["put", "pop", "contains"], p=[.5, .25, .25])
        path = rng.integers(0, 3, int(rng.integers(1, 4))).tolist()
        # keys are (tenant namespace, token path), as the reference's
        ns = str(rng.choice(["", "t"]))
        if kind == "put":
            payload = int(rng.integers(1000))
            assert got.put(ns, path, payload) == want.put(ns, path, payload)
        else:
            assert getattr(got, kind)(ns, path) == \
                getattr(want, kind)(ns, path)
        assert list(got._entries.items()) == list(want._entries.items()), i
        assert got.spilled_bytes == want.spilled_bytes


@pytest.mark.parametrize("seed", range(4))
def test_radix_demotes_into_the_tier_as_the_reference(seed):
    """Insert token paths into a 12-block pool until eviction must make
    room; each victim's content (its block id, through the reader) goes
    to a tier of 5 blocks, which drops its oldest. The tier's keys and
    payloads, the pool's free list and the ledgers' snapshots stay
    equal."""
    rng = np.random.default_rng(seed)
    sides = []
    for pool_cls, radix_cls, tier_cls, ledger_cls in (
            (JBlockPool, JRadix, JHostSpillTier, JCacheLedger),
            (BlockPool, RadixPrefixCache, HostSpillTier, CacheLedger)):
        pool = pool_cls(13, BS)
        pool.attach_ledger(ledger_cls())
        radix = radix_cls(pool)
        tier = tier_cls(5 * 64, 64)
        radix.attach_spill(tier, lambda b: None if b == 7 else ("kv", b))
        sides.append((pool, radix, tier))
    for _ in range(40):
        toks = rng.integers(0, 3, BS * int(rng.integers(1, 5))).tolist()
        n = len(toks) // BS
        for pool, radix, tier in sides:
            radix.match(toks)
            blocks = pool.alloc(n)
            if blocks is None:
                radix.evict(n - pool.num_free)
                blocks = pool.alloc(n)
            adopted, _ = radix.insert(toks, dict(enumerate(blocks)))
            pool.free([b for i, b in enumerate(blocks) if i not in adopted],
                      cause="divergence")
        (jp, _, jt), (tp, _, tt) = sides
        assert list(tt._entries.items()) == list(jt._entries.items())
        assert tp._free == jp._free
        assert tp.ledger.snapshot() == jp.ledger.snapshot()
    snap = sides[1][0].ledger.snapshot()
    assert snap["conserved"] and snap["spill"]["drops"] > 0
    assert snap["frees"]["lru"] > 0   # the reader's None for block 7


# -- device halves -----------------------------------------------------------


@pytest.mark.parametrize("ids", [[3], [1, 9, 4], [12, 2, 30, 7]])
def test_export_import_round_trip_matches_reference(engines, ids):
    jeng, teng = engines
    kw = dict(max_slots=SLOTS, block_size=BS)
    jce = JCEngine(jeng, paged_attention_impl="xla", **kw)
    tce = ContinuousEngine(teng, seed=0, **kw)
    cfg = tllama.LLAMA_TINY
    shape = (cfg.num_layers, tce.num_blocks, BS, cfg.num_kv_heads,
             cfg.head_dim)
    rng = np.random.default_rng(len(ids))
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jst = jce.init_slots()
    jst.k, jst.v = jnp.asarray(k), jnp.asarray(v)
    tst = tce.slots()
    with torch.inference_mode():
        tst.k.copy_(torch.from_numpy(k))
        tst.v.copy_(torch.from_numpy(v))
    want = jce.export_blocks(jst, ids)
    got = tce.export_blocks(tst, ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # into other blocks: the same bits land there, in both packages
    dst = [b + 1 for b in ids]
    jst = jce.import_blocks(jst, dst, *want)
    tce.import_blocks(tst, dst, *got)
    for pool, jpool, src in ((tst.k, jst.k, k), (tst.v, jst.v, v)):
        np.testing.assert_array_equal(pool.numpy()[:, dst], src[:, ids])
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
    bad = want[0][:, :, :BS // 2]
    for engine, state in ((jce, jst), (tce, tst)):
        with pytest.raises(ValueError, match="geometry"):
            engine.import_blocks(state, dst, bad, bad)


# -- the batcher against the reference's -------------------------------------


def _traffic():
    rng = np.random.default_rng(51)
    prompts = [rng.integers(0, 512, 20).tolist() for _ in range(6)]
    # one prompt per wave: each retirement caches 3 blocks in a pool of
    # 12 usable, so later admissions evict (demote) the oldest chains;
    # then the first prompt again
    return [[{"tokens": p, "max_new": 5}] for p in prompts] + [
        [{"tokens": prompts[0], "max_new": 5}]]


WAVES = _traffic()
# budget in blocks: keeps every demotion / drops all but the last two
BUDGETS = {"restore": 64, "drop": 2}
_REFERENCE: dict = {}


def _reference(jeng, budget, chunk):
    key = (budget, chunk)
    if key not in _REFERENCE:
        probe = JCEngine(jeng, max_slots=SLOTS, block_size=BS)
        b = JBatcher(jeng, asyncio.Lock(), max_slots=SLOTS,
                     kv_block_size=BS, prefill_chunk_tokens=chunk,
                     pipeline_depth=1, paged_attention_impl="xla",
                     kv_pool_blocks=1 + MAX_LEN // BS,
                     kv_spill_bytes=BUDGETS[budget]
                     * probe.kv_block_bytes())
        out = asyncio.run(serve_waves(b, WAVES, reference=True))
        _REFERENCE[key] = (out, cache_books(b))
    return _REFERENCE[key]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_spilling_batcher_matches_reference(engines, budget, chunk, depth):
    jeng, teng = engines
    want, want_books = _reference(jeng, budget, chunk)
    bb = ContinuousEngine(teng, max_slots=SLOTS,
                          block_size=BS).kv_block_bytes()
    b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=SLOTS,
                          kv_block_size=BS, prefill_chunk_tokens=chunk,
                          pipeline_depth=depth, seed=0,
                          kv_pool_blocks=1 + MAX_LEN // BS,
                          kv_spill_bytes=BUDGETS[budget] * bb)
    assert b._spill_tier.capacity_blocks == BUDGETS[budget]
    got = asyncio.run(serve_waves(b, WAVES, reference=False))
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        assert toks == wtoks
        np.testing.assert_allclose(lps, wlps, **TOL)
    assert got[-1][0] == got[0][0]   # the repeat, restored or not
    books = cache_books(b)
    assert books == want_books
    sp = books["ledger"]["spill"]
    assert books["ledger"]["conserved"] and sp["demotions"] > 0
    assert sp["demotions"] == sp["restores"] + sp["drops"] + sp["spilled"]
    if budget == "restore":
        assert sp["restores"] > 0 and sp["drops"] == 0
        assert books["hits"] == 1
    else:
        assert sp["drops"] > 0
    stats = b.prefix_cache_stats()
    assert stats["spilled_bytes"] == stats["spilled_blocks"] * bb


def test_failed_restore_degrades_to_plain_prefill(engines):
    """An import that raises leaves the repeated prompt to a plain
    prefill of the cells it would have restored: the reference's tokens
    all the same, the payloads that left the tier booked as drops, the
    ledger conserved."""
    jeng, teng = engines
    want, _ = _reference(jeng, "restore", None)
    bb = ContinuousEngine(teng, max_slots=SLOTS,
                          block_size=BS).kv_block_bytes()
    b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=SLOTS,
                          kv_block_size=BS, seed=0,
                          kv_pool_blocks=1 + MAX_LEN // BS,
                          kv_spill_bytes=BUDGETS["restore"] * bb)

    def broken(*args):
        raise RuntimeError("import failed")

    b.cengine.import_blocks = broken
    got = asyncio.run(serve_waves(b, WAVES, reference=False))
    assert [t for t, _ in got] == [t for t, _ in want]
    snap = b.cache_ledger.snapshot()
    sp = snap["spill"]
    assert sp["restores"] == 0 and sp["drops"] > 0
    assert snap["conserved"] and b.prefix_hits == 0


def test_cli_kv_spill_bytes():
    for argv in (["--kv-spill-bytes", "1024"],
                 ["--continuous", "--kv-spill-bytes", "-1"]):
        with pytest.raises(SystemExit):
            cli.parse_args(["--model", "llama-tiny", "--random", *argv])
    args = cli.parse_args(["--model", "llama-tiny", "--random", "--cpu",
                           "--continuous", "--max-len", "64",
                           "--kv-spill-bytes", str(1 << 20)])
    batcher = cli.build_app(args)[BATCHERS_KEY]["llama-tiny"]
    assert batcher._spill_tier.budget_bytes == 1 << 20
    assert batcher._radix.spill is batcher._spill_tier
    off = cli.build_app(cli.parse_args([
        "--model", "llama-tiny", "--random", "--cpu", "--continuous",
        "--max-len", "64"]))[BATCHERS_KEY]["llama-tiny"]
    assert off._spill_tier is None and off._radix.spill is None
