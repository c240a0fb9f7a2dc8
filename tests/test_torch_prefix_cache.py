"""The port's radix prefix cache and prefix-reusing continuous batcher
against the JAX reference, on the CPU.

- `RadixPrefixCache` (and the `BlockPool` it frees into) in both
  packages, driven by the same random sequence of operations from a
  numpy seed: match results, adopted and held blocks, refs, LRU eviction
  order, the pool's free list and the heat digest must be equal.
- The device halves on the same pool contents: `gather_seed` exactly as
  the reference's; after a seeded `insert_many` the shared chain blocks
  are bit-identical, and the rest within 1e-4 of the reference's.
- The batcher against the reference's `ContinuousBatcher` with the same
  LLAMA_TINY weights (fp32, lm_head x50 so that greedy argmax cannot
  flip on rounding: the reference's own test idiom), in both admission
  modes and at dispatch-ahead depths 1 and 2, over traffic that
  exercises every branch of the planner: a shared prefix in two waves,
  a twin admitted while the first decodes (in-flight sharing), prompts
  that diverge inside a cached block (copy-on-write), prompts of an
  exact multiple of the block size repeated (the seed capped at
  len - 1), a small pool that forces eviction and deferral, and a
  registered prefix. Greedy tokens exactly, logprobs within 1e-4 (sums
  in another order), and every count of `torch_cases.cache_books`
  exactly.
- At depth 2 with rows retired by EOS inside a chunk: every block the
  tree adopted holds what a fresh prefill of its tokens gives (1e-4).
- The HTTP `"prefix"` field.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu.serving.paged import BlockPool as JBlockPool
from kubeflow_tpu.serving.paged import RadixPrefixCache as JRadix
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
)
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.paged import BlockPool, RadixPrefixCache
from kubeflow_tpu_torch.serving.server import (
    BATCHERS_KEY,
    create_serving_app,
)
from torch_cases import cache_books, serve_waves

pytest_plugins = ("aiohttp.pytest_plugin",)

BS = 8
MAX_LEN = 96
SLOTS = 4
TOL = dict(atol=1e-4, rtol=1e-4)
GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


def _params():
    p = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    p["lm_head"] = p["lm_head"] * 50.0   # argmax can't flip
    return p


def _pair(params, **ec):
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=MAX_LEN, **ec))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN, **ec),
        device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def engines(params):
    return _pair(params)


# -- the radix tree, driven by the same operations ---------------------------


def _node_ids(nodes):
    return [n.block for n in nodes]


def _radix_script(rng, n_ops=120):
    """Operations over a small vocabulary (so prompts share prefixes):
    match, insert of freshly allocated blocks (held or not), ref/unref of
    matched chains, evict, and an occasional clear."""
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["match", "insert", "insert", "ref", "unref",
                           "evict"], p=[.25, .2, .15, .15, .15, .1])
        if rng.random() < 0.02:
            kind = "clear"
        toks = rng.integers(0, 3, int(rng.integers(1, 5 * BS))).tolist()
        ops.append((str(kind), toks, int(rng.integers(1, 6))))
    return ops


class _Side:
    """One framework's pool + tree, and the chains it holds refs on."""

    def __init__(self, pool_cls, radix_cls, num_blocks):
        self.pool = pool_cls(num_blocks, BS)
        # a short half-life and a small table, so decay and pruning show
        self.radix = radix_cls(self.pool, heat_half_life=8,
                               heat_max_entries=6)
        self.held: list[list] = []

    def run(self, kind, toks, k):
        r = self.radix
        if kind == "match":
            nodes, pnode, plen = r.match(toks)
            return (_node_ids(nodes), pnode and pnode.block, plen)
        if kind == "insert":
            n_full = len(toks) // BS
            blocks = self.pool.alloc(n_full)
            if blocks is None:
                return None
            adopted, held = r.insert(toks[:n_full * BS],
                                     dict(enumerate(blocks)),
                                     hold=bool(k % 2))
            dup = [b for i, b in enumerate(blocks) if i not in adopted]
            self.pool.free(dup, cause="divergence")
            if held:
                self.held.append(held)
            return (sorted(adopted), _node_ids(held))
        if kind == "ref":
            nodes, _, _ = r.match(toks)
            r.ref(nodes)
            self.held.append(nodes)
            return _node_ids(nodes)
        if kind == "unref":
            if not self.held:
                return None
            nodes = self.held.pop(k % len(self.held))
            r.unref(nodes)
            return _node_ids(nodes)
        if kind == "evict":
            return r.evict(k)
        self.held.clear()
        r.clear(cause="refdrop")
        return None


@pytest.mark.parametrize("seed", range(6))
def test_radix_tree_matches_reference_under_random_operations(seed):
    ops = _radix_script(np.random.default_rng(seed))
    ref = _Side(JBlockPool, JRadix, 24)
    got = _Side(BlockPool, RadixPrefixCache, 24)
    for i, op in enumerate(ops):
        assert got.run(*op) == ref.run(*op), (i, op)
        assert got.pool._free == ref.pool._free, i
        assert got.radix.cached_blocks == ref.radix.cached_blocks
        assert got.radix._clock == ref.radix._clock
    assert got.radix.heat_digest(4) == ref.radix.heat_digest(4)


def test_radix_partial_match_refs_and_hold():
    """The reference's own walk-through (tests/test_paged_kv.py), on
    the port: a partial match inside the next edge, duplicates left with
    the caller, held nodes protected from eviction."""
    pool = BlockPool(16, 4)
    radix = RadixPrefixCache(pool)
    toks = list(range(10))
    blocks = pool.alloc(2)
    adopted, held = radix.insert(toks[:8], dict(enumerate(blocks)),
                                 hold=True)
    assert adopted == {0, 1} and _node_ids(held) == blocks
    nodes, pnode, plen = radix.match([0, 1, 2, 3, 4, 5, 9, 9])
    assert _node_ids(nodes) == blocks[:1] and pnode.block == blocks[1]
    assert plen == 2
    assert radix.evict(5) == 0        # held: nothing evictable
    radix.unref(held)
    assert radix.evict(1) == 1 and radix.cached_blocks == 1
    again = pool.alloc(1)
    adopted, _ = radix.insert(toks[:4], {0: again[0]})
    assert adopted == set()           # the edge exists: a duplicate


# -- device halves on the same pool contents ---------------------------------


def _same_pools(jce, tce, seed):
    """Both engines' slot states with one random pool."""
    rng = np.random.default_rng(seed)
    cfg = tllama.LLAMA_TINY
    shape = (cfg.num_layers, tce.num_blocks, BS, cfg.num_kv_heads,
             cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jst = jce.init_slots()
    jst.k, jst.v = jnp.asarray(k), jnp.asarray(v)
    tst = tce.slots()
    with torch.inference_mode():
        tst.k.copy_(torch.from_numpy(k))
        tst.v.copy_(torch.from_numpy(v))
    return jst, tst


@pytest.mark.parametrize("m", [1, 8, 13, 24, 47])
def test_gather_seed_matches_reference_exactly(engines, m):
    jeng, teng = engines
    kw = dict(max_slots=SLOTS, block_size=BS)
    jce = JCEngine(jeng, paged_attention_impl="xla", **kw)
    tce = ContinuousEngine(teng, seed=0, **kw)
    jst, tst = _same_pools(jce, tce, m)
    rng = np.random.default_rng(100 + m)
    chains = np.zeros((4, tce.blocks_per_slot), np.int32)
    for row in range(3):   # row 3: a dummy, all trash
        chains[row, :-(-m // BS)] = rng.permutation(
            np.arange(1, tce.num_blocks))[:-(-m // BS)]
    want = jce.gather_seed(jst, chains, m)
    got = tce.gather_seed(tst, chains, m)
    assert got.length == int(want.length) == m
    for name in ("k", "v", "pad", "offset"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("m,suffix", [(16, 5), (13, 9), (23, 1)])
def test_seeded_insert_keeps_chain_blocks_bit_identical(engines, m, suffix):
    """Two rows seeded from one shared chain (full blocks below m, plus
    the partial block copied into each row's own fresh block) prefill
    their suffixes and land through `insert_many`: the chain's blocks
    keep their bits, and every written block matches the reference's
    within 1e-4."""
    jeng, teng = engines
    kw = dict(max_slots=SLOTS, block_size=BS)
    jce = JCEngine(jeng, paged_attention_impl="xla", **kw)
    tce = ContinuousEngine(teng, seed=0, **kw)
    jst, tst = _same_pools(jce, tce, 7)
    cut = m // BS
    shared = [3, 9, 5][:cut]
    partial = 11 if m % BS else None
    chains = np.zeros((2, tce.blocks_per_slot), np.int32)
    for row in range(2):
        phys = shared + ([partial] if partial else [])
        chains[row, :len(phys)] = phys
    rng = np.random.default_rng(m)
    lists = [rng.integers(0, 512, suffix).tolist() for _ in range(2)]
    bucket = tce.bucket_for(suffix, 5, reserve=m)
    assert bucket == jce.bucket_for(suffix, 5, reserve=m)
    tables = np.zeros((2, tce.blocks_per_slot), np.int32)
    n_blocks = -(-(m + suffix + 5) // BS)
    fresh = [[20, 21, 22, 23, 24][:n_blocks - cut],
             [30, 31, 32, 33, 34][:n_blocks - cut]]
    for row in range(2):
        tables[row, :n_blocks] = shared + fresh[row]
    with torch.inference_mode():
        chain_before = [t[:, shared].clone() for t in (tst.k, tst.v)]
    jseed = jce.gather_seed(jst, chains, m)
    tseed = tce.gather_seed(tst, chains, m)
    jp, jfirst, _, jlps = jce.prefill_batch(lists, bucket, [GREEDY] * 2,
                                            jax.random.key(0),
                                            prefix_state=jseed)
    tp, tfirst, _, tlps = tce.prefill_batch(
        lists, bucket, [GREEDY] * 2, torch.Generator().manual_seed(0),
        prefix_state=tseed)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), **TOL)
    jst = jce.insert_many(jst, [1, 3], jp, [0, 1], jfirst, tables=tables,
                          seed_lens=[m, m])
    tce.insert_many(tst, [1, 3], tp, [0, 1], tfirst, tables=tables,
                    seed_lens=[m, m])
    for before, after in zip(chain_before, (tst.k, tst.v)):
        assert torch.equal(after[:, shared], before)
    written = sorted(set(tables.reshape(-1)) - {0})
    for got, want in ((tst.k, jst.k), (tst.v, jst.v)):
        np.testing.assert_allclose(got.numpy()[:, written],
                                   np.asarray(want)[:, written], **TOL)
    np.testing.assert_array_equal(tst.length.numpy(),
                                  np.asarray(jst.length))


def test_pool_size_is_validated_and_sizes_the_pool(engines):
    _, teng = engines
    ce = ContinuousEngine(teng, max_slots=SLOTS, block_size=BS,
                          num_blocks=20)
    assert ce.num_blocks == ce.pool.num_blocks == 20
    assert ce.slots().k.shape[1] == 20
    assert ce.kv_block_bytes() == teng.kv_cache_bytes(1, BS)
    with pytest.raises(ValueError, match="could never be admitted"):
        ContinuousEngine(teng, max_slots=SLOTS, block_size=BS,
                         num_blocks=MAX_LEN // BS)


# -- the batcher against the reference's -------------------------------------


def _traffic():
    rng = np.random.default_rng(31)

    def toks(n):
        return rng.integers(0, 512, n).tolist()

    def req(tokens, max_new=5, **kw):
        return {"tokens": tokens, "max_new": max_new, **kw}

    p = toks(20)
    tails = [toks(n) for n in (5, 9, 13, 3)]
    x = toks(30)
    q1 = toks(21)
    e, f = toks(24), toks(16)
    pool = [toks(20) for _ in range(4)]
    big = [toks(40) for _ in range(3)]
    sys_, t1, t2 = toks(12), toks(9), toks(14)
    # name: (waves, batcher kwargs, prefix hits)
    return {
        "shared_waves": ([[req(p + t) for t in tails[:3]],
                          [req(p + t) for t in tails]], {}, 4),
        "twin": ([[req(x, 12), req(x, 6, late=True)]], {}, 1),
        "cow": ([[req(q1)],
                 [req(q1[:13] + toks(8)), req(q1[:19] + toks(6))],
                 [req(q1)]], {}, 3),
        "exact_multiple": ([[req(e), req(f)], [req(e), req(f)]], {}, 2),
        "small_pool": ([[req(t)] for t in pool] + [[req(pool[0])],
                        [req(t) for t in big], [req(big[2])]],
                       {"kv_pool_blocks": 1 + MAX_LEN // BS}, 2),
        "registered_prefix": (
            [[req(t1, prefix="sys"), req(t2, prefix="sys")],
             [req(t1, prefix="sys"), req(sys_ + t1)]],
            {"prefixes": {"sys": sys_}}, 4),
    }


TRAFFIC = _traffic()
_REFERENCE: dict = {}


def _reference(jeng, name, chunk):
    """The reference batcher's tokens and books for one traffic, run
    once per admission mode (at depth 1, where its CPU runs are
    deterministic)."""
    key = (name, chunk)
    if key not in _REFERENCE:
        waves, kw, _ = TRAFFIC[name]
        b = JBatcher(jeng, asyncio.Lock(), max_slots=SLOTS,
                     kv_block_size=BS, prefill_chunk_tokens=chunk,
                     pipeline_depth=1, paged_attention_impl="xla", **kw)
        out = asyncio.run(serve_waves(b, waves, reference=True))
        _REFERENCE[key] = (out, cache_books(b))
    return _REFERENCE[key]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("name", list(TRAFFIC))
def test_prefix_reusing_batcher_matches_reference(engines, name, chunk,
                                                  depth):
    jeng, teng = engines
    want, want_books = _reference(jeng, name, chunk)
    waves, kw, hits = TRAFFIC[name]
    b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=SLOTS,
                          kv_block_size=BS, prefill_chunk_tokens=chunk,
                          pipeline_depth=depth, seed=0, **kw)
    got = asyncio.run(serve_waves(b, waves, reference=False))
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        assert toks == wtoks
        np.testing.assert_allclose(lps, wlps, **TOL)
    books = cache_books(b)
    assert books == want_books
    assert books["hits"] == hits
    assert books["ledger"]["conserved"]
    assert books["ledger"]["frees"]["unattributed"] == 0
    if name == "small_pool":
        assert books["ledger"]["frees"]["lru"] > 0
        assert b.cache_ledger.defers["pool_exhausted"] > 0
    if name == "exact_multiple":
        # both repeats seeded from all but their last token
        assert books["tokens_reused"] == 23 + 15
    assert b.kv_blocks_in_use() == books["cached_blocks"]


def _eviction_race():
    """A two-slot batcher with a pool of 1 + blocks_per_slot blocks
    whose matched, not yet ref'd cache is the only thing eviction could
    take. -> name: (waves, max_new of each request)."""
    rng = np.random.default_rng(53)
    p = rng.integers(0, 512, 34).tolist()   # caches 4 full blocks
    a = rng.integers(0, 512, 20).tolist()   # + 44 new: holds 8 blocks
    short = rng.integers(0, 512, 20).tolist()   # caches 2 full blocks
    return {
        # the repeat matches a 4-block chain while the pool is spent
        "chain": [[(p, 4)], [(a, 44), (p, 4)]],
        # the variant matches 3 blocks and 5 cells of the fourth
        "partial": [[(p, 4)], [(a, 44), (p[:29] + a[:5], 4)]],
        # idle, and the partial seed's block is the one the pool lacks:
        # planned without it rather than deferred for ever
        "idle_partial": [[(short, 4)], [(short[:12] + a[:8], 76)]],
    }


EVICTION_RACE = _eviction_race()


@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("name", list(EVICTION_RACE))
def test_eviction_spares_the_match_being_planned(engines, name, chunk):
    """The eviction that makes room for a plan never takes the chain or
    the partial seed it matched: no physical block appears twice in a
    table, and every request's tokens equal a fresh prefill's (greedy,
    exactly)."""
    _, teng = engines
    b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                          kv_block_size=BS, prefill_chunk_tokens=chunk,
                          kv_pool_blocks=1 + MAX_LEN // BS, seed=0)
    tables = []
    plan_blocks = b._plan_blocks

    def recording(req):
        plan = plan_blocks(req)
        if plan is not None:
            tables.append(plan["table"][plan["table"] != 0].tolist())
        return plan

    b._plan_blocks = recording
    waves = [[{"tokens": t, "max_new": n, "late": i > 0}
              for i, (t, n) in enumerate(wave)]
             for wave in EVICTION_RACE[name]]
    out = asyncio.run(asyncio.wait_for(
        serve_waves(b, waves, reference=False), 120))
    assert len(tables) == len(out)
    for table in tables:
        assert len(set(table)) == len(table), table
    for (toks, _), req in zip(out, (r for w in waves for r in w)):
        want = teng.generate(np.asarray([req["tokens"]]),
                             max_new=req["max_new"]).numpy()[0]
        assert toks == want.tolist()
    assert b.cache_ledger.snapshot()["conserved"]
    if name != "idle_partial":
        assert b.cache_ledger.defers["pool_exhausted"] > 0
        assert b.tokens_reused == {"chain": 32, "partial": 29}[name]
    else:
        assert b.tokens_reused == 8   # the chain, without the partial


def test_retired_rows_cache_only_what_a_fresh_prefill_gives(params):
    """Depth 2, chunk 4, EOS the third token the first prompt generates:
    rows retire inside a chunk while the next one is in flight and
    over-decodes their tails. Every block the tree adopted (prompt and
    decode-written cells alike) holds the K/V a fresh prefill of its
    token path computes."""
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, 512, n).tolist() for n in (17, 26, 11, 33)]
    _, plain = _pair(params)
    first = plain.generate(np.asarray([prompts[0]]), max_new=6).numpy()[0]
    _, teng = _pair(params, eos_token=int(first[2]))
    b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                          kv_block_size=BS, chunk=4, pipeline_depth=2,
                          seed=0)
    waves = [[{"tokens": p, "max_new": 12} for p in prompts],
             [{"tokens": prompts[1], "max_new": 12}]]
    out = asyncio.run(serve_waves(b, waves, reference=False))
    assert out[0][0][:3] == list(first[:3])   # stopped at EOS
    assert b.calls > b.tokens_emitted / 2      # tails over-decoded
    assert out[4][0] == out[1][0]              # the seeded repeat
    st = b.cengine.slots()
    checked = 0
    stack = list(b._radix.root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        path = list(b._radix._path_tokens(node))
        fresh = teng.precompute_prefix(path)
        cells = slice(len(path) - BS, len(path))
        for pool, dense in ((st.k, fresh.k), (st.v, fresh.v)):
            np.testing.assert_allclose(pool[:, node.block].numpy(),
                                       dense[:, 0, cells].numpy(), **TOL)
        checked += 1
    assert checked == b._radix.cached_blocks >= 10


# -- the HTTP "prefix" field -------------------------------------------------


async def test_generate_prefix_field(engines, aiohttp_client):
    _, teng = engines
    sys_ = list(range(3, 15))
    app = create_serving_app({"m": teng}, continuous=True, kv_block_size=BS,
                             max_batch=2, prefixes={"sys": sys_})
    client = await aiohttp_client(app)
    tail = [7, 8, 9, 10, 11]
    resp = await client.post("/v1/models/m:generate", json={
        "tokens": [tail], "max_new": 6, "prefix": "sys"})
    assert resp.status == 200, await resp.text()
    want = teng.generate(np.asarray([sys_ + tail]), max_new=6).numpy()[0]
    assert (await resp.json())["tokens"] == [want.tolist()]
    batcher = app[BATCHERS_KEY]["m"]
    assert batcher.prefix_hits == 1 and batcher.tokens_reused == 12
    for body, msg in (({"prefix": "nope"}, "unknown prefix"),
                      ({"prefix": 3}, "prefix must be a string"),
                      ({"prefix": "sys", "tokens": [tail, tail]},
                       "single-prompt"),
                      ({"prefix": "sys", "max_new": 80}, "exceeds")):
        resp = await client.post("/v1/models/m:generate", json={
            "tokens": [tail], "max_new": 6, **body})
        assert resp.status == 400 and msg in (await resp.json())["error"]
    models = (await (await client.get("/v1/models")).json())["models"][0]
    assert models["prefixes"] == {"sys": 12}
    assert models["prefix_cache"]["hits"] == 1
    oneshot = await aiohttp_client(create_serving_app({"m": teng}))
    resp = await oneshot.post("/v1/models/m:generate", json={
        "tokens": [tail], "max_new": 6, "prefix": "sys"})
    assert resp.status == 400
    with pytest.raises(ValueError, match="require continuous=True"):
        create_serving_app({"m": teng}, prefixes={"sys": sys_})
