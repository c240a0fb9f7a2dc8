"""The port's multi-tenant QoS against the JAX reference, on the CPU.

- The tenancy package (kubeflow_tpu_torch/tenancy/, a copy of the
  reference's) under the same operations as kubeflow_tpu/tenancy/, on a
  fake clock: token-bucket refill and debt pacing, spec validation,
  unknown tenants resolving to `default`, ledger throttles with their
  retry_after, KV share and usage accounting, fair-share alternation and
  weight splits, idle tenants banking no credit, priority classes with
  pacing fallthrough, and `appendleft` refunds. Every answer equal. The
  reference's queue items are its batcher's tuples (future at index 3,
  meta at 7), the port's carry `fut` and `meta` attributes.
- `LabelGuard` (obs/cardinality.py) equal to the reference's.
- The namespaced radix tree: the same inserts, matches and evictions
  under several namespaces on both packages' `RadixPrefixCache`, with
  equal matches, adoptions, free lists and heat digests.
- The batcher, greedy in fp32 with the reference's weights (lm_head x50
  so argmax cannot flip) through `bridge.from_jax`, held to the
  reference engine's solo `generate` exactly: preemption replay (chunked
  and monolithic admission at dispatch-ahead depths 1 and 2, and under
  continuous speculative decoding with a self-draft), a preempted
  request finishing during a drain, a tenant-blind batcher as plain
  FIFO, prefix isolation blocking cross-tenant hits, and a `kv_quota`
  deferral booked in the tenant ledger and the cache ledger.
"""

import asyncio
import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu import tenancy as jten
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs import LabelGuard as JLabelGuard
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving.paged import BlockPool as JBlockPool
from kubeflow_tpu.serving.paged import RadixPrefixCache as JRadix
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch import tenancy as tten
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs.cardinality import OVERFLOW_LABEL, LabelGuard
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.paged import BlockPool, RadixPrefixCache

BS = 8
QOS = {"tenants": {"live": {"priority": "interactive"},
                   "bulk": {"priority": "batch"}}}
P1, P2, P3 = [3, 5, 7, 11], [4, 6, 8, 10], [9, 2, 4, 8]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


SIDES = (jten, tten)


# -- token buckets, specs, config ------------------------------------------


def test_token_bucket_refill_and_debt_match_reference():
    got = []
    for mod in SIDES:
        clk = FakeClock()
        out = []
        b = mod.TokenBucket(10.0, 5.0, clock=clk)
        out.append([b.try_take() for _ in range(7)])
        out.append(b.delay_until(1.0))
        clk.t = 0.25
        out.append((b.try_take(2.0), b.level))
        clk.t = 10.0
        out.append(b.level if not b.try_take(0.0) else b.level)
        d = mod.TokenBucket(10.0, clock=clk)
        d.take(15.0)
        out.append((d.level, d.debt_delay(), d.burst))
        clk.t = 10.25
        out.append(d.debt_delay())
        clk.t = 10.5
        out.append((d.debt_delay(), d.try_take()))
        u = mod.TokenBucket(0.0, clock=clk)
        u.take(1e9)
        out.append((u.unlimited, u.try_take(1e9), u.delay_until(5.0),
                    u.debt_delay()))
        got.append(out)
    assert got[0] == got[1]
    assert got[1][0] == [True] * 5 + [False] * 2


@pytest.mark.parametrize("fields", [
    {"priority": "urgent"}, {"weight": 0}, {"weight": -1.0},
    {"kv_block_share": 0.0}, {"kv_block_share": 1.5}, {"bogus": 1},
    {"priority": "batch", "weight": 2.0, "kv_block_share": 0.5},
])
def test_spec_validation_matches_reference(fields):
    results = []
    for mod in SIDES:
        try:
            spec = mod.config_from_dict({"tenants": {"t": fields}}).resolve("t")
            results.append(("ok", spec.priority, spec.weight,
                            spec.kv_block_share))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]
    with pytest.raises(ValueError):
        tten.TenantSpec(name="")


def test_config_resolves_unknown_to_default_and_loads_files(tmp_path):
    data = {"tenants": {"a": {"weight": 2.0}, "b": {"priority": "batch"}},
            "default": {"requests_per_s": 3.0}}
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(data))
    answers = []
    for mod in SIDES:
        cfg = mod.load_config(path)
        answers.append((cfg.names(),
                        [(cfg.resolve(n).name, cfg.resolve(n).priority,
                          cfg.resolve(n).requests_per_s)
                         for n in ("a", "b", "", "nobody", "default")]))
        with pytest.raises(ValueError):
            mod.TenancyConfig([mod.TenantSpec("x"), mod.TenantSpec("x")])
    assert answers[0] == answers[1]
    assert answers[1][1][3][0] == tten.DEFAULT_TENANT
    assert tten.PRIORITIES == jten.PRIORITIES


# -- the ledger ----------------------------------------------------------------


def test_ledger_throttles_and_accounts_as_the_reference():
    tenants = {"limited": {"requests_per_s": 2.0, "request_burst": 1.0},
               "share": {"kv_block_share": 0.25}, "free": {}}
    got = []
    for mod in SIDES:
        clk = FakeClock()
        led = mod.TenantLedger(mod.config_from_dict({"tenants": tenants}),
                               clock=clk)
        out = []
        led.check_request("limited")
        try:
            led.check_request("limited")
            out.append("admitted")
        except mod.Throttled as e:
            out.append((e.tenant, e.reason, e.retry_after, str(e)))
        clk.t = 0.5
        led.check_request("limited")
        led.check_request("stranger")            # resolves to default
        out.append((led.block_limit("share", 100), led.block_limit("free",
                                                                   100),
                    led.block_limit("share", 2)))
        led.note_slot_taken("share", 7)
        led.note_slot_taken("share", 3)
        led.note_slot_released("share", 7)
        led.charge_tokens("free", 5)
        led.note_completed("free")
        led.note_preempted("share")
        led.note_throttled("share", "kv_quota")
        out.append((led.blocks_held("share"), led.runnable("free"),
                    led.pacing_delay("free")))
        out.append(led.stats())
        got.append(out)
    assert got[0] == got[1]
    assert got[1][0][1] == "rate" and got[1][0][2] == pytest.approx(0.5)
    assert set(tten.THROTTLE_REASONS) == set(jten.THROTTLE_REASONS)


# -- the fair-share queue ------------------------------------------------------


class _Fut:
    def __init__(self, done=False):
        self._done = done

    def done(self):
        return self._done


class _Item:
    """A port queue item: the batcher's requests carry `fut` and `meta`."""

    def __init__(self, fut, meta):
        self.fut, self.meta = fut, meta


def _items(tenant, cost=8.0, priority="standard", weight=1.0, done=False):
    """The same request as the reference's tuple and the port's item."""
    kw = dict(tenant=tenant, priority=priority, weight=weight, cost=cost)
    jmeta, tmeta = jten.ReqMeta(**kw), tten.ReqMeta(**kw)
    return ((None, None, None, _Fut(done), None, None, None, jmeta),
            _Item(_Fut(done), tmeta))


def _meta(mod, item):
    return item[7] if mod is jten else item.meta


def _queues(tenants, clock=None, paced=False):
    out = []
    for mod in SIDES:
        cfg = mod.config_from_dict({"tenants": tenants})
        led = mod.TenantLedger(cfg, clock=clock) if paced else None
        out.append((mod, mod.FairShareQueue(cfg, led), led))
    return out


def _pop_tenants(mod, q, n):
    out = []
    for _ in range(n):
        it = q.popleft()
        out.append(None if it is None else _meta(mod, it).tenant)
    return out


def _push(queues, *item_args, left=False, **item_kw):
    pair = _items(*item_args, **item_kw)
    for (mod, q, _), it in zip(queues, pair):
        (q.appendleft if left else q.append)(it)
    return pair


@pytest.mark.parametrize("weights", [(1.0, 1.0), (2.0, 1.0), (3.0, 0.5)])
def test_fair_share_split_matches_reference(weights):
    wa, wb = weights
    queues = _queues({"a": {"weight": wa}, "b": {"weight": wb}})
    rng = np.random.default_rng(int(wa * 10 + wb))
    for _ in range(40):
        _push(queues, "a", cost=float(rng.integers(1, 16)), weight=wa)
        _push(queues, "b", cost=float(rng.integers(1, 16)), weight=wb)
    orders = [_pop_tenants(mod, q, 80) for mod, q, _ in queues]
    assert orders[0] == orders[1]
    if weights == (1.0, 1.0):
        # equal weights and costs would alternate; here the costs vary
        assert abs(orders[1][:40].count("a") - 20) <= 4
    for mod, q, _ in queues:
        with pytest.raises(IndexError):
            q.popleft()


def test_idle_tenant_banks_no_credit_as_the_reference():
    queues = _queues({"a": {}, "b": {}})
    for _ in range(10):
        _push(queues, "a")
    assert [_pop_tenants(mod, q, 10) for mod, q, _ in queues][1] == ["a"] * 10
    for _ in range(4):
        _push(queues, "a")
        _push(queues, "b")
    orders = [_pop_tenants(mod, q, 8) for mod, q, _ in queues]
    assert orders[0] == orders[1]
    assert orders[1].count("b") == 4 and orders[1][:2] != ["b", "b"]


def test_priority_classes_and_pacing_fallthrough_as_the_reference():
    clk = FakeClock()
    tenants = {"live": {"priority": "interactive", "tokens_per_s": 10.0},
               "std": {}, "bulk": {"priority": "batch"}}
    queues = _queues(tenants, clock=clk, paced=True)
    _push(queues, "bulk", priority="batch")
    _push(queues, "live", priority="interactive")
    _push(queues, "std")
    got = [_pop_tenants(mod, q, 3) for mod, q, _ in queues]
    assert got[0] == got[1] == ["live", "std", "bulk"]
    for _, _, led in queues:
        led.charge_tokens("live", 15)           # 0.5 s of debt
    _push(queues, "live", priority="interactive")
    _push(queues, "bulk", priority="batch")
    _push(queues, "std", done=True)             # cancelled: not waiting
    answers = []
    for mod, q, _ in queues:
        answers.append((q.has_waiting("interactive"), q.has_waiting("batch"),
                        _pop_tenants(mod, q, 3), len(q), q.pacing_delay(),
                        q.depths(), [_meta(mod, i).tenant
                                     for i in q.items()]))
    assert answers[0] == answers[1]
    assert answers[1][2] == ["std", "bulk", None]
    assert answers[1][4] == pytest.approx(0.5)
    clk.t = 0.5                                 # the debt has refilled
    later = [_pop_tenants(mod, q, 1) for mod, q, _ in queues]
    assert later[0] == later[1] == ["live"]


def test_appendleft_refunds_and_drain_all_as_the_reference():
    queues = _queues({"a": {}, "b": {}})
    _push(queues, "a")
    _push(queues, "b")
    popped = [q.popleft() for _, q, _ in queues]
    charged = [_meta(mod, it).charged for (mod, _, _), it in
               zip(queues, popped)]
    for (_, q, _), it in zip(queues, popped):
        q.appendleft(it)
    assert charged[0] == charged[1] > 0
    assert [_meta(mod, it).charged for (mod, _, _), it in
            zip(queues, popped)] == [0.0, 0.0]
    orders = [_pop_tenants(mod, q, 1) for mod, q, _ in queues]
    assert orders[0] == orders[1] == ["a"]
    _push(queues, "a")
    drained = [[_meta(mod, i).tenant for i in q.drain_all()]
               for mod, q, _ in queues]
    assert drained[0] == drained[1] == ["a", "b"]
    assert [len(q) for _, q, _ in queues] == [0, 0]


def test_label_guard_matches_reference():
    answers = []
    for cls in (JLabelGuard, LabelGuard):
        g = cls(max_values=2, seed=("known",))
        h = cls(hashed=True)
        c = cls(closed=True, seed=("x",))
        answers.append(([g.admit(v) for v in ("known", "fresh", "attack-1",
                                               "attack-2", "known", "")],
                        g.overflowed, sorted(g.known()),
                        h.admit("tenant-a"), c.admit("x"), c.admit("y")))
        with pytest.raises(ValueError):
            cls(max_values=0)
        with pytest.raises(ValueError):
            cls(hashed=True, closed=True)
    assert answers[0] == answers[1]
    assert answers[1][0][2] == OVERFLOW_LABEL


# -- the namespaced radix tree -------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_radix_namespaces_match_the_reference(seed):
    """Random inserts, matches and evictions over three namespaces (the
    shared "" among them) on a 24-block pool: every match, adoption,
    eviction count, free list and heat digest equal; a namespace never
    matches another's entries."""
    rng = np.random.default_rng(seed)
    sides = []
    for pool_cls, radix_cls in ((JBlockPool, JRadix),
                                (BlockPool, RadixPrefixCache)):
        pool = pool_cls(25, 4)
        sides.append((pool, radix_cls(pool)))
    namespaces = ("", "tenant-a", "tenant-b")
    for step in range(60):
        toks = rng.integers(0, 3, 4 * int(rng.integers(1, 4))).tolist()
        ns = namespaces[int(rng.integers(0, 3))]
        kind = rng.choice(["insert", "match", "evict"], p=[.5, .35, .15])
        need = int(rng.integers(1, 4))
        got = []
        for pool, radix in sides:
            if kind == "insert":
                n = len(toks) // 4
                blocks = pool.alloc(n)
                if blocks is None:
                    radix.evict(n - pool.num_free)
                    blocks = pool.alloc(n)
                adopted, _ = radix.insert(toks, dict(enumerate(blocks)),
                                          ns=ns)
                pool.free([b for i, b in enumerate(blocks)
                           if i not in adopted], cause="divergence")
                got.append(sorted(adopted))
            elif kind == "match":
                nodes, partial, plen = radix.match(toks, ns=ns)
                got.append(([nd.block for nd in nodes],
                            None if partial is None else partial.block, plen))
            else:
                got.append(radix.evict(need))
            got[-1] = (got[-1], pool._free[:], radix.cached_blocks,
                       radix.heat_digest(8))
        assert got[0] == got[1], (step, kind)
    # the isolation itself, on the port's tree
    pool = BlockPool(16, 4)
    radix = RadixPrefixCache(pool)
    adopted, _ = radix.insert(list(range(8)), dict(enumerate(pool.alloc(2))),
                              ns="tenant-a")
    assert adopted == {0, 1}
    assert radix.match(list(range(8)), ns="tenant-b") == ([], None, 0)
    assert radix.match(list(range(8)))[0] == []
    assert len(radix.match(list(range(8)), ns="tenant-a")[0]) == 2
    free0 = pool.num_free
    assert radix.evict(2) == 2 and pool.num_free == free0 + 2


# -- the batcher against the reference engine ----------------------------------


@pytest.fixture(scope="module")
def engines():
    cfg = jllama.LLAMA_TINY
    params = dict(jllama.init(jax.random.key(0), cfg))
    params["lm_head"] = params["lm_head"] * 50.0  # argmax can't flip
    jeng = JEngine(params, cfg, J_LLAMA, JEngineConfig(max_len=64))
    tparams = bridge.from_jax(jax.tree.map(np.asarray, params),
                              tllama.LLAMA_TINY, "cpu")
    teng = InferenceEngine(tparams, tllama.LLAMA_TINY, LLAMA_FAMILY,
                           EngineConfig(max_len=64), device="cpu")
    return jeng, teng


def _solo(jeng, prompt, max_new):
    return np.asarray(jeng.generate(jnp.asarray([prompt], jnp.int32),
                                    max_new=max_new))[0].tolist()


@pytest.fixture(scope="module")
def oracle(engines):
    jeng, _ = engines
    return {"p1": _solo(jeng, P1, 24), "p2": _solo(jeng, P2, 24),
            "p3": _solo(jeng, P3, 8)}


async def _until(cond, what):
    for _ in range(2000):
        if cond():
            return
        await asyncio.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _both_decoding(b, emitted=1):
    """Both slots decode and each has emitted at least `emitted`."""
    return (len(b._active) == 2
            and all(r.prefilling is None and len(r.out) >= emitted
                    for r in b._active.values()))


@pytest.mark.parametrize("mode", [
    "monolithic-depth1", "monolithic-depth2", "chunked-depth1",
    "chunked-depth2", "spec-selfdraft"])
def test_preemption_replay_is_token_identical(engines, oracle, mode):
    """Two batch-class decodes fill both slots; an interactive arrival
    preempts the younger mid-generation (at depth 2 with a chunk in
    flight for it). The victim's replay seeds from its donated blocks
    and prefills only the partial tail; every output equals the
    reference engine's solo tokens, and the ledger books the tokens, the
    preemption and the completions."""
    _, teng = engines
    kw = dict(max_slots=2, kv_block_size=BS, seed=0,
              tenancy=tten.config_from_dict(QOS))
    if mode == "spec-selfdraft":
        kw.update(draft=teng, spec_gamma=3, prefill_chunk_tokens=4)
    else:
        kw["pipeline_depth"] = int(mode[-1])
        if mode.startswith("chunked"):
            kw["prefill_chunk_tokens"] = 4

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), **kw)
        try:
            f1 = asyncio.ensure_future(b.submit(P1, 24, {"tenant": "bulk"}))
            f2 = asyncio.ensure_future(b.submit(P2, 24, {"tenant": "bulk"}))
            # 12 tokens out: the victim has a full block to donate
            await _until(lambda: _both_decoding(b, 12),
                         "both slots 12 tokens in")
            reused0 = b.tokens_reused
            got3 = await b.submit(P3, 8, {"tenant": "live"})
            got1, got2 = await f1, await f2
            return (b.preemptions, got1, got2, got3, b.tenant_stats(),
                    b.tokens_reused - reused0,
                    b.cache_anatomy()["ledger"], b.timelines)
        finally:
            await b.close()

    (preempted, got1, got2, got3, stats, reused, ledger,
     timelines) = asyncio.run(go())
    assert preempted >= 1
    assert got1 == oracle["p1"]
    assert got2 == oracle["p2"]
    assert got3 == oracle["p3"]
    assert stats["bulk"]["preempted"] == preempted
    assert stats["live"]["completed"] == 1
    assert stats["bulk"]["completed"] == 2
    assert stats["bulk"]["tokens"] == 48 and stats["live"]["tokens"] == 8
    assert stats["bulk"]["slots_held"] == stats["bulk"]["blocks_held"] == 0
    # the younger bulk request was the victim, and its replay reused its
    # donated full blocks
    victim = timelines.get("req-000001").to_dict()
    kinds = [e["kind"] for e in victim["events"]]
    assert "preempt" in kinds and "resume" in kinds
    assert victim["tokens"] == 24
    assert reused >= BS
    assert ledger["conserved"] and ledger["frees"]["pressure"] > 0


def test_drain_completes_preempted_request(engines, oracle):
    """A batch request preempted back into the queue while the batcher
    drains is re-admitted past the closed door and finishes exactly."""
    _, teng = engines

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=BS, seed=0,
                              tenancy=tten.config_from_dict(QOS))
        try:
            f1 = asyncio.ensure_future(b.submit(P1, 24, {"tenant": "bulk"}))
            f2 = asyncio.ensure_future(b.submit(P2, 24, {"tenant": "bulk"}))
            await _until(lambda: _both_decoding(b), "both slots decoding")
            f3 = asyncio.ensure_future(b.submit(P3, 8, {"tenant": "live"}))
            await _until(lambda: b.preemptions >= 1, "a preemption")
            drained = await b.drain(timeout=60.0)
            with pytest.raises(RuntimeError, match="draining"):
                await b.submit(P3, 4, {"tenant": "live"})
            return drained, await f1, await f2, await f3, b.in_flight()
        finally:
            await b.close()

    drained, got1, got2, got3, left = asyncio.run(go())
    assert drained and left == 0
    assert (got1, got2, got3) == (oracle["p1"], oracle["p2"], oracle["p3"])


def test_tenant_blind_batcher_is_plain_fifo(engines, oracle):
    _, teng = engines

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=BS, seed=0)
        try:
            assert isinstance(b._pending, collections.deque)
            assert b.tenant_stats() == {}
            # the tenant still rides the sampling channel, inert
            got = await b.submit(P3, 8, {"tenant": "whoever"})
            tl = b.timelines.get("req-000000").to_dict()
            return got, b.tenant_stats(), b.preemptions, tl
        finally:
            await b.close()

    got, stats, preempted, tl = asyncio.run(go())
    assert got == oracle["p3"] and stats == {} and preempted == 0
    assert tl["tenant"] == "whoever"


def test_prefix_isolation_blocks_cross_tenant_hits(engines):
    """Two prefix-isolated tenants send the same prompt: each one's
    second request hits its own namespace, the other tenant's first
    misses; every output equals the solo tokens."""
    jeng, teng = engines
    ten = tten.config_from_dict({"tenants": {
        "a": {"prefix_isolation": True}, "b": {"prefix_isolation": True}}})
    prompt = [5, 3, 9, 2, 7, 1, 8, 6, 4, 3, 2, 9, 5, 7, 1, 2]
    want = _solo(jeng, prompt, 4)

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=BS, seed=0, tenancy=ten)
        out = []
        try:
            for tenant in ("a", "a", "b", "b", "default"):
                h0 = b.prefix_cache_stats()["hits"]
                got = await b.submit(prompt, 4, {"tenant": tenant})
                out.append((tenant, got,
                            b.prefix_cache_stats()["hits"] - h0 > 0))
            return out, b.prefix_cache_stats()["heat"]
        finally:
            await b.close()

    out, heat = asyncio.run(go())
    assert [o[1] for o in out] == [want] * 5
    assert [(t, hit) for t, _, hit in out] == [
        ("a", False), ("a", True), ("b", False), ("b", True),
        ("default", False)]
    # three namespaces, three heat entries for one first block
    assert len({h["prefix"] for h in heat}) == 3


def test_kv_quota_deferral_is_booked(engines):
    """A tenant whose KV share (0.2 of a 16-block pool: 3 blocks) is held
    by its first request waits for it: the second request is deferred,
    booked as a `kv_quota` throttle and a `kv_quota` cache defer, and
    both finish with the solo tokens."""
    jeng, teng = engines
    ten = tten.config_from_dict({"tenants": {"small": {
        "kv_block_share": 0.2}}})

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=BS, seed=0, tenancy=ten)
        try:
            got = await asyncio.gather(
                b.submit(P1, 24, {"tenant": "small"}),
                b.submit(P2, 24, {"tenant": "small"}))
            return (got, b.tenant_stats()["small"],
                    b.cache_anatomy()["ledger"])
        finally:
            await b.close()

    got, stats, ledger = asyncio.run(go())
    assert got == [_solo(jeng, P1, 24), _solo(jeng, P2, 24)]
    assert stats["throttled"]["kv_quota"] >= 1
    assert ledger["defers"]["kv_quota"] == stats["throttled"]["kv_quota"]
    assert stats["completed"] == 2 and stats["blocks_held"] == 0
    assert ledger["conserved"]
