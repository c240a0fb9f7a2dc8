"""The port's live KV-block migration against the JAX reference, on the
CPU (the counterpart of tests/test_migration.py).

The migration contract is preemption replay's: a generation exported
from replica A and resumed on replica B emits exactly the tokens the
uninterrupted run would, `rec["out"] + resumed == solo oracle` under
greedy sampling (fp32, the reference's weights through
`bridge.from_jax`, lm_head x50 for llama and gemma's final norm at 49 so
argmax cannot flip). Checked at the three migrate points (never
admitted, mid-block, past a block boundary) on llama at dispatch-ahead
depths 1 and 2, at a block boundary on gemma (one kv head, another pool
geometry), and across frameworks: a record the reference's batcher
exported resumes in the port to the reference's oracle, and one the
port exported resumes in the reference's batcher. The failure edges: a
wedged import frees every block it took, a bad record is refused before
anything is allocated, and the block ledger stays conserved. The wire
format itself: `encode_kv` gives the reference's bytes for the same pool
contents, and a bf16 pool's blocks come back bit-equal through the
float32 wire.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import migration as jmigration
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.serving.continuous import ContinuousEngine as JCEngine
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import migration
from kubeflow_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousEngine,
    MigratedAway,
)
from kubeflow_tpu_torch.serving.engine import (
    GEMMA_FAMILY,
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)

BS = 8
MAX_NEW = 24
PROMPT = [3, 5, 7, 11, 13, 17]


def _pair(family):
    """(reference engine, port engine) on the same weights."""
    if family == "llama":
        jcfg, tcfg = jllama.LLAMA_TINY, tllama.LLAMA_TINY
        params = dict(jllama.init(jax.random.key(0), jcfg))
        params["lm_head"] = params["lm_head"] * 50.0  # argmax can't flip
        jfam, tfam = J_LLAMA, LLAMA_FAMILY
    else:
        jcfg, tcfg = jgemma.GEMMA_TINY, tgemma.GEMMA_TINY
        params = dict(jgemma.init(jax.random.key(1), jcfg))
        # (1 + w) = 50 on the tied head: argmax can't flip
        params["final_norm"] = jnp.full_like(params["final_norm"], 49.0)
        jfam, tfam = J_GEMMA, GEMMA_FAMILY
    jeng = JEngine(params, jcfg, jfam, JEngineConfig(max_len=64))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"),
        tcfg, tfam, EngineConfig(max_len=64), device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def gemma():
    return _pair("gemma")


def _solo(jeng, prompt, max_new=MAX_NEW):
    return np.asarray(jeng.generate(jnp.asarray([prompt], jnp.int32),
                                    max_new=max_new))[0].tolist()


def _port(engine, depth=1):
    return ContinuousBatcher(engine, asyncio.Lock(), max_slots=2,
                             kv_block_size=BS, pipeline_depth=depth, seed=0)


def _ref(engine):
    return JBatcher(engine, asyncio.Lock(), max_slots=2, kv_block_size=BS)


async def _export_at(batcher, prompt, k):
    """Start one streaming generation, read `k` tokens of it, then drain
    the batcher by export. -> the single wire record (its `out` is
    authoritative: the worker may be ahead of the consumer)."""
    ref = isinstance(batcher, JBatcher)
    fut, q = batcher.open_stream(prompt, MAX_NEW, () if ref else None)
    for _ in range(k):
        assert await q.get() is not None, "stream ended early"
    records = await batcher.export_sequences()
    with pytest.raises(Exception) as info:
        await fut
    assert type(info.value).__name__ == "MigratedAway"
    assert len(records) == 1
    return records[0]


def _export(batcher, prompt, k):
    async def go():
        try:
            rec = await _export_at(batcher, prompt, k)
            await asyncio.sleep(0)   # the futures' done callbacks run
            if not isinstance(batcher, JBatcher):
                # nothing is held after an export: every slot's blocks
                # went back (tree-cached ones stay cached, unreferenced)
                ce = batcher.cengine
                assert not batcher._active and batcher.in_flight() == 0
                assert ce.pool.in_use == batcher._radix.cached_blocks
                assert batcher.cache_anatomy()["ledger"]["conserved"]
            return rec
        finally:
            await batcher.close()

    return asyncio.run(go())


def _resume(batcher, rec):
    """Import `rec` on a fresh replica and re-issue the remaining budget.
    -> (blocks adopted, resumed tokens, tokens reused, ledger)."""
    ref = isinstance(batcher, JBatcher)

    async def go():
        try:
            adopted = await batcher.import_sequence(rec)
            out = await batcher.submit(rec["tokens"],
                                       rec["max_new"] - len(rec["out"]),
                                       () if ref else None)
            ledger = (None if ref
                      else batcher.cache_anatomy()["ledger"])
            return adopted, list(out), batcher.tokens_reused, ledger
        finally:
            await batcher.close()

    return asyncio.run(go())


def _check_resume(rec, adopted, out, reused, oracle):
    if rec["kv"] is not None:
        # a fresh pool caches nothing: every migrated block is adopted,
        # and the resumed prefill seeds from them
        assert adopted == rec["kv"]["n_full"] > 0
        assert reused >= rec["kv"]["n_full"] * BS
    else:
        assert adopted == 0
    assert rec["out"] + out == oracle


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("k", [0, 5, 9],
                         ids=["token0", "mid-block", "block-boundary"])
def test_migration_is_token_identical_llama(llama, k, depth):
    jeng, teng = llama
    oracle = _solo(jeng, PROMPT)
    rec = _export(_port(teng, depth), PROMPT, k)
    assert rec["version"] == migration.MIGRATION_WIRE_VERSION == \
        jmigration.MIGRATION_WIRE_VERSION
    if k == 0:
        # exported straight from the queue: a tokens-only record
        assert rec["kv"] is None and rec["out"] == []
    else:
        assert len(rec["out"]) >= k
        want_full = (len(PROMPT) + len(rec["out"]) - 1) // BS
        assert (rec["kv"]["n_full"] if rec["kv"] else 0) == want_full
        if k == 9:          # 6 + >= 9 tokens: past the first boundary
            assert rec["kv"]["n_full"] >= 1
    adopted, out, reused, ledger = _resume(_port(teng, depth), rec)
    _check_resume(rec, adopted, out, reused, oracle)
    assert ledger["conserved"]


def test_migration_is_token_identical_gemma(gemma):
    """Another family and pool geometry (one kv head): the
    block-boundary migrate point stays token-exact."""
    jeng, teng = gemma
    prompt = np.random.default_rng(7).integers(0, 512, 6).tolist()
    oracle = _solo(jeng, prompt)
    rec = _export(_port(teng), prompt, 11)
    assert rec["kv"] is not None and rec["kv"]["n_full"] >= 2
    assert rec["geometry"]["num_kv_heads"] == 1
    adopted, out, reused, _ = _resume(_port(teng), rec)
    _check_resume(rec, adopted, out, reused, oracle)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_records_cross_frameworks(llama, direction):
    """A record exported by one framework's batcher imports into the
    other's and resumes to the reference's oracle: the wire format and
    the pools' canonical form are one."""
    jeng, teng = llama
    oracle = _solo(jeng, PROMPT)
    if direction == "jax-to-port":
        rec = _export(_ref(jeng), PROMPT, 5)
        adopted, out, reused, ledger = _resume(_port(teng), rec)
        assert ledger["conserved"]
    else:
        rec = _export(_port(teng), PROMPT, 5)
        adopted, out, reused, _ = _resume(_ref(jeng), rec)
    assert rec["kv"] is not None
    _check_resume(rec, adopted, out, reused, oracle)


def test_wedged_import_rolls_back_without_leaking(llama):
    """A transfer wedged mid-import frees every block it took (pool
    occupancy and the ledger unchanged), and the same record then
    imports cleanly."""
    jeng, teng = llama
    prompt = [2, 4, 6, 8, 10, 12]
    oracle = _solo(jeng, prompt)
    rec = _export(_port(teng), prompt, 5)
    assert rec["kv"] is not None
    b = _port(teng)

    async def go():
        try:
            free0 = b.cengine.pool.num_free
            with pytest.raises(RuntimeError, match="wedged"):
                await b.import_sequence(rec, wedge=True)
            assert b.cengine.pool.num_free == free0
            snap = b.cache_anatomy()["ledger"]
            assert snap["conserved"] and snap["live_blocks"] == 0
            assert await b.import_sequence(rec) == rec["kv"]["n_full"]
            # a second import of the same prefix is a duplicate: freed
            assert await b.import_sequence(rec) == 0
            assert b.cache_anatomy()["ledger"]["frees"]["divergence"] == \
                rec["kv"]["n_full"]
            out = await b.submit(rec["tokens"],
                                 rec["max_new"] - len(rec["out"]))
            assert rec["out"] + out == oracle
            assert b.cache_anatomy()["ledger"]["conserved"]
        finally:
            await b.close()

    asyncio.run(go())


def test_import_rejects_bad_records_before_allocating(llama):
    """Geometry and envelope guards fire before any block is allocated,
    with the reference's messages."""
    _, teng = llama
    rec = _export(_port(teng), [9, 8, 7, 6, 5, 4], 5)
    n_full = rec["kv"]["n_full"]
    bad = {
        "geometry": {**rec, "geometry": {
            **rec["geometry"],
            "num_kv_heads": rec["geometry"]["num_kv_heads"] + 1}},
        "version": {**rec, "version": 99},
        "short": {**rec, "out": [], "tokens": rec["tokens"][:n_full * BS - 1]},
        "complete": {**rec, "max_new": len(rec["out"])},
        "missing": {k: v for k, v in rec.items() if k != "sampling"},
        "truncated": {**rec, "kv": {**rec["kv"], "k": rec["kv"]["k"][:-8]}},
        "not-a-dict": [rec],
    }
    b = _port(teng)

    async def go():
        try:
            free0 = b.cengine.pool.num_free
            out = {}
            for name, r in bad.items():
                with pytest.raises(ValueError) as info:
                    await b.import_sequence(r)
                out[name] = str(info.value)
                assert b.cengine.pool.num_free == free0, name
            return out
        finally:
            await b.close()

    got = asyncio.run(go())
    assert "migration geometry mismatch" in got["geometry"]
    assert "wire version" in got["version"]
    assert "carries only" in got["short"]
    assert "already complete" in got["complete"]
    assert "truncated" in got["truncated"]
    # the same refusals, word for word, as the reference's wire module
    for name, r in bad.items():
        if name in ("geometry", "short", "truncated"):
            continue     # these need a pool (the batcher's checks)
        with pytest.raises(ValueError) as info:
            jmigration.unpack_record(r)
        assert str(info.value) == got[name]


def test_wire_helpers_match_reference(llama):
    """pack, unpack, the geometry check and the prefix-fetch request give
    the reference's records, answers and errors."""
    jeng, teng = llama
    jce = JCEngine(jeng, max_slots=2, block_size=BS)
    tce = ContinuousEngine(teng, max_slots=2, block_size=BS, seed=0)
    assert migration.pool_geometry(tce) == jmigration.pool_geometry(jce)
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 2, BS, 2, 32)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    kw = dict(request_id="r1", tenant="t", ns="t", tokens=list(range(20)),
              out=[17, 18, 19], lps=[-0.5, -0.25, -1.0], max_new=8,
              sampling={"temperature": 0.0}, geometry=jmigration.pool_geometry(
                  jce), kv=(k, v))
    got, want = migration.pack_record(**kw), jmigration.pack_record(**kw)
    assert got == want
    assert migration.unpack_record(got) == jmigration.unpack_record(want)
    gk, gv = migration.decode_kv(got["kv"])
    np.testing.assert_array_equal(gk, k)
    np.testing.assert_array_equal(gv, v)
    for geom in ({**got["geometry"], "head_dim": 64}, "bad"):
        errs = []
        for mod, ce in ((migration, tce), (jmigration, jce)):
            with pytest.raises(ValueError) as info:
                mod.validate_geometry(geom, ce)
            errs.append(str(info.value))
        assert errs[0] == errs[1]
    body = migration.prefix_fetch_request("tiny", list(range(12)), ns="t",
                                          block_size=BS)
    assert body == jmigration.prefix_fetch_request(
        "tiny", list(range(12)), ns="t", block_size=BS)
    assert migration.validate_fetch_request(body, block_size=BS) == \
        jmigration.validate_fetch_request(body, block_size=BS)
    for bad in ({**body, "prefix": "0" * 16}, {**body, "tokens": [1, 2]},
                {**body, "ns": 3}, {**body, "tokens": []}, "x"):
        errs = []
        for mod in (migration, jmigration):
            with pytest.raises(ValueError) as info:
                mod.validate_fetch_request(bad, block_size=BS)
            errs.append(str(info.value))
        assert errs[0] == errs[1]


def test_encode_kv_matches_reference_bytes_and_bf16_round_trips(llama):
    """The same pool contents exported by both engines encode to the same
    wire bytes. A bf16 pool's blocks cross the float32 wire and come back
    bit-equal in another bf16 pool."""
    jeng, teng = llama
    jce = JCEngine(jeng, max_slots=2, block_size=BS)
    tce = ContinuousEngine(teng, max_slots=2, block_size=BS, seed=0)
    cfg = tllama.LLAMA_TINY
    shape = (cfg.num_layers, tce.num_blocks, BS, cfg.num_kv_heads,
             cfg.head_dim)
    rng = np.random.default_rng(5)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jst = jce.init_slots()
    jst.k, jst.v = jnp.asarray(k), jnp.asarray(v)
    tst = tce.slots()
    with torch.inference_mode():
        tst.k.copy_(torch.from_numpy(k))
        tst.v.copy_(torch.from_numpy(v))
    ids = [4, 1, 9]
    assert migration.encode_kv(*tce.export_blocks(tst, ids)) == \
        jmigration.encode_kv(*jce.export_blocks(jst, ids))

    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    beng = InferenceEngine(tllama.init(bcfg, 0, "cpu"), bcfg, LLAMA_FAMILY,
                           EngineConfig(max_len=64), device="cpu")
    src = ContinuousEngine(beng, max_slots=2, block_size=BS, seed=0)
    dst = ContinuousEngine(beng, max_slots=2, block_size=BS, seed=0)
    sst, dstt = src.slots(), dst.slots()
    with torch.inference_mode():
        sst.k.copy_(torch.from_numpy(k))
        sst.v.copy_(torch.from_numpy(v))
    bk, bv = src.export_blocks(sst, ids)
    assert bk.dtype == torch.bfloat16
    wire = migration.encode_kv(bk, bv)
    dst.import_blocks(dstt, [2, 3, 5], *migration.decode_kv(wire))
    assert torch.equal(dstt.k[:, [2, 3, 5]], sst.k[:, ids])
    assert torch.equal(dstt.v[:, [2, 3, 5]], sst.v[:, ids])


def test_export_keeps_pending_and_preempted_records(llama):
    """Two slots busy and a third request queued: the export carries the
    two active ones with their blocks and the queued one tokens-only,
    every future fails with MigratedAway, and `checkpoints()` listed the
    same three before."""
    jeng, teng = llama
    prompts = [PROMPT, [2, 4, 6, 8, 10, 12], [1, 3, 5, 7]]

    async def go():
        b = _port(teng, depth=2)
        try:
            futs = [b.open_stream(p, MAX_NEW)[0] for p in prompts]
            for _ in range(2000):
                if len(b._active) == 2 and all(
                        len(r.out) >= 9 for r in b._active.values()):
                    break
                await asyncio.sleep(0.005)
            cps = b.checkpoints()
            recs = await b.export_sequences()
            for f in futs:
                with pytest.raises(MigratedAway):
                    await f
            await asyncio.sleep(0)   # the futures' done callbacks run
            return cps, recs, b.in_flight()
        finally:
            await b.close()

    cps, recs, left = asyncio.run(go())
    assert left == 0
    assert [r["request_id"] for r in recs] == [c["request_id"] for c in cps]
    assert [r["kv"] is not None for r in recs] == [True, True, False]
    assert recs[2]["tokens"] == prompts[2] and recs[2]["out"] == []
    for rec in recs[:2]:
        prompt = rec["tokens"][:rec["prompt_len"]]
        assert rec["tokens"] == prompt + rec["out"]
        adopted, out, reused, _ = _resume(_port(teng), rec)
        _check_resume(rec, adopted, out, reused, _solo(jeng, prompt))


def test_export_carries_a_preempted_request_parked_in_the_queue(llama):
    """A batch request preempted for an interactive one waits in the
    queue with its replay prompt: the export packs it tokens-only with
    the tokens it had emitted and its whole budget, and it resumes on
    another replica to the oracle."""
    from kubeflow_tpu_torch.tenancy import config_from_dict

    jeng, teng = llama
    p1, p2, live = [3, 5, 7, 11], [4, 6, 8, 10], [9, 2, 4, 8]
    tenancy = config_from_dict({"tenants": {
        "live": {"priority": "interactive"}, "bulk": {"priority": "batch"}}})

    async def go():
        b = ContinuousBatcher(teng, asyncio.Lock(), max_slots=2,
                              kv_block_size=BS, seed=0, tenancy=tenancy)
        try:
            futs = [b.open_stream(p, MAX_NEW, {"tenant": "bulk"})[0]
                    for p in (p1, p2)]
            for _ in range(2000):
                if len(b._active) == 2 and all(
                        len(r.out) >= 12 for r in b._active.values()):
                    break
                await asyncio.sleep(0.005)
            futs.append(b.open_stream(live, MAX_NEW, {"tenant": "live"})[0])
            for _ in range(2000):
                if b.preemptions:
                    break
                await asyncio.sleep(0.001)
            parked = [r for r in b._pending.items()
                      if r.meta.resume is not None]
            cps = b.checkpoints()
            recs = await b.export_sequences()
            for f in futs:
                with pytest.raises(MigratedAway):
                    await f
            return parked, cps, recs
        finally:
            await b.close()

    parked, cps, recs = asyncio.run(go())
    assert len(parked) == 1
    victim = parked[0].meta.request_id
    rec = next(r for r in recs if r["request_id"] == victim)
    cp = next(c for c in cps if c["request_id"] == victim)
    assert rec["kv"] is None and rec["tenant"] == "bulk"
    assert len(rec["out"]) >= 12 and rec["max_new"] == MAX_NEW
    assert (cp["tokens"], cp["out"], cp["max_new"]) == (
        rec["tokens"], rec["out"], rec["max_new"])
    prompt = rec["tokens"][:rec["prompt_len"]]
    assert prompt == p2 and rec["tokens"] == prompt + rec["out"]
    adopted, out, reused, _ = _resume(_port(teng), rec)
    _check_resume(rec, adopted, out, reused, _solo(jeng, prompt))
