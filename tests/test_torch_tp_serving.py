"""Tensor-parallel serving (serving/engine.py and serving/continuous.py at
tensor > 1, stepped by serving/gang.py) against the reference's engines,
on the CPU.

The reference serves a sharded engine mesh-obliviously and its own slow
tests hold that equal to the unsharded engine (tests/test_continuous.py
`test_continuous_engine_under_tensor_parallel_mesh`, tests/
test_serving.py `test_sharded_gemma_scale_vocab_decode_matches_
unsharded`), so the reference side here is the UNSHARDED engine, run in
the parent (no sharded JAX compile). Every torch-side case runs in one
spawn of a 4-rank gloo gang (tests/torch_dist.py, workers in tests/
torch_dist_workers.py `tp_serving_cases`), started in a thread before
the reference's runs: llama-tiny at tensor 2 (its KV heads cut) and 4
(held whole), gemma-tiny at 2 and 4 (its one KV head held whole),
through the `ContinuousEngine`'s prefill / insert / step and one-shot
`generate` (with its stream and chunked prefill); the 262,144-token
tied vocabulary's `generate` at tensor 4; rank 0's HTTP app with
continuous batching at tensor 2; the refusals; a follower's failure.

Greedy tokens must be EXACTLY the reference's: fp32 weights, and the
head scaled x50 (llama's lm_head, as the reference's test; gemma's
final norm at 49 and the tied model's at 50, the port's gemma idiom),
so that the exit sums' other order cannot flip an argmax. `score` at
tensor > 1 against the reference's unsharded `score` and the port's
one-device engine within LP_TOL.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.parallel import LLAMA_RULES as JRULES
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.parallel import shard_pytree_specs
from kubeflow_tpu.serving import GEMMA_FAMILY as J_GEMMA
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from torch_dist import run_gang
from torch_dist_workers import TP_FAIL_TIMEOUT_S

JTIED = dataclasses.replace(jllama.LLAMA_TINY, vocab_size=262144,
                            tie_embeddings=True)
TTIED = dataclasses.replace(tllama.LLAMA_TINY, vocab_size=262144,
                            tie_embeddings=True)
ENGINE_LENS, ENGINE_NEW = (5, 9), 5
HTTP_LENS, HTTP_NEW = (17, 9, 12, 5), 6
TIED_NEW = 4
LP_TOL = dict(atol=1e-3, rtol=1e-4)
CASES = ("llama2", "llama4", "gemma2", "gemma4")
# a case's rank's KV heads
KV_HEADS = {"llama2": 1, "llama4": 1, "gemma2": 1, "gemma4": 1}


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _padded(prompts):
    width = max(len(p) for p in prompts)
    arr = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), bool)
    for i, p in enumerate(prompts):
        arr[i, width - len(p):] = p
        mask[i, width - len(p):] = True
    return arr, mask


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def payload():
    llama = dict(jllama.init(jax.random.key(0), jllama.LLAMA_TINY))
    llama["lm_head"] = llama["lm_head"] * 50.0
    gemma = dict(jgemma.init(jax.random.key(0), jgemma.GEMMA_TINY))
    gemma["final_norm"] = jnp.full_like(gemma["final_norm"], 49.0)
    tied = dict(jax.jit(lambda k: jllama.init(k, JTIED))(jax.random.key(1)))
    tied["final_norm"] = tied["final_norm"] * 50.0
    engine_prompts = _prompts(22, ENGINE_LENS)
    return {"llama": _np(llama), "gemma": _np(gemma), "tied": _np(tied),
            "tied_cfg": TTIED, "engine_prompts": engine_prompts,
            "engine_new": ENGINE_NEW,
            "engine_batch": _padded(engine_prompts),
            "http_prompts": _prompts(23, HTTP_LENS), "http_new": HTTP_NEW,
            "tied_prompt": np.random.default_rng(1).integers(
                0, JTIED.vocab_size, (2, 6)).astype(np.int32),
            "tied_new": TIED_NEW}


@pytest.fixture(scope="module")
def gang(payload):
    """The gang's per-rank results, a future: the reference's runs go on
    while it runs."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(run_gang, "tp_serving_cases", 4, payload)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(gang):
    return gang.result()


def _generate(jeng, prompts, max_new):
    arr, mask = _padded(prompts)
    return np.asarray(jeng.generate(jnp.asarray(arr), max_new=max_new,
                                    prompt_mask=jnp.asarray(mask)))


@pytest.fixture(scope="module")
def reference(payload, gang):
    """The unsharded reference engines' greedy tokens (the gang runs
    meanwhile)."""
    jl = JEngine(jax.tree.map(jnp.asarray, payload["llama"]),
                 jllama.LLAMA_TINY, J_LLAMA, JEngineConfig(max_len=64))
    both = payload["engine_prompts"] + payload["http_prompts"]
    llama = _generate(jl, both, HTTP_NEW)
    jg = JEngine(jax.tree.map(jnp.asarray, payload["gemma"]),
                 jgemma.GEMMA_TINY, J_GEMMA, JEngineConfig(max_len=64))
    gemma = _generate(jg, payload["engine_prompts"], ENGINE_NEW)
    jt = JEngine(jax.tree.map(jnp.asarray, payload["tied"]), JTIED, J_LLAMA,
                 JEngineConfig(max_len=32))
    tied = np.asarray(jt.generate(jnp.asarray(payload["tied_prompt"]),
                                  max_new=TIED_NEW))
    n = len(ENGINE_LENS)
    return {"llama": llama[:n, :ENGINE_NEW], "http": llama[n:],
            "gemma": gemma, "tied": tied,
            "engines": {"llama": jl, "gemma": jg}}


def _leader(ranks, case):
    """The leading rank's result of `case` (rank 0, or rank 2 for the
    tensor-2 cases on ranks 2 and 3)."""
    return ranks[2 if case in ("gemma2", "refusals", "failure") else 0][case]


# -- the weight cut -----------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_weight_cut_matches_reference_shards(payload, gang, case):
    """Each tensor rank's params (`bridge.tensor_rank_params`) against
    the device shards of the reference's `LLAMA_RULES` on a (tensor t)
    mesh of the virtual CPU devices, leaf by leaf. The documented
    exception: KV projections held whole (gemma's one head; llama-tiny's
    two at tensor 4), where the reference cuts inside a head and the
    port holds the leaf whole on every rank."""
    model, t = case[:-1], int(case[-1])
    jmod, tmod = (jgemma, tgemma) if model == "gemma" else (jllama, tllama)
    cfg = tmod.GEMMA_TINY if model == "gemma" else tmod.LLAMA_TINY
    jcfg = jmod.GEMMA_TINY if model == "gemma" else jmod.LLAMA_TINY
    mesh = jcreate_mesh(JMeshSpec(data=1, fsdp=1, tensor=t),
                        devices=jax.devices()[:t])
    specs = shard_pytree_specs(JRULES, jmod.param_logical_axes(jcfg), mesh)
    sharded = jax.device_put(jax.tree.map(jnp.asarray, payload[model]),
                             specs)
    full = bridge.from_jax(payload[model], cfg, "cpu")
    cuts = [bridge.tensor_rank_params(full, cfg, i, t) for i in range(t)]
    order = list(mesh.devices.flat)
    held_whole = cfg.num_kv_heads % t != 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        keys = [k.key for k in path]
        for shard in leaf.addressable_shards:
            rank = order.index(shard.device)
            got = cuts[rank]
            whole = full
            for k in keys:
                got, whole = got[k], whole[k]
            got = got.numpy()
            if held_whole and keys[-1] in ("wk", "wv"):
                np.testing.assert_array_equal(got, whole.numpy())
                continue
            np.testing.assert_array_equal(got, np.asarray(shard.data),
                                          err_msg=".".join(keys))


# -- the engines -----------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_continuous_engine_tokens_match_unsharded_reference(
        ranks, reference, case):
    """prefill / insert / step of the slot engine at tensor t emit
    exactly the unsharded reference's greedy tokens."""
    got = _leader(ranks, case)["continuous"]
    assert got == reference[case[:-1]].tolist()


@pytest.mark.parametrize("case", CASES)
def test_generate_matches_unsharded_reference(ranks, reference, case):
    """One-shot `generate` of the left-padded batch at tensor t, its
    stream and its chunked prefill: the reference's tokens."""
    out = _leader(ranks, case)
    want = reference[case[:-1]]
    np.testing.assert_array_equal(out["generate"], want)
    np.testing.assert_array_equal(out["stream"], want)
    np.testing.assert_array_equal(out["chunked"], want)


@pytest.mark.parametrize("case", CASES)
def test_score_matches_unsharded_reference(ranks, reference, case):
    """`score` at tensor t against the reference's unsharded engine's
    `score` on the same sequences and mask (the prompts and the greedy
    tokens the gang generated)."""
    out = _leader(ranks, case)
    jeng = reference["engines"][case[:-1]]
    want = np.asarray(jeng.score(jnp.asarray(out["seq"]),
                                 prompt_mask=jnp.asarray(out["seq_mask"])))
    assert out["score"].shape == want.shape
    np.testing.assert_allclose(out["score"], want, **LP_TOL)


@pytest.mark.parametrize("case", CASES)
def test_score_matches_one_device(ranks, case):
    """`score` at tensor t against the port's one-device engine on the
    same sequences (fp32, sums in another order)."""
    out = _leader(ranks, case)
    np.testing.assert_allclose(out["score"], out["solo_score"], **LP_TOL)


@pytest.mark.parametrize("case", CASES)
def test_rank_holds_its_kv_heads(ranks, case):
    """The paged pool and the dense cache hold the rank's KV heads: one
    head cut from llama-tiny's two at tensor 2, the one head its query
    heads share where the KV heads are held whole."""
    out = _leader(ranks, case)
    assert out["kv_heads"] == KV_HEADS[case]
    assert out["pool"][3] == KV_HEADS[case]
    assert out["cache"][3] == KV_HEADS[case]


def test_tied_vocab_generate_tensor4(ranks, reference):
    """The 262,144-token tied vocabulary cut on "tensor" at tensor 4:
    the vocab-parallel lookup and head, gathered logits, identical
    greedy tokens."""
    np.testing.assert_array_equal(ranks[0]["tied4"]["generate"],
                                  reference["tied"])


def test_followers_mirror_every_call(ranks):
    """Every follower made each call its leader made (the gang's
    `calls`), and a stopped gang's followers returned."""
    for case, members in (("llama2", (0, 1)), ("gemma2", (2, 3)),
                          ("llama4", (0, 1, 2, 3)), ("gemma4", (0, 1, 2, 3)),
                          ("tied4", (0, 1, 2, 3))):
        calls = {ranks[r][case]["calls"] for r in members}
        assert len(calls) == 1 and calls.pop() > 0, case


def test_gang_handles_stay_bounded(ranks):
    """The results a gang keeps handles for do not grow with traffic:
    the slot state that `step` and `insert_many` return each time keeps
    its one handle and its one finalizer. After each of eight requests
    more, one at a time, the leader's live handles and finalizers and
    the follower's held results are the same as after the first."""
    marks = ranks[0]["llama2"]["http"]["handles"]
    held = ranks[1]["llama2"]["held"]
    assert len(marks) == 8
    assert len({(n, f) for n, f, _ in marks}) == 1, marks
    assert len({held[c] for _, _, c in marks}) == 1, [
        held[c] for _, _, c in marks]


# -- the HTTP app ----------------------------------------------------------------

def test_http_continuous_tensor2_matches_reference(ranks, reference):
    """Rank 0's app (continuous batching, chunked prefill) over the
    gang's engine: four prompts, then the first again, which hits the
    radix cache; then a monolithic batcher over the same engine, and the
    one-shot app's window batcher and direct 2-row path. Every answer is
    the unsharded reference's."""
    out = ranks[0]["llama2"]["http"]
    want = reference["http"].tolist()
    assert out["wave"] == want
    assert out["repeat"] == want[0]
    assert out["hits"] >= 1
    assert out["mono"] == want
    assert out["mono_repeat"] == want[0]
    assert out["mono_hits"] >= 1
    assert out["oneshot"] == [[want[1]], [want[3], want[3]]]
    assert any("per rank" in ln or "rank's view" in ln
               for ln in out["kv_family"])


# -- refusals and failure ------------------------------------------------------

REFUSALS = {
    "graphs": "3k", "int8": "3e", "int8_cut": "3e", "pack": "3f",
    "moe": "3d", "moe_cut": "3d", "spec_continuous": "3g",
    "spec_batch1": "3g", "spill": "3h", "migration": "3i", "warmup": "3k",
    "warmup_continuous": "3k", "graphs_continuous": "3k", "reload": "3i",
    "vocab": "vocab_size 511",
    "heads": "num_heads 3", "kv_heads": "num_kv_heads 3",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_at_tensor_gt_1(ranks, case):
    """Each feature refused at tensor > 1 raises, naming the ROADMAP
    item that will port it (or the count the axis does not divide)."""
    err = _leader(ranks, "refusals")[case]
    assert err is not None, f"{case} was not refused"
    assert REFUSALS[case] in err, err


def test_follower_failure_fails_request_within_timeout(ranks):
    """A follower that raises in a decode step: the leader's request
    fails with the gang's error within the tensor group's timeout
    (plus the time to agree), a later request fails at once, and the
    follower leaves its loop naming its fault."""
    out = _leader(ranks, "failure")
    err, took = out["first"]
    assert err.startswith("GangError"), err
    assert "injected follower fault" in err
    assert took < 2 * TP_FAIL_TIMEOUT_S + 5.0, took
    later, took_later = out["later"]
    assert later.startswith("GangError"), later
    assert took_later < 2.0, took_later
    assert "injected follower fault" in ranks[3]["failure"]["follower"]
