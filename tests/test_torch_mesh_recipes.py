"""The mesh trainer's recipes against the reference's, on the CPU: the
MoE family routed over the global batch (mixtral-tiny on (data 2, fsdp
4), with a capacity that drops choices) and tensor-parallel (on (data
2, fsdp 2, tensor 2)), ViT-tiny at tensor 2, Adafactor with and without
ZeRO (its state, its bytes and a checkpoint restored on one device and
on another mesh), gradient accumulation over a ragged mask, the hybrid
(dcn 2, fsdp 2, tensor 2) mesh against one slice, and Adafactor under
the pipeline trainer on (stage 2, data 4). The reference's tests are
tests/test_llama_moe.py::test_moe_trains_under_sharded_mesh,
tests/test_models.py::test_vit_trainer_sharded_smoke and
tests/test_llama.py's hybrid, grad_accum and Adafactor tests.

All torch-side cases run in one spawn of an 8-rank gloo gang
(tests/torch_dist.py, `torch_dist_workers.mesh_recipe_cases`), started
before the reference's runs and awaited by the first test that reads
it; the reference runs on the 8 virtual CPU devices (4 for the one
slice). Every mesh of the gang covers its 8 ranks. The reference's
trainer routes, reduces and updates the same whatever its mesh, so one
reference run serves both MoE meshes.

Tolerances (fp32, sums in other orders and over gloo): losses within
2e-5 relative, params after 3 steps within rtol 5e-3, atol 5e-4 (an
AdamW step turns a rounding-level gradient difference near 0 into up
to a learning rate); one step's gradients, as full leaves, within 1e-5
relative L2 of `jax.grad` (ViT's key bias, whose exact gradient is 0,
within 1e-6 absolute); Adafactor's gathered state within the params'
bound; accumulation the reference's own bounds (loss 1e-5 relative,
params rtol 2e-4, atol 2e-6); the hybrid mesh the reference's own
(losses 2e-4, params rtol 5e-3, atol 3e-4).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.models import llama_moe as jmoe
from kubeflow_tpu.models import llama_pp as jpp
from kubeflow_tpu.models import vit as jvit
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.train import trainer as jtrainer
from torch_dist import run_gang

LCFG = jllama.LLAMA_TINY
MOE = dict(capacity_factor=0.75, aux_loss_weight=1.0)
MCFG = dataclasses.replace(jmoe.MIXTRAL_TINY, **MOE)
VCFG = jvit.VIT_TINY
PCFG = dataclasses.replace(LCFG, num_layers=4)
MOE_TC = dict(warmup_steps=2, total_steps=100, learning_rate=3e-3)
VIT_TC = dict(learning_rate=1e-3, warmup_steps=0, total_steps=20)
ADA_TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50,
              optimizer="adafactor")
ACC_TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)
PP_TC = dict(warmup_steps=2, total_steps=10, optimizer="adafactor")
GRAD_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, b=8, s=16, vocab=512):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _vit_payload():
    """ViT-tiny's params with every bias, the CLS token and the head
    drawn (a zero bias would hide where it is added), and 8 images."""
    p = _np(jvit.init(jax.random.key(4), VCFG))
    rng = np.random.default_rng(14)
    for name in ("bq", "bk", "bv", "bo", "b1", "b2"):
        p["blocks"][name] = rng.normal(
            scale=0.1, size=p["blocks"][name].shape).astype(np.float32)
    for name, scale in (("head_w", 0.2), ("head_b", 0.1),
                        ("patch_bias", 0.1)):
        p[name] = rng.normal(scale=scale, size=p[name].shape).astype(
            np.float32)
    return {"vit": p,
            "vit_x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
            "vit_y": rng.integers(0, 10, (8, 1)).astype(np.int32),
            "vit_w": np.ones((8, 1), np.float32)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    toks, tgts = _tokens(5)
    moe_toks, moe_tgts = _tokens(6)
    # the reference test's batch and ragged mask (rows carry different
    # token counts), drawn as it draws them
    rng = np.random.default_rng(9)
    acc_toks = rng.integers(0, 512, (8, 16)).astype(np.int32)
    acc_tgts = np.roll(acc_toks, -1, axis=1)
    mask = (np.arange(16)[None, :] < rng.integers(4, 17, (8, 1))).astype(
        np.float32)
    hyb_toks, hyb_tgts = _tokens(7)
    pp_toks, pp_tgts = _tokens(4)
    return dict(
        llama=_np(jllama.init(jax.random.key(3), LCFG)),
        llama4=_np(jllama.init(jax.random.key(4), PCFG)),
        moe=_np(jmoe.init(jax.random.key(3), MCFG)), moe_cfg=MOE,
        toks=toks, tgts=tgts, moe_toks=moe_toks, moe_tgts=moe_tgts,
        acc_toks=acc_toks, acc_tgts=acc_tgts, acc_mask=mask,
        hyb_toks=hyb_toks, hyb_tgts=hyb_tgts, pp_toks=pp_toks,
        pp_tgts=pp_tgts, moe_tc=MOE_TC, vit_tc=VIT_TC, ada_tc=ADA_TC,
        acc_tc=ACC_TC, pp_tc=PP_TC, dir=str(tmp_path_factory.mktemp("mr")),
        **_vit_payload())


@pytest.fixture(scope="module")
def gang(inputs):
    """Rank 0's results of the gang, a future: the reference's runs in
    the tests go on while it runs (every rank ends with the same
    gathered params)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(lambda: run_gang("mesh_recipe_cases", 8, inputs,
                                       timeout=600)[0])
    pool.shutdown(wait=True)


def _jmesh(**kw):
    spec = JMeshSpec(**kw)
    n = spec.data * spec.fsdp * spec.tensor
    return jcreate_mesh(spec, devices=jax.devices()[:n])


def _trainer(mod, cfg, mesh, tc, **kw):
    return jtrainer.Trainer(
        mesh=mesh, apply_fn=kw.pop("apply_fn",
                                   lambda p, t: mod.apply(p, cfg, t)),
        init_fn=lambda k: mod.init(k, cfg),
        logical_axes=mod.param_logical_axes(cfg),
        train_config=jtrainer.TrainConfig(**tc), **kw)


def _run(trainer, params, batch, steps=3):
    state = trainer.init_from_params(jax.tree.map(jnp.asarray, params))
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, *map(jnp.asarray, batch))
        losses.append(float(loss))
    return losses, state


def _jgrads(loss, params, *batch):
    grads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params),
                                    *map(jnp.asarray, batch))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {".".join(k.key for k in path): np.asarray(g)
            for path, g in flat}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))


def _assert_close(got, want, rtol=5e-3, atol=5e-4, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_close(got[k], w, rtol, atol, f"{prefix}{k}.")
            continue
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=prefix + k)


def _ok(res):
    assert "error" not in res, res.get("error")
    return res


@pytest.fixture(scope="module")
def moe_reference(inputs):
    """The reference's MoE trainer on (data 2, fsdp 2, tensor 2), 3
    steps, and jax.grad of its loss at the initial params."""
    batch = (inputs["moe_toks"], inputs["moe_tgts"])
    tr = _trainer(jmoe, MCFG, _jmesh(data=2, fsdp=2, tensor=2), MOE_TC,
                  apply_fn=lambda p, t: jmoe.apply(p, MCFG, t)[0],
                  loss_fn=jmoe.loss_fn(MCFG))
    losses, state = _run(tr, inputs["moe"], batch)
    loss = jmoe.loss_fn(MCFG)
    grads = _jgrads(lambda p, t, y: loss(p, t, y, None), inputs["moe"],
                    *batch)
    return losses, _np(state.params), grads


@pytest.mark.parametrize("mesh", ["df", "dft"])
def test_moe_trainer_matches_reference(inputs, gang, moe_reference, mesh):
    """mixtral-tiny at capacity factor 0.75 routed over the global batch:
    on (data 2, fsdp 4) each rank routes one row of 8, on (data 2, fsdp
    2, tensor 2) two rows of 8 against its 2 of 4 experts; choices drop
    in every layer, and the losses and params are the reference's."""
    losses, want, _ = moe_reference
    got = _ok(gang.result()["moe"][mesh])
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    _assert_close(got["params"], want)
    assert len(got["drops"]) == MCFG.num_layers
    assert all(d > 0 for d, _ in got["drops"]), got["drops"]
    router = inputs["moe"]["blocks"]["router"]
    assert np.abs(got["params"]["blocks"]["router"].numpy()
                  - router).max() > 0


def test_moe_tensor_parallel_gradients_match_jax_grad(gang, moe_reference):
    """One step's gradients at tensor 2, the expert stacks held as 2 of
    4 experts a rank: within 1e-5 relative L2 of jax.grad at aux weight
    1.0, the router's included."""
    grads = moe_reference[2]
    res = _ok(gang.result()["moe"]["dft"])
    assert res["experts"] == (2, 2, 64, 192)
    errs = {n: _rel_l2(g, grads[n]) for n, g in res["grads"].items()}
    assert len(errs) == 13
    assert max(errs.values()) <= GRAD_TOL, errs


def test_router_summed_over_tensor_fails_the_check(gang, moe_reference):
    """The control: the router's gradient, whole on every tensor rank
    (the gate values enter per-rank work), summed over "tensor" as a
    leaf read in per-rank work would be, fails the gradient bound; the
    other leaves stay within it."""
    grads = moe_reference[2]
    res = _ok(gang.result()["moe"]["dft"])
    errs = {n: _rel_l2(g, grads[n]) for n, g in res["control"].items()}
    assert errs.pop("blocks.router") > 0.5
    assert max(errs.values()) <= GRAD_TOL, errs


def test_moe_refuses_a_micro_the_batch_ranks_do_not_divide(gang):
    """grad_accum 4 at B 8 on 4 batch ranks: micros of 2 rows, padded to
    4; padding would take MoE capacity slots, so the routing refuses."""
    res = gang.result()["moe"]["padded"]
    assert "MoE routing on a micro-batch" in res.get("error", ""), res


@pytest.fixture(scope="module")
def vit_reference(inputs):
    batch = (inputs["vit_x"], inputs["vit_y"], inputs["vit_w"])
    tr = _trainer(jvit, VCFG, _jmesh(data=2, fsdp=2, tensor=2), VIT_TC,
                  apply_fn=lambda p, x: jvit.apply(p, VCFG, x)[:, None, :])
    losses, state = _run(tr, inputs["vit"], batch)

    def loss(p, x, y, w):
        return jtrainer.cross_entropy_loss(
            jvit.apply(p, VCFG, x)[:, None, :], y, w)

    return losses, _np(state.params), _jgrads(loss, inputs["vit"], *batch)


def _vit_errs(got, want):
    errs = {n: _rel_l2(g, want[n]) for n, g in got.items()
            if n != "blocks.bk"}
    return errs, float(np.abs(got["blocks.bk"].numpy()).max())


def test_vit_tensor_parallel_matches_reference(gang, vit_reference):
    """ViT-tiny on (data 2, fsdp 2, tensor 2): 2 heads and 5 classes a
    rank; gradients, 3 steps' losses and params. The key bias's exact
    gradient is 0: its noise is held to 1e-6, and its AdamW steps (up to
    a learning rate each) to 3 learning rates."""
    losses, want, grads = vit_reference
    res = _ok(gang.result()["vit"])
    assert res["local"] == {"wq": (2, 32, 32), "bq": (2, 32),
                            "wo": (2, 32, 32), "bo": (2, 32),
                            "w1": (2, 32, 64), "b1": (2, 64)}
    assert res["head"] == (32, 5)
    errs, bk = _vit_errs(res["grads"], grads)
    assert len(errs) == 23
    assert max(errs.values()) <= GRAD_TOL, errs
    assert bk <= 1e-6
    np.testing.assert_allclose(res["losses"], losses, rtol=2e-5)
    assert res["losses"][-1] < res["losses"][0]
    got = res["params"]
    bk_got = got["blocks"].pop("bk").numpy()
    bk_want = want["blocks"].pop("bk")
    _assert_close(got, want)
    assert np.abs(bk_got - bk_want).max() <= 3 * VIT_TC["learning_rate"]


def test_vit_bias_inside_rank_work_fails_the_check(gang, vit_reference):
    """The control: bo added before the `exit` that sums the ranks'
    partial products is counted twice; the gradients miss the bound."""
    errs, _ = _vit_errs(_ok(gang.result()["vit"])["control"],
                        vit_reference[2])
    assert max(errs.values()) > 100 * GRAD_TOL, errs


@pytest.fixture(scope="module")
def ada_reference(inputs):
    mesh = _jmesh(data=2, fsdp=2, tensor=2)
    tr = _trainer(jllama, LCFG, mesh, ADA_TC)
    losses, state = _run(tr, inputs["llama"], (inputs["toks"],
                                               inputs["tgts"]))
    factored = state.opt_state[1][0]
    assert type(factored).__name__ == "FactoredState"
    nbytes = {zero: _trainer(jllama, LCFG, mesh, {
        **ADA_TC, "zero_optimizer": zero}).opt_state_bytes()
        for zero in (True, False)}
    return losses, _np(state.params), _np(factored), nbytes


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("zero", [True, False])
def test_adafactor_on_a_mesh_matches_reference(gang, ada_reference, zero):
    """llama-tiny with Adafactor on (data 2, fsdp 2, tensor 2): wq [2,
    128, 128] is factored on the full leaf (its block [2, 64, 64] would
    not be); 3 steps' losses, params and the gathered v_row, v_col and
    v (the port's unused slots are empty where optax holds a (1,)
    placeholder)."""
    losses, want, factored, _ = ada_reference
    res = _ok(gang.result()["ada"])[zero]
    np.testing.assert_allclose(res["losses"], losses, rtol=2e-5)
    assert res["losses"][-1] < res["losses"][0]
    _assert_close(res["params"], want)
    assert res["held"]["v_row"]["blocks.wq"] == (
        (1, 128) if zero else (2, 128))
    for slot in ("v_row", "v_col", "v"):
        ref = _flat(getattr(factored, slot))
        assert set(ref) == set(res["opt"][slot])
        for name, t in res["opt"][slot].items():
            if ref[name].shape == (1,):
                assert t.numel() == 0, (slot, name)
                continue
            np.testing.assert_allclose(t.numpy(), ref[name], rtol=5e-3,
                                       atol=5e-4, err_msg=f"{slot} {name}")


@pytest.mark.parametrize("zero", [True, False])
def test_adafactor_state_bytes_equal_the_reference(gang, ada_reference,
                                                   zero):
    """A rank's optimizer-state bytes as the reference reckons them: v
    cut (and ZeRO-extended) as its param, v_row and v_col replicated
    (with ZeRO split over data where a dim allows), optax's placeholders
    and counts."""
    res = _ok(gang.result()["ada"])[zero]
    assert res["opt_bytes"] == ada_reference[3][zero]


def test_adafactor_checkpoint_round_trip(gang):
    """The ZeRO run saved under (data 2, fsdp 2, tensor 2) and restored
    on the same mesh, on one device and on (data 2, fsdp 4): params and
    every slot bit-equal, and the next step's loss equal to the
    uninterrupted run's (exactly on the same mesh)."""
    res = _ok(gang.result()["ada"])[True]
    for key, ck in res["ckpt"].items():
        assert ck["step"] == 3 and ck["params"] and ck["opt"], key
        np.testing.assert_allclose(ck["next"], res["next"], rtol=2e-5,
                                   err_msg=key)
    assert res["ckpt"]["same"]["next"] == res["next"]


@pytest.fixture(scope="module")
def acc_reference(inputs):
    batch = (inputs["acc_toks"], inputs["acc_tgts"], inputs["acc_mask"])
    mesh = _jmesh(data=2, fsdp=2, tensor=2)
    out = {}
    for acc in (2, 4):
        tr = _trainer(jllama, LCFG, mesh, {**ACC_TC, "grad_accum": acc})
        losses, state = _run(tr, inputs["llama"], batch, steps=1)
        out[acc] = (losses[0], _np(state.params))
    return out


@pytest.mark.parametrize("acc", [2, 4])
def test_grad_accum_matches_the_full_batch_step(gang, acc_reference, acc):
    """grad_accum 2 and 4 at B 8 over the reference's ragged mask on
    (data 2, fsdp 2, tensor 2) (at 4, micros of 2 rows over 4 batch
    ranks, padded with mask-0 rows): one step's loss and params against
    the port's acc-1 step and the reference's acc-N step."""
    res = gang.result()["acc"]
    one, got = _ok(res[1]), _ok(res[acc])
    ref_loss, ref_params = acc_reference[acc]
    for want_loss, want in ((one["loss"], one["params"]),
                            (ref_loss, ref_params)):
        assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
        _assert_close(got["params"], want, rtol=2e-4, atol=2e-6)


def test_grad_accum_refuses_a_batch_it_does_not_divide(gang):
    assert "not divisible" in gang.result()["acc"][3].get("error", "")


def test_hybrid_mesh_matches_one_slice(inputs, gang):
    """The hybrid (dcn 2, fsdp 2, tensor 2) mesh: the batch over ("dcn",
    "data", "fsdp"), 4 batch ranks; 3 steps equal the reference's one
    (fsdp 2, tensor 2) slice."""
    tr = _trainer(jllama, LCFG, _jmesh(data=1, fsdp=2, tensor=2), ACC_TC)
    losses, state = _run(tr, inputs["llama"], (inputs["hyb_toks"],
                                               inputs["hyb_tgts"]))
    res = _ok(gang.result()["hybrid"])
    assert res["batch_axes"] == ["dcn", "data", "fsdp"]
    assert res["batch_group"] == ("dcn", "fsdp") and res["batch_size"] == 4
    np.testing.assert_allclose(res["losses"], losses, rtol=2e-4)
    _assert_close(res["params"], _np(state.params), rtol=5e-3, atol=3e-4)


def test_pipeline_trainer_takes_adafactor(inputs, gang):
    """PipelineTrainer with Adafactor on (stage 2, data 4), llama-tiny at
    4 layers (2 a stage), 2 microbatches, against the reference's
    PipelineTrainer: a stage's v_row of wq is whole ([4, 128]), as the
    reference replicates it."""
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                 ("stage", "data"))
    tr = jpp.PipelineTrainer(PCFG, mesh, num_microbatches=2,
                             train_config=jtrainer.TrainConfig(**PP_TC))
    state = tr.init(jax.random.key(4))
    losses = []
    for _ in range(3):
        state, loss = tr.step(state, jnp.asarray(inputs["pp_toks"]),
                              jnp.asarray(inputs["pp_tgts"]))
        losses.append(float(loss))
    res = _ok(gang.result()["pp"])
    np.testing.assert_allclose(res["losses"], losses, rtol=2e-5)
    _assert_close(res["params"], _np(state.params))
    assert res["v_row"] == (4, 128)
