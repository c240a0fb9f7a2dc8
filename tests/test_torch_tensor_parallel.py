"""Tensor parallelism in the port's mesh trainer (train/fsdp.py,
parallel/tensor.py) against the reference's `Trainer` on meshes of the
same shape, on the CPU: llama-tiny on (fsdp 2, tensor 2) with dense and
chunked cross entropy, gemma-tiny on (data 2, tensor 2) with ZeRO
moments (its one KV head held whole on every tensor rank, where the
reference's GSPMD cuts inside the head), and a LoRA pack on wq, wk, wv
and wo; 3 AdamW steps from the reference's initial params on one global
batch. All torch-side cases run in one spawn of a 4-rank gloo gang
(tests/torch_dist.py), started before the reference's runs and awaited
by the first test that reads it; the reference runs on 4 of the 8
virtual CPU devices.

Tolerances: the forward's logits within the reference's own sharded
bound (atol 2e-4, rtol 1e-3, tests/test_llama.py); losses within 2e-5
relative and params after 3 steps within rtol 5e-3, atol 5e-4 (as
tests/test_torch_fsdp.py); one step's gradients before the optimizer,
as full leaves, within 1e-5 relative L2 of `jax.grad` of the reference's
loss at the same params (fp32: the sums run in another order). AdamW's
update m / sqrt(v) hides a constant factor in a gradient, so params
after a few steps would not catch a whole leaf's gradient summed over
the tensor axis once too often; the gradient check does, and a control
run that does just that to `final_norm` fails it.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.train import lora as jlora
from kubeflow_tpu.train import trainer as jtrainer
from torch_dist import run_gang

LCFG, GCFG = jllama.LLAMA_TINY, jgemma.GEMMA_TINY
JLC = jlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wk", "wv", "wo"))
TC = dict(warmup_steps=1, total_steps=10)
LORA_TC = dict(warmup_steps=2, total_steps=100, learning_rate=3e-3)
GRAD_TOL = 1e-5


def _jmesh(data, fsdp):
    return jcreate_mesh(JMeshSpec(data=data, fsdp=fsdp, tensor=2),
                        devices=jax.devices()[:4])


def _lora_init(rng):
    k1, k2 = jax.random.split(rng)
    return jlora.lora_train_tree(jllama.init(k1, LCFG),
                                 jlora.init_lora(k2, LCFG, JLC))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    params = {"llama": jax.tree.map(np.asarray, jllama.init(
        jax.random.key(3), LCFG)),
        "gemma": jax.tree.map(np.asarray, jgemma.init(
            jax.random.key(3), GCFG))}
    lora = jax.tree.map(np.asarray, _lora_init(jax.random.key(7)))
    # B = 0 at init: draw it, so the first step's adapters move both
    rng = np.random.default_rng(8)
    for ab in lora["lora"]["blocks"].values():
        ab["B"] = rng.normal(scale=0.05, size=ab["B"].shape).astype(
            np.float32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (8, 16)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    return dict(params, lora=lora, toks=toks, tgts=tgts,
                dir=str(tmp_path_factory.mktemp("tp")))


@pytest.fixture(scope="module")
def gang(inputs):
    """The gang's per-rank results, a future: the reference's runs in
    the tests go on while it runs."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(run_gang, "tensor_parallel_cases", 4, inputs)
    pool.shutdown(wait=True)


def _loss(mod, cfg):
    def loss(p, t, tg, m=None):
        return jtrainer.cross_entropy_loss(mod.apply(p, cfg, t), tg, m)
    return loss


def _chunked(p, t, tg, m=None):
    return jtrainer.chunked_cross_entropy_from_hidden(
        jllama.hidden(p, LCFG, t), jllama.unembed_matrix(p, LCFG), tg, m)


def _run(trainer, params, inputs):
    state = trainer.init_from_params(jax.tree.map(jnp.asarray, params))
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, jnp.asarray(inputs["toks"]),
                                   jnp.asarray(inputs["tgts"]))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _reference(mod, cfg, mesh, inputs, name, **kw):
    trainer = jtrainer.Trainer(
        mesh=mesh, apply_fn=lambda p, t: mod.apply(p, cfg, t),
        init_fn=lambda k: mod.init(k, cfg),
        logical_axes=mod.param_logical_axes(cfg),
        train_config=jtrainer.TrainConfig(**TC, **kw.pop("tc", {})), **kw)
    losses, params = _run(trainer, inputs[name], inputs)
    return losses, params, trainer


def _jgrads(loss, params, inputs):
    """jax.grad of the reference's loss at `params`, by dotted name."""
    grads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(inputs["toks"]),
                                    jnp.asarray(inputs["tgts"]))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {".".join(k.key for k in path): np.asarray(g)
            for path, g in flat}


@pytest.fixture(scope="module")
def llama_grads(inputs):
    return _jgrads(_loss(jllama, LCFG), inputs["llama"], inputs)


def _rel_l2(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grad_errs(got, want):
    return {n: _rel_l2(g, want[n]) for n, g in got.items()}


def _assert_close(got, want, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_close(got[k], w, f"{prefix}{k}.")
            continue
        np.testing.assert_allclose(got[k].numpy(), w, rtol=5e-3, atol=5e-4,
                                   err_msg=prefix + k)


def _assert_ranks_agree(res, key):
    for r in res[1:]:
        assert r[key]["losses"] == res[0][key]["losses"]


def test_llama_forward_matches_reference(inputs, gang):
    """The logits of `llama.apply` on (fsdp 2, tensor 2), each rank's
    vocab block of its batch rows, gathered."""
    want = jax.jit(lambda p, t: jllama.apply(p, LCFG, t))(
        jax.tree.map(jnp.asarray, inputs["llama"]),
        jnp.asarray(inputs["toks"]))
    res = gang.result()
    for r in res:
        np.testing.assert_allclose(r["logits"].numpy(), np.asarray(want),
                                   atol=2e-4, rtol=1e-3)
        assert r["context_left"]


def test_blocks_are_cut_on_whole_heads(inputs, gang):
    """llama-tiny (4 query heads, 2 KV, hd 32) at (fsdp 2, tensor 2): wq
    [L, D, 128] held as [2, 64, 64], wk as one KV head [2, 64, 32], wo
    and w_down by rows; gemma-tiny's one KV head held whole at (data 2,
    tensor 2); the LoRA factors cut with their base weight's side."""
    res = gang.result()[0]
    assert res["llama_local"] == {
        "attn_norm": (2, 64), "wq": (2, 64, 64), "wk": (2, 64, 32),
        "wv": (2, 64, 32), "wo": (2, 64, 64), "mlp_norm": (2, 64),
        "w_gate": (2, 64, 192), "w_up": (2, 64, 192),
        "w_down": (2, 192, 64)}
    assert res["gemma_local"]["wk"] == (2, 128, 32)
    assert res["gemma_local"]["wq"] == (2, 128, 64)
    assert res["gemma_local"]["w_down"] == (2, 256, 128)
    assert res["lora_local"] == {
        "wq.A": (2, 64, 4), "wq.B": (2, 4, 64), "wk.A": (2, 64, 4),
        "wk.B": (2, 4, 32), "wv.A": (2, 64, 4), "wv.B": (2, 4, 32),
        "wo.A": (2, 64, 4), "wo.B": (2, 4, 64)}


def test_llama_trainer_matches_reference(inputs, gang):
    losses, want, trainer = _reference(jllama, LCFG, _jmesh(1, 2), inputs,
                                       "llama")
    res = gang.result()
    got = res[0]["llama"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    _assert_close(got["params"], want)
    assert got["opt_bytes"] == trainer.opt_state_bytes(per_replica=True)
    _assert_ranks_agree(res, "llama")


def test_gemma_zero_trainer_matches_reference(inputs, gang):
    """(data 2, tensor 2) with ZeRO moments. The reference cuts gemma's
    one KV head's 32 columns over tensor; the port holds wk and wv whole
    there, so each of their moments covers twice the reference's share:
    the per-rank bytes exceed the reference's by exactly that."""
    losses, want, trainer = _reference(jgemma, GCFG, _jmesh(2, 1), inputs,
                                       "gemma",
                                       tc=dict(zero_optimizer=True))
    res = gang.result()
    got = res[0]["gemma"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    _assert_close(got["params"], want)
    # wk, wv [L=2, 128, 32]: ZeRO's data slice on the layers dim, the
    # reference's tensor cut on the columns
    kv = 2 * 128 * 32 * 4
    extra = 2 * 2 * (kv // 2 - kv // 4)   # 2 leaves x 2 moments
    assert got["opt_bytes"] == trainer.opt_state_bytes(per_replica=True) \
        + extra
    _assert_ranks_agree(res, "gemma")


def test_llama_chunked_loss_matches_reference(inputs, gang):
    trainer = jtrainer.Trainer(
        mesh=_jmesh(1, 2), apply_fn=None,
        init_fn=lambda k: jllama.init(k, LCFG),
        logical_axes=jllama.param_logical_axes(LCFG),
        train_config=jtrainer.TrainConfig(**TC), loss_fn=_chunked)
    losses, want = _run(trainer, inputs["llama"], inputs)
    res = gang.result()
    got = res[0]["chunked"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    _assert_close(got["params"], want)
    # the dense and the chunked loss agree at the same params
    np.testing.assert_allclose(got["losses"][0],
                               res[0]["llama"]["losses"][0], rtol=2e-5)
    _assert_ranks_agree(res, "chunked")


def _lora_reference(inputs):
    shapes = jax.eval_shape(_lora_init, jax.ShapeDtypeStruct((2,),
                                                             jnp.uint32))
    base_axes = jllama.param_logical_axes(LCFG)
    return jtrainer.Trainer(
        mesh=_jmesh(1, 2), apply_fn=None, init_fn=_lora_init,
        logical_axes={"base": base_axes,
                      "lora": jlora.lora_logical_axes(base_axes, JLC)},
        train_config=jtrainer.TrainConfig(**LORA_TC),
        loss_fn=jlora.lora_loss_fn(_loss(jllama, LCFG), JLC),
        freeze_labels=jlora.lora_freeze_labels(shapes))


def test_lora_trainer_matches_reference(inputs, gang):
    """wq's A and wo's B are held whole on every tensor rank, wk's and
    wv's B cut with their one KV head each; the base stays bit for bit."""
    losses, want = _run(_lora_reference(inputs), inputs["lora"], inputs)
    res = gang.result()
    got = res[0]["lora"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    _assert_close(got["params"], want["lora"])
    assert got["base_unchanged"]
    _assert_ranks_agree(res, "lora")


def test_gradients_match_jax_grad(inputs, gang, llama_grads):
    """One step's gradients before the optimizer, full leaves, against
    jax.grad of the reference's loss: llama-tiny on (fsdp 2, tensor 2),
    gemma-tiny on (data 2, tensor 2) and the LoRA factors."""
    gemma = _jgrads(_loss(jgemma, GCFG), inputs["gemma"], inputs)

    def lora_loss(ad, t, tg):
        return jlora.lora_loss_fn(_loss(jllama, LCFG), JLC)(
            {"base": inputs["lora"]["base"], "lora": ad}, t, tg, None)

    lora = _jgrads(lora_loss, inputs["lora"]["lora"], inputs)
    for r in gang.result():
        errs = {("llama", n): e for n, e in
                _grad_errs(r["llama_grads"], llama_grads).items()}
        errs.update({("gemma", n): e for n, e in
                     _grad_errs(r["gemma_grads"], gemma).items()})
        errs.update({("lora", n): _rel_l2(g, lora[n.removeprefix("lora.")])
                     for n, g in r["lora_grads"].items()})
        assert len(errs) == 12 + 11 + 8
        assert max(errs.values()) <= GRAD_TOL, errs


def test_a_whole_leaf_summed_over_tensor_fails_the_check(gang, llama_grads):
    """The control: final_norm's gradient, whole on every tensor rank,
    summed over the axis once more comes out doubled, and only it."""
    got = gang.result()[0]["control_grads"]
    errs = _grad_errs(got, llama_grads)
    assert errs.pop("final_norm") > 0.5
    assert max(errs.values()) <= GRAD_TOL


@pytest.mark.parametrize("policy", ["full", "mlp", "dots", "outside"])
def test_remat_reruns_the_collectives(gang, llama_grads, policy):
    """With remat the backward reruns each block, its psums included, on
    every rank in the same order: the gradients are unchanged. "outside":
    "dots" with the backward run outside the tensor context, as
    autograd's device thread runs a CUDA backward."""
    for r in gang.result():
        errs = _grad_errs(r["remat"][policy], llama_grads)
        assert max(errs.values()) <= GRAD_TOL, errs


def test_checkpoint_round_trip_under_tensor_parallelism(gang):
    """Saved under (fsdp 2, tensor 2) (stamped with its data axis, 1),
    restored on one device and under (data 2, fsdp 2): params and
    moments bit-equal."""
    ck = gang.result()[0]["ckpt"]
    assert ck["saved_stamp"] == 1
    assert ck["one"] == {"stamp": 1, "step": 3, "params": True, "opt": True}
    assert ck["df"] == {"stamp": 2, "step": 3, "params": True, "opt": True}
