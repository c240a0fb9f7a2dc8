"""The port's pipeline parallelism (parallel/pipeline.py) and
pipelined Llama (models/llama_pp.py) against the JAX reference, on the
CPU, in one spawn of a 4-rank gloo gang (tests/torch_dist.py).

Cases, the reference's tests/test_pipeline.py and test_llama_pp.py
ones: the GPipe schedule over 4 stages of a residual MLP equals the
sequential composition at 1, 2, 4 and 8 microbatches, and its
gradients equal the sequential ones; LLAMA_TINY pipelined over 2
stages on a (stage 2, data 2) mesh gives `llama.apply`'s logits and the
dense loss's gradients; `make_train_step`'s SGD lowers the loss from
the dense loss; `PipelineTrainer` on 4 layers (2 a stage, 4
microbatches, AdamW) gives the reference's dense `Trainer` losses and
params over 3 steps, its blocks held one stage a rank.

Tolerances (fp32, other summation orders): schedule outputs 1e-5,
logits 1e-4 of max |logit|, gradients 1e-4 of each leaf's max, trainer
losses 2e-5 relative and params the reference's own pipeline-trainer
bound (rtol 5e-3, atol 5e-4: an AdamW step turns a rounding-level
gradient difference near 0 into up to a learning rate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.parallel import pipeline as jpp
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import llama_pp
from kubeflow_tpu_torch.parallel import pipeline as pp
from torch_dist import run_gang

CFG = jllama.LLAMA_TINY
CFG4 = dataclasses.replace(CFG, num_layers=4)
TC = dict(warmup_steps=2, total_steps=10)


def _mlp_stage(params, x):
    h = jax.nn.gelu(x @ params["w1"] + params["b1"], approximate=False)
    return x + h @ params["w2"]


def _mlp_params(n=4, d=16, h=32, seed=0):
    rng = np.random.default_rng(seed)
    per = [{"w1": (rng.normal(size=(d, h)) * 0.1).astype(np.float32),
            "b1": np.zeros((h,), np.float32),
            "w2": (rng.normal(size=(h, d)) * 0.1).astype(np.float32)}
           for _ in range(n)]
    return per, jax.tree.map(np.asarray, jpp.stack_stage_params(per))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.fixture(scope="module")
def setup():
    per, stacked = _mlp_params()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    tgt = rng.normal(size=(4, 16)).astype(np.float32)
    params = _np(jllama.init(jax.random.key(0), CFG))
    params4 = _np(jllama.init(jax.random.key(4), CFG4))
    toks, tgts = _data(CFG, 4, 16, 2)
    toks4, tgts4 = _data(CFG4, 8, 16, 4)
    res = run_gang("pipeline_cases", 4, dict(
        mlp=stacked, x=x, tgt=tgt, llama=params, toks=toks, tgts=tgts,
        llama4=params4, toks4=toks4, tgts4=tgts4))
    return dict(per=per, stacked=stacked, x=x, tgt=tgt, params=params,
                params4=params4, toks=toks, tgts=tgts, toks4=toks4,
                tgts4=tgts4), res


def _close_tree(got, want, rel, what):
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=rel,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{what} {k}")


def test_ranks_agree(setup):
    _, res = setup
    for r in res[1:]:
        for m in (1, 2, 4, 8):
            np.testing.assert_array_equal(r[("mlp", m)].numpy(),
                                          res[0][("mlp", m)].numpy())
        assert r["trainer_losses"] == res[0]["trainer_losses"]


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_schedule_matches_sequential(setup, m):
    d, res = setup
    want = jpp.reference_forward(_mlp_stage, d["per"], jnp.asarray(d["x"]))
    np.testing.assert_allclose(res[0][("mlp", m)].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_schedule_grads_match_sequential(setup):
    d, res = setup

    def loss_seq(stacked):
        per = [jax.tree.map(lambda leaf: leaf[i], stacked) for i in range(4)]
        y = jpp.reference_forward(_mlp_stage, per, jnp.asarray(d["x"][:4]))
        return jnp.mean((y - d["tgt"]) ** 2)

    want = jax.grad(loss_seq)(jax.tree.map(jnp.asarray, d["stacked"]))
    _close_tree(res[0]["mlp_grads"], want, 1e-4, "mlp")


def test_pipelined_llama_logits_and_grads_match_dense(setup):
    d, res = setup
    toks = jnp.asarray(d["toks"])
    want = np.asarray(jllama.apply(d["params"], CFG, toks))
    got = res[0]["logits"].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())

    def dense_loss(p):
        logp = jax.nn.log_softmax(jllama.apply(p, CFG, toks), axis=-1)
        return jnp.mean(-jnp.take_along_axis(
            logp, jnp.asarray(d["tgts"])[..., None], axis=-1))

    g = jax.grad(dense_loss)(jax.tree.map(jnp.asarray, d["params"]))
    flat = {".".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(g)}
    _close_tree(res[0]["pp_grads"], flat, 1e-4, "llama")


def test_sgd_step_trains_from_the_dense_loss(setup):
    d, res = setup
    logp = jax.nn.log_softmax(jllama.apply(d["params"], CFG,
                                           jnp.asarray(d["toks"])), axis=-1)
    dense = float(jnp.mean(-jnp.take_along_axis(
        logp, jnp.asarray(d["tgts"])[..., None], axis=-1)))
    sgd = res[0]["sgd"]
    np.testing.assert_allclose(sgd[0], dense, rtol=1e-5)
    assert sgd[-1] < sgd[0], sgd


def test_pipeline_trainer_matches_reference_trainer(setup):
    d, res = setup
    mesh = jcreate_mesh(JMeshSpec(data=1, fsdp=1, tensor=1),
                        devices=jax.devices()[:1])
    trainer = jtrainer.Trainer(
        mesh=mesh, apply_fn=lambda p, t: jllama.apply(p, CFG4, t),
        init_fn=lambda k: jllama.init(k, CFG4),
        logical_axes=jllama.param_logical_axes(CFG4),
        train_config=jtrainer.TrainConfig(**TC))
    state = trainer.init_from_params(jax.tree.map(jnp.asarray,
                                                  d["params4"]))
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, jnp.asarray(d["toks4"]),
                                   jnp.asarray(d["tgts4"]))
        losses.append(float(loss))
    np.testing.assert_allclose(res[0]["trainer_losses"], losses, rtol=2e-5)
    got = res[0]["trainer_params"]
    want = _np(state.params)
    for k in want["blocks"]:
        np.testing.assert_allclose(got["blocks"][k].numpy(),
                                   want["blocks"][k], rtol=5e-3, atol=5e-4,
                                   err_msg=k)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    # each rank held its stage's 2 of the 4 layers
    assert res[0]["wq_local"][0] == 2


def test_split_merge_and_refusals():
    params = tllama.init(tllama.LLAMA_TINY, 0, "cpu")
    staged = llama_pp.split_stages(params, tllama.LLAMA_TINY, 2)
    assert all(v.shape[:2] == (2, 1) for v in staged.values())
    merged = llama_pp.merge_stages(staged)
    for k, v in params["blocks"].items():
        assert (merged[k] == v).all()
    with pytest.raises(ValueError, match="not divisible"):
        llama_pp.split_stages(params, tllama.LLAMA_TINY, 3)
    per = [{"w": torch.full((2,), float(i))} for i in range(3)]
    stacked = pp.stack_stage_params(per)
    assert stacked["w"].shape == (3, 2) and stacked["w"][2, 0] == 2.0
