"""The port's trainer on a mesh (train/fsdp.py: FSDP blocks gathered
per block, the batch over the data axes, ZeRO-sliced moments) against
the reference's `Trainer` on a mesh of the same shape, on the CPU:
LLAMA_TINY, GEMMA_TINY and VIT_TINY on (data 2, fsdp 2), with
`zero_optimizer` on and off, and a LoRA pack on LLAMA_TINY that adapts
wq, wk, wv and wo; 3 AdamW steps from the reference's initial params on
one global batch. ViT's attention and MLP biases, its head bias and the
wo adapter's A are held whole on every rank (their logical axes map to
"tensor", which is 1), so their gradients must still be summed over
fsdp. All torch-side cases run in one spawn of a 4-rank gloo gang
(tests/torch_dist.py); the reference runs on 4 of the 8 virtual CPU
devices.

Tolerances: losses within 2e-5 relative (fp32, sums in another order
and over gloo); params after 3 steps within rtol 5e-3, atol 5e-4 (the
reference's own trainer-parity bound: an AdamW step turns a
rounding-level gradient difference near 0 into up to a learning rate);
ViT's key bias, whose gradient is rounding noise around an exact 0
(softmax ignores a per-query constant), is held within 3 learning rates
of 0 on both sides, as tests/test_torch_vit.py holds it; per-rank
optimizer-state bytes equal to the reference's
`opt_state_bytes(per_replica=True)`. Every rank ends with the same
params.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.models import vit as jvit
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.train import lora as jlora
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import llama_moe as tmoe
from kubeflow_tpu_torch.models import llama_pp as tpp
from kubeflow_tpu_torch.parallel import Mesh, MeshSpec, create_mesh
from kubeflow_tpu_torch.train import TrainConfig, Trainer
from torch_dist import run_gang

MODELS = {"llama": (jllama, jllama.LLAMA_TINY),
          "gemma": (jgemma, jgemma.GEMMA_TINY)}
JLC = jlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wk", "wv", "wo"))
VIT_TC = dict(learning_rate=1e-3, warmup_steps=0, total_steps=20)
LORA_TC = dict(warmup_steps=2, total_steps=100, learning_rate=3e-3)


def _jmesh():
    return jcreate_mesh(JMeshSpec(data=2, fsdp=2, tensor=1),
                        devices=jax.devices()[:4])


def _vit_payload():
    """ViT-tiny's params with a random head (so every leaf gets a
    gradient) and 8 images with their classes."""
    p = jax.tree.map(np.asarray, jvit.init(jax.random.key(4),
                                           jvit.VIT_TINY))
    rng = np.random.default_rng(14)
    p["head_w"] = rng.normal(scale=0.2, size=p["head_w"].shape).astype(
        np.float32)
    p["head_b"] = rng.normal(scale=0.1, size=p["head_b"].shape).astype(
        np.float32)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (8, 1)).astype(np.int32)
    return {"vit": p, "vit_x": x, "vit_y": y,
            "vit_w": np.ones((8, 1), np.float32)}


def _lora_init(rng):
    k1, k2 = jax.random.split(rng)
    return jlora.lora_train_tree(jllama.init(k1, jllama.LLAMA_TINY),
                                 jlora.init_lora(k2, jllama.LLAMA_TINY, JLC))


@pytest.fixture(scope="module")
def setup():
    params = {name: jax.tree.map(np.asarray, mod.init(jax.random.key(3),
                                                      cfg))
              for name, (mod, cfg) in MODELS.items()}
    params["llama4"] = jax.tree.map(np.asarray, jllama.init(
        jax.random.key(6), dataclasses.replace(jllama.LLAMA_TINY,
                                               num_layers=4)))
    lora = jax.tree.map(np.asarray, _lora_init(jax.random.key(7)))
    # B = 0 at init: draw it, so the first step's adapters move both
    rng = np.random.default_rng(8)
    for ab in lora["lora"]["blocks"].values():
        ab["B"] = rng.normal(scale=0.05, size=ab["B"].shape).astype(
            np.float32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (8, 16)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    res = run_gang("fsdp_cases", 4, dict(params, toks=toks, tgts=tgts,
                                         lora=lora, **_vit_payload()))
    return params, toks, tgts, lora, res


def _reference(name, zero, params, toks, tgts):
    mod, cfg = MODELS[name]
    mesh = _jmesh()
    trainer = jtrainer.Trainer(
        mesh=mesh, apply_fn=lambda p, t: mod.apply(p, cfg, t),
        init_fn=lambda k: mod.init(k, cfg),
        logical_axes=mod.param_logical_axes(cfg),
        train_config=jtrainer.TrainConfig(warmup_steps=1, total_steps=10,
                                          zero_optimizer=zero))
    state = trainer.init_from_params(jax.tree.map(jnp.asarray, params))
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, jnp.asarray(toks),
                                   jnp.asarray(tgts))
        losses.append(float(loss))
    return (losses, jax.tree.map(np.asarray, state.params),
            trainer.opt_state_bytes(per_replica=True))


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("name", ["llama", "gemma"])
def test_fsdp_trainer_matches_reference(setup, name, zero):
    params, toks, tgts, _, res = setup
    losses, want, opt_bytes = _reference(name, zero, params[name], toks,
                                         tgts)
    got = res[0][(name, zero)]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    for k, w in want["blocks"].items():
        np.testing.assert_allclose(got["params"]["blocks"][k].numpy(), w,
                                   rtol=5e-3, atol=5e-4, err_msg=k)
    for k in ("embed", "final_norm"):
        np.testing.assert_allclose(got["params"][k].numpy(), want[k],
                                   rtol=5e-3, atol=5e-4, err_msg=k)
    assert got["opt_bytes"] == opt_bytes
    for r in res[1:]:
        assert r[(name, zero)]["losses"] == got["losses"]


def test_blocks_and_moments_are_sharded(setup):
    """wq [L, D, n_q hd] is held as its fsdp block along D (128 / 2);
    the embedding's moment [vocab, D] is its fsdp block (512, 64), and
    with ZeRO half of that along vocab (the first dim data divides), and
    the per-rank bytes drop."""
    *_, res = setup
    zero, plain = res[0][("llama", True)], res[0][("llama", False)]
    assert zero["local"]["wq"] == (2, 64, 128)
    assert plain["mu"] == (512, 64) and zero["mu"] == (256, 64)
    assert zero["opt_bytes"] < plain["opt_bytes"]
    assert res[0]["shard_gather"] == ((2, 64, 128), True)


def _assert_params_close(got, want, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_params_close(got[k], w, f"{prefix}{k}.")
            continue
        np.testing.assert_allclose(got[k].numpy(), w, rtol=5e-3, atol=5e-4,
                                   err_msg=prefix + k)


@pytest.mark.parametrize("zero", [True, False])
def test_fsdp_vit_matches_reference(setup, zero):
    """ViT-tiny's whole leaves (bq, bk, bv, b1, head_b, at tensor = 1)
    take the gradient of the whole batch, not of their fsdp rank's rows:
    the loss, every leaf and every rank agree with the reference."""
    *_, res = setup
    vp = _vit_payload()
    cfg = jvit.VIT_TINY
    trainer = jtrainer.Trainer(
        mesh=_jmesh(),
        apply_fn=lambda p, imgs: jvit.apply(p, cfg, imgs)[:, None, :],
        init_fn=lambda k: jvit.init(k, cfg),
        logical_axes=jvit.param_logical_axes(cfg),
        train_config=jtrainer.TrainConfig(zero_optimizer=zero, **VIT_TC))
    state = trainer.init_from_params(jax.tree.map(jnp.asarray, vp["vit"]))
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, *(jnp.asarray(vp[f"vit_{k}"])
                                            for k in "xyw"))
        losses.append(float(loss))
    want = jax.tree.map(np.asarray, state.params)
    got = res[0][("vit", zero)]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    for r in res[1:]:
        other = r[("vit", zero)]
        assert other["losses"] == got["losses"]
        for k, v in other["params"]["blocks"].items():
            assert torch.equal(v, got["params"]["blocks"][k]), k
        assert torch.equal(other["params"]["head_b"],
                           got["params"]["head_b"])
    lr3 = 3 * VIT_TC["learning_rate"]
    assert np.abs(want["blocks"].pop("bk")).max() <= lr3
    got = dict(got["params"], blocks=dict(got["params"]["blocks"]))
    assert np.abs(got["blocks"].pop("bk").numpy()).max() <= lr3
    _assert_params_close(got, want)


def test_fsdp_lora_with_wo_matches_reference(setup):
    """A LoRA pack on q, k, v and o: wo's A ("heads", "lora_rank") is
    held whole on every rank, its B cut over fsdp; the base stays frozen
    and the adapters match the reference's after 3 steps."""
    _, toks, tgts, lora, res = setup
    cfg = jllama.LLAMA_TINY
    base_axes = jllama.param_logical_axes(cfg)
    shapes = jax.eval_shape(_lora_init, jax.ShapeDtypeStruct((2,),
                                                             jnp.uint32))

    def loss(p, t, tg, m):
        return jtrainer.cross_entropy_loss(jllama.apply(p, cfg, t), tg, m)

    trainer = jtrainer.Trainer(
        mesh=_jmesh(),
        apply_fn=None, init_fn=_lora_init,
        logical_axes={"base": base_axes,
                      "lora": jlora.lora_logical_axes(base_axes, JLC)},
        train_config=jtrainer.TrainConfig(**LORA_TC),
        loss_fn=jlora.lora_loss_fn(loss, JLC),
        freeze_labels=jlora.lora_freeze_labels(shapes))
    state = trainer.init_from_params(jax.tree.map(jnp.asarray, lora))
    losses = []
    for _ in range(3):
        state, loss_ = trainer.step(state, jnp.asarray(toks),
                                    jnp.asarray(tgts))
        losses.append(float(loss_))
    want = jax.tree.map(np.asarray, state.params["lora"])
    got = res[0]["lora"]
    assert got["wo_A"] == (2, 128, 4)   # whole: [L, q_dim, rank]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert got["losses"][-1] < got["losses"][0]
    _assert_params_close(got["params"], want)
    for r in res[1:]:
        assert r["lora"]["losses"] == got["losses"]
        for n, ab in r["lora"]["params"]["blocks"].items():
            for k, v in ab.items():
                assert torch.equal(v, got["params"]["blocks"][n][k]), (n, k)


@pytest.mark.parametrize("policy", ["full", "mlp", "dots"])
def test_layer_gathers_do_not_outlive_their_block(setup, policy):
    """Under remat, a block's gathered layer is made inside the block's
    checkpointed region: once the forward is done only the leaves
    gathered once (the embedding [vocab, D], the final norm [D] and the
    head [D, vocab]) can be alive, and the backward's recompute gathers
    each layer again (4 layers, 9 stacked leaves each)."""
    *_, res = setup
    got = res[0]["alive"][policy]
    assert got["made"] == 3 + 4 * 9
    assert set(got["alive"]) <= {(512, 128), (128,), (128, 512)}
    assert len(got["alive"]) <= 3
    assert got["regathered"] == 4 * 9


def test_tensor_parallel_mesh_is_refused_by_name():
    """What the mesh trainer still refuses at tensor > 1 is refused by
    name (tests/test_torch_tensor_parallel.py trains llama, gemma and
    LoRA there, tests/test_torch_mesh_recipes.py the MoE family, ViT,
    Adafactor and gradient accumulation): the pipeline, a mesh trainer
    without the model's config, a query head count the axis does not
    divide, KV heads that neither divide nor are divided by it, and an
    expert count the axis does not divide."""
    mesh = create_mesh(MeshSpec(data=1, fsdp=2, tensor=2), devices=range(4))

    def build(cfg, axes, tc=TrainConfig(), mesh=mesh):
        return Trainer(None, None, tc, device="cpu", mesh=mesh,
                       logical_axes=axes, model_config=cfg)

    cfg = tllama.LLAMA_TINY
    with pytest.raises(ValueError, match="needs the model's config"):
        build(None, tllama.param_logical_axes(cfg))
    odd = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1)
    with pytest.raises(ValueError, match="num_heads 3 is not divisible"):
        build(odd, tllama.param_logical_axes(odd))
    odd = dataclasses.replace(tgemma.GEMMA_TINY, num_heads=6,
                              num_kv_heads=3)
    with pytest.raises(ValueError, match="num_kv_heads 3 at tensor=2"):
        build(odd, tgemma.param_logical_axes(odd))
    odd = dataclasses.replace(tmoe.MIXTRAL_TINY, num_experts=3)
    with pytest.raises(ValueError, match="num_experts 3 is not divisible"):
        build(odd, tmoe.param_logical_axes(odd))
    staged = Mesh(np.arange(4).reshape(2, 2), ("stage", "tensor"), "cpu")
    with pytest.raises(ValueError, match="not ported for the pipeline"):
        tpp.PipelineTrainer(cfg, staged, device="cpu")
