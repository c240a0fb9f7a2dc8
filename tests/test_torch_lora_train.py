"""LoRA training with a frozen base in the port against the JAX
reference, on the CPU (kubeflow_tpu/train/lora.py: `init_lora`,
`lora_train_tree`, `lora_freeze_labels`, `lora_loss_fn`; the trainer's
`freeze_labels`; tests/test_lora.py's cases on a one-device mesh).

The reference's base weights and adapters reach the port as numpy
arrays (`bridge.from_jax(..., dtype=torch.float32)`); batches come from numpy
seeds.

Tolerances (fp32; other summation orders): `lora_loss_fn`'s value 1e-6
relative and the adapters' gradients within 1e-5 of each leaf's
max|ref|; a 3-step trainer run: losses 1e-5, adapters within 5e-5 +
5e-5 |ref| but for at most 5e-4 of a leaf's elements, and those within
5e-4 (AdamW's per-element normalisation, as tests/test_torch_train.py
explains). The base is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.train import lora as jlora
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs.metrics import Registry
from kubeflow_tpu_torch.train import lora as tlora
from kubeflow_tpu_torch.train import trainer as ttrain
from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

JCFG, TCFG = jllama.LLAMA_TINY, tllama.LLAMA_TINY
JLC, TLC = jlora.LoraConfig(rank=4, alpha=8.0), tlora.LoraConfig(rank=4,
                                                                 alpha=8.0)
TC = dict(warmup_steps=2, total_steps=100, learning_rate=3e-3)


def _batch(b=8, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _adapters_to_torch(ad):
    return {"blocks": {n: {k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in ab.items()}
                       for n, ab in ad["blocks"].items()}}


def _tloss(p, t, tg, m):
    return ttrain.cross_entropy_loss(tllama.apply(p, TCFG, t), tg, m)


def _jloss(p, t, tg, m):
    return jtrain.cross_entropy_loss(jllama.apply(p, JCFG, t), tg, m)


def test_init_lora_starts_at_the_base():
    base = tllama.init(TCFG, 0, "cpu", train=True)
    a, b = (tlora.init_lora(TCFG, TLC, 1, "cpu") for _ in range(2))
    assert set(a["blocks"]) == set(TLC.targets)
    for name, ab in a["blocks"].items():
        d_in, d_out = (getattr(TCFG, x) for x in tlora._TARGET_DIMS[name])
        assert tuple(ab["A"].shape) == (TCFG.num_layers, d_in, TLC.rank)
        assert tuple(ab["B"].shape) == (TCFG.num_layers, TLC.rank, d_out)
        assert torch.equal(ab["A"], b["blocks"][name]["A"])
        assert not ab["B"].any()
        # truncated normal on [-2, 2] (std 0.880) times d_in**-0.5
        assert ab["A"].abs().max() <= 2 * d_in**-0.5 + 1e-6
        assert abs(float(ab["A"].std()) * d_in**0.5 / 0.880 - 1) < 0.1
    merged = tlora.merge_lora(base, a, TLC)
    for name, w in base["blocks"].items():
        assert torch.equal(merged["blocks"][name], w), name


def test_freeze_labels_of_a_train_tree():
    tree = tlora.lora_train_tree(tllama.init(TCFG, 0, "cpu", train=True),
                                 tlora.init_lora(TCFG, TLC, 1, "cpu"))
    labels = tlora.lora_freeze_labels(tree)
    flat = ttrain._named_leaves(labels)
    assert [n for n, _ in flat] == [n for n, _ in
                                    ttrain._named_leaves(tree)]
    assert {lab for n, lab in flat if n.startswith("base.")} == {"freeze"}
    assert {lab for n, lab in flat if n.startswith("lora.")} == {"train"}


def test_loss_and_adapter_gradients_match_reference():
    """B drawn non-zero (numpy) so A's gradient is not 0."""
    base = jax.tree.map(np.asarray, jllama.init(jax.random.key(0), JCFG))
    ad = jax.tree.map(np.asarray, jlora.init_lora(jax.random.key(1), JCFG,
                                                  JLC))
    rng = np.random.default_rng(4)
    for ab in ad["blocks"].values():
        ab["B"] = (rng.standard_normal(ab["B"].shape) * 0.05).astype(
            np.float32)
    toks, tgts = _batch()
    jval, jgrad = jax.value_and_grad(
        lambda tree: jlora.lora_loss_fn(_jloss, JLC)(
            tree, jnp.asarray(toks), jnp.asarray(tgts), None))(
        jlora.lora_train_tree(jax.tree.map(jnp.asarray, base),
                              jax.tree.map(jnp.asarray, ad)))
    tbase = bridge.from_jax(base, TCFG, "cpu", dtype=TCFG.param_dtype)
    tad = _adapters_to_torch(ad)
    leaves = [x.requires_grad_(True) for ab in tad["blocks"].values()
              for x in ab.values()]
    loss = tlora.lora_loss_fn(_tloss, TLC)(
        tlora.lora_train_tree(tbase, tad), torch.from_numpy(toks),
        torch.from_numpy(tgts), None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-6)
    want = [np.asarray(x) for ab in jgrad["lora"]["blocks"].values()
            for x in ab.values()]
    for g, w in zip(grads, want, strict=True):
        err = float(np.abs(g.numpy() - w).max())
        assert 0 < np.abs(w).max() and err <= 1e-5 * np.abs(w).max(), err


def _reference_run(steps=3):
    def init_fn(rng):
        k1, k2 = jax.random.split(rng)
        return jlora.lora_train_tree(jllama.init(k1, JCFG),
                                     jlora.init_lora(k2, JCFG, JLC))

    base_axes = jllama.param_logical_axes(JCFG)
    shapes = jax.eval_shape(init_fn, jax.ShapeDtypeStruct((2,), jnp.uint32))
    trainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda tree, toks: jllama.apply(
            jlora.merge_lora(tree["base"], tree["lora"], JLC), JCFG, toks),
        init_fn=init_fn,
        logical_axes={"base": base_axes,
                      "lora": jlora.lora_logical_axes(base_axes, JLC)},
        train_config=jtrain.TrainConfig(**TC),
        loss_fn=jlora.lora_loss_fn(_jloss, JLC),
        freeze_labels=jlora.lora_freeze_labels(shapes))
    state = trainer.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, state.params)
    toks, tgts = _batch()
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, jnp.asarray(toks),
                                   jnp.asarray(tgts))
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state.params), trainer


def _port_trainer(tree):
    return ttrain.Trainer(
        apply_fn=None, init_fn=None, train_config=ttrain.TrainConfig(**TC),
        loss_fn=tlora.lora_loss_fn(_tloss, TLC), device="cpu",
        freeze_labels=tlora.lora_freeze_labels(tree))


def _port_tree(init):
    return tlora.lora_train_tree(
        bridge.from_jax(init["base"], TCFG, "cpu", dtype=TCFG.param_dtype),
        _adapters_to_torch(init["lora"]))


def _assert_close(got, want, name):
    diff = np.abs(got - want)
    far = diff > 5e-5 + 5e-5 * np.abs(want)
    assert far.mean() <= 5e-4, (name, int(far.sum()), float(diff.max()))
    assert diff.max() <= 5e-4, (name, float(diff.max()))


@pytest.fixture(scope="module")
def reference():
    return _reference_run()


def test_trainer_matches_reference_frozen_base(reference):
    init, want_losses, want, jtrainer = reference
    tree = _port_tree(init)
    trainer = _port_trainer(tree)
    state = trainer.init_from_params(tree)
    base_before = {n: t.clone() for n, t in
                   ttrain._named_leaves(state.params["base"])}
    assert not any(t.requires_grad for t in base_before.values())
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = bridge.to_numpy(state.params["lora"])
    for name, ab in want["lora"]["blocks"].items():
        for k in ("A", "B"):
            _assert_close(got["blocks"][name][k], ab[k], f"{name}.{k}")
    assert any(np.abs(got["blocks"][n]["B"]).max() > 0 for n in TLC.targets)
    # the base never moved: bitwise, and it is the reference's
    for n, t in ttrain._named_leaves(state.params["base"]):
        assert torch.equal(t, base_before[n]), n
    # moment leaves exist for the adapters only
    n_lora = len(ttrain._leaves(state.params["lora"]))
    assert all(len(state.opt_state[s]) == n_lora for s in ("mu", "nu"))
    assert trainer.opt_state_bytes() == 2 * 4 * sum(
        t.numel() for t in ttrain._leaves(state.params["lora"]))
    assert trainer.opt_state_bytes() == jtrainer.opt_state_bytes() - 8
    assert trainer.param_count == jtrainer.param_count


def test_checkpoint_and_resume(reference, tmp_path):
    init = reference[0]
    tree = _port_tree(init)
    trainer = _port_trainer(tree)
    state = trainer.init_from_params(tree)
    toks, tgts = (torch.from_numpy(a) for a in _batch(seed=2))
    for _ in range(3):
        state, _ = trainer.step(state, toks, tgts)
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path), enable_async=False),
                        trainer, registry=Registry())
    ckpt.save(state, force=True)
    opt = torch.load(tmp_path / "3" / "opt_state.pt", weights_only=True)
    assert all(n.startswith("lora.") for n in opt["mu"]) and opt["nu"]
    restored = ckpt.restore()
    for (na, a), (nb, b) in zip(ttrain._named_leaves(state.params),
                                ttrain._named_leaves(restored.params)):
        assert na == nb and torch.equal(a, b), na
        assert b.requires_grad == na.startswith("lora.")
    for slot in ("mu", "nu"):
        for a, b in zip(state.opt_state[slot], restored.opt_state[slot],
                        strict=True):
            assert torch.equal(a, b)
    state, l1 = trainer.step(state, toks, tgts)
    restored, l2 = trainer.step(restored, toks, tgts)
    assert float(l1) == float(l2)
    for a, b in zip(ttrain._leaves(state.params),
                    ttrain._leaves(restored.params)):
        assert torch.equal(a, b)
