"""The port's Adafactor (and the frozen group of `freeze_labels`)
against optax, and the port's Adafactor trainer against the reference's
and through a checkpoint, on the CPU (kubeflow_tpu/train/trainer.py's
`make_optimizer`: optax.chain(clip_by_global_norm(grad_clip),
optax.adafactor(schedule, weight_decay_rate=weight_decay or None)),
optax 0.2.6).

The optimizer cases feed both sides the same params and five steps of
gradients from numpy seeds, over leaves optax factors (both trailing
axes >= 128, in either order, and a leading layers axis) and leaves it
does not (a vector, a matrix under 128, a matrix with one axis under
128). Gradients are scaled up on some steps so the global-norm clip and
the block-RMS clip both act.

Tolerances: params after each step within 1e-6 + 1e-5 |ref| (fp32; the
means sum in another order, optax evaluates the schedule and the decay
in fp32 where the port evaluates the schedule in float64 and rounds it;
read: at most 1.5e-8 absolute; the block-RMS clip acted on 18 of 60
leaf updates); the second-moment state 1e-5 relative.
The trainer against the reference's over 3 steps of LLAMA_TINY: losses
1e-5, params within 5e-5 + 5e-5 |ref| (Adafactor's factored RMS does not
divide an element by its own RMS, so no element is magnified the way
AdamW's are).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs.metrics import Registry
from kubeflow_tpu_torch.train import trainer as ttrain
from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

SHAPES = {"wide": (256, 160), "tall": (200, 130), "stacked": (2, 128, 144),
          "small": (64, 96), "thin": (300, 8), "vec": (130,)}
FACTORED = {"wide", "tall", "stacked"}
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * 0.05).astype(np.float32)
            for name, shape in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    scale = 30.0 if step % 2 else 0.01   # odd steps: the global clip acts
    return {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, shape in SHAPES.items()}


def _optax_chain(tc):
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=tc.learning_rate,
        warmup_steps=tc.warmup_steps,
        decay_steps=max(tc.total_steps, tc.warmup_steps + 1),
        end_value=tc.learning_rate * 0.1)
    return optax.chain(optax.clip_by_global_norm(tc.grad_clip),
                       optax.adafactor(learning_rate=schedule,
                                       weight_decay_rate=tc.weight_decay
                                       or None))


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_update_matches_optax_over_five_steps(weight_decay):
    tc = ttrain.TrainConfig(optimizer="adafactor", warmup_steps=1,
                            weight_decay=weight_decay, learning_rate=1e-2,
                            total_steps=20)
    jopt = _optax_chain(tc)
    jp = jax.tree.map(jnp.asarray, _params())
    jstate = jopt.init(jp)
    opt = ttrain.make_optimizer(tc)
    assert isinstance(opt, ttrain.Adafactor)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    tstate = opt.init(tp)
    for step in range(5):
        g = _grads(step)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(g[k]) for k in tp], tstate, tp)
        for name in tp:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                       err_msg=f"{name} step {step}",
                                       **STEP_TOL)
    assert tstate["count"] == 5
    fstate = jstate[1][0]             # adafactor's scale_by_factored_rms
    for i, name in enumerate(tp):
        if name in FACTORED:
            for slot in ("v_row", "v_col"):
                np.testing.assert_allclose(
                    tstate[slot][i].numpy(),
                    np.asarray(getattr(fstate, slot)[name]), rtol=1e-5,
                    err_msg=f"{name} {slot}")
            assert tstate["v"][i].numel() == 0
        else:
            np.testing.assert_allclose(tstate["v"][i].numpy(),
                                       np.asarray(fstate.v[name]),
                                       rtol=1e-5, err_msg=name)
            assert tstate["v_row"][i].numel() == 0


def test_frozen_group_matches_multi_transform():
    """freeze_labels: optax.multi_transform({"train": chain, "freeze":
    set_to_zero()}): frozen leaves keep their values and have no state,
    and the clip's norm covers the trained leaves alone."""
    tc = ttrain.TrainConfig(optimizer="adafactor", **TC)
    labels = {name: "freeze" if name in ("wide", "vec") else "train"
              for name in SHAPES}
    jopt = optax.multi_transform(
        {"train": _optax_chain(tc), "freeze": optax.set_to_zero()}, labels)
    jp = jax.tree.map(jnp.asarray, _params())
    jstate = jopt.init(jp)
    opt = ttrain.make_optimizer(tc, labels)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    frozen_before = {k: tp[k].clone() for k in ("wide", "vec")}
    tstate = opt.init(tp)
    assert all(len(tstate[s]) == 4 for s in opt.slots)
    for step in range(4):
        g = _grads(step)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(g[k]) for k, lab in labels.items()
                    if lab == "train"], tstate, tp)
    for name in tp:
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   err_msg=name, **STEP_TOL)
    for name, before in frozen_before.items():
        assert torch.equal(tp[name], before)


def test_freeze_labels_errors():
    with pytest.raises(ValueError, match="unknown labels"):
        ttrain.make_optimizer(ttrain.TrainConfig(), {"a": "thaw"})
    opt = ttrain.make_optimizer(ttrain.TrainConfig(), {"a": "train"})
    with pytest.raises(ValueError, match="name different leaves"):
        opt.init({"b": torch.zeros(2)})


def _reference_run(steps):
    cfg = jllama.LLAMA_TINY
    trainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, t: jllama.apply(p, cfg, t),
        init_fn=lambda k: jllama.init(k, cfg),
        logical_axes=jllama.param_logical_axes(cfg),
        train_config=jtrain.TrainConfig(optimizer="adafactor", **TC))
    state = trainer.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, state.params)
    toks, tgts = _batch()
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, jnp.asarray(toks),
                                   jnp.asarray(tgts))
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state.params), trainer


def _batch(b=8, s=16, seed=11):
    toks = np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_trainer():
    cfg = tllama.LLAMA_TINY
    return ttrain.Trainer(
        apply_fn=lambda p, t: tllama.apply(p, cfg, t),
        init_fn=lambda seed: tllama.init(cfg, seed, "cpu", train=True),
        train_config=ttrain.TrainConfig(optimizer="adafactor", **TC),
        device="cpu")


def test_trainer_matches_reference_over_three_steps():
    init, want_losses, want_params, jtrainer = _reference_run(3)
    trainer = _port_trainer()
    state = trainer.init_from_params(
        bridge.from_jax(init, tllama.LLAMA_TINY, "cpu",
                        dtype=tllama.LLAMA_TINY.param_dtype))
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=1e-5)
    got = bridge.to_numpy(state.params)
    for name, want in want_params["blocks"].items():
        np.testing.assert_allclose(got["blocks"][name], want, atol=5e-5,
                                   rtol=5e-5, err_msg=name)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(got[name], want_params[name], atol=5e-5,
                                   rtol=5e-5, err_msg=name)
    # LLAMA_TINY has both kinds: optax's factored leaves hold a (1,)
    # placeholder v and the unfactored a (1,) v_row and v_col, where the
    # port holds empty tensors; optax adds two int32 counts
    leaves = ttrain._leaves(state.params)
    placeholders = sum(
        4 if ttrain._factored_dims(p.shape) else 8 for p in leaves)
    assert any(ttrain._factored_dims(p.shape) for p in leaves)
    assert not all(ttrain._factored_dims(p.shape) for p in leaves)
    assert trainer.opt_state_bytes() == \
        jtrainer.opt_state_bytes() - 8 - placeholders
    adamw_bytes = 2 * 4 * trainer.param_count
    assert trainer.opt_state_bytes() < adamw_bytes / 10


def test_adafactor_trains_and_checkpoints(tmp_path):
    """The port's tests/test_llama.py::test_adafactor_trains_and_
    checkpoints: the loss falls over 5 steps, the factored state round-
    trips through the Checkpointer bit for bit, and a restored run's next
    step equals the uninterrupted one's."""
    trainer = _port_trainer()
    state = trainer.init(0)
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    losses = []
    for _ in range(5):
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path), enable_async=False),
                        trainer, registry=Registry())
    ckpt.save(state, force=True)
    restored = ckpt.restore(5)
    assert restored.opt_state["count"] == state.opt_state["count"] == 5
    for slot in trainer.optimizer.slots:
        for a, b in zip(state.opt_state[slot], restored.opt_state[slot],
                        strict=True):
            assert a.shape == b.shape and torch.equal(a, b), slot
    state, l1 = trainer.step(state, toks, tgts)
    restored, l2 = trainer.step(restored, toks, tgts)
    assert float(l1) == float(l2)
    for a, b in zip(ttrain._leaves(state.params),
                    ttrain._leaves(restored.params)):
        assert torch.equal(a, b)
    # an AdamW trainer refuses the Adafactor state
    adamw = dataclasses.replace(trainer.tc, optimizer="adamw")
    other = ttrain.Trainer(apply_fn=trainer.apply_fn,
                           init_fn=trainer.init_fn, train_config=adamw,
                           device="cpu")
    with pytest.raises(ValueError, match="another optimizer"):
        Checkpointer(CheckpointConfig(str(tmp_path), enable_async=False),
                     other, registry=Registry()).restore(5)
