"""The port's trainer against the JAX reference's on the CPU: the
learning-rate schedule, the two cross-entropy losses and their
gradients, and whole training runs of LLAMA_TINY from the same weights
(the reference's init, carried over with `bridge.from_jax`) on the same
batch, the reference on a one-device mesh.

Tolerances: the schedule 1e-9 relative (the port evaluates in float64,
optax in float32: ~1e-7 absolute at lr 1e-2 is covered by atol 1e-9 +
rtol 1e-6); losses and their gradients 1e-5 (fp32, different summation
orders); a 3-step run 1e-5 on losses. Params after 3 steps: every
element within 5e-5 but for at most 1e-4 of them, and those within
5e-4. AdamW normalises each gradient element by its own RMS, so where
an element's gradient is within fp32 rounding of zero the two
frameworks' m / sqrt(v) differ more than elsewhere (observed: 2
elements of 98304 past 5e-5, by 6e-5); 5e-4 is several times that and
a twentieth of one step's movement at lr 1e-2, so an element the port
moves the wrong way fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.train import trainer as ttrain

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=5e-5)
PARAM_OUTLIER_TOL = 5e-4
TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)


def _assert_params_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
    assert far.mean() <= 1e-4, (name, int(far.sum()), float(diff.max()))
    assert diff.max() <= PARAM_OUTLIER_TOL, (name, float(diff.max()))


def _batch(b=4, s=16, seed=3, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.mark.parametrize("warmup,total", [(10, 1000), (2, 50), (0, 20)])
def test_schedule_matches_optax(warmup, total):
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=total, end_value=3e-5)
    got = ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total,
                                              3e-5)
    for count in range(30):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   atol=1e-9, rtol=1e-6)
    assert got(0) == 0.0 or warmup == 0


def _logits_case(seed=0, b=2, s=8, vocab=96):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, s, vocab))).astype(np.float32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    return logits, targets, mask


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_grad_match_reference(masked):
    logits, targets, mask = _logits_case()
    m = mask if masked else None
    jval, jgrad = jax.value_and_grad(
        lambda x: jtrain.cross_entropy_loss(x, jnp.asarray(targets),
                                            None if m is None
                                            else jnp.asarray(m)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = ttrain.cross_entropy_loss(
        x, torch.from_numpy(targets),
        None if m is None else torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval),
                               **LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               **LOSS_TOL)


@pytest.mark.parametrize("num_chunks", [4, 5, 1])
def test_chunked_cross_entropy_and_grads_match_reference(num_chunks):
    """Chunk counts that divide the vocab (96), one that does not (5 ->
    the largest divisor, 4) and none."""
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 8, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 96)) * 0.5).astype(np.float32)
    _, targets, mask = _logits_case(seed=2)

    def jloss(h, w):
        return jtrain.chunked_cross_entropy_from_hidden(
            h, w, jnp.asarray(targets), jnp.asarray(mask),
            num_chunks=num_chunks)

    jval, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    loss = ttrain.chunked_cross_entropy_from_hidden(
        h, w, torch.from_numpy(targets), torch.from_numpy(mask),
        num_chunks=num_chunks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval),
                               **LOSS_TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgh), **LOSS_TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgw), **LOSS_TOL)


def _chunked(cfg, hidden_fn, unembed_fn, ce):
    def loss(params, tokens, targets, mask):
        return ce(hidden_fn(params, cfg, tokens), unembed_fn(params, cfg),
                  targets, mask, num_chunks=4)
    return loss


def _reference_run(loss_kind, steps=3):
    cfg = jllama.LLAMA_TINY
    loss_fn = None if loss_kind == "dense" else _chunked(
        cfg, jllama.hidden, jllama.unembed_matrix,
        jtrain.chunked_cross_entropy_from_hidden)
    trainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, t: jllama.apply(p, cfg, t),
        init_fn=lambda k: jllama.init(k, cfg),
        logical_axes=jllama.param_logical_axes(cfg),
        train_config=jtrain.TrainConfig(**TC), loss_fn=loss_fn)
    state = trainer.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, state.params)
    toks, tgts = _batch()
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, jnp.asarray(toks),
                                   jnp.asarray(tgts))
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state.params), trainer


def _port_trainer(cfg=tllama.LLAMA_TINY, loss_kind="dense", **tc):
    loss_fn = None if loss_kind == "dense" else _chunked(
        cfg, tllama.hidden, tllama.unembed_matrix,
        ttrain.chunked_cross_entropy_from_hidden)
    return ttrain.Trainer(
        apply_fn=lambda p, t: tllama.apply(p, cfg, t),
        init_fn=lambda seed: tllama.init(cfg, seed, "cpu", train=True),
        train_config=ttrain.TrainConfig(**{**TC, **tc}), loss_fn=loss_fn,
        device="cpu")


@pytest.mark.parametrize("loss_kind", ["dense", "chunked"])
def test_trainer_matches_reference_over_three_steps(loss_kind):
    init, want_losses, want_params, jtrainer = _reference_run(loss_kind)
    trainer = _port_trainer(loss_kind=loss_kind)
    state = trainer.init_from_params(
        bridge.from_jax(init, tllama.LLAMA_TINY, "cpu",
                        dtype=torch.float32))
    toks, tgts = _batch()
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, torch.from_numpy(toks),
                                   torch.from_numpy(tgts))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    # lr is 0 on the first update (optax counts from 0): steps 2 and 3 move
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)
    assert losses[2] < losses[1]
    got = bridge.to_numpy(state.params)
    for name in want_params["blocks"]:
        _assert_params_close(got["blocks"][name],
                             want_params["blocks"][name], name)
    for name in ("embed", "final_norm", "lm_head"):
        _assert_params_close(got[name], want_params[name], name)
    assert state.step == 3
    assert trainer.param_count == jtrainer.param_count \
        == tllama.num_params(tllama.LLAMA_TINY) \
        == jllama.num_params(jllama.LLAMA_TINY)
    assert trainer.step_flops(4, 16) == jtrainer.step_flops(4, 16)
    # both fp32 moments; optax adds its two int32 step counters
    assert trainer.opt_state_bytes() == jtrainer.opt_state_bytes() - 8


def _run(trainer, steps, mask=None, seed=0):
    state = trainer.init(seed)
    toks, tgts = _batch()
    mask = None if mask is None else torch.from_numpy(mask)
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, torch.from_numpy(toks),
                                   torch.from_numpy(tgts), mask)
        losses.append(float(loss))
    return losses, state


def test_grad_accum_matches_full_batch():
    """Mask-weighted microbatches equal the full batch (the reference's
    invariant), with a ragged mask so the weights differ."""
    mask = np.ones((4, 16), np.float32)
    mask[0, 5:] = 0
    mask[3, :2] = 0
    la, sa = _run(_port_trainer(grad_accum=1), 3, mask)
    lb, sb = _run(_port_trainer(grad_accum=2), 3, mask)
    np.testing.assert_allclose(lb, la, **LOSS_TOL)
    for name, p in sa.params["blocks"].items():
        _assert_params_close(sb.params["blocks"][name].detach(),
                             p.detach(), name)


def test_remat_matches_no_remat():
    cfg = dataclasses.replace(tllama.LLAMA_TINY, remat=True)
    la, sa = _run(_port_trainer(), 2)
    lb, sb = _run(_port_trainer(cfg), 2)
    assert lb == la
    for name, p in sa.params["blocks"].items():
        assert torch.equal(sb.params["blocks"][name], p), name


def test_loss_falls():
    losses, state = _run(_port_trainer(), 5)
    assert losses[-1] < losses[0], losses
    assert state.step == 5


def _adafactor_state():
    """Adafactor's state: factored (v_row, v_col) for a leaf with two axes
    of at least 128, whole (v) for a small one."""
    opt = ttrain.make_optimizer(ttrain.TrainConfig(optimizer="adafactor"))
    state = opt.init({"w": torch.zeros(256, 128), "b": torch.zeros(4)})
    got = {s: [tuple(t.shape) for t in state[s]]
           for s in ("v_row", "v_col", "v")}
    return got, {"v_row": [(128,), (0,)], "v_col": [(256,), (0,)],
                 "v": [(0,), (4,)]}


def _frozen_leaf():
    """A frozen leaf has no optimizer state and is no autograd leaf."""
    labels = {"a": "train", "b": "freeze"}
    opt = ttrain.make_optimizer(ttrain.TrainConfig(), labels)
    params = {"a": torch.zeros(3), "b": torch.zeros(5)}
    state = opt.init(params)
    prepped = ttrain._prep(params, torch.device("cpu"), labels)
    got = ([tuple(t.shape) for t in state["mu"] + state["nu"]],
           {k: v.requires_grad for k, v in prepped.items()})
    return got, ([(3,), (3,)], {"a": True, "b": False})


def _mlp_policy():
    """Under "mlp" a block saves the 2-D products inside the MLP and
    recomputes the others."""
    cfg = dataclasses.replace(tllama.LLAMA_TINY, remat_policy="mlp")
    mm = torch.ops.aten.mm.default

    def decide():
        return tllama._save_policy(cfg.remat_policy, None, mm)

    outside = decide()
    with tllama._mlp_product():
        inside = decide()
    return (outside, inside), (CheckpointPolicy.PREFER_RECOMPUTE,
                               CheckpointPolicy.MUST_SAVE)


@pytest.mark.parametrize("build,msg", [
    (lambda: _adafactor_state(), "adafactor"),
    (lambda: _frozen_leaf(), "freeze_labels"),
    (lambda: _mlp_policy(), "remat_policy 'mlp'"),
])
def test_unported_options_raise(build, msg):
    """The options the port once refused by name (NotImplementedError)
    now build and do what they name."""
    got, want = build()
    assert got == want, msg


def test_trainer_errors():
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_optimizer(ttrain.TrainConfig(optimizer="sgd"))
    with pytest.raises(ValueError, match="remat_policy 'x' unknown"):
        dataclasses.replace(tllama.LLAMA_TINY, remat_policy="x")
    trainer = _port_trainer(grad_accum=3)
    with pytest.raises(RuntimeError, match="after init"):
        trainer.param_count
    state = trainer.init(0)
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        trainer.step(state, torch.zeros(4, 8, dtype=torch.int64),
                     torch.zeros(4, 8, dtype=torch.int64))


def test_to_numpy_inverts_from_jax():
    params = jax.tree.map(np.asarray,
                          jllama.init(jax.random.key(2), jllama.LLAMA_TINY))
    back = bridge.to_numpy(bridge.from_jax(params, tllama.LLAMA_TINY,
                                           "cpu", dtype=torch.float32))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
