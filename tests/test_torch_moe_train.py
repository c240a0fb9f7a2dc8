"""MoE training in the port against the JAX reference, on the CPU:
`parallel/moe.py::moe_mlp`'s gradients, `llama_moe.loss_fn`'s value and
every gradient leaf, remat, and whole trainer runs (kubeflow_tpu/
parallel/moe.py, kubeflow_tpu/models/llama_moe.py).

Inputs come from numpy seeds; the reference's weights reach the port as
numpy arrays (`bridge.from_jax(..., dtype=torch.float32)` for the model:
every leaf in fp32, the trainer's masters). Each case runs at the config's
capacity factor 1.25, where choices drop (asserted), and at a roomy 2.0,
where none does (asserted).

Tolerances (fp32 throughout; both frameworks sum in other orders):
- `moe_mlp` layer gradients: 1e-5 of the leaf's max|ref| (read: at
  most 4e-7 of it);
- `loss_fn`: loss 1e-6 relative; every gradient leaf within 1e-5 of its
  max|ref| (read: at most 1.1e-7 absolute, 1e-6 of max|ref|, at seed 0);
- a 3-step trainer run: losses 1e-5; params as tests/test_torch_train.py
  holds llama's, every element within 5e-5 but for at most 5e-4 of a
  leaf's, and those within 1e-3. AdamW normalises each gradient element
  by its own RMS, so where an element's gradient is within fp32 rounding
  of 0 the frameworks' m / sqrt(v) part (read: 4 of wq's 32768 elements
  past 5e-5, 1.2e-4 of them; 15 of w_up's 196608; the largest
  difference 6.8e-4 in wv, where the first gradient is
  -5.1e-8 against the leaf's RMS 1.9e-2); 1e-3 is a tenth of one step's
  movement at lr 1e-2, and an element moved the wrong way differs by
  twice that movement.
Remat on and off are the same computation on the CPU: bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama_moe as jmodel
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama_moe as tmodel
from kubeflow_tpu_torch.parallel import moe as tmoe
from kubeflow_tpu_torch.train import trainer as ttrain

CAPACITY = {"tight": 1.25, "roomy": 2.0}
GRAD_TOL = 1e-5            # of the leaf's max|ref|
LOSS_RTOL = 1e-6
TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)
PARAM_TOL = dict(atol=5e-5, rtol=5e-5)
PARAM_OUTLIER_TOL = 1e-3


def _cfgs(capacity_factor, **kw):
    return (dataclasses.replace(jmodel.MIXTRAL_TINY,
                                capacity_factor=capacity_factor, **kw),
            dataclasses.replace(tmodel.MIXTRAL_TINY,
                                capacity_factor=capacity_factor, **kw))


def _batch(b=2, s=32, seed=0, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


class _Drops:
    """Counts the choices each `moe._assign` call drops."""

    def __init__(self, monkeypatch):
        self.dropped = []
        assign = tmoe._assign

        def counted(*a, **kw):
            out = assign(*a, **kw)
            self.dropped.append(int((~out[3]).sum()))
            return out

        monkeypatch.setattr(tmoe, "_assign", counted)


def _assert_drops(drops, capacity):
    assert drops.dropped, "no routed layer ran"
    if capacity == "tight":
        assert sum(drops.dropped) > 0, drops.dropped
    else:
        assert sum(drops.dropped) == 0, drops.dropped


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    tol = GRAD_TOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (name, err, tol)


# -- the routed layer --------------------------------------------------------


@pytest.mark.parametrize("capacity", [0.5, 2.0])
def test_moe_mlp_gradients_match_reference(capacity, monkeypatch):
    """x, the router and the three expert stacks, through a weighted sum
    of the output plus the aux loss, at a tight capacity (a quarter of
    the choices fit) and at E / k."""
    kw = dict(num_experts=4, top_k=2, embed_dim=64, mlp_dim=96,
              capacity_factor=capacity)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(3), jcfg))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    wy = rng.standard_normal((3, 11, 64)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_mlp(p, x, jcfg)
        return jnp.sum(y * wy) + 0.7 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    drops = _Drops(monkeypatch)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_mlp(tp, tx, tcfg)
    (y * torch.from_numpy(wy)).sum().add(0.7 * aux).backward()
    assert (sum(drops.dropped) > 0) == (capacity < 1)
    _close(tx.grad, jgx, "x")
    for name in jp:
        _close(tp[name].grad, jgp[name], name)


def test_dropped_choice_gets_no_gradient():
    """A token whose every choice is dropped gets no gradient through the
    layer, nor do its gate values; its router row's gradient comes from
    the aux loss alone."""
    tcfg = tmoe.MoEConfig(num_experts=4, top_k=2, embed_dim=16, mlp_dim=24,
                          capacity_factor=0.5)
    p = {k: v.requires_grad_(True) for k, v in
         tmoe.init_moe(tcfg, 0, "cpu").items()}
    x = torch.randn(1, 12, 16, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    y, _ = tmoe.moe_mlp(p, x, tcfg)
    logits = x.detach().reshape(12, 16) @ p["router"].detach()
    keep = tmoe._assign(logits, tcfg, tcfg.capacity(12))[3]
    gone = ~keep.any(1)
    assert gone.any(), keep
    y.sum().backward()
    assert x.grad[0, gone].abs().max() == 0
    assert x.grad[0, ~gone].abs().max() > 0


# -- the model ---------------------------------------------------------------


def _value_and_grads(capacity, monkeypatch, seed=0):
    jcfg, tcfg = _cfgs(CAPACITY[capacity])
    jp = jmodel.init(jax.random.key(seed), jcfg)
    toks, tgts = _batch(seed=seed)
    jval, jgrad = jax.value_and_grad(jmodel.loss_fn(jcfg))(
        jp, jnp.asarray(toks), jnp.asarray(tgts), None)
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                         dtype=tcfg.param_dtype)
    leaves = {**{f"blocks.{n}": v for n, v in tp["blocks"].items()},
              **{k: v for k, v in tp.items() if k != "blocks"}}
    for v in leaves.values():
        v.requires_grad_(True)
    drops = _Drops(monkeypatch)
    loss = tmodel.loss_fn(tcfg)(tp, torch.from_numpy(toks),
                                torch.from_numpy(tgts), None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    jgrad = jax.tree.map(np.asarray, jgrad)
    want = {**{f"blocks.{n}": v for n, v in jgrad["blocks"].items()},
            **{k: v for k, v in jgrad.items() if k != "blocks"}}
    return (float(loss.detach()), float(jval), dict(zip(leaves, grads)), want,
            drops)


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_loss_and_every_gradient_match_reference(capacity, monkeypatch):
    got_l, want_l, got, want, drops = _value_and_grads(capacity,
                                                       monkeypatch)
    _assert_drops(drops, capacity)
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.dtype == torch.float32
        _close(g.numpy(), want[name], name)
    # the aux term reaches the router
    assert np.abs(want["blocks.router"]).max() > 0


def test_aux_loss_gradient_reaches_the_router(monkeypatch):
    """With the aux weight at 0 the router's gradient changes: the
    load-balance term is part of what the check above compares."""
    _, tcfg = _cfgs(1.25)
    params = tmodel.init(tcfg, 0, "cpu", train=True)
    toks, tgts = (torch.from_numpy(a) for a in _batch())

    def router_grad(cfg):
        p = {**params, "blocks": {k: v.detach().requires_grad_(True)
                                  for k, v in params["blocks"].items()}}
        loss = tmodel.loss_fn(cfg)(p, toks, tgts, None)
        return torch.autograd.grad(loss, p["blocks"]["router"])[0]

    with_aux = router_grad(tcfg)
    without = router_grad(dataclasses.replace(tcfg, aux_loss_weight=0.0))
    assert not torch.allclose(with_aux, without, rtol=1e-3, atol=0)


def test_remat_matches_no_remat():
    _, tcfg = _cfgs(1.25)
    params = tmodel.init(tcfg, 1, "cpu", train=True)
    toks, tgts = (torch.from_numpy(a) for a in _batch(seed=1))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        p = {k: ({n: x.detach().requires_grad_(True) for n, x in v.items()}
                 if isinstance(v, dict) else v.detach().requires_grad_(True))
             for k, v in params.items()}
        leaves = [*p["blocks"].values(), p["embed"], p["final_norm"],
                  p["lm_head"]]
        loss = tmodel.loss_fn(cfg)(p, toks, tgts, None)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_train_init_keeps_fp32_masters():
    _, tcfg = _cfgs(1.25, dtype=torch.bfloat16)
    train = tmodel.init(tcfg, 0, "cpu", train=True)
    serve = tmodel.init(tcfg, 0, "cpu")
    for name, leaf in train["blocks"].items():
        assert leaf.dtype == torch.float32, name
        # the same draws, rounded for serving where serving rounds
        assert torch.equal(leaf.to(serve["blocks"][name].dtype),
                           serve["blocks"][name]), name
    jp = jax.tree.map(np.asarray,
                      jmodel.init(jax.random.key(0), jmodel.MIXTRAL_TINY))
    tree = bridge.from_jax(jp, tcfg, "cpu", dtype=tcfg.param_dtype)
    assert all(v.dtype == torch.float32 for v in tree["blocks"].values())
    assert bridge.from_jax(jp, tcfg, "cpu")["blocks"]["router"].dtype == \
        torch.bfloat16


def test_apply_without_grad_builds_no_graph():
    """Serving's teacher passes: with gradients off nothing is recorded,
    even for leaves that require grad."""
    _, tcfg = _cfgs(2.0, remat=True)
    params = tmodel.init(tcfg, 0, "cpu", train=True)
    params["blocks"] = {k: v.requires_grad_(True)
                        for k, v in params["blocks"].items()}
    with torch.inference_mode():
        logits, aux = tmodel.apply(params, tcfg,
                                   torch.zeros(1, 8, dtype=torch.long))
    assert logits.grad_fn is None and aux.grad_fn is None


# -- the trainer -------------------------------------------------------------


def _reference_run(jcfg, steps=3):
    trainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, t: jmodel.apply(p, jcfg, t)[0],
        init_fn=lambda k: jmodel.init(k, jcfg),
        logical_axes=jmodel.param_logical_axes(jcfg),
        train_config=jtrain.TrainConfig(**TC),
        loss_fn=jmodel.loss_fn(jcfg))
    state = trainer.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, state.params)
    toks, tgts = _batch()
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, jnp.asarray(toks),
                                   jnp.asarray(tgts))
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state.params), trainer


def _assert_params_close(got, want, name):
    diff = np.abs(got - want)
    far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
    assert far.mean() <= 5e-4, (name, int(far.sum()), float(diff.max()))
    assert diff.max() <= PARAM_OUTLIER_TOL, (name, float(diff.max()))


def test_trainer_matches_reference_over_three_steps(monkeypatch):
    jcfg, tcfg = _cfgs(1.25)
    init, want_losses, want_params, jtrainer = _reference_run(jcfg)
    trainer = ttrain.Trainer(
        apply_fn=lambda p, t: tmodel.apply(p, tcfg, t)[0],
        init_fn=lambda seed: tmodel.init(tcfg, seed, "cpu", train=True),
        train_config=ttrain.TrainConfig(**TC),
        loss_fn=tmodel.loss_fn(tcfg), device="cpu")
    state = trainer.init_from_params(
        bridge.from_jax(init, tcfg, "cpu", dtype=tcfg.param_dtype))
    drops = _Drops(monkeypatch)
    toks, tgts = _batch()
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, torch.from_numpy(toks),
                                   torch.from_numpy(tgts))
        losses.append(float(loss))
    _assert_drops(drops, "tight")
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=1e-5)
    assert losses[2] < losses[0]
    got = bridge.to_numpy(state.params)
    for name in want_params["blocks"]:
        _assert_params_close(got["blocks"][name],
                             want_params["blocks"][name], name)
    for name in ("embed", "final_norm", "lm_head"):
        _assert_params_close(got[name], want_params[name], name)
    # the router moved, and moved as the reference's did
    moved = np.abs(want_params["blocks"]["router"]
                   - init["blocks"]["router"]).max()
    assert moved > 1e-3
    assert trainer.param_count == jtrainer.param_count
    assert trainer.opt_state_bytes() == jtrainer.opt_state_bytes() - 8
