"""Gemma training in the port against the JAX reference's, on the CPU:
`gemma.init(train=True)`, the training forward (unbound layers, remat),
loss and gradients through `gemma.apply` with dense cross entropy, and
3-step runs of the model-agnostic `Trainer`
(`Trainer(apply_fn=lambda p, t: gemma.apply(p, cfg, t))`) from the same
weights (the reference's init, carried over with `bridge.from_jax`) on
the same batch, the reference on a one-device mesh.

Two configs: the reference's GEMMA_TINY (4 heads of 32 over one KV
head, no remat) and a narrow config with gemma-2b's head geometry (8
query heads over one KV head of 256, hidden 256, vocab 512, 2 layers)
with remat on, as GEMMA_2B has it, on both sides.

Tolerances, as tests/test_torch_train.py states them where they can be
the same: losses 1e-5 (fp32, different summation orders); gradients
atol 1e-5 + rtol 1e-4, the tied head's gradient summing over both of
its uses. Params after 3 steps: every element within 5e-5 but for at
most 1e-4 of a leaf's elements (at least 2), and those within 1e-3.
AdamW divides each element by its own RMS, so where an element's
gradient is within fp32 rounding of zero the two frameworks' m /
sqrt(v) differ more than elsewhere; with one KV head the wv gradient
sums over every query head, so its few such elements are a larger share
of a small leaf. Observed: 1 element of wv's 8192 past 5e-5 (tiny), 18
of wo's 1048576 (hd256), the worst 5.3e-4 (hd256's wv). 1e-3 is a tenth
of one step's movement at lr 1e-2 (Adam moves an element by about lr),
so an element the port moves the wrong way fails.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import gemma as tgemma
from kubeflow_tpu_torch.train import trainer as ttrain

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=5e-5)
PARAM_OUTLIER_TOL = 1e-3
TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)

_HD256 = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=8, num_kv_heads=1, head_dim=256,
              remat=True)
# name -> (reference config, port config)
CFGS = {
    "tiny": (jgemma.GEMMA_TINY, tgemma.GEMMA_TINY),
    "hd256": (dataclasses.replace(jgemma.GEMMA_TINY, **_HD256),
              dataclasses.replace(tgemma.GEMMA_TINY, **_HD256)),
}


def _assert_params_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
    assert far.sum() <= max(2, 1e-4 * far.size), (
        name, int(far.sum()), float(diff.max()))
    assert diff.max() <= PARAM_OUTLIER_TOL, (name, float(diff.max()))


def _batch(b=4, s=16, seed=3, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _params(name, seed=0):
    """The reference's init (numpy leaves) and the same weights in the
    port as fp32 masters."""
    jcfg, tcfg = CFGS[name]
    params = jax.tree.map(np.asarray, jgemma.init(jax.random.key(seed),
                                                  jcfg))
    return params, bridge.from_jax(params, tcfg, "cpu", dtype=torch.float32)


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# -- init and the training forward ------------------------------------------


@pytest.mark.parametrize("name", list(CFGS))
def test_train_init_keeps_fp32_masters(name):
    cfg = CFGS[name][1]
    train = _named(tgemma.init(cfg, 0, "cpu", train=True))
    serve = _named(tgemma.init(cfg, 0, "cpu"))
    shapes = _named(tgemma.param_shapes(cfg))
    assert train.keys() == serve.keys() == shapes.keys()
    for key, t in train.items():
        assert t.dtype == cfg.param_dtype == torch.float32, key
        assert tuple(t.shape) == shapes[key], key
        # the same draws; serving stores them in its own dtypes
        assert torch.equal(t.to(serve[key].dtype), serve[key]), key


def test_gemma_2b_param_count():
    """N of 6·N·T at gemma-2b: every leaf once, the tied head with the
    embedding (no lm_head)."""
    shapes = _named(tgemma.param_shapes(tgemma.GEMMA_2B))
    assert "lm_head" not in shapes
    assert sum(math.prod(s) for s in shapes.values()) == 2_506_434_560


def _old_apply(params, cfg, tokens):
    """The serving forward as it was before the training forward: each
    stacked leaf indexed per layer, no remat."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32).expand(b, s)
    inv_freq = tgemma.rope_frequencies(cfg.head_dim, theta=cfg.rope_theta,
                                       device=tokens.device)
    x = tgemma.embed_lookup(params["embed"], tokens, cfg.dtype)
    x = x * tgemma.embed_scale(cfg)
    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in params["blocks"].items()}
        x = tgemma._block(cfg, x, p, positions, inv_freq, None, True)
    x = tgemma.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["embed"].T.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CFGS))
def test_grad_off_apply_is_the_serving_forward(name, dtype):
    """With gradients off (serving), `apply` gives the serving forward's
    logits bit for bit, remat set or not."""
    cfg = dataclasses.replace(CFGS[name][1], dtype=dtype, remat=True)
    params = tgemma.init(cfg, 1, "cpu")
    toks = torch.from_numpy(_batch(2, 12, seed=1)[0])
    with torch.no_grad():
        got = tgemma.apply(params, cfg, toks)
        want = _old_apply(params, cfg, toks)
    assert torch.equal(got, want)


def _loss_and_grads(params, cfg, toks, tgts):
    live = {k: ({n: x.detach().clone().requires_grad_(True)
                 for n, x in v.items()} if isinstance(v, dict)
                else v.detach().clone().requires_grad_(True))
            for k, v in params.items()}
    named = _named(live)
    loss = ttrain.cross_entropy_loss(tgemma.apply(live, cfg, toks), tgts)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


@pytest.mark.parametrize("name", list(CFGS))
def test_remat_matches_no_remat(name):
    cfg = CFGS[name][1]
    params = tgemma.init(cfg, 2, "cpu", train=True)
    toks, tgts = (torch.from_numpy(a) for a in _batch(2, 12, seed=2))
    la, ga = _loss_and_grads(params, dataclasses.replace(cfg, remat=False),
                             toks, tgts)
    lb, gb = _loss_and_grads(params, dataclasses.replace(cfg, remat=True),
                             toks, tgts)
    assert la == lb
    for key, g in ga.items():
        assert torch.equal(gb[key], g), key


@pytest.mark.parametrize("name", list(CFGS))
def test_loss_and_gradients_match_reference(name):
    jcfg, tcfg = CFGS[name]
    params, tparams = _params(name, seed=4)
    toks, tgts = _batch(2, 12, seed=4)

    def jloss(p):
        return jtrain.cross_entropy_loss(
            jgemma.apply(p, jcfg, jnp.asarray(toks)), jnp.asarray(tgts))

    jval, jgrads = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, params))
    loss, grads = _loss_and_grads(tparams, tcfg, torch.from_numpy(toks),
                                  torch.from_numpy(tgts))
    np.testing.assert_allclose(loss, float(jval), **LOSS_TOL)
    want = _named(jax.tree.map(np.asarray, jgrads))
    assert grads.keys() == want.keys()
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key], **GRAD_TOL,
                                   err_msg=key)


# -- the Trainer ---------------------------------------------------------------


def _reference_run(name, steps=3):
    cfg = CFGS[name][0]
    trainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, t: jgemma.apply(p, cfg, t),
        init_fn=lambda k: jgemma.init(k, cfg),
        logical_axes=jgemma.param_logical_axes(cfg),
        train_config=jtrain.TrainConfig(**TC))
    state = trainer.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, state.params)
    toks, tgts = _batch()
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, jnp.asarray(toks),
                                   jnp.asarray(tgts))
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state.params), trainer


@pytest.mark.parametrize("name", list(CFGS))
def test_trainer_matches_reference_over_three_steps(name):
    init, want_losses, want_params, jtrainer = _reference_run(name)
    cfg = CFGS[name][1]
    trainer = ttrain.Trainer(
        apply_fn=lambda p, t: tgemma.apply(p, cfg, t),
        init_fn=lambda seed: tgemma.init(cfg, seed, "cpu", train=True),
        train_config=ttrain.TrainConfig(**TC), device="cpu")
    state = trainer.init_from_params(
        bridge.from_jax(init, cfg, "cpu", dtype=torch.float32))
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
    got = _named(bridge.to_numpy(state.params))
    want = _named(want_params)
    assert got.keys() == want.keys()
    for key, p in got.items():
        _assert_params_close(p, want[key], key)
    assert state.step == 3
    assert trainer.param_count == jtrainer.param_count == sum(
        math.prod(s) for s in _named(tgemma.param_shapes(cfg)).values())
    assert trainer.step_flops(4, 16) == jtrainer.step_flops(4, 16)
