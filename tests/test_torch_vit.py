"""The port's ViT (kubeflow_tpu_torch/models/vit.py) against the
reference's (kubeflow_tpu/models/vit.py) on the CPU, on VIT_TINY at
fp32 with the reference's weights carried over by `bridge.from_jax`.

The head is zero at init, so the logits are 0 there and every leaf but
the head gets a zero gradient: the comparisons draw a random head
first. Tolerances: logits 2e-5 absolute (fp32, other summation orders
over at most 192 terms); the loss 1e-5; each gradient leaf within
1e-4 of its largest element plus 1e-4 relative, but the key bias's:
softmax over keys is blind to a bias added to every key, so its exact
gradient is 0 and both frameworks give rounding noise, held under
1e-6 (the query bias's gradient is ~1e-2); a 3-step Trainer run
1e-5 on losses and 5e-5 on params (AdamW's moves are ~lr = 1e-3), the
key bias, whose noise AdamW turns into steps of up to lr, within 3 lr
of 0 in both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import vit as jvit
from kubeflow_tpu.ops import norms as jnorms
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import vit
from kubeflow_tpu_torch.ops import norms
from kubeflow_tpu_torch.train import trainer as ttrain

CFG = vit.VIT_TINY
JCFG = jvit.VIT_TINY
LOGIT_TOL = dict(atol=2e-5, rtol=0)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
TC = dict(learning_rate=1e-3, warmup_steps=0, total_steps=20)


def _images(b=4, seed=1, size=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    return x, y


def _ref_params(seed=0, cls=True):
    jcfg = dataclasses.replace(JCFG, use_cls_token=cls)
    p = jax.tree.map(np.asarray, jvit.init(jax.random.key(seed), jcfg))
    # a random head, so every leaf gets a gradient
    rng = np.random.default_rng(seed + 10)
    p["head_w"] = rng.normal(scale=0.2, size=p["head_w"].shape).astype(
        np.float32)
    p["head_b"] = rng.normal(scale=0.1, size=p["head_b"].shape).astype(
        np.float32)
    return p


def _ref_loss_fn(jcfg):
    def loss(p, x, y):
        logits = jvit.apply(p, jcfg, x)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, y[:, None], -1)[:, 0]
        return jnp.mean(logz - gold), logits
    return loss


def _port_loss(p, cfg, x, y):
    logits = vit.apply(p, cfg, x)
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (logz - gold).mean(), logits


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(scale, 1e-6),
                               err_msg=name)


def test_patchify_matches_reference():
    x, _ = _images(b=2)
    got = vit.patchify(CFG, torch.from_numpy(x)).numpy()
    want = np.asarray(jvit.patchify(JCFG, jnp.asarray(x)))
    assert got.shape == (2, CFG.num_patches, CFG.patch_dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((3, 5, 64))).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = norms.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                           torch.from_numpy(b))
    want = jnorms.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                             jnp.asarray(b))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol * 4, rtol=tol)


def test_init_shapes_and_zero_logits():
    p = vit.init(CFG, 0, "cpu")
    want = jax.tree.map(np.shape, jvit.init(jax.random.key(0), JCFG))
    got = {k: (dict(_leaves(v)) if isinstance(v, dict) else v)
           for k, v in p.items()}
    for name, leaf in _leaves(p):
        top, _, sub = name.partition(".")
        shape = want[top][sub] if sub else want[top]
        assert tuple(leaf.shape) == tuple(shape), name
        assert leaf.dtype == torch.float32
    assert set(got) == set(want)
    assert sum(t.numel() for _, t in _leaves(p)) == vit.num_params(CFG)
    x, _ = _images()
    logits = vit.apply(p, CFG, torch.from_numpy(x))
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    assert torch.count_nonzero(logits) == 0


@pytest.mark.parametrize("cls", [True, False])
def test_logits_and_gradients_match_reference(cls):
    jcfg = dataclasses.replace(JCFG, use_cls_token=cls)
    cfg = dataclasses.replace(CFG, use_cls_token=cls)
    ref = _ref_params(cls=cls)
    x, y = _images()
    (want_loss, want_logits), want_g = jax.value_and_grad(
        _ref_loss_fn(jcfg), has_aux=True)(ref, jnp.asarray(x),
                                          jnp.asarray(y))
    params = bridge.from_jax(ref, cfg, "cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, logits = _port_loss(params, cfg, torch.from_numpy(x),
                              torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **LOGIT_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **LOSS_TOL)
    want_leaves = dict(_leaves(jax.tree.map(np.asarray, want_g)))
    assert set(want_leaves) == set(leaves)
    for (name, _), g in zip(leaves.items(), grads):
        if name == "blocks.bk":
            assert float(g.abs().max()) < 1e-6
            assert float(np.abs(want_leaves[name]).max()) < 1e-6
            continue
        assert float(g.abs().max()) > 0, name
        _grad_close(g.numpy(), want_leaves[name], name)


def test_remat_equals_no_remat():
    params = bridge.from_jax(_ref_params(), CFG, "cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    x, y = _images()
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        loss, _ = _port_loss(params, cfg, torch.from_numpy(x),
                             torch.from_numpy(y))
        out[remat] = (loss, torch.autograd.grad(loss, list(leaves.values())))
    assert float(out[True][0].detach()) == float(out[False][0].detach())
    for name, a, b in zip(leaves, out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_bf16_activations_close_to_fp32():
    """VIT_B16's recipe (bf16 activations, fp32 params and head) on the
    tiny widths: the logits stay within bf16 noise of fp32's."""
    params = bridge.from_jax(_ref_params(), CFG, "cpu")
    x, _ = _images()
    with torch.no_grad():
        a = vit.apply(params, CFG, torch.from_numpy(x))
        b = vit.apply(params, dataclasses.replace(CFG,
                                                  dtype=torch.bfloat16),
                      torch.from_numpy(x))
    assert b.dtype == torch.float32
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) < 0.05 * scale


def test_trainer_matches_reference_over_three_steps():
    ref = _ref_params()
    x, y = _images(b=4)
    y1, w1 = y[:, None], np.ones((4, 1), np.float32)
    jtrainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, imgs: jvit.apply(p, JCFG, imgs)[:, None, :],
        init_fn=lambda k: jvit.init(k, JCFG),
        logical_axes=jvit.param_logical_axes(JCFG),
        train_config=jtrain.TrainConfig(**TC))
    state = jtrainer.init_from_params(jax.tree.map(jnp.asarray, ref))
    want = []
    for _ in range(3):
        state, loss = jtrainer.step(state, jnp.asarray(x), jnp.asarray(y1),
                                    jnp.asarray(w1))
        want.append(float(loss))
    want_params = jax.tree.map(np.asarray, state.params)

    trainer = ttrain.Trainer(
        apply_fn=vit.apply_fn(CFG),
        init_fn=lambda seed: vit.init(CFG, seed, "cpu"),
        train_config=ttrain.TrainConfig(**TC), device="cpu")
    tstate = trainer.init_from_params(bridge.from_jax(ref, CFG, "cpu"))
    got = []
    for _ in range(3):
        tstate, loss = trainer.step(tstate, torch.from_numpy(x),
                                    torch.from_numpy(y1),
                                    torch.from_numpy(w1))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[2] < got[0]
    got_params = dict(_leaves(bridge.to_numpy(tstate.params)))
    for name, w in _leaves(want_params):
        if name == "blocks.bk":
            # AdamW normalises the key bias's noise gradient to a step of
            # up to lr in either direction: both stay within 3 steps of 0
            assert np.abs(got_params[name]).max() <= 3 * TC["learning_rate"]
            assert np.abs(w).max() <= 3 * TC["learning_rate"]
            continue
        np.testing.assert_allclose(got_params[name], w, atol=5e-5,
                                   rtol=5e-5, err_msg=name)
    assert trainer.param_count == jtrainer.param_count == vit.num_params(CFG)
