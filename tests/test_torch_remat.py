"""The llama remat policies ("full", "mlp", "dots") in the port against
the JAX reference's, on the CPU (kubeflow_tpu/models/llama.py's
`_REMAT_POLICIES`; the port's `_remat_context`).

The reference's weights reach the port with `bridge.from_jax(...,
dtype=torch.float32)`; the batch comes from a numpy seed. Each policy's loss and
every gradient leaf against the reference under the same policy: the
loss within the reference's own rtol 1e-6 between policies
(tests/test_llama.py), the gradients within 1e-5 + 1e-5 |ref| (fp32,
summed in other orders; tests/test_torch_train.py's bound). The port's
three policies are the same arithmetic on the CPU: bit-equal.

What each policy recomputes in the backward is counted by a dispatch
mode: the `aten.mm` calls of a backward with remat, less those of one
without (the gradients' own products), per layer. A block runs seven
2-D products (wq, wk, wv, wo, w_gate, w_up, w_down). "full" reruns six:
w_down's output only feeds the residual add, which saves nothing, so
the recompute stops before it, as XLA drops the same dead product in the
reference. "mlp" reruns the four attention-side ones, "dots" none. The
attention core (`bmm` on the CPU's plain path, the flash forward on the
card) is rerun under every policy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.train import trainer as ttrain

POLICIES = ("full", "mlp", "dots")
RECOMPUTED_MM = {"full": 6, "mlp": 4, "dots": 0}   # per layer
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def case():
    params = jax.tree.map(np.asarray, jllama.init(jax.random.key(0),
                                                  jllama.LLAMA_TINY))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jllama.LLAMA_TINY.vocab_size, (2, 16)).astype(
        np.int32)
    return params, toks, np.roll(toks, -1, axis=1)


def _port(case, remat, policy):
    """-> (loss, grads by leaf name, mm calls of the backward)."""
    params, toks, tgts = case
    cfg = dataclasses.replace(tllama.LLAMA_TINY, remat=remat,
                              remat_policy=policy)
    tp = bridge.from_jax(params, cfg, "cpu", dtype=cfg.param_dtype)
    named = {**{f"blocks.{n}": v for n, v in tp["blocks"].items()},
             **{k: v for k, v in tp.items() if k != "blocks"}}
    for v in named.values():
        v.requires_grad_(True)
    loss = ttrain.cross_entropy_loss(
        tllama.apply(tp, cfg, torch.from_numpy(toks)),
        torch.from_numpy(tgts))
    ops = _CountOps()
    with ops:
        grads = torch.autograd.grad(loss, list(named.values()))
    return (loss.detach(), dict(zip(named, grads)),
            ops.counts.get(torch.ops.aten.mm.default, 0))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_reference(case, policy):
    params, toks, tgts = case
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, remat=True,
                               remat_policy=policy)
    jl, jg = jax.value_and_grad(lambda p: jtrain.cross_entropy_loss(
        jllama.apply(p, jcfg, jnp.asarray(toks)), jnp.asarray(tgts)))(
        jax.tree.map(jnp.asarray, params))
    loss, grads, _ = _port(case, True, policy)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    jg = jax.tree.map(np.asarray, jg)
    want = {**{f"blocks.{n}": v for n, v in jg["blocks"].items()},
            **{k: v for k, v in jg.items() if k != "blocks"}}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_policies_are_the_same_arithmetic(case):
    base_loss, base_grads, _ = _port(case, False, "full")
    for policy in POLICIES:
        loss, grads, _ = _port(case, True, policy)
        assert torch.equal(loss, base_loss), policy
        for name, g in grads.items():
            assert torch.equal(g, base_grads[name]), (policy, name)


@pytest.mark.parametrize("policy", POLICIES)
def test_recomputed_products_per_layer(case, policy):
    _, _, plain = _port(case, False, "full")
    _, _, with_remat = _port(case, True, policy)
    layers = tllama.LLAMA_TINY.num_layers
    assert (with_remat - plain) == RECOMPUTED_MM[policy] * layers, (
        policy, with_remat, plain)


def test_unknown_policy_names_the_choices():
    with pytest.raises(ValueError, match=r"\['dots', 'full', 'mlp'\]"):
        dataclasses.replace(tllama.LLAMA_TINY, remat_policy="some")
    assert tllama.REMAT_POLICIES == tuple(jllama._REMAT_POLICIES)


def test_policy_runs_in_the_trainer():
    """One trainer step under each policy from the same weights: the same
    loss and the same params, bit for bit."""
    states = []
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 16)))
    for policy in POLICIES:
        cfg = dataclasses.replace(tllama.LLAMA_TINY, remat=True,
                                  remat_policy=policy)
        trainer = ttrain.Trainer(
            apply_fn=lambda p, t, cfg=cfg: tllama.apply(p, cfg, t),
            init_fn=lambda seed, cfg=cfg: tllama.init(cfg, seed, "cpu",
                                                      train=True),
            train_config=ttrain.TrainConfig(warmup_steps=0, total_steps=10),
            device="cpu")
        state, loss = trainer.step(trainer.init(0), toks,
                                   torch.roll(toks, -1, 1))
        states.append((float(loss), state.params["blocks"]["w_up"]))
    for loss, w in states[1:]:
        assert loss == states[0][0]
        assert torch.equal(w, states[0][1])
