"""The port's routed expert layer and MoE model against the JAX
reference, on the CPU (kubeflow_tpu/parallel/moe.py,
kubeflow_tpu/models/llama_moe.py).

Inputs come from numpy seeds; the reference's weights (`init_moe`,
`llama_moe.init`) reach the port as numpy arrays (`bridge.from_jax` for
the model). The routing cases run at E 4, k 2 and T 5, 16 and 33, at a
tight capacity (factor 0.5: a quarter of the tokens' choices fit, so
choices drop) and at E / k (nothing drops).

Tolerances:
- routing: dispatch exactly (the slot logic is integer); combine, frac
  and mean_prob within 1e-6 relative (the fp32 softmax's and the mean's
  last bit may differ between the frameworks: XLA's mean over 33 tokens
  lands one ulp from torch's).
- `moe_mlp` and the aux loss in fp32: relative 1e-5 of max|ref| (the
  expert products sum in another order in each framework); aux 1e-6.
- `moe_mlp` in bf16: |err| <= 2^-7 max|ref|. Both round the same
  places (the expert products, the SwiGLU, the combine) once to bf16,
  from fp32 sums in another order, so an element may land one bf16 ulp
  (2^-8 of itself) away, and the SwiGLU product and w_down carry such a
  step on. Read: bit-equal outputs, and at most 1.9e-4 max|ref| for the
  serving FFN, over seeds 3-9.
- `llama_moe.apply` logits in fp32: atol = rtol = 1e-4 (llama's bound:
  two layers of fp32 products summed in other orders); aux 1e-5
  relative. The serving FFN (`_moe_serving_mlp`) on one layer: the
  routed layer's bounds. No bf16 model-level bound: at bf16 a router
  probability moves by up to ~2e-3 between the frameworks at these
  widths, and where the k-th and (k+1)-th probabilities are closer a
  token takes another expert (a jump, not a rounding); the card's
  check excuses such positions by their router gap (chip_smoke.py
  phase 14).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama_moe as jmodel
from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu.serving.engine import _moe_serving_mlp as j_serving_mlp
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import llama_moe as tmodel
from kubeflow_tpu_torch.parallel import moe as tmoe
from kubeflow_tpu_torch.serving.engine import (
    _moe_serving_mlp as t_serving_mlp,
)

E, K = 4, 2
CAPACITY = {"tight": 0.5, "dropless": E / K}
FP32_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(capacity_factor, dtype="float32", d=64, m=96):
    """(reference, port) MoEConfig of one layer."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(num_experts=E, top_k=K, embed_dim=d, mlp_dim=m,
              capacity_factor=capacity_factor)
    return jmoe.MoEConfig(dtype=jdt, **kw), tmoe.MoEConfig(dtype=tdt, **kw)


def _layer(jcfg, seed):
    """The reference's layer params, as numpy and as torch tensors in the
    config's dtype."""
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    tdt = torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
          for k, v in jp.items()}
    return jp, tp


def _moe_params(jtree, tcfg):
    return bridge.from_jax(jax.tree.map(np.asarray, jtree), tcfg, "cpu")


# -- routing -----------------------------------------------------------------


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("T", [5, 16, 33])
def test_route_matches_reference(T, capacity):
    jcfg, tcfg = _cfgs(CAPACITY[capacity])
    cap = jcfg.capacity(T)
    assert tcfg.capacity(T) == cap
    logits = np.random.default_rng(T).standard_normal((T, E)).astype(
        np.float32)
    jd, jc, jf, jm = jmoe._route(jnp.asarray(logits), jcfg, cap)
    td, tc, tf, tm = tmoe._route(torch.from_numpy(logits), tcfg, cap)
    assert td.dtype == torch.bool and tuple(td.shape) == (T, E, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    kept = int(td.sum())
    if capacity == "dropless":
        assert cap == T and kept == T * K
    else:
        assert kept < T * K   # the tight capacity drops choices
        # rank-major: every token's first choice is kept before any
        # second choice takes a slot of that expert
        first = tmoe._assign(torch.from_numpy(logits), tcfg, cap)[3][:, 0]
        assert kept >= int(first.sum())


def test_gate_values_are_the_raw_top_k_probabilities():
    """The combine weights are the full softmax's top-k probabilities,
    not renormalised over the k chosen."""
    _, tcfg = _cfgs(E / K)
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, E)).astype(np.float32))
    _, combine, _, _ = tmoe._route(logits, tcfg, 8)
    probs = torch.softmax(logits, -1)
    want = torch.topk(probs, K, -1).values.sum(-1)
    torch.testing.assert_close(combine.sum((1, 2)), want)
    assert (combine.sum((1, 2)) < 1 - 1e-3).all()


def test_init_moe_shapes_and_scales():
    """The reference's recipe: normal times fan_in**-0.5 in cfg.dtype,
    repeatable by seed."""
    _, tcfg = _cfgs(E / K, "bfloat16", d=256, m=512)
    a, b = (tmoe.init_moe(tcfg, 3, "cpu") for _ in range(2))
    shapes = {"router": (256, E), "w_gate": (E, 256, 512),
              "w_up": (E, 256, 512), "w_down": (E, 512, 256)}
    for name, shape in shapes.items():
        assert tuple(a[name].shape) == shape and a[name].dtype == \
            torch.bfloat16, name
        assert torch.equal(a[name], b[name])
    assert abs(float(a["w_gate"].float().std()) * 256**0.5 - 1) < 0.05
    assert abs(float(a["w_down"].float().std()) * 512**0.5 - 1) < 0.05


# -- the routed layer --------------------------------------------------------


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_reference(dtype, capacity):
    jcfg, tcfg = _cfgs(CAPACITY[capacity], dtype)
    jp, tp = _layer(jcfg, seed=3)
    x = np.random.default_rng(3).standard_normal((2, 8, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.from_numpy(x).to(tcfg.dtype)
    jy, jaux = jmoe.moe_mlp(jp, jx, jcfg)
    ty, taux = tmoe.moe_mlp(tp, tx, tcfg)
    assert ty.dtype == tcfg.dtype and tuple(ty.shape) == (2, 8, 64)
    want = np.asarray(jy, np.float32)
    err = np.abs(ty.float().numpy() - want).max()
    rel = 1e-5 if dtype == "float32" else 2**-7
    assert err <= rel * np.abs(want).max(), err
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_index_dispatch_equals_one_hot_einsums():
    """`moe_mlp`'s gather/scatter by (expert, slot) gives the one-hot
    einsums' values (the reference's form, built here from `_route`),
    drops included."""
    _, tcfg = _cfgs(CAPACITY["tight"])
    _, tp = _layer(_cfgs(CAPACITY["tight"])[0], seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 11, 64)).astype(np.float32))
    y, _ = tmoe.moe_mlp(tp, x, tcfg)
    xt = x.reshape(33, 64)
    disp, combine, _, _ = tmoe._route(xt @ tp["router"], tcfg,
                                      tcfg.capacity(33))
    xe = torch.einsum("tec,td->ecd", disp.float(), xt)
    ye = tmoe._expert_ffn(tp, xe)
    want = torch.einsum("tec,ecd->td", combine, ye).reshape(3, 11, 64)
    torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-5)


# -- the model ---------------------------------------------------------------


def test_config_matches_reference():
    fields = [f.name for f in dataclasses.fields(jmodel.MoELlamaConfig)]
    assert fields == [f.name for f in dataclasses.fields(
        tmodel.MoELlamaConfig)]
    for jcfg, tcfg in ((jmodel.MoELlamaConfig(), tmodel.MIXTRAL_8X7B),
                       (jmodel.MIXTRAL_TINY, tmodel.MIXTRAL_TINY)):
        for f in fields:
            if f not in ("dtype", "param_dtype"):
                assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert (tcfg.q_dim, tcfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
        jm, tm = jcfg.moe_config(), tcfg.moe_config()
        for f in ("num_experts", "top_k", "embed_dim", "mlp_dim",
                  "capacity_factor"):
            assert getattr(tm, f) == getattr(jm, f), f
        for n in (1, 7, 64, 300):
            assert tm.capacity(n) == jm.capacity(n)


def _model(seed=0, **variant):
    jcfg = dataclasses.replace(jmodel.MIXTRAL_TINY, **variant)
    tcfg = dataclasses.replace(tmodel.MIXTRAL_TINY, **variant)
    params = jmodel.init(jax.random.key(seed), jcfg)
    return jcfg, tcfg, params, _moe_params(params, tcfg)


@pytest.mark.parametrize("capacity", ["config", "dropless"])
def test_apply_matches_reference(capacity):
    variant = ({} if capacity == "config" else
               {"capacity_factor": E / K})
    jcfg, tcfg, params, tparams = _model(**variant)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want, jaux = jmodel.apply(params, jcfg, jnp.asarray(toks))
    got, taux = tmodel.apply(tparams, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_mlp_matches_reference(dtype):
    """The engines' dropless FFN (`_moe_serving_mlp`) on one layer of the
    reference's fp32 params: both cast the four leaves, the router
    included, to the activation dtype at use."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = dataclasses.replace(jmodel.MIXTRAL_TINY, dtype=jdt)
    tcfg = dataclasses.replace(tmodel.MIXTRAL_TINY, dtype=tdt)
    blocks = jmodel.init(jax.random.key(6), jcfg)["blocks"]
    jp = {k: v[0] for k, v in blocks.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    h = np.random.default_rng(6).standard_normal((3, 7, 128)).astype(
        np.float32)
    want = np.asarray(j_serving_mlp(jcfg, jp, jnp.asarray(h, jdt)),
                      np.float32)
    got = t_serving_mlp(tcfg, tp, torch.from_numpy(h).to(tdt))
    assert got.dtype == tdt
    rel = 1e-5 if dtype == "float32" else 2**-7
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), err
    # the router is rounded before its fp32 product: an fp32 master
    # router and its bf16 copy route alike, bit for bit
    if dtype == "bfloat16":
        rounded = dict(tp, router=tp["router"].to(torch.bfloat16))
        assert torch.equal(
            t_serving_mlp(tcfg, rounded, torch.from_numpy(h).to(tdt)), got)


def test_bridge_dtypes_and_shapes():
    cfg = dataclasses.replace(tmodel.MIXTRAL_TINY, dtype=torch.bfloat16)
    params = jmodel.init(jax.random.key(2), jmodel.MIXTRAL_TINY)
    tparams = _moe_params(params, cfg)
    shapes = tmodel.param_shapes(cfg)
    assert set(tparams) == set(shapes)
    for name, shape in shapes["blocks"].items():
        leaf = tparams["blocks"][name]
        assert tuple(leaf.shape) == shape, name
        want = (torch.bfloat16 if name in tllama.MATRICES
                else torch.float32)
        assert leaf.dtype == want, name
    assert shapes["blocks"]["w_gate"] == (2, 4, 128, 192)
    assert shapes["blocks"]["w_down"] == (2, 4, 192, 128)
    assert tparams["lm_head"].dtype == torch.float32
    back = bridge.to_numpy(_moe_params(params, tmodel.MIXTRAL_TINY))
    np.testing.assert_array_equal(back["blocks"]["w_down"],
                                  np.asarray(params["blocks"]["w_down"]))


def test_seeded_init_is_repeatable_and_shaped():
    cfg = tmodel.MIXTRAL_TINY
    a = tmodel.init(cfg, 3, "cpu")
    b = tmodel.init(cfg, 3, "cpu")
    c = tmodel.init(cfg, 4, "cpu")
    for name in ("router", "w_gate", "w_down"):
        assert torch.equal(a["blocks"][name], b["blocks"][name])
        assert not torch.equal(a["blocks"][name], c["blocks"][name])
    # each layer of an expert stack is its own draw
    assert not torch.equal(a["blocks"]["w_up"][0], a["blocks"]["w_up"][1])
    # the fan-in scaling: truncated N(0,1) * fan_in**-0.5
    w = a["blocks"]["w_down"]
    assert abs(float(w.std()) * cfg.expert_mlp_dim**0.5 - 0.88) < 0.05
    assert torch.count_nonzero(a["blocks"]["mlp_norm"]) == 0
    # a Mixtral-width tree, leaf by leaf, as the reference's init shapes it
    jcfg = dataclasses.replace(jmodel.MoELlamaConfig(), num_layers=16)
    want = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg))
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        tmodel.param_shapes(dataclasses.replace(tmodel.MIXTRAL_8X7B,
                                                num_layers=16))


def test_store_stages_layer_draws_on_the_host():
    """`store="cpu"` keeps the same values (the draws happen on the
    device either way; here both are the CPU)."""
    cfg = tmodel.MIXTRAL_TINY
    a = tmodel.init(cfg, 5, "cpu")
    b = tmodel.init(cfg, 5, "cpu", store="cpu")
    for name, leaf in a["blocks"].items():
        assert torch.equal(leaf, b["blocks"][name]), name
