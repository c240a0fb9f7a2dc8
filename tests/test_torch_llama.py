"""The port's Llama forward against the JAX reference: LLAMA_TINY fp32
logits on the same weights (the reference's init, carried over by
`bridge.from_jax`) and the same tokens.

Tolerance: atol/rtol 1e-4 on fp32 logits — two layers of fp32 matmuls
whose sums run in different orders in the two frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama


@pytest.mark.parametrize("variant", [{}, {"sliding_window": 5},
                                     {"tie_embeddings": True}])
def test_tiny_logits_match_reference(variant):
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, **variant)
    tcfg = dataclasses.replace(tllama.LLAMA_TINY, **variant)
    params = jllama.init(jax.random.key(0), jcfg)
    tparams = bridge.from_jax(jax.tree.map(np.asarray, params), tcfg,
                              "cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = jllama.apply(params, jcfg, jnp.asarray(toks))
    got = tllama.apply(tparams, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_bridge_dtypes_and_shapes():
    cfg = tllama.LLAMA_TINY
    params = jllama.init(jax.random.key(1), jllama.LLAMA_TINY)
    tparams = bridge.from_jax(jax.tree.map(np.asarray, params), cfg, "cpu",
                              dtype=torch.bfloat16)
    shapes = tllama.param_shapes(cfg)
    assert tparams["blocks"]["wq"].dtype == torch.bfloat16
    assert tparams["blocks"]["attn_norm"].dtype == torch.float32
    assert tparams["lm_head"].dtype == torch.float32
    for name, shape in shapes["blocks"].items():
        assert tuple(tparams["blocks"][name].shape) == shape


def test_seeded_init_is_repeatable_and_shaped():
    cfg = tllama.LLAMA_TINY
    a = tllama.init(cfg, 3, "cpu")
    b = tllama.init(cfg, 3, "cpu")
    c = tllama.init(cfg, 4, "cpu")
    assert torch.equal(a["blocks"]["w_up"], b["blocks"]["w_up"])
    assert not torch.equal(a["blocks"]["w_up"], c["blocks"]["w_up"])
    # the reference's fan-in scaling: truncated N(0,1) * fan_in**-0.5
    w = a["blocks"]["w_down"]
    assert abs(float(w.std()) * cfg.intermediate_size**0.5 - 0.88) < 0.05
    assert torch.count_nonzero(a["blocks"]["mlp_norm"]) == 0
