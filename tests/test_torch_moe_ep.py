"""The port's expert parallelism (parallel/moe.py's
`moe_mlp_expert_parallel` and `moe_mlp_sharded`) against the JAX
reference, on the CPU: 4 gloo ranks on a (data 1, fsdp 2, tensor 2)
mesh, the experts over tensor and the batch over all three axes, in one
spawn (tests/torch_dist.py).

Cases, the reference's tests/test_moe.py ones: at a generous capacity
(8.0, nothing drops) output and aux loss equal the reference's dense
`moe_mlp` and its `moe_mlp_sharded` on a mesh of the same shape, the
aux loss's router gradient and the gradients of sum(y^2) + 0.01 aux
equal the dense path's; at a tight capacity (0.5) the output equals the
reference's `moe_mlp` run on each rank's token block (capacity from the
local token count) and differs from the global-batch one.

Tolerances: fp32, other summation orders and a gloo sum: outputs and
gradients within 1e-4 (rtol and atol, the reference's own), the aux
loss within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu_torch.parallel import moe
from torch_dist import run_gang

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(num_experts=8, top_k=2, embed_dim=32, mlp_dim=64)
CFGS = {"generous": dict(BASE, capacity_factor=8.0),
        "tight": dict(BASE, capacity_factor=0.5)}


def _jcfg(name):
    return jmoe.MoEConfig(**CFGS[name])


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray,
                          jmoe.init_moe(jax.random.key(0), _jcfg("generous")))
    x = np.random.default_rng(0).normal(size=(8, 16, 32)).astype(np.float32)
    res = run_gang("moe_ep_cases", 4, {"params": params, "x": x,
                                       "cfgs": CFGS})
    return params, x, res


def _np(t):
    return t.detach().numpy()


def test_ranks_agree(setup):
    _, _, res = setup
    for r in res[1:]:
        for name in CFGS:
            np.testing.assert_array_equal(_np(r[name]["y"]),
                                          _np(res[0][name]["y"]))


def test_expert_parallel_matches_dense_and_reference(setup):
    params, x, res = setup
    got = res[0]["generous"]
    y, aux = jmoe.moe_mlp(params, jnp.asarray(x), _jcfg("generous"))
    np.testing.assert_allclose(_np(got["y"]), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(got["aux"]), float(aux), rtol=1e-5)
    mesh = jcreate_mesh(JMeshSpec(data=1, fsdp=2, tensor=2),
                        devices=jax.devices()[:4])
    ys, auxs = jax.jit(lambda p, x: jmoe.moe_mlp_sharded(
        p, x, _jcfg("generous"), mesh))(params, jnp.asarray(x))
    np.testing.assert_allclose(_np(got["y"]), np.asarray(ys), **TOL)
    np.testing.assert_allclose(float(got["aux"]), float(auxs), rtol=1e-5)


def test_aux_router_gradient_matches_dense(setup):
    params, x, res = setup
    want = jax.grad(lambda p: jmoe.moe_mlp(p, jnp.asarray(x),
                                           _jcfg("generous"))[1])(params)
    np.testing.assert_allclose(_np(res[0]["generous"]["g_aux"]),
                               np.asarray(want["router"]), rtol=1e-4,
                               atol=1e-6)


def test_gradients_match_dense(setup):
    params, x, res = setup

    def loss(p):
        y, aux = jmoe.moe_mlp(p, jnp.asarray(x), _jcfg("generous"))
        return jnp.sum(y ** 2) + 0.01 * aux

    want = jax.grad(loss)(params)
    for k, g in res[0]["generous"]["grads"].items():
        assert np.all(np.isfinite(_np(g))), k
        scale = float(np.abs(np.asarray(want[k])).max())
        np.testing.assert_allclose(_np(g), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=k)
    assert np.abs(_np(res[0]["generous"]["grads"]["router"])).max() > 0


def test_tight_capacity_matches_per_shard_dense(setup):
    """Capacity binds per token block: each rank's output is the
    reference's `moe_mlp` on its own 2 rows, not the global batch's."""
    params, x, res = setup
    tight = _jcfg("tight")
    per_shard = np.concatenate([np.asarray(jmoe.moe_mlp(
        params, jnp.asarray(blk), tight)[0]) for blk in np.split(x, 4)])
    got = _np(res[0]["tight"]["y"])
    np.testing.assert_allclose(got, per_shard, **TOL)
    dense = np.asarray(jmoe.moe_mlp(params, jnp.asarray(x), tight)[0])
    assert not np.allclose(got, dense, atol=1e-5)


def test_per_rank_entry_point_gives_its_block(setup):
    params, x, res = setup
    y, _ = jmoe.moe_mlp(params, jnp.asarray(x), _jcfg("generous"))
    for r, out in enumerate(res):
        np.testing.assert_allclose(_np(out["local"]),
                                   np.split(np.asarray(y), 4)[r], **TOL)


def test_logical_axes_and_refusals():
    assert moe.moe_logical_axes() == jmoe.moe_logical_axes()
    from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh

    mesh = create_mesh(MeshSpec(data=1, fsdp=2, tensor=2), devices=range(4))
    bad = moe.MoEConfig(**dict(BASE, num_experts=5))
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_mlp_sharded({}, np.zeros((8, 2, 32)), bad, mesh)
    cfg = moe.MoEConfig(**CFGS["generous"])
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_mlp_sharded({}, np.zeros((6, 2, 32)), cfg, mesh)
    assert dataclasses.asdict(cfg)["capacity_factor"] == 8.0
