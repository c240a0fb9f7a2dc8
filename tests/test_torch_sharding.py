"""The port's sharding rules (parallel/sharding.py) and every model's
logical axes against the reference's, on the CPU: the rule table, the
specs of every model's (and LoRA's and the MoE layer's) logical-axes
tree equal to the reference's PartitionSpecs entry by entry,
`zero_extend_spec` on the reference's mesh shapes, and the no-op
`with_sharding_constraint` that still catches a typo."""

import jax
import pytest
import torch

from kubeflow_tpu.models import gemma as jgemma
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.models import llama_moe as jllama_moe
from kubeflow_tpu.models import mnist as jmnist
from kubeflow_tpu.models import vit as jvit
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import create_mesh as jcreate_mesh
from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu.parallel import sharding as jsharding
from kubeflow_tpu.train import lora as jlora
from kubeflow_tpu_torch.models import gemma, llama, llama_moe, mnist, vit
from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh, moe
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.train import lora


def _jspecs(tree):
    return jax.tree.map(
        lambda axes: tuple(jsharding.LLAMA_RULES.resolve(axes)), tree,
        is_leaf=lambda x: isinstance(x, tuple))


def _specs(tree):
    return sharding.tree_map(lambda s: tuple(s), sharding.logical_to_spec(
        sharding.LLAMA_RULES, tree), lambda x: isinstance(x, sharding.P))


def test_rule_table_equals_reference():
    assert dict(sharding.LLAMA_RULES.rules) == dict(
        jsharding.LLAMA_RULES.rules)


CASES = {
    "llama": (llama.param_logical_axes(llama.LLAMA3_1B),
              jllama.param_logical_axes(jllama.LLAMA3_1B)),
    "llama-tied": (
        llama.param_logical_axes(llama.LlamaConfig(tie_embeddings=True)),
        jllama.param_logical_axes(jllama.LlamaConfig(tie_embeddings=True))),
    "gemma": (gemma.param_logical_axes(gemma.GEMMA_2B),
              jgemma.param_logical_axes(jgemma.GEMMA_2B)),
    "llama_moe": (llama_moe.param_logical_axes(llama_moe.MIXTRAL_TINY),
                  jllama_moe.param_logical_axes(jllama_moe.MIXTRAL_TINY)),
    "vit": (vit.param_logical_axes(vit.VIT_B16),
            jvit.param_logical_axes(jvit.VIT_B16)),
    "vit-pool": (vit.param_logical_axes(vit.ViTConfig(use_cls_token=False)),
                 jvit.param_logical_axes(jvit.ViTConfig(
                     use_cls_token=False))),
    "mnist": (mnist.param_logical_axes(), jmnist.param_logical_axes(
        jmnist.MNIST_MLP)),
    "lora": (lora.lora_logical_axes(llama.param_logical_axes(
        llama.LLAMA3_1B), lora.LoraConfig(rank=8)),
        jlora.lora_logical_axes(jllama.param_logical_axes(
            jllama.LLAMA3_1B), jlora.LoraConfig(rank=8))),
    "moe": (moe.moe_logical_axes(), jmoe.moe_logical_axes()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_logical_axes_and_specs_equal_reference(name):
    port, ref = CASES[name]
    assert port == ref
    assert _specs(port) == _jspecs(ref)


@pytest.mark.parametrize("shape,spec", [
    ((512, 128), ("tensor", "fsdp")),
    ((2, 128, 128), (None, "fsdp", "tensor")),
    ((3, 5), (None, None)),
    ((8,), ("fsdp",)),
    ((6, 16), ("data", None)),
    ((), ()),
])
@pytest.mark.parametrize("layout", [(2, 2, 2), (1, 4, 2), (4, 2, 1)])
def test_zero_extend_spec_equals_reference(shape, spec, layout):
    jm = jcreate_mesh(JMeshSpec(*layout))
    m = create_mesh(MeshSpec(*layout), devices=range(8))
    want = jsharding.zero_extend_spec(jax.sharding.PartitionSpec(*spec),
                                      shape, jm)
    got = sharding.zero_extend_spec(sharding.P(*spec), shape, m)
    assert tuple(got) == tuple(want)


def test_with_sharding_constraint_is_a_checked_noop():
    x = torch.ones(2, 3)
    assert sharding.with_sharding_constraint(x, ("batch", "act_embed")) is x
    with pytest.raises(KeyError, match="no sharding rule"):
        sharding.with_sharding_constraint(x, ("batch", "act_embd"))


def test_filter_spec_drops_axes_the_mesh_lacks():
    m = create_mesh(MeshSpec(2, 2, 2), devices=range(8))
    spec = sharding.LLAMA_RULES.resolve(("batch", "embed"))
    assert tuple(spec) == (("dcn", "data", "fsdp"), "fsdp")
    assert tuple(sharding.filter_spec(spec, m)) == (("data", "fsdp"),
                                                    "fsdp")
