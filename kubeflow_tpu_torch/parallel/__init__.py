"""Parallel layers of the port (counterpart: kubeflow_tpu/parallel/):
meshes over torch.distributed ranks (mesh.py), the collectives over one
mesh axis (comm.py), logical-axis sharding rules (sharding.py), ring
and Ulysses attention (ring.py), the GPipe schedule (pipeline.py) and
the routed expert layer with expert parallelism (moe.py)."""

from kubeflow_tpu_torch.parallel.mesh import (
    SLICE_TOPOLOGIES,
    Mesh,
    MeshSpec,
    SliceTopology,
    create_hybrid_mesh,
    create_mesh,
    mesh_from_env,
    num_slices_from_env,
)
from kubeflow_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe,
    moe_logical_axes,
    moe_mlp,
    moe_mlp_expert_parallel,
    moe_mlp_sharded,
)
# NOTE: the bare `pipeline` schedule fn is not re-exported: it would
# shadow the `kubeflow_tpu_torch.parallel.pipeline` submodule name.
from kubeflow_tpu_torch.parallel.pipeline import (
    pipeline_sharded,
    stack_stage_params,
)
from kubeflow_tpu_torch.parallel.ring import (
    ring_attention,
    ring_attention_sharded,
    ring_flash_attention,
    ring_flash_attention_sharded,
    ulysses_attention,
    ulysses_attention_sharded,
)
from kubeflow_tpu_torch.parallel.sharding import (
    LLAMA_RULES,
    ShardingRules,
    logical_to_spec,
    with_sharding_constraint,
)
