"""The port stands alone: no module of kubeflow_tpu_torch/, and not
chip_smoke.py, imports JAX or anything of the JAX package — not even
its jax-free modules (the port keeps its own copies)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "kubeflow_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names():
    assert _forbidden("jax.numpy")
    assert _forbidden("kubeflow_tpu.serving.paged")
    assert not _forbidden("kubeflow_tpu_torch.serving.paged")
    assert not _forbidden("torch")


def test_moe_modules_are_covered():
    """The MoE slice's modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"kubeflow_tpu_torch/parallel/moe.py",
            "kubeflow_tpu_torch/parallel/__init__.py",
            "kubeflow_tpu_torch/models/llama_moe.py"} <= names


def test_data_and_single_card_modules_are_covered():
    """The data path, the tools, the HPO layer, the profiling utilities
    and the ViT / MNIST models are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"kubeflow_tpu_torch/{m}.py" for m in (
        "data/loader", "data/_native", "data/bpe", "tools/prepare_data",
        "tools/eval_ppl", "hpo/search", "hpo/local", "utils/profiling",
        "models/vit", "models/mnist")} <= names


def test_distributed_modules_are_covered():
    """The distributed set's modules (mesh, collectives, sharding rules,
    ring, pipeline, the mesh trainer, pipelined Llama) are among the
    files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"kubeflow_tpu_torch/{m}.py" for m in (
        "distributed", "parallel/mesh", "parallel/comm",
        "parallel/sharding", "parallel/ring", "parallel/pipeline",
        "train/fsdp", "models/llama_pp")} <= names


def test_elastic_modules_are_covered():
    """The elastic slice's modules (the replica registry, the exposition
    parser and federation, the goodput ledger, the elastic fleet, the
    memory planner) are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"kubeflow_tpu_torch/{m}.py" for m in (
        "fleet/registry", "obs/exposition", "obs/federation",
        "train/goodput", "train/elastic", "tools/memplan")} <= names
