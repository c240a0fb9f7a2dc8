"""The port's meshes (parallel/mesh.py) against the reference's
(kubeflow_tpu/parallel/mesh.py), on the CPU: the slice table equal
entry by entry, `MeshSpec.resolve`, `create_mesh`, `create_hybrid_mesh`
and `mesh_from_env` on the reference's tests/test_mesh.py cases, the
port's meshes over 8 ranks (no process group: shapes and rank layout)
against the reference's over the 8 virtual CPU devices."""

import dataclasses

import jax
import numpy as np
import pytest

from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu_torch.parallel import mesh

RANKS = range(8)


def _layout(jm):
    """A reference mesh's device ids in its layout."""
    return np.vectorize(lambda d: d.id)(jm.devices)


def test_axis_constants():
    for name in ("DATA_AXIS", "FSDP_AXIS", "TENSOR_AXIS", "SEQ_AXIS",
                 "EXPERT_AXIS", "STAGE_AXIS", "DCN_AXIS", "MESH_AXES",
                 "HYBRID_MESH_AXES", "NUM_SLICES_ENV",
                 "MEGASCALE_NUM_SLICES_ENV"):
        assert getattr(mesh, name) == getattr(jmesh, name), name


def test_topology_table_equals_reference():
    assert mesh.SLICE_TOPOLOGIES.keys() == jmesh.SLICE_TOPOLOGIES.keys()
    for name, t in jmesh.SLICE_TOPOLOGIES.items():
        got = mesh.SLICE_TOPOLOGIES[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(t), name
        assert got.hosts == t.hosts
    assert mesh.SLICE_TOPOLOGIES["v5e-16"].hosts == 4
    assert mesh.SLICE_TOPOLOGIES["v5e-8"].hosts == 1


@pytest.mark.parametrize("spec", [(1, -1, 1), (2, -1, 2), (2, 2, 2),
                                  (-1, 2, 1), (8, 1, 1)])
def test_mesh_spec_resolution_equals_reference(spec):
    want = jmesh.MeshSpec(*spec).resolve(8)
    assert mesh.MeshSpec(*spec).resolve(8) == want


@pytest.mark.parametrize("spec", [(3, -1, 1), (2, 2, 1), (-1, -1, 1)])
def test_mesh_spec_refusals(spec):
    for mod in (mesh, jmesh):
        with pytest.raises(ValueError):
            mod.MeshSpec(*spec).resolve(8)


@pytest.mark.parametrize("spec", [(2, 2, 2), (1, 8, 1), (2, 4, 1)])
def test_create_mesh_equals_reference(spec):
    jm = jmesh.create_mesh(jmesh.MeshSpec(*spec))
    m = mesh.create_mesh(mesh.MeshSpec(*spec), devices=RANKS)
    assert m.axis_names == jm.axis_names
    assert m.shape == dict(jm.shape)
    np.testing.assert_array_equal(m.devices, _layout(jm))


def test_hybrid_mesh_equals_reference():
    spec = (1, 2, 2)
    jm = jmesh.create_hybrid_mesh(jmesh.MeshSpec(*spec), num_slices=2)
    m = mesh.create_hybrid_mesh(mesh.MeshSpec(*spec), num_slices=2,
                                devices=RANKS)
    assert m.axis_names == jm.axis_names == ("dcn", "data", "fsdp",
                                             "tensor")
    assert m.shape == dict(jm.shape)
    np.testing.assert_array_equal(m.devices, _layout(jm))


def test_hybrid_mesh_validation():
    for mod, kw in ((mesh, dict(devices=RANKS)), (jmesh, {})):
        with pytest.raises(ValueError, match="not divisible"):
            mod.create_hybrid_mesh(mod.MeshSpec(), num_slices=3, **kw)
        with pytest.raises(ValueError, match="num_slices"):
            mod.create_hybrid_mesh(mod.MeshSpec(), num_slices=0, **kw)


@pytest.mark.parametrize("env", [
    {"KFTPU_MESH": "data=1,fsdp=4,tensor=2"},
    {},
    {"KFTPU_NUM_SLICES": "2", "KFTPU_MESH": "data=1,fsdp=4,tensor=1"},
    {"MEGASCALE_NUM_SLICES": "4", "KFTPU_MESH": "data=1,fsdp=2,tensor=1"},
    {"KFTPU_MESH": "data=2", "KFTPU_TOPOLOGY": "v5e-8"},
    {"KFTPU_TOPOLOGY": "v9-1"},
])
def test_mesh_from_env_equals_reference(monkeypatch, env):
    for name in ("KFTPU_MESH", "KFTPU_NUM_SLICES", "MEGASCALE_NUM_SLICES",
                 "KFTPU_TOPOLOGY"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm = jmesh.mesh_from_env()
    m = mesh.mesh_from_env(devices=RANKS)
    assert m.axis_names == jm.axis_names
    assert m.shape == dict(jm.shape)
    np.testing.assert_array_equal(m.devices, _layout(jm))


def test_malformed_env_is_refused(monkeypatch):
    monkeypatch.setenv("KFTPU_MESH", "data=two")
    with pytest.raises(ValueError, match="malformed KFTPU_MESH"):
        mesh.mesh_from_env(devices=RANKS)
    monkeypatch.delenv("KFTPU_MESH")
    monkeypatch.setenv("KFTPU_NUM_SLICES", "x")
    with pytest.raises(ValueError, match="malformed KFTPU_NUM_SLICES"):
        mesh.num_slices_from_env()


def test_axis_groups_without_a_process_group():
    """Without a process group a mesh still answers its layout; an axis
    of size 1 needs no group, a larger one names what is missing."""
    m = mesh.create_mesh(mesh.MeshSpec(2, 2, 2), devices=RANKS)
    assert m.device_mesh is None and m.size == 8
    assert m.axis_index("fsdp") == 0
    single = mesh.create_mesh(mesh.MeshSpec(1, 1, 1), devices=[0])
    g = single.axis_group("fsdp")
    assert g.size == 1 and g.index == 0 and g.pg is None
    with pytest.raises(ValueError, match="no process group"):
        m.axis_group("fsdp")
    assert len(jax.devices()) == 8
