"""Device meshes over torch.distributed ranks (counterpart:
kubeflow_tpu/parallel/mesh.py).

A mesh lays the ranks of the process group out on named axes, outer to
inner: "data" (pure data parallelism, gradients all-reduced), "fsdp"
(sharded data parallelism: parameters sharded, gathered per block,
ZeRO-3) and "tensor" (tensor parallelism: heads, MLP columns and vocab
cut, parallel/tensor.py). Hybrid multi-slice
meshes put "dcn" outermost. Sequence ("seq"), expert ("expert") and
stage ("stage") axes are the names the ring, MoE and pipeline layers
use; as in the reference they reuse these device axes, or name the axes
of a mesh built for them (`Mesh(ranks, ("stage", "data"))`).

`Mesh` holds the rank array (`devices`: global ranks, one per device)
and, when the default process group is up and the mesh covers it, a
`torch.distributed.device_mesh.DeviceMesh` over the same ranks plus the
process groups of the axis combinations the trainers reduce over
(`axis_group`). Group creation is collective, so every rank builds the
same mesh at the same point of its program. A mesh built without a
process group (or whose axes all have size 1) still answers `shape`,
`axis_names` and its rank layout, which is what the CPU tests hold
against the reference's `jax.sharding.Mesh`.

The slice table (`SliceTopology`, `SLICE_TOPOLOGIES`) is the port's own
copy of the reference's: the control plane reads that one.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.comm import AxisGroup

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"
DCN_AXIS = "dcn"

MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
HYBRID_MESH_AXES = (DCN_AXIS,) + MESH_AXES
# the data-parallel axes a batch splits over, outer to inner
BATCH_AXES = (DCN_AXIS, DATA_AXIS, FSDP_AXIS)

NUM_SLICES_ENV = "KFTPU_NUM_SLICES"
MEGASCALE_NUM_SLICES_ENV = "MEGASCALE_NUM_SLICES"

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A TPU slice: chip grid plus host layout. `hosts` is the number of
    hosts (pods the controller gang-schedules); each sees
    `chips_per_host` chips."""

    name: str
    generation: str
    chips: int
    grid: tuple[int, ...]
    chips_per_host: int

    @property
    def hosts(self) -> int:
        return max(1, self.chips // self.chips_per_host)


def _v5e(n: int, grid: tuple[int, ...]) -> SliceTopology:
    # 4 chips a host on multi-host slices, n on single-host ones up to 8
    cph = n if n <= 8 else 4
    return SliceTopology(f"v5e-{n}", "v5e", n, grid, cph)


def _v5p(n: int, grid: tuple[int, ...]) -> SliceTopology:
    return SliceTopology(f"v5p-{n}", "v5p", n, grid, min(n, 4))


def _v4(n: int, grid: tuple[int, ...]) -> SliceTopology:
    return SliceTopology(f"v4-{n}", "v4", n, grid, min(n, 4))


SLICE_TOPOLOGIES: dict[str, SliceTopology] = {
    t.name: t
    for t in [
        _v5e(1, (1, 1)), _v5e(4, (2, 2)), _v5e(8, (2, 4)),
        _v5e(16, (4, 4)), _v5e(32, (4, 8)), _v5e(64, (8, 8)),
        _v5e(128, (8, 16)), _v5e(256, (16, 16)),
        _v5p(8, (2, 2, 1)), _v5p(16, (2, 2, 2)), _v5p(32, (2, 2, 4)),
        _v5p(128, (4, 4, 4)),
        _v4(8, (2, 2, 1)), _v4(16, (2, 2, 2)), _v4(32, (2, 2, 4)),
    ]
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A parallelism layout over a device set. A size of -1 absorbs the
    remaining devices (at most one axis may be -1); the resolved sizes
    must multiply to the device count."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {DATA_AXIS: self.data, FSDP_AXIS: self.fsdp,
                 TENSOR_AXIS: self.tensor}
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {free}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if free:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes product {fixed}")
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(f"mesh {sizes} does not cover {n_devices} "
                             "devices")
        return sizes


def _world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Ranks on named axes. `devices`: an int array of global ranks, one
    axis per name; `device_type`: "cuda" or "cpu" (the tensors' device,
    for the DeviceMesh)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 device_type: str | None = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        self.device_type = device_type
        world, rank = _world()
        self.rank = rank
        where = np.argwhere(self.devices == rank)
        self._coords = (dict(zip(self.axis_names, where[0].tolist()))
                        if len(where) else None)
        self.device_mesh = None
        self._groups: dict[tuple[str, ...], AxisGroup] = {}
        if world > 1 and self.devices.size == world:
            self._build()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _axis_ranks(self, axes: tuple[str, ...], coords) -> tuple[int, ...]:
        """Global ranks along `axes` (flattened in mesh order) through the
        point `coords`."""
        index = [slice(None) if a in axes else coords[a]
                 for a in self.axis_names]
        return tuple(int(r) for r in self.devices[tuple(index)].ravel())

    def _build(self):
        """The DeviceMesh and the groups of every axis combination the
        layers reduce over, created collectively in one fixed order."""
        from torch.distributed.device_mesh import DeviceMesh

        self.device_mesh = DeviceMesh(
            self.device_type, torch.as_tensor(self.devices),
            mesh_dim_names=self.axis_names)
        # every combination of the axes larger than 1, in mesh order:
        # the batch axes, a leaf's cut axes and both (train/fsdp.py)
        live = [a for a in self.axis_names if self.shape[a] > 1]
        combos = [c for n in range(1, len(live) + 1)
                  for c in itertools.combinations(live, n)]
        for axes in combos:
            if len(axes) == 1:
                pg = self.device_mesh.get_group(axes[0])
                self._groups[axes] = AxisGroup(
                    axes[0], self._check_order(axes, self._coords),
                    self._coords[axes[0]], pg)
                continue
            others = [a for a in self.axis_names if a not in axes]
            for point in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                coords = dict(zip(others, point))
                ranks = self._axis_ranks(axes, {**coords, **{
                    a: 0 for a in axes}})
                pg = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    self._groups[axes] = AxisGroup(
                        axes, self._check_order(axes, self._coords),
                        ranks.index(self.rank), pg)

    def _check_order(self, axes, coords) -> tuple[int, ...]:
        ranks = self._axis_ranks(axes, coords)
        if list(ranks) != sorted(ranks):
            raise ValueError(f"ranks along {axes} must increase in axis "
                             f"order (process groups order them so), got "
                             f"{ranks}")
        return ranks

    def axis_index(self, axis: str) -> int:
        return 0 if self._coords is None else self._coords[axis]

    def axis_group(self, axes: str | Sequence[str]) -> AxisGroup:
        """The AxisGroup of one axis, or of several flattened in mesh
        order (axes absent from the mesh are dropped, as the reference's
        specs drop them, and so are axes of size 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        live = tuple(a for a in axes if self.shape[a] > 1)
        if not live:
            return AxisGroup(axes, (self.rank,), 0, None)
        try:
            return self._groups[live]
        except KeyError:
            raise ValueError(
                f"no process group for axes {axes} of mesh {self.shape} "
                "(the default process group must be up and the mesh must "
                "cover it)") from None

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _ranks(devices) -> list[int]:
    if devices is None:
        return list(range(_world()[0]))
    return [int(d) for d in devices]


def create_mesh(spec: MeshSpec | None = None, *,
                devices: Sequence[int] | None = None,
                topology: str | SliceTopology | None = None,
                device_type: str | None = None) -> Mesh:
    """A (data, fsdp, tensor) mesh over `devices` (global ranks; default:
    every rank of the process group, one when there is none). A named
    `topology` whose chip count differs from the rank count is a
    simulation, logged as the reference logs it off the TPU."""
    ranks = _ranks(devices)
    spec = spec or MeshSpec()
    if isinstance(topology, str):
        topology = SLICE_TOPOLOGIES[topology]
    if topology is not None and len(ranks) != topology.chips:
        log.warning("simulating topology %s (%d chips) with %d ranks",
                    topology.name, topology.chips, len(ranks))
    sizes = spec.resolve(len(ranks))
    arr = np.asarray(ranks).reshape(sizes[DATA_AXIS], sizes[FSDP_AXIS],
                                    sizes[TENSOR_AXIS])
    return Mesh(arr, MESH_AXES, device_type)


def create_hybrid_mesh(spec: MeshSpec | None = None, *, num_slices: int,
                       devices: Sequence[int] | None = None,
                       topology: str | SliceTopology | None = None,
                       device_type: str | None = None) -> Mesh:
    """Hybrid multi-slice mesh ("dcn", "data", "fsdp", "tensor"): "dcn"
    spans slices, each slice a contiguous block of ranks (process-ordinal
    order, the reference's fallback grouping). `spec` lays out one
    slice."""
    ranks = _ranks(devices)
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if len(ranks) % num_slices:
        raise ValueError(f"{len(ranks)} devices not divisible into "
                         f"{num_slices} slices")
    per_slice = len(ranks) // num_slices
    spec = spec or MeshSpec()
    if isinstance(topology, str):
        topology = SLICE_TOPOLOGIES[topology]
    if topology is not None and per_slice != topology.chips:
        log.warning("simulating %d-slice %s (%d chips each) with %d "
                    "ranks/slice", num_slices, topology.name,
                    topology.chips, per_slice)
    sizes = spec.resolve(per_slice)
    arr = np.asarray(ranks).reshape(num_slices, sizes[DATA_AXIS],
                                    sizes[FSDP_AXIS], sizes[TENSOR_AXIS])
    return Mesh(arr, HYBRID_MESH_AXES, device_type)


def num_slices_from_env() -> int:
    """Slice count injected by the webhook (KFTPU_NUM_SLICES, mirroring
    MEGASCALE_NUM_SLICES); 1 when absent."""
    for var in (NUM_SLICES_ENV, MEGASCALE_NUM_SLICES_ENV):
        raw = os.environ.get(var, "")
        if raw:
            try:
                return max(1, int(raw))
            except ValueError:
                raise ValueError(f"malformed {var}={raw!r}") from None
    return 1


def mesh_from_env(devices: Sequence[int] | None = None, *,
                  device_type: str | None = None) -> Mesh:
    """A mesh from the webhook env: KFTPU_MESH="data=1,fsdp=16,tensor=1"
    (default: pure FSDP over every rank) and KFTPU_TOPOLOGY; a gang of
    several slices (KFTPU_NUM_SLICES > 1) gets the hybrid mesh, KFTPU_MESH
    then laying out one slice."""
    raw = os.environ.get("KFTPU_MESH", "")
    kwargs: dict[str, int] = {}
    if raw:
        for part in raw.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k in MESH_AXES:
                try:
                    kwargs[k] = int(v)
                except ValueError:
                    raise ValueError(f"malformed KFTPU_MESH entry {part!r} "
                                     f"(full value: {raw!r})") from None
    spec = MeshSpec(**kwargs) if kwargs else MeshSpec()
    topo = os.environ.get("KFTPU_TOPOLOGY") or None
    if topo is not None and topo not in SLICE_TOPOLOGIES:
        log.warning("unknown KFTPU_TOPOLOGY %r (known: %s); skipping slice "
                    "validation", topo, sorted(SLICE_TOPOLOGIES))
        topo = None
    n_slices = num_slices_from_env()
    if n_slices > 1:
        return create_hybrid_mesh(spec, num_slices=n_slices,
                                  devices=devices, topology=topo,
                                  device_type=device_type)
    return create_mesh(spec, devices=devices, topology=topo,
                       device_type=device_type)
