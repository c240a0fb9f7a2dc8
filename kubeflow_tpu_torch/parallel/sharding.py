"""Logical-axis sharding rules mapped onto the mesh (counterpart:
kubeflow_tpu/parallel/sharding.py).

Every parameter carries logical axis names ("embed", "heads", "mlp",
...); `ShardingRules` maps them to mesh axes and `logical_to_spec`
resolves a tree of them into specs. A spec (`P`) is a tuple with one
entry per dim, as `jax.sharding.PartitionSpec` is: a mesh axis name, a
tuple of names (the dim split over their product, outer first) or None
(replicated), so the tests compare it with the reference's entry by
entry.

The port's layout is explicit: the trainers cut each leaf into its
local block by its spec (`shard_tensor`) and gather it by hand before
use, so there is nothing for a constraint to steer, and
`with_sharding_constraint` only checks the logical names (a typo still
raises) and returns x.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from kubeflow_tpu_torch.parallel import mesh as mesh_lib
from kubeflow_tpu_torch.parallel.comm import AxisGroup, _all_gather, _block


class P(tuple):
    """A partition spec: one entry per dim (axis name, tuple of names,
    or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis names (or None)."""

    rules: Mapping[str, str | tuple[str, ...] | None]

    def resolve(self, logical_axes: tuple[str | None, ...]) -> P:
        out: list[Any] = []
        for ax in logical_axes:
            if ax is None:
                out.append(None)
            else:
                if ax not in self.rules:
                    raise KeyError(f"no sharding rule for logical axis "
                                   f"{ax!r}")
                out.append(self.rules[ax])
        return P(*out)


# The Llama/transformer rule set. A param's embed dim shards over fsdp
# (ZeRO-3, gathered per block); an activation's batch dim carries the
# data axes; tensor parallelism shards heads / mlp / vocab (the blocks
# compute on them, parallel/tensor.py).
LLAMA_RULES = ShardingRules(
    rules={
        # --- params ---
        "embed": mesh_lib.FSDP_AXIS,
        "heads": mesh_lib.TENSOR_AXIS,
        "kv_heads": mesh_lib.TENSOR_AXIS,
        "head_dim": None,
        "mlp": mesh_lib.TENSOR_AXIS,
        "vocab": mesh_lib.TENSOR_AXIS,
        "layers": None,
        "experts": mesh_lib.TENSOR_AXIS,
        "stage": None,
        "lora_rank": None,
        # --- activations ---
        "batch": (mesh_lib.DCN_AXIS, mesh_lib.DATA_AXIS,
                  mesh_lib.FSDP_AXIS),
        "seq": None,
        "act_embed": None,
        "act_heads": mesh_lib.TENSOR_AXIS,
        "act_kv_heads": mesh_lib.TENSOR_AXIS,
        "act_mlp": mesh_lib.TENSOR_AXIS,
        "act_vocab": mesh_lib.TENSOR_AXIS,
    }
)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, P) and all(
        a is None or isinstance(a, str) for a in x)


def tree_map(fn, tree, is_leaf=_is_axes):
    """fn over the leaves of a nested dict / list tree (a logical-axes
    tree's leaves are tuples of names)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def logical_to_spec(rules: ShardingRules, logical: Any) -> Any:
    """A tree of logical-axis tuples -> the same tree of specs."""
    return tree_map(rules.resolve, logical)


def spec_axes(spec: P) -> set[str]:
    """Every mesh axis name a spec consumes."""
    used: set[str] = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return used


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def zero_extend_spec(spec: P, shape: tuple[int, ...], mesh,
                     axis: str = mesh_lib.DATA_AXIS) -> P:
    """Fold `axis` (default "data") into `spec`, ZeRO-style: the first
    dim that is divisible by the axis size after its existing sharding,
    and does not use the axis yet, is also split over it. Unchanged when
    the axis is absent or of size 1, already used, or no dim divides."""
    if axis not in mesh.axis_names:
        return spec
    axis_size = mesh.shape[axis]
    if axis_size <= 1 or axis in spec_axes(spec):
        return spec
    entries: list[Any] = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        existing = _entry_axes(entries[i])
        sharded_by = 1
        for name in existing:
            sharded_by *= mesh.shape.get(name, 1)
        per_shard = (dim // sharded_by
                     if sharded_by and dim % sharded_by == 0 else 0)
        if per_shard and per_shard % axis_size == 0:
            entries[i] = existing + (axis,) if existing else axis
            return P(*entries)
    return spec


def _keep_axes(spec: P, keep) -> P:
    """`spec` with only the axis names `keep(name)` accepts."""

    def filt(entry):
        kept = tuple(a for a in _entry_axes(entry) if keep(a))
        if not kept:
            return None
        return kept if isinstance(entry, (tuple, list)) else kept[0]

    return P(*(filt(e) for e in spec))


def filter_spec(spec: P, mesh) -> P:
    """Drop the axes `mesh` lacks (a hybrid mesh's "dcn" on a plain one)."""
    return _keep_axes(spec, lambda a: a in mesh.axis_names)


def without_axis(spec: P, axis: str) -> P:
    """`spec` with `axis` dropped from every entry (no dim split over
    it)."""
    return _keep_axes(spec, lambda a: a != axis)


def _dim_groups(spec: P, mesh) -> list[tuple[int, AxisGroup]]:
    """(dim, group) of every mesh axis a spec splits a dim over, in the
    spec's order: a dim split over ("fsdp", "data") is cut by fsdp, then
    each block by data (fsdp major, as the reference lays it out)."""
    out = []
    for dim, entry in enumerate(filter_spec(spec, mesh)):
        out.extend((dim, mesh.axis_group(a)) for a in _entry_axes(entry)
                   if mesh.shape[a] > 1)
    return out


def shard_tensor(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of a full tensor under `spec`, in storage of
    its own (a view would keep the full tensor alive)."""
    for dim, group in _dim_groups(spec, mesh):
        x = _block(x, dim, group)
    return x.clone(memory_format=torch.contiguous_format)


def gather_tensor(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under `spec` (no
    gradient)."""
    for dim, group in reversed(_dim_groups(spec, mesh)):
        x = _all_gather(x, dim, group)
    return x


class LayerStack:
    """A stacked [L, ...] leaf that the model reads one layer at a time:
    `layer(li)` makes layer li's tensor (an FSDP block's all-gather, a
    LoRA merge over gathered layers). The models' layer loops unbind
    every block leaf once; a LayerStack's `unbind` gives `LayerRef`s,
    which the block function reads (`read_layer`) inside its
    checkpointed region: the layer's full tensor lives while the block
    runs, and a recompute makes it again."""

    def __init__(self, n: int, layer):
        self.n, self.layer = n, layer

    def __len__(self) -> int:
        return self.n

    def unbind(self, dim: int = 0) -> tuple["LayerRef", ...]:
        if dim != 0:
            raise ValueError("a stacked leaf unbinds along its layers")
        return tuple(LayerRef(self, li) for li in range(self.n))

    def detach(self) -> "LayerStack":
        return LayerStack(self.n, lambda li: self.layer(li).detach())

    @staticmethod
    def map(fn, *leaves) -> "LayerStack":
        """fn over the layers of stacked leaves (LayerStacks or [L, ...]
        tensors, the latter unbound once), layer by layer on read."""
        parts = [x if isinstance(x, LayerStack) else x.unbind(0)
                 for x in leaves]

        def layer(li):
            return fn(*(p.layer(li) if isinstance(p, LayerStack) else p[li]
                        for p in parts))

        return LayerStack(len(leaves[0]), layer)


class LayerRef:
    """Layer li of a LayerStack, made when read."""

    __slots__ = ("stack", "li")

    def __init__(self, stack: LayerStack, li: int):
        self.stack, self.li = stack, li

    def read(self) -> torch.Tensor:
        return self.stack.layer(self.li)


def read_layer(p: dict) -> dict:
    """A block's layer params with every LayerRef read (the first line
    of each model's block function; tensors pass through)."""
    return {k: v.read() if isinstance(v, LayerRef) else v
            for k, v in p.items()}


def make_shard_and_gather_fns(specs: Any, mesh):
    """Per-leaf (shard_fns, gather_fns) for a tree of specs: a shard fn
    cuts a full (host or device) tensor into this rank's block, a gather
    fn assembles the full tensor from the blocks. The checkpoint-resize
    bridge: gather under the old mesh, shard under the new one."""
    is_leaf = lambda x: isinstance(x, P)  # noqa: E731
    return (
        tree_map(lambda s: lambda x: shard_tensor(torch.as_tensor(x), s,
                                                  mesh), specs, is_leaf),
        tree_map(lambda s: lambda x: gather_tensor(x, s, mesh), specs,
                 is_leaf),
    )


def with_sharding_constraint(x: Any, logical_axes: tuple[str | None, ...],
                             rules: ShardingRules = LLAMA_RULES) -> Any:
    """A no-op in the port: the layout is explicit (the trainers place
    every block themselves). The logical names are still resolved, so a
    typo raises as it does in the reference."""
    rules.resolve(logical_axes)
    return x
