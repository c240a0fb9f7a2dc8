"""The trainer's mesh layout: FSDP (ZeRO-3) parameters, ZeRO-sharded
optimizer state and the data-parallel batch (counterpart: the sharded
half of kubeflow_tpu/train/trainer.py, which jits its step with
NamedShardings and lets XLA insert the collectives; here they are
explicit, parallel/comm.py's).

- Each parameter leaf is resolved through the sharding rules into a
  spec; the rank holds its block (`sharding.shard_tensor`): with
  LLAMA_RULES, the block along the dim whose logical axis is "embed"
  (-> "fsdp"). A leaf whose logical axes the rules leave unmapped (a
  bias over "heads" or "mlp" at tensor = 1, a LoRA rank-side factor) is
  held whole on every rank.
- The model reads its parameters through `model_view`: a stacked block
  leaf ([L, ...], logical axes led by "layers") becomes a
  `sharding.LayerStack` whose layers are gathered where the block
  function reads them (`sharding.read_layer`), inside the block's
  checkpointed region: a layer's full weights live while its block
  runs, and the backward's recompute gathers them again, so no more
  than one gathered layer outlives its block. Every other leaf (the
  embedding, the final norm) is gathered once at the start of the loss.
  Each gather is `comm.all_gather`: all-gather forward, reduce-scatter
  (sum) backward, so each rank's gradient comes back as its block,
  summed over the axes the leaf is cut on. The kernels see plain
  contiguous tensors; no DTensor is involved.
- The batch splits over the data axes the mesh has ("dcn", "data",
  "fsdp", outer first, as the reference's `batch_axes`): a rank takes
  its rows of the global batch. Its loss is weighted by its share of the
  global mask mass, so the sum over ranks is the global masked mean, and
  a leaf's gradient is the global batch's once summed over every batch
  axis: the reduce-scatter sums the axes the leaf is cut on,
  `reduce_grads` the rest (for a leaf held whole, all of them).
- The optimizer update is the trainer's own (`_Optimizer.update`) with
  two hooks: the global-norm clip's squared norm summed over the axes
  each leaf is cut on (`sharded_sq_norm`), and with `zero_optimizer`
  each moment covering the rank's slice of its block, split further
  over "data" as the reference's `zero_extend_spec` splits it (`slot`:
  the rank updates its slice and all-gathers the slices over data).
A mesh with tensor > 1 is refused (tensor parallelism is not ported),
as are Adafactor and gradient accumulation on a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from kubeflow_tpu_torch.parallel import comm
from kubeflow_tpu_torch.parallel import mesh as mesh_lib
from kubeflow_tpu_torch.parallel import sharding as sharding_lib
from kubeflow_tpu_torch.train.trainer import _named_leaves


@dataclasses.dataclass
class LeafLayout:
    """How one parameter leaf lies on the mesh."""

    shape: tuple[int, ...]      # the full (global) shape
    spec: sharding_lib.P        # the param's spec
    opt_spec: sharding_lib.P    # its moments' spec (ZeRO-extended)
    gathers: list               # (dim, AxisGroup) the block is cut by
    per_layer: bool             # a stacked leaf, gathered layer by layer
    zero: tuple | None          # (dim, data AxisGroup) of the ZeRO slice
    grad_group: comm.AxisGroup  # the batch axes the block is not cut on

    @property
    def norm_axes(self) -> tuple:
        """The mesh axes the block is cut over."""
        return tuple(g.name for _, g in self.gathers)


def _gathered(x: torch.Tensor, gathers) -> torch.Tensor:
    for dim, group in reversed(gathers):
        x = comm.all_gather(x, dim, group)
    return x


def _rebuild(tree, fn, prefix=""):
    return {k: (_rebuild(v, fn, f"{prefix}{k}.") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in tree.items()}


def sharded_sq_norm(mesh, grads, axes) -> torch.Tensor:
    """The squared global norm of gradients held as blocks: `axes[i]`
    are the mesh axes leaf i is cut over (() for a leaf every rank holds
    whole); each set's squares are summed over its ranks once."""
    sq: dict = {}
    for g, a in zip(grads, axes, strict=True):
        sq[a] = sq.get(a, 0.0) + (g.float() ** 2).sum()
    return sum(comm._psum(v, mesh.axis_group(a)) if a else v
               for a, v in sq.items())


class MeshLayout:
    """Per-leaf layouts of a params tree on `mesh` under `rules`."""

    def __init__(self, mesh, logical_axes, rules, tc):
        if mesh.shape.get(mesh_lib.TENSOR_AXIS, 1) > 1:
            raise ValueError(
                f"tensor parallelism is not ported: mesh {mesh.shape} has "
                "tensor > 1 (use data and fsdp)")
        if tc.optimizer != "adamw":
            raise ValueError(f"optimizer {tc.optimizer!r} is not ported on "
                             "a mesh (adamw is)")
        if tc.grad_accum > 1:
            raise ValueError("grad_accum > 1 is not ported on a mesh")
        self.mesh = mesh
        self.rules = rules
        self.zero = tc.zero_optimizer
        self.axes = dict(_named_leaves(logical_axes))
        self.leaves: dict[str, LeafLayout] = {}
        self.batch_axes = [a for a in mesh_lib.BATCH_AXES
                           if a in mesh.axis_names]
        self.batch = mesh.axis_group(self.batch_axes)

    def add(self, name: str, shape) -> LeafLayout:
        mesh = self.mesh
        axes = self.axes[name]
        if len(axes) != len(shape):
            raise ValueError(f"{name}: logical axes {axes} for shape "
                             f"{tuple(shape)}")
        spec = sharding_lib.filter_spec(self.rules.resolve(axes), mesh)
        gathers = sharding_lib._dim_groups(spec, mesh)
        for dim, g in gathers:
            if shape[dim] % g.size:
                raise ValueError(f"{name}: dim {dim} of {tuple(shape)} not "
                                 f"divisible by {g.name}={g.size}")
        opt_spec = (sharding_lib.zero_extend_spec(spec, tuple(shape), mesh)
                    if self.zero else spec)
        zero = None
        for dim, (a, b) in enumerate(zip(spec, opt_spec)):
            if a != b:
                zero = (dim, mesh.axis_group(mesh_lib.DATA_AXIS))
        cut = sharding_lib.spec_axes(spec)
        lay = LeafLayout(
            tuple(shape), spec, opt_spec, gathers,
            axes[0] == "layers" and all(d > 0 for d, _ in gathers), zero,
            mesh.axis_group([a for a in self.batch_axes if a not in cut]))
        self.leaves[name] = lay
        return lay

    # -- params ----------------------------------------------------------

    def shard_params(self, params: dict) -> dict:
        """Full params (alike on every rank) -> this rank's blocks."""
        def cut(name, leaf):
            lay = self.add(name, tuple(leaf.shape))
            return sharding_lib.shard_tensor(leaf, lay.spec, self.mesh)
        return _rebuild(params, cut)

    def model_view(self, local: dict) -> dict:
        """The tree the model reads: stacked block leaves as LayerStacks
        gathered layer by layer where the block reads them, the others
        gathered now (differentiably)."""
        def view(name, leaf):
            lay = self.leaves[name]
            if not lay.gathers:
                return leaf
            if lay.per_layer:
                slices = leaf.unbind(0)
                gathers = [(d - 1, g) for d, g in lay.gathers]
                return sharding_lib.LayerStack(
                    len(slices), lambda li: _gathered(slices[li], gathers))
            return _gathered(leaf, lay.gathers)
        return _rebuild(local, view)

    def gather_params(self, local: dict) -> dict:
        """The full params from every rank's blocks (collective)."""
        return _rebuild(local, lambda name, leaf: sharding_lib.gather_tensor(
            leaf.detach(), self.leaves[name].spec, self.mesh))

    # -- the batch -------------------------------------------------------

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global [B, ...] batch."""
        n = self.batch.size
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"data axes' {n} ranks")
        return x.chunk(n, 0)[self.batch.index]

    def loss_weight(self, mask: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global masked mean."""
        lw = mask.float().sum()
        gw = comm._psum(lw, self.batch)
        return torch.clamp(lw, min=1.0) / torch.clamp(gw, min=1.0)

    # -- the optimizer ---------------------------------------------------

    def reduce_grads(self, named, grads) -> list:
        """Each block's gradient summed over the batch axes its leaf is
        not cut on (the gathers' reduce-scatters summed the others)."""
        return [comm._psum(g, self.leaves[name].grad_group)
                for (name, _), g in zip(named, grads, strict=True)]

    def sq_norm(self, names, grads) -> torch.Tensor:
        """`_Optimizer.update`'s norm hook: the global squared norm."""
        return sharded_sq_norm(self.mesh, grads,
                               [self.leaves[n].norm_axes for n in names])

    def slot_view(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The slice of a block this rank's moments cover (a view)."""
        zero = self.leaves[name].zero
        if zero is None:
            return p
        dim, group = zero
        return p.chunk(group.size, dim)[group.index]

    def shard_slot(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """A full moment (alike on every rank) -> this rank's slice, the
        one `slot_view` gives of its block."""
        return sharding_lib.shard_tensor(full, self.leaves[name].opt_spec,
                                         self.mesh)

    def gather_slot(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full moment from every rank's slice (collective)."""
        return sharding_lib.gather_tensor(t.detach(),
                                          self.leaves[name].opt_spec,
                                          self.mesh)

    @contextlib.contextmanager
    def slot(self, name: str, p: torch.Tensor, g: torch.Tensor):
        """`_Optimizer.update`'s slot hook: the slices of the block and
        its gradient that the rank updates; after the update, with
        ZeRO, the block is put together from every data rank's slice."""
        ps = self.slot_view(name, p)
        yield ps, self.slot_view(name, g)
        zero = self.leaves[name].zero
        if zero is not None:
            dim, group = zero
            p.copy_(comm._all_gather(ps.contiguous(), dim, group))

    def opt_state_bytes(self, named, optimizer) -> int:
        """Moment bytes a rank holds, as the reference reckons them: each
        fp32 moment at its full shape over the product of its spec's
        axis sizes (rounded up), plus the two int32 step counts of its
        chain."""
        total = 8
        for name, p in named:
            lay = self.leaves[name]
            ways = math.prod(self.mesh.shape.get(a, 1) for a in
                             sharding_lib.spec_axes(lay.opt_spec))
            nbytes = -(-math.prod(lay.shape) * p.element_size() // ways)
            total += nbytes * len(optimizer.slots)
        return total
