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
  The slice's `LeafCut` (every axis it is cut over, ZeRO's data slice
  included) gives Adafactor the full leaf's factored means and RMS;
  its `v_row` and `v_col`, which mirror no param, are held as the
  reference holds them: whole on every rank, or with `zero_optimizer`
  split over "data" by `zero_extend_spec`.
- With `grad_accum` > 1 the trainer runs the reference's micro-steps,
  each micro's global rows cut over the batch ranks (train/trainer.py).
- A MoE model routes each rank's rows as its slice of the global batch
  (`parallel()` sets the batch group for parallel/moe.py); its
  load-balance loss enters the loss once (`trainer.global_term`).
- With tensor > 1 (Megatron-style tensor parallelism, parallel/
  tensor.py) the leaves whose logical axes map to "tensor" are cut on
  it and never gathered: the blocks compute on their local heads, MLP
  columns and vocab block, and `parallel()` gives them the axis's
  group. The cut falls on whole heads, so the layout takes the model's
  config: KV projections whose heads the axis does not divide (the axis
  a multiple of them) are held whole on every tensor rank, and a query
  head count it does not divide is refused. A leaf held whole and read
  inside per-rank work (those KV projections, a LoRA factor on the
  uncut side) has a partial gradient on each tensor rank: `reduce_grads`
  sums it over "tensor" too; the norm scales, read before the residual
  enters per-rank work, have whole gradients and are not summed. The
  clip's squares of a tensor-cut block are summed over "tensor" as over
  any axis a block is cut on. The MoE family's expert stacks are cut on
  "experts" (E / t experts a rank) and ViT's classes on "vocab"; leaves
  held whole and read on the invariant side (the norm scales, ViT's
  patch and position embeddings and its residual biases, the MoE
  router, whose gate values enter per-rank work) are not summed.
Refused on a mesh: at tensor > 1, a trainer without the model's config,
head, KV-head, expert or class counts the axis does not divide (and
the pipeline, models/llama_pp.py); MoE routing on a micro-batch the
batch ranks do not divide (parallel/moe.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from kubeflow_tpu_torch.parallel import comm, moe, tensor
from kubeflow_tpu_torch.parallel import mesh as mesh_lib
from kubeflow_tpu_torch.parallel import sharding as sharding_lib
from kubeflow_tpu_torch.train.trainer import LeafCut, _named_leaves


@dataclasses.dataclass
class LeafLayout:
    """How one parameter leaf lies on the mesh."""

    shape: tuple[int, ...]      # the full (global) shape
    spec: sharding_lib.P        # the param's spec
    opt_spec: sharding_lib.P    # its moments' spec (ZeRO-extended)
    gathers: list               # (dim, AxisGroup) the block is cut by
    per_layer: bool             # a stacked leaf, gathered layer by layer
    zero: tuple | None          # (dim, data AxisGroup) of the ZeRO slice
    grad_group: comm.AxisGroup  # the axes its gradient is summed over
    cut: LeafCut                # where the moments' slice lies

    @property
    def norm_axes(self) -> tuple:
        """The mesh axes the block is cut over."""
        return tuple(g.name for _, g in self.gathers)

    @property
    def view_gathers(self) -> list:
        """The gathers the model's view makes: over every axis but
        "tensor", whose blocks the model computes on."""
        return [(d, g) for d, g in self.gathers
                if g.name != mesh_lib.TENSOR_AXIS]


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


def _divides(count: int, what: str, size: int) -> None:
    if count % size:
        raise ValueError(f"{what} {count} is not divisible by "
                         f"tensor={size}: the cut falls on whole {what}")


def _tensor_heads(model_config, size: int) -> bool:
    """At tensor `size` > 1: whether the model's KV projections are held
    whole (`tensor.kv_held_whole`); refuses a config the cut cannot take
    (head, expert or class counts the axis does not divide) and a
    trainer without one."""
    from kubeflow_tpu_torch.models.gemma import GemmaConfig
    from kubeflow_tpu_torch.models.llama import LlamaConfig
    from kubeflow_tpu_torch.models.llama_moe import MoELlamaConfig
    from kubeflow_tpu_torch.models.vit import ViTConfig

    if isinstance(model_config, ViTConfig):
        _divides(model_config.num_heads, "num_heads", size)
        _divides(model_config.num_classes, "num_classes", size)
        return False
    if isinstance(model_config, MoELlamaConfig):
        _divides(model_config.num_experts, "num_experts", size)
    elif not isinstance(model_config, (LlamaConfig, GemmaConfig)):
        raise ValueError(
            f"a mesh with tensor={size} needs the model's config "
            f"(model_config=: llama, gemma, the MoE family or ViT) for its "
            f"head counts, got {type(model_config).__name__}")
    return tensor.kv_held_whole(model_config.num_heads,
                                model_config.num_kv_heads, size)


def tensor_spec(rules, logical_axes: tuple, kv_whole: bool) -> sharding_lib.P:
    """A leaf's spec under `rules`, "tensor" dropped from the KV
    projections where they are held whole (`_tensor_heads`)."""
    spec = rules.resolve(logical_axes)
    if kv_whole and "kv_heads" in logical_axes:
        spec = sharding_lib.without_axis(spec, mesh_lib.TENSOR_AXIS)
    return spec


def tensor_rank_cut(params: dict, logical_axes, model_config, index: int,
                    size: int, rules=sharding_lib.LLAMA_RULES) -> dict:
    """Tensor rank `index` of `size`'s blocks of full `params`: the cut
    `MeshLayout` makes on a mesh whose only axis above 1 is "tensor"
    (`tensor_spec`, on whole heads; KV projections held whole where
    `_tensor_heads` says so). The serving engines' weights
    (`bridge.tensor_rank_params`)."""
    kv_whole = _tensor_heads(model_config, size)
    axes = dict(_named_leaves(logical_axes))

    def cut(name, leaf):
        spec = tensor_spec(rules, axes[name], kv_whole)
        for dim, entry in enumerate(spec):
            if mesh_lib.TENSOR_AXIS in sharding_lib._entry_axes(entry):
                if leaf.shape[dim] % size:
                    raise ValueError(f"{name}: dim {dim} of "
                                     f"{tuple(leaf.shape)} not divisible "
                                     f"by tensor={size}")
                leaf = leaf.chunk(size, dim)[index]
        return leaf.clone(memory_format=torch.contiguous_format)

    return _rebuild(params, cut)


class MeshLayout:
    """Per-leaf layouts of a params tree on `mesh` under `rules`
    (`model_config`: the model's, needed at tensor > 1)."""

    def __init__(self, mesh, logical_axes, rules, tc, model_config=None):
        size = mesh.shape.get(mesh_lib.TENSOR_AXIS, 1)
        self.kv_whole = size > 1 and _tensor_heads(model_config, size)
        self.mesh = mesh
        self.rules = rules
        self.zero = tc.zero_optimizer
        self.axes = dict(_named_leaves(logical_axes))
        self.leaves: dict[str, LeafLayout] = {}
        self.batch_axes = [a for a in mesh_lib.BATCH_AXES
                           if a in mesh.axis_names]
        self.batch = mesh.axis_group(self.batch_axes)
        self.tensor = mesh.axis_group(mesh_lib.TENSOR_AXIS)

    @contextlib.contextmanager
    def parallel(self, padded: bool = False):
        """The context the model runs in: tensor-parallel over the mesh's
        "tensor" axis, MoE routing over the batch axes' global batch
        (each a no-op at size 1). `padded`: the rows hold padding, which
        MoE routing refuses."""
        with tensor.parallel(self.tensor), moe.global_batch(
                self.batch, padded=padded):
            yield

    def _side(self, shape) -> list:
        """The cuts of a moment that mirrors no param, of full `shape`."""
        return sharding_lib._dim_groups(self.slot_spec(None, shape),
                                        self.mesh)

    def slot_spec(self, name: str | None, shape) -> sharding_lib.P:
        """The spec of a moment of leaf `name`: the leaf's (ZeRO-
        extended) where it mirrors the leaf (`shape` None), else the
        reference's for a state leaf that mirrors no param: replicated,
        split over "data" by `zero_extend_spec` with `zero_optimizer`."""
        if shape is None:
            return self.leaves[name].opt_spec
        if not self.zero:
            return sharding_lib.P()
        return sharding_lib.zero_extend_spec(sharding_lib.P(), tuple(shape),
                                             self.mesh)

    def add(self, name: str, shape) -> LeafLayout:
        mesh = self.mesh
        axes = self.axes[name]
        if len(axes) != len(shape):
            raise ValueError(f"{name}: logical axes {axes} for shape "
                             f"{tuple(shape)}")
        spec = sharding_lib.filter_spec(
            tensor_spec(self.rules, axes, self.kv_whole), mesh)
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
        summed = [a for a in self.batch_axes if a not in cut]
        if (self.tensor.size > 1 and mesh_lib.TENSOR_AXIS not in cut
                and tensor.read_in_rank_work(axes)):
            summed.append(mesh_lib.TENSOR_AXIS)
        lay = LeafLayout(
            tuple(shape), spec, opt_spec, gathers,
            axes[0] == "layers" and all(d > 0 for d, _ in gathers), zero,
            mesh.axis_group(summed),
            LeafCut(shape, gathers + ([zero] if zero else []), self._side))
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
        gathered now (differentiably). A block cut on "tensor" stays
        this rank's block along that dim."""
        def view(name, leaf):
            lay = self.leaves[name]
            gathers = lay.view_gathers
            if not gathers:
                return leaf
            if lay.per_layer:
                slices = leaf.unbind(0)
                gathers = [(d - 1, g) for d, g in gathers]
                return sharding_lib.LayerStack(
                    len(slices), lambda li: _gathered(slices[li], gathers))
            return _gathered(leaf, gathers)
        return _rebuild(local, view)

    def gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full leaf (or its gradient) from every rank's block
        (collective)."""
        return sharding_lib.gather_tensor(t.detach(), self.leaves[name].spec,
                                          self.mesh)

    def gather_params(self, local: dict) -> dict:
        """The full params from every rank's blocks (collective)."""
        return _rebuild(local, self.gather_leaf)

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
        not cut on (the gathers' reduce-scatters summed the others), and
        over "tensor" for a leaf held whole there and read inside
        per-rank work."""
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

    def shard_slot(self, name: str, full: torch.Tensor,
                   shape=None) -> torch.Tensor:
        """A full moment (alike on every rank) -> what this rank holds of
        it: for one that mirrors the leaf (`shape` None), the slice
        `slot_view` gives of its block; else its part under `slot_spec`."""
        return sharding_lib.shard_tensor(full, self.slot_spec(name, shape),
                                         self.mesh)

    def gather_slot(self, name: str, t: torch.Tensor,
                    shape=None) -> torch.Tensor:
        """The full moment from what every rank holds (collective)."""
        return sharding_lib.gather_tensor(t.detach(),
                                          self.slot_spec(name, shape),
                                          self.mesh)

    @contextlib.contextmanager
    def slot(self, name: str, p: torch.Tensor, g: torch.Tensor):
        """`_Optimizer.update`'s slot hook: the slices of the block and
        its gradient that the rank updates, and their `LeafCut`; after
        the update, with ZeRO, the block is put together from every data
        rank's slice."""
        ps = self.slot_view(name, p)
        yield ps, self.slot_view(name, g), self.leaves[name].cut
        zero = self.leaves[name].zero
        if zero is not None:
            dim, group = zero
            p.copy_(comm._all_gather(ps.contiguous(), dim, group))

    def opt_state_bytes(self, named, optimizer) -> int:
        """Optimizer-state bytes a rank holds, as the reference reckons
        them: each state leaf at its full shape over the product of its
        spec's axis sizes (rounded up), plus the two int32 step counts
        of its chain. A slot that mirrors its leaf has the leaf's shape
        and (ZeRO-extended) spec; Adafactor's factored `v_row` and
        `v_col` theirs under `slot_spec`; a slot the leaf does not use
        is optax's one-element placeholder, replicated."""
        total = 8
        for name, p in named:
            lay = self.leaves[name]
            for slot in optimizer.slots:
                shape = optimizer.slot_shape(slot, lay.shape)
                if shape is not None and not math.prod(shape):
                    shape = (1,)
                spec = self.slot_spec(name, shape)
                ways = math.prod(self.mesh.shape.get(a, 1) for a in
                                 sharding_lib.spec_axes(spec))
                n = math.prod(lay.shape if shape is None else shape)
                total += -(-n * p.element_size() // ways)
        return total
