"""Collectives over one mesh axis: the port's counterpart of the
collectives `shard_map` code calls (`jax.lax.ppermute`, `all_to_all`,
`psum`, `pmean`, `pmax`, `axis_index`; `all_gather` and its transpose for the
FSDP gather).

Each op takes an `AxisGroup` (`Mesh.axis_group(name)`): the axis's
process group, its ranks in axis order and this rank's index along it.
An axis of size 1 needs no group and no communication.

The differentiable ops are `autograd.Function`s whose backward is the
op's transpose under JAX's rules for values that are the same on every
rank of an axis ("invariant", one logical copy) and values that differ
("varying"):
- `ppermute` sends the gradient back along the inverse permutation and
  `all_to_all` runs the inverse exchange (varying to varying);
- `all_gather` reduce-scatters (sums) the gradient: the gathered tensor
  feeds per-rank work, as an FSDP parameter feeds each rank's batch;
- `all_gather_invariant` keeps this rank's block of the gradient: the
  gathered tensor is an invariant output (a `shard_map` output with the
  axis in its spec), whose gradient every rank holds alike;
- `shard` (this rank's block of an invariant tensor, a `shard_map`
  input) all-gathers the gradient blocks;
- `pvary` (an invariant tensor entering per-rank work) sums the
  gradient over the axis;
- `psum` and `pmean` make invariant values: their gradient is the
  incoming one (divided by the axis size for `pmean`).
An objective that every rank computes from invariant values is one
copy, and its gradients come out whole on every rank; the trainers sum
the gradients of per-rank (batch-sharded) objectives themselves.

Their roles in tensor parallelism (Megatron-style, over the "tensor"
axis; parallel/tensor.py places them in the blocks):
- `pvary` where an invariant activation enters per-rank work: the
  normed residual before the column-parallel products (wq, wk, wv,
  w_gate, w_up) and the final hidden before the vocab-cut head. Each
  rank's gradient of it is partial; the backward sums them;
- `psum` after the row-parallel products (wo, w_down) and after the
  masked lookup in the rank's vocab block of the embedding: the
  partial sums become the invariant residual, whose gradient every
  rank already holds whole;
- `pmax` (no gradient) and `psum` in the vocab-parallel cross entropy:
  the logits' max over the vocab blocks, then the sum-exp and the gold
  logit.

Host staging: a gloo group lacks send/recv and all_to_all for CUDA
tensors (and its CUDA paths for the rest vary by build), so on a gloo
group every op copies CUDA tensors to host memory, communicates there
and copies the result back. That is the layout of several ranks on one
card, where NCCL refuses two ranks of one device. `staged` counts those
ops, their bytes and their seconds so a caller can report the cost
apart from its own. An NCCL group never stages.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

# host-staged ops on gloo groups: calls, bytes moved to and from the
# host, and wall seconds of the staged ops (copies and communication)
staged = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_staged() -> None:
    staged.update(calls=0, bytes=0, seconds=0.0)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis (or several, flattened in mesh order) as seen from
    this rank: `ranks` are the global ranks along it in axis order,
    `index` is this rank's position, `pg` the process group (None when
    the axis has size 1)."""

    name: str | tuple[str, ...]
    ranks: tuple[int, ...]
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self) -> str | None:
        return None if self.pg is None else dist.get_backend(self.pg)


def axis_index(group: AxisGroup) -> int:
    return group.index


def axis_size(group: AxisGroup) -> int:
    return group.size


class _Staged:
    """Runs a collective on host copies of CUDA tensors for a gloo
    group, and counts it; otherwise hands the tensors through."""

    def __init__(self, group: AxisGroup, x: torch.Tensor):
        self.device = x.device
        self.on = group.backend == "gloo" and x.device.type == "cuda"

    def __enter__(self):
        if self.on:
            self.t0 = time.perf_counter()
        return self

    def host(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return x.contiguous()
        staged["bytes"] += x.numel() * x.element_size()
        return x.detach().to("cpu").contiguous()

    def back(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return x
        staged["bytes"] += x.numel() * x.element_size()
        return x.to(self.device)

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.synchronize(self.device)
            staged["calls"] += 1
            staged["seconds"] += time.perf_counter() - self.t0
        return False


def _ppermute(x: torch.Tensor, perm, group: AxisGroup) -> torch.Tensor:
    """Each (src, dst) pair of axis indices sends src's x to dst; a rank
    that no pair sends to gets zeros (`jax.lax.ppermute`)."""
    me = group.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    if group.size == 1:
        return x.clone() if src else torch.zeros_like(x)
    with _Staged(group, x) as st:
        xs = st.host(x)
        out = torch.empty_like(xs) if src else None
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, xs, group.ranks[dst[0]],
                                  group.pg))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, group.ranks[src[0]],
                                  group.pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = st.back(out) if src else None
    return out if out is not None else torch.zeros_like(x)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group: AxisGroup) -> torch.Tensor:
    """Tiled all-to-all (`jax.lax.all_to_all(..., tiled=True)`): x's
    split_dim cut into `size` blocks, block j to axis index j; the
    blocks received, in source order, concatenated along concat_dim."""
    n = group.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not "
                         f"divisible by axis size {n}")
    if n == 1:
        return x.clone()
    with _Staged(group, x) as st:
        blocks = st.host(torch.stack(x.chunk(n, split_dim)))
        out = torch.empty_like(blocks)
        dist.all_to_all_single(out, blocks, group=group.pg)
        out = st.back(out)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _all_gather(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """The axis's blocks concatenated along dim, in axis order."""
    if group.size == 1:
        return x.clone()
    with _Staged(group, x) as st:
        xs = st.host(x)
        parts = [torch.empty_like(xs) for _ in range(group.size)]
        dist.all_gather(parts, xs, group=group.pg)
        out = st.back(torch.cat(parts, dim=dim))
    return out


def _psum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    if group.size == 1:
        return x.clone()
    with _Staged(group, x) as st:
        xs = st.host(x).clone()
        dist.all_reduce(xs, group=group.pg)
        out = st.back(xs)
    return out


def _pmax(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    if group.size == 1:
        return x.clone()
    with _Staged(group, x) as st:
        xs = st.host(x).clone()
        dist.all_reduce(xs, op=dist.ReduceOp.MAX, group=group.pg)
        out = st.back(xs)
    return out


def _reduce_scatter(x: torch.Tensor, dim: int,
                    group: AxisGroup) -> torch.Tensor:
    """The sum over the axis, cut along dim: this rank's block (the
    transpose of `all_gather`)."""
    n = group.size
    if n == 1:
        return x.clone()
    if group.backend == "gloo":
        return _psum(x, group).chunk(n, dim)[group.index].contiguous()
    blocks = torch.stack(x.chunk(n, dim)).contiguous()
    out = torch.empty_like(blocks[0])
    dist.reduce_scatter_tensor(out, blocks, group=group.pg)
    return out


def _block(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    if x.shape[dim] % group.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible "
                         f"by axis size {group.size}")
    return x.chunk(group.size, dim)[group.index].contiguous()


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _ppermute(g.contiguous(), inv, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None,
                None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        y = _psum(x, group)
        return y / group.size if mean else y

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.group.size if ctx.mean else g), None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.group), None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


def ppermute(x: torch.Tensor, perm, group: AxisGroup) -> torch.Tensor:
    """`jax.lax.ppermute` over the axis: `perm` holds (src, dst) pairs of
    axis indices; a rank no pair sends to gets zeros. Differentiable."""
    return _PPermute.apply(x, tuple(tuple(p) for p in perm), group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group: AxisGroup) -> torch.Tensor:
    """Tiled `jax.lax.all_to_all`. Differentiable (the inverse exchange).
    The result is contiguous."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def all_gather(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """The axis's blocks concatenated along dim. Differentiable: the
    gradient is reduce-scattered (summed) back to the blocks."""
    return _AllGather.apply(x, dim, group)


def all_gather_invariant(x: torch.Tensor, dim: int,
                         group: AxisGroup) -> torch.Tensor:
    """The axis's blocks concatenated along dim, as an invariant value:
    the gradient keeps this rank's block."""
    return _AllGatherInvariant.apply(x, dim, group)


def psum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Sum over the axis (an invariant value)."""
    return _PSum.apply(x, group, False)


def pmean(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Mean over the axis (an invariant value)."""
    return _PSum.apply(x, group, True)


def pmax(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Elementwise max over the axis (an invariant value), with no
    gradient: `jax.lax.pmax` under `stop_gradient`, the shift a
    vocab-parallel softmax subtracts."""
    return _pmax(x.detach(), group)


def pvary(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """x unchanged, entering per-rank work: its gradient is summed over
    the axis."""
    return _PVary.apply(x, group)


def shard(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """This rank's block of a tensor every rank of the axis holds alike,
    cut along dim (a `shard_map` input); its gradient blocks are
    all-gathered, so the replicated tensor gets the whole gradient on
    every rank."""
    return _Shard.apply(x, dim, group)
