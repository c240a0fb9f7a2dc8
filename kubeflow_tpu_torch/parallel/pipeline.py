"""Pipeline parallelism: the GPipe schedule over a stage axis
(counterpart: kubeflow_tpu/parallel/pipeline.py).

Each rank of the stage axis holds its own stage's params. The schedule
runs M + S - 1 ticks (M microbatches, S stages): at tick t, stage s
computes microbatch t - s, and boundary activations move one hop up per
tick (`comm.ppermute`, neighbour-only). As in the reference, the shape
is static: bubble ticks compute on zeros (or a repeat of the last
microbatch on stage 0) and their results are masked, which wastes the
bubble's S - 1 of M + S - 1 stage calls and keeps every rank's kernel
launches the same count. The last stage's outputs are summed over the
stage axis (`comm.psum`), so every stage returns them alike.

The schedule is one `autograd.Function` (GPipe with activation
recompute): the forward keeps only each tick's stage input; the backward
walks the ticks in reverse, receives the gradient of the tick's output
from the next stage (the transpose of the forward hop), reruns the
active ticks' stage with gradients on and sends the gradient of their
input to the previous stage. Bubble ticks are masked, so their backward
is a zero hop and no stage call: a stage runs M + S - 1 calls forward
and M again in the backward. Every rank's backward runs whatever its
local share of the loss (the output is the invariant sum), so the hops
always meet. The input's gradient (nonzero on the first stage only) is
summed over the stages, as `comm.pvary`'s; each stage's params get
their own.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from kubeflow_tpu_torch.parallel import comm
from kubeflow_tpu_torch.parallel.sharding import tree_map


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _flatten(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree, _is_tensor)
    return leaves


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, _is_tensor)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, structure, x_mb, *leaves):
        S, idx = group.size, group.index
        M = x_mb.shape[0]
        params = _unflatten(structure, leaves)
        fwd = [(i, i + 1) for i in range(S - 1)]
        prev = torch.zeros_like(x_mb[0])
        outs = torch.zeros_like(x_mb)
        inps = []
        for t in range(M + S - 1):
            mb = t - idx
            inp = x_mb[min(t, M - 1)] if idx == 0 else prev
            inps.append(inp)
            out = stage_fn(params, inp)
            if not 0 <= mb < M:
                out = torch.zeros_like(out)
            elif idx == S - 1:
                outs[mb] = out
            prev = comm._ppermute(out, fwd, group)
        ctx.stage_fn, ctx.group, ctx.structure = stage_fn, group, structure
        ctx.n_leaves = len(leaves)
        ctx.save_for_backward(*leaves, *inps)
        return comm._psum(outs, group)

    @staticmethod
    def backward(ctx, gy):
        group, S = ctx.group, ctx.group.size
        idx = group.index
        saved = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in saved[:ctx.n_leaves]]
        inps = saved[ctx.n_leaves:]
        M = gy.shape[0]
        params = _unflatten(ctx.structure, leaves)
        wants = [t for t in leaves if t.requires_grad]
        gleaves = [torch.zeros_like(t) for t in wants]
        gx = torch.zeros_like(gy)
        bwd = [(i + 1, i) for i in range(S - 1)]
        # the gradient of the next tick's input, sent back each tick
        carry = torch.zeros_like(gy[0])
        for t in reversed(range(M + S - 1)):
            g_out = comm._ppermute(carry, bwd, group)
            mb = t - idx
            carry = torch.zeros_like(gy[0])
            if not 0 <= mb < M:
                continue
            if idx == S - 1:
                g_out = g_out + gy[mb]
            inp = inps[t].detach().requires_grad_(True)
            with torch.enable_grad():
                out = ctx.stage_fn(params, inp)
                grads = torch.autograd.grad(out, [inp, *wants], g_out,
                                            allow_unused=True)
            for acc, g in zip(gleaves, grads[1:]):
                if g is not None:
                    acc += g
            if idx == 0:
                gx[mb] += grads[0]
            else:
                carry = grads[0]
        # the input entered per-stage work: its gradient sums over stages
        gx = comm._psum(gx, group)
        it = iter(gleaves)
        gl = [next(it) if t.requires_grad else None for t in leaves]
        return (None, None, None, gx, *gl)


def pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             stage_params: Any, x_mb: torch.Tensor, *,
             group: comm.AxisGroup) -> torch.Tensor:
    """Run the schedule on every rank of the stage axis `group`.
    `stage_fn(params, x) -> y` keeps the activation's shape (a dict tree
    of this stage's param tensors); x_mb [M, mb, ...] is the
    microbatched input every stage holds alike. Returns [M, mb, ...],
    the same on every stage."""
    return _Pipeline.apply(stage_fn, group, stage_params, x_mb,
                           *_flatten(stage_params))


def pipeline_sharded(stage_fn, stacked_params: Any, x: torch.Tensor, mesh,
                     *, stage_axis: str, num_microbatches: int
                     ) -> torch.Tensor:
    """Split x [batch, ...] into microbatches, give each rank its stage's
    slice of the stage-major stacked params (leaves [S, ...]), run the
    schedule and return [batch, ...] on every stage."""
    group = mesh.axis_group(stage_axis)
    S = group.size
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches "
                         f"{num_microbatches}")
    leaves = _flatten(stacked_params)
    if any(leaf.shape[0] != S for leaf in leaves):
        raise ValueError(
            f"stacked params' leading dim must equal {stage_axis}={S}, "
            f"got {sorted({leaf.shape[0] for leaf in leaves})}")
    local = tree_map(lambda leaf: comm.shard(leaf, 0, group)[0],
                     stacked_params, _is_tensor)
    x_mb = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
    y = pipeline(stage_fn, local, x_mb, group=group)
    return y.reshape(b, *y.shape[2:])


def stack_stage_params(per_stage: list[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage])
                for k in first}
    return torch.stack(per_stage)


def reference_forward(stage_fn, per_stage_params: list[Any],
                      x: torch.Tensor) -> torch.Tensor:
    """Sequential stage composition: the numerics oracle for tests."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x
