"""Mixture-of-Experts: the routed expert layer on one device
(counterpart: kubeflow_tpu/parallel/moe.py, its `moe_mlp` half).

Routing is the reference's, step for step: the router product in fp32
(the caller has rounded the router to the activation dtype, as the
reference casts it), a softmax in fp32, and the top k of the
probabilities. The gate values are those RAW probabilities of the full
softmax, not renormalised over the k chosen (public Mixtral code
renormalises; the reference does not). Each expert grants `capacity`
slots in rank-major order: the running count runs over the flattened
(k, T) priority, so every token's rank-0 choice outranks any rank-1
choice, and a choice whose slot is at or past the capacity is dropped.
The Switch load-balancing factors (`frac`, `mean_prob`) come back with
the routing.

Dispatch and combine. The reference builds [T, E, C] one-hot dispatch
and combine tensors and contracts them with einsums; `_route` builds
them too, for the tests to hold against the reference's. `moe_mlp`
moves tokens by index instead: each kept (token, choice) pair owns row
e * C + slot of an [E * C + 1, D] buffer (the last row takes the
dropped choices and is never read back), the expert products run
batched over [E, C, D], and each token gathers its k rows back and
sums them weighted by its gate values, rounded to the activation dtype
first, in fp32 (the einsum's fp32 accumulation of at most k non-zero
terms), rounded once. A one-hot selection is exact, so the values are
the einsums' at O(T k D) work instead of O(T^2 E D), which matters at
serving's capacity C = T. Every shape is static and nothing is read
back to the host (no `.item()`, `nonzero` or boolean indexing), so a
CUDA graph holds the layer.

Gradients (training) are autograd's through the same index moves, and
they are the reference's: the dispatch write's backward gathers each
kept choice's row gradient back to its token, the combine's gives each
expert row its tokens' weighted output gradient and each gate value
the dot of its row with the output gradient. A dropped choice's gate
value is replaced by 0 before the combine, so it gets no gradient, and
its token's write went to the trash row, which no product reads, so
that row's gradient is 0 and gives the token none. The router's
gradient flows through the top-k values and through `mean_prob` in the
aux loss; `frac` is a count and carries none.

The expert products are `torch.bmm` over all E experts and C slots: at
serving's capacity they compute E / k times the routed products and
read every expert's weights each step, as the reference's einsums do.
No Pallas kernel lies on this path.

Expert parallelism (`moe_mlp_expert_parallel`, on every rank of the
expert axis, as the reference's runs inside `shard_map`): each rank
routes its own tokens against ALL experts (the router is replicated)
into the same [E, C, D] slot buffer, a tiled all-to-all sends expert
group j's slots to rank j ([E/N, N*C, D]: this rank's experts' slots
from every rank), the local experts run, and the inverse all-to-all
brings the outputs home for the combine. Capacity comes from the LOCAL
token count, so under tight capacity each rank drops as `moe_mlp` does
on its own token block (the reference's documented per-shard
semantics). The load-balance factors are averaged over every token
axis (`pmean`) before their product, so the aux loss, and its router
gradient, are the global batch's. `moe_mlp_sharded` takes the global
batch every rank holds alike, splits it over the batch axes and the
experts over the expert axis, and returns the global output.

Under the mesh trainer (train/fsdp.py) `moe_mlp` routes the rank's rows
as its slice of the global batch, as the reference's GSPMD `moe_mlp`
sees the whole batch (`global_batch(group)`, which the trainer sets over
its batch axes as `tensor.parallel` sets the tensor group): the capacity
comes from the global token count; a choice's slot counts, for its
expert, every choice of an earlier choice rank over all batch ranks,
then the earlier batch ranks' choices of its own choice rank, then its
own rank's earlier tokens (rows are rank-major over the batch axes,
outer first, as `MeshLayout.local_rows` cuts them), so the slots are
the global (k, T) priority's, from one all-gather of the [k, E] counts a
layer; and `frac` and `mean_prob` are averaged over the batch ranks
before their product (`pmean`), so the aux loss is the global batch's,
the same on every rank (the trainer adds it to the loss once). Under
tensor parallelism (parallel/tensor.py) the rank holds E / t experts
(the stacks cut on "experts"): every tensor rank routes alike on the
invariant input, runs its experts on their global capacity slots, and
`exit` sums the ranks' outputs; the input and the gate values `enter`
per-rank work, so their gradients are summed over "tensor" and the
router's comes out whole on every tensor rank.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch

from kubeflow_tpu_torch.parallel import comm, tensor
from kubeflow_tpu_torch.parallel import mesh as mesh_lib

_BATCH: contextvars.ContextVar = contextvars.ContextVar("moe_batch",
                                                       default=None)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    embed_dim: int = 512
    mlp_dim: int = 1024          # per-expert hidden dim (SwiGLU)
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token slots, from the token count alone."""
        cap = int(self.capacity_factor * n_tokens * self.top_k
                  / self.num_experts)
        return max(cap, self.top_k)


def init_moe(cfg: MoEConfig, seed: int,
             device: torch.device | str) -> dict[str, torch.Tensor]:
    """Random layer params from `seed`: normal times fan_in**-0.5 in
    `cfg.dtype`, the reference's recipe (not its values)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, m, e = cfg.embed_dim, cfg.mlp_dim, cfg.num_experts

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device)
        return (w * fan_in**-0.5).to(cfg.dtype)

    return {"router": normal((d, e), d), "w_gate": normal((e, d, m), d),
            "w_up": normal((e, d, m), d), "w_down": normal((e, m, d), m)}


def moe_logical_axes() -> dict[str, tuple[str | None, ...]]:
    """Logical axes of the layer's params for sharding.py's rules
    ("experts" -> tensor by default)."""
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", None),
        "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
    }


def _top_k(probs: torch.Tensor, k: int):
    """The k highest router probabilities of each token and their
    experts, [T, k] each, highest first (`jax.lax.top_k`)."""
    return torch.topk(probs, k, dim=-1)


@contextlib.contextmanager
def global_batch(group: comm.AxisGroup | None, *, padded: bool = False):
    """`moe_mlp` inside routes the rank's rows as its slice of the batch
    split over `group` (None, or a group of one rank: the rows are the
    whole batch). `padded`: the rows include padding (a micro-batch the
    ranks do not divide), which a routing would count: `moe_mlp` refuses
    it."""
    token = _BATCH.set((group, padded) if group is not None
                       and group.size > 1 else None)
    try:
        yield
    finally:
        _BATCH.reset(token)


def bind(fn):
    """fn run under the batch context current now, wherever it is called
    (a checkpointed block that the backward reruns on autograd's device
    thread, as `tensor.bind`)."""
    batch = _BATCH.get()
    if batch is None:
        return fn

    def run(*args, **kwargs):
        token = _BATCH.set(batch)
        try:
            return fn(*args, **kwargs)
        finally:
            _BATCH.reset(token)

    return run


def _batch_group() -> comm.AxisGroup | None:
    batch = _BATCH.get()
    if batch is None:
        return None
    group, padded = batch
    if padded:
        raise ValueError(
            "MoE routing on a micro-batch the batch ranks do not divide is "
            "refused: its padding rows would take capacity slots (make "
            "batch / grad_accum a multiple of the batch ranks)")
    return group


def _assign(router_logits: torch.Tensor, cfg: MoEConfig, capacity: int,
            group: comm.AxisGroup | None = None):
    """Top-k routing with capacity, in index form. logits [T, E], the
    rank's slice of the batch split over `group` (None: the whole
    batch). -> (gate values [T, k] fp32, experts [T, k], slots [T, k],
    kept [T, k] bool, frac [E], mean_prob [E]); frac and mean_prob are
    the rank's own."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)
    # one-hot by comparison: F.one_hot checks its range on the host
    onehot = (gate_idx[..., None] == torch.arange(
        E, device=gate_idx.device)).long()                     # [T, k, E]
    per_rank = onehot.transpose(0, 1)                          # [k, T, E]
    counts = per_rank.sum(1, keepdim=True)                     # [k, 1, E]
    every = (counts[None] if group is None
             else comm._all_gather(counts[None], 0, group))    # [n, k, 1, E]
    total = every.sum(0)
    # earlier choice ranks over every batch rank, then the earlier batch
    # ranks at the same choice rank, then this rank's earlier tokens
    pos = (torch.cumsum(total, 0) - total
           + every[:0 if group is None else group.index].sum(0)
           + torch.cumsum(per_rank, 1) - per_rank)             # [k, T, E]
    slot = (pos.transpose(0, 1) * onehot).sum(-1)              # [T, k]
    keep = slot < capacity
    frac = onehot.sum(1).float().mean(0)
    mean_prob = probs.mean(0)
    return gate_vals, gate_idx, slot, keep, frac, mean_prob


def _route(router_logits: torch.Tensor, cfg: MoEConfig, capacity: int):
    """The reference's dense routing tensors. logits [T, E].
    -> (dispatch [T, E, C] bool, combine [T, E, C] fp32, frac [E],
    mean_prob [E]); aux loss = E * sum(frac * mean_prob)."""
    gate_vals, gate_idx, slot, keep, frac, mean_prob = _assign(
        router_logits, cfg, capacity)
    T, E = router_logits.shape
    dev = router_logits.device
    # a token's k experts differ, so each (t, e) is written once; a
    # dropped choice writes its zero at slot 0
    at = (torch.arange(T, device=dev).repeat_interleave(cfg.top_k),
          gate_idx.reshape(-1), torch.where(keep, slot, 0).reshape(-1))
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    combine[at] = torch.where(keep, gate_vals, 0.0).reshape(-1)
    disp = torch.zeros((T, E, capacity), dtype=torch.bool, device=dev)
    disp[at] = keep.reshape(-1)
    return disp, combine, frac, mean_prob


def _aux_loss(frac: torch.Tensor, mean_prob: torch.Tensor) -> torch.Tensor:
    return frac.shape[0] * torch.sum(frac * mean_prob)


def _expert_ffn(params, x_ecd: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU, batched over E. x [E, C, d] -> [E, C, d]."""
    gate = torch.bmm(x_ecd, params["w_gate"])
    up = torch.bmm(x_ecd, params["w_up"])
    act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return torch.bmm(act, params["w_down"])


def _dispatch(xt, logits, cfg: MoEConfig, capacity: int, group=None,
              first: int = 0, experts: int | None = None):
    """Route [T, d] tokens into an [n * C, d] slot buffer of the n
    `experts` from `first` (default: all E). -> (slots, rows [T * k] each
    choice's slot row (n * C for a dropped choice or another rank's
    expert), gate weights [T, k] fp32 (0 where dropped), frac,
    mean_prob)."""
    k = cfg.top_k
    n = cfg.num_experts if experts is None else experts
    gate_vals, gate_idx, slot, keep, frac, mean_prob = _assign(
        logits, cfg, capacity, group)
    trash = n * capacity
    mine = keep & (gate_idx >= first) & (gate_idx < first + n)
    row = torch.where(mine, (gate_idx - first) * capacity + slot,
                      trash).reshape(-1)
    xe = xt.new_zeros((trash + 1, xt.shape[1]))
    xe[row] = xt.repeat_interleave(k, 0)   # only the trash row repeats
    w = torch.where(keep, gate_vals, 0.0)
    return xe[:trash], row, w, frac, mean_prob


def _combine(ye, row, w, T, k, dtype):
    """Each token's k slot rows of ye [n * C, d], weighted by its gate
    values rounded to the activation dtype, summed in fp32 (a row of
    another rank's expert reads the zero row); rounded to `dtype` (None:
    kept in fp32)."""
    ye = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
    w = w.to(ye.dtype).float()
    y = (ye[row].view(T, k, -1).float() * w[..., None]).sum(1)
    return y if dtype is None else y.to(dtype)


def moe_mlp(params: dict[str, torch.Tensor], x: torch.Tensor,
            cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed layer on x [b, s, d] -> (output [b, s, d] in x's dtype,
    aux loss []). `params` (router [d, E], w_gate / w_up [E, d, M],
    w_down [E, M, d]) are in the activation dtype; under tensor
    parallelism the stacks are the rank's E / t experts. Inside
    `global_batch` x is the rank's rows of the global batch."""
    b, s, d = x.shape
    T = b * s
    group = _batch_group()
    capacity = cfg.capacity(T * (1 if group is None else group.size))
    xt = x.reshape(T, d)
    logits = xt.float() @ params["router"].float()
    n = params["w_gate"].shape[0]
    tg = tensor.group()
    first = 0 if tg is None or n == cfg.num_experts else tg.index * n
    xe, row, w, frac, mean_prob = _dispatch(tensor.enter(xt), logits, cfg,
                                            capacity, group, first, n)
    ye = _expert_ffn(params, xe.view(n, capacity, d))
    y = _combine(ye.reshape(n * capacity, d), row, tensor.enter(w), T,
                 cfg.top_k, None)
    if group is not None:
        frac = comm.pmean(frac, group)
        mean_prob = comm.pmean(mean_prob, group)
    return (tensor.exit(y).to(x.dtype).reshape(b, s, d),
            _aux_loss(frac, mean_prob))


def moe_mlp_expert_parallel(
    params: dict[str, torch.Tensor],   # experts dim LOCAL (E/N a rank)
    x: torch.Tensor,                   # [b_local, s, d] LOCAL tokens
    cfg: MoEConfig, *,
    group: comm.AxisGroup,
    token_groups: tuple[comm.AxisGroup, ...] = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert parallelism over the expert axis `group`, run on
    every rank of it. `token_groups`: the axes the token batch is split
    over (default: the expert axis), over which the load-balance
    factors are averaged before their product."""
    n = group.size
    b, s, d = x.shape
    T = b * s
    e_local = params["w_gate"].shape[0]
    E = e_local * n
    if E != cfg.num_experts:
        raise ValueError(f"{e_local} local experts x {n} ranks != "
                         f"num_experts={cfg.num_experts}")
    xt = x.reshape(T, d)
    capacity = cfg.capacity(T)
    logits = xt.float() @ params["router"].float()
    xe, row, w, frac, mean_prob = _dispatch(xt, logits, cfg, capacity)
    # a2a #1: [E, C, d] -> [E/N, N*C, d], this rank's experts' slots
    # from every rank
    xe = comm.all_to_all(xe.view(E, capacity, d), 0, 1, group)
    ye = _expert_ffn(params, xe)
    # a2a #2 (inverse): back to [E, C, d] on the tokens' ranks
    ye = comm.all_to_all(ye, 1, 0, group)
    y = _combine(ye.reshape(E * capacity, d), row, w, T, cfg.top_k, x.dtype)
    for g in (token_groups or (group,)):
        frac = comm.pmean(frac, g)
        mean_prob = comm.pmean(mean_prob, g)
    return y.reshape(b, s, d), _aux_loss(frac, mean_prob)


def moe_mlp_sharded(
    params: dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
    mesh, *, expert_axis: str = mesh_lib.TENSOR_AXIS,
    batch_axes: tuple[str, ...] = (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS,
                                   mesh_lib.TENSOR_AXIS),
) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch [b, s, d] split over `batch_axes`, the experts
    over `expert_axis` (which is also a batch axis: tokens and experts
    co-shard, so the all-to-alls move only dispatched slots). Params and
    x are the global tensors every rank holds alike; returns the global
    output and the aux loss, gradients whole on every rank."""
    n = mesh.shape[expert_axis]
    if cfg.num_experts % n:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by "
                         f"{expert_axis}={n}")
    n_batch = math.prod(mesh.shape[a] for a in batch_axes)
    if x.shape[0] % max(1, n_batch):
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{batch_axes}")
    batch = mesh.axis_group(batch_axes)
    experts = mesh.axis_group(expert_axis)
    rest = mesh.axis_group([a for a in mesh.axis_names if a != expert_axis])
    local = {"router": comm.pvary(params["router"], batch)}
    for k in ("w_gate", "w_up", "w_down"):
        local[k] = comm.shard(comm.pvary(params[k], rest), 0, experts)
    y, aux = moe_mlp_expert_parallel(
        local, comm.shard(x, 0, batch), cfg, group=experts,
        token_groups=tuple(mesh.axis_group(a) for a in batch_axes))
    return comm.all_gather_invariant(y, 0, batch), aux
