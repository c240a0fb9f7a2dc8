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
No Pallas kernel lies on this path. Expert parallelism
(`moe_mlp_expert_parallel`, `moe_mlp_sharded`, `moe_logical_axes`)
waits for the distributed queue (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses

import torch


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


def _top_k(probs: torch.Tensor, k: int):
    """The k highest router probabilities of each token and their
    experts, [T, k] each, highest first (`jax.lax.top_k`)."""
    return torch.topk(probs, k, dim=-1)


def _assign(router_logits: torch.Tensor, cfg: MoEConfig, capacity: int):
    """Top-k routing with capacity, in index form. logits [T, E].
    -> (gate values [T, k] fp32, experts [T, k], slots [T, k], kept
    [T, k] bool, frac [E], mean_prob [E])."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)
    # one-hot by comparison: F.one_hot checks its range on the host
    onehot = (gate_idx[..., None] == torch.arange(
        E, device=gate_idx.device)).long()                     # [T, k, E]
    prio = onehot.transpose(0, 1).reshape(cfg.top_k * T, E)
    pos = (torch.cumsum(prio, 0) - prio).reshape(cfg.top_k, T, E)
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


def moe_mlp(params: dict[str, torch.Tensor], x: torch.Tensor,
            cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed layer on x [b, s, d] -> (output [b, s, d] in x's dtype,
    aux loss []). `params` (router [d, E], w_gate / w_up [E, d, M],
    w_down [E, M, d]) are in the activation dtype."""
    b, s, d = x.shape
    T, E, k = b * s, cfg.num_experts, cfg.top_k
    xt = x.reshape(T, d)
    capacity = cfg.capacity(T)
    logits = xt.float() @ params["router"].float()
    gate_vals, gate_idx, slot, keep, frac, mean_prob = _assign(
        logits, cfg, capacity)
    trash = E * capacity
    row = torch.where(keep, gate_idx * capacity + slot, trash).reshape(-1)
    xe = x.new_zeros((trash + 1, d))
    xe[row] = xt.repeat_interleave(k, 0)   # only the trash row repeats
    ye = _expert_ffn(params, xe[:trash].view(E, capacity, d))
    ye = torch.cat([ye.reshape(trash, d), ye.new_zeros((1, d))])
    w = torch.where(keep, gate_vals, 0.0).to(ye.dtype).float()
    y = (ye[row].view(T, k, d).float() * w[..., None]).sum(1)
    return y.to(x.dtype).reshape(b, s, d), _aux_loss(frac, mean_prob)
