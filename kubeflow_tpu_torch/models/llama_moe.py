"""Mixtral-style MoE transformer, for serving and training: Llama
attention and routed expert FFN blocks (counterpart:
kubeflow_tpu/models/llama_moe.py).

The dense Llama block's SwiGLU MLP is replaced by parallel/moe.py's
top-k routed expert layer; the attention half is models/llama.py's
(`_attention_half`: GQA, rope, rms norms, the sliding window). Expert
weights are stacked [L, E, ...] under "blocks" as in the reference's
tree, so `bridge.from_jax` carries the reference's params across.

Storage: serving keeps the block matrices, the router among them
(`llama.MATRICES`), in the activation dtype, since the reference casts
them to it at every use, and the embedding, head and norms in fp32;
training (`init(..., train=True)`) keeps every leaf in `param_dtype`
(fp32 masters), cast at each use. `init` draws the expert stacks a
layer at a time (`llama.random_params`' `by_layer`): at Mixtral-8x7B's
widths one layer's w_gate is 1.88 GB in fp32, the whole stack of 16
layers 30 GB.

`apply` returns the logits and the mean aux loss, with gradients when
the caller has them on (serving's teacher passes call it under
`inference_mode`); with `remat` each block runs under
`torch.utils.checkpoint`, the reference's full remat. Each stacked leaf
is unbound once, so the backward stacks its layers' gradients once
(indexing per layer would write a full-size zero gradient per layer:
1.88 GB per expert stack and layer at Mixtral's widths). At the config's
`capacity_factor` (1.25) an expert that overflows drops choices,
rank-major, so logits are causal only while capacity holds; serving
routes with capacity_factor E / k, where nothing can drop
(serving/engine.py's `_moe_serving_mlp`). `loss_fn` is the trainer's:
dense CE plus `aux_loss_weight` times the layers' mean aux loss, the
latter a `global_term` (under the mesh trainer every rank routes its
rows as part of the global batch and computes the global aux loss,
which enters the loss once).

Under tensor parallelism (parallel/tensor.py) the attention half is
llama's, the expert stacks are the rank's E / t experts (parallel/
moe.py's `moe_mlp` sums their outputs over the axis), and the head's
logits are the rank's vocab block; each block is bound to the tensor
group and the routing's batch group, which a backward rerun on
autograd's device thread does not see otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.llama import (
    Params,
    _attention_half,
    leaf_dtype,
    random_params,
)
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import rope_frequencies
from kubeflow_tpu_torch.parallel import moe as moe_lib
from kubeflow_tpu_torch.parallel import tensor
from kubeflow_tpu_torch.parallel.sharding import read_layer

EXPERT_STACKS = ("w_gate", "w_up", "w_down")
MOE_LEAVES = ("router",) + EXPERT_STACKS


@dataclasses.dataclass(frozen=True)
class MoELlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16    # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # MoE
    num_experts: int = 8
    top_k: int = 2
    expert_mlp_dim: int = 14336     # per-expert SwiGLU hidden
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    sliding_window: int | None = None   # llama.py semantics

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def moe_config(self) -> moe_lib.MoEConfig:
        return moe_lib.MoEConfig(
            num_experts=self.num_experts, top_k=self.top_k,
            embed_dim=self.hidden_size, mlp_dim=self.expert_mlp_dim,
            capacity_factor=self.capacity_factor, dtype=self.dtype)


MIXTRAL_8X7B = MoELlamaConfig()
MIXTRAL_TINY = MoELlamaConfig(
    vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=32, num_experts=4, top_k=2,
    expert_mlp_dim=192, dtype=torch.float32, remat=False)

CONFIGS = {"mixtral-8x7b": MIXTRAL_8X7B, "tiny": MIXTRAL_TINY}


def param_logical_axes(cfg: MoELlamaConfig) -> Params:
    """Logical axis names per param leaf (the reference's tree; the
    expert stacks' "experts" axis maps to tensor)."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "embed"),
            "router": ("layers", "embed", None),
            "w_gate": ("layers", "experts", "embed", None),
            "w_up": ("layers", "experts", "embed", None),
            "w_down": ("layers", "experts", None, "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def param_shapes(cfg: MoELlamaConfig) -> Params:
    L, D, E, M = (cfg.num_layers, cfg.hidden_size, cfg.num_experts,
                  cfg.expert_mlp_dim)
    return {
        "embed": (cfg.vocab_size, D),
        "blocks": {
            "attn_norm": (L, D),
            "wq": (L, D, cfg.q_dim),
            "wk": (L, D, cfg.kv_dim),
            "wv": (L, D, cfg.kv_dim),
            "wo": (L, cfg.q_dim, D),
            "mlp_norm": (L, D),
            "router": (L, D, E),
            "w_gate": (L, E, D, M),
            "w_up": (L, E, D, M),
            "w_down": (L, E, M, D),
        },
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab_size),
    }


def init(cfg: MoELlamaConfig, seed: int, device: torch.device | str, *,
         train: bool = False,
         store: torch.device | str | None = None) -> Params:
    """Random params from `seed` (`llama.random_params`: the reference's
    recipe, not its values; parity tests convert the reference's params
    with `bridge.from_jax` instead), the expert stacks drawn a layer at
    a time. `train=True` keeps every leaf in `cfg.param_dtype` (the
    trainer's masters); otherwise leaves take their serving dtype.
    `store`: where the leaves drawn on `device` live (a live reload
    stages them on the host)."""

    def dtype_of(name):
        return cfg.param_dtype if train else leaf_dtype(cfg, name)

    return random_params(param_shapes(cfg), dtype_of, seed, device, store,
                         by_layer=EXPERT_STACKS)


def _block(cfg: MoELlamaConfig, x, p, positions, inv_freq):
    """One MoE block on x [b, s, D] in cfg.dtype -> (x, aux)."""
    p = read_layer(p)
    x = _attention_half(cfg, x, p, positions, inv_freq, None,
                        contiguous_positions=True)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    # the reference casts all four to the activation dtype at use, the
    # router too: its fp32 product sees the rounded weights
    moe_params = {name: p[name].to(cfg.dtype) for name in MOE_LEAVES}
    y, aux = moe_lib.moe_mlp(moe_params, h, cfg.moe_config())
    return x + y, aux


def apply(params: Params, cfg: MoELlamaConfig,
          tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward -> (logits [b, s, vocab] fp32, mean aux loss []); under
    tensor parallelism the rank's vocab block of the logits."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    inv_freq = rope_frequencies(cfg.head_dim, theta=cfg.rope_theta,
                                device=tokens.device)
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    block = tensor.bind(moe_lib.bind(_block))
    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in layers.items()}
        args = (cfg, x, p, positions, inv_freq)
        x, a = (checkpoint(block, *args, use_reentrant=False) if remat
                else block(*args))
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = tensor.enter(x.float()) @ params["lm_head"].float()
    return logits, aux / cfg.num_layers


def loss_fn(cfg: MoELlamaConfig):
    """Trainer-shaped loss: next-token CE plus the weighted load-balance
    aux loss (a `global_term`: once in the mesh trainer's global loss)."""

    from kubeflow_tpu_torch.train.trainer import (
        cross_entropy_loss,
        global_term,
    )

    def loss(params, tokens, targets, mask):
        logits, aux = apply(params, cfg, tokens)
        return (cross_entropy_loss(logits, targets, mask)
                + global_term(cfg.aux_loss_weight * aux))

    return loss
