"""Llama-3 family forward, for serving and training (counterpart:
kubeflow_tpu/models/llama.py).

Parameters are a nested dict with every transformer block STACKED on a
leading layers axis, the reference's layout: `params["blocks"]["wq"]`
is `[L, D, n_q * hd]`. The forward is a Python loop over L where the
reference scans; with `remat` (and gradients on) each block runs under
`torch.utils.checkpoint` with the reference's save policy
(`remat_policy`): "full" keeps only the block's input, "mlp" also the
outputs of the three MLP products, "dots" every product without batch
dims (torch's selective activation checkpointing; see `_remat_context`).
`param_logical_axes` names each leaf's axes for the sharding rules
(parallel/sharding.py), which the trainer's mesh layout reads.

Storage dtypes: serving stores the block matrices in the activation
dtype (the reference casts them to it at every use) and the embedding,
head and norm weights in fp32; training (`init(..., train=True)`) keeps
every leaf in `param_dtype` (fp32 masters), cast at each use as the
reference does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rope, rope_frequencies
from kubeflow_tpu_torch.parallel import tensor
from kubeflow_tpu_torch.parallel.sharding import read_layer

Params = dict

# Block matrices, stored in the activation dtype; every other leaf is fp32.
# "router" is the MoE family's (models/llama_moe.py), which the reference
# also rounds to the activation dtype before its fp32 product.
MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int | None = None
    dtype: torch.dtype = torch.bfloat16   # activation dtype
    param_dtype: torch.dtype = torch.float32  # training master weights
    remat: bool = True
    # What a checkpointed block keeps for its backward:
    #   "full" - the block's input only; the backward reruns the block;
    #   "mlp"  - also the outputs of the three MLP products (gate, up,
    #            down), so the backward reruns the attention side;
    #   "dots" - also every product without batch dims (the 2-D `mm`
    #            each projection folds into); the backward reruns the
    #            elementwise ops and the attention core.
    # The flash forward is rerun under every policy: it launches outside
    # the dispatcher, and the reference saves no kernel output either.
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {self.remat_policy!r} unknown "
                f"(choose from {sorted(REMAT_POLICIES)})")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


REMAT_POLICIES = ("full", "mlp", "dots")
# the products a policy may save: a 3-D @ 2-D matmul folds into this 2-D
# `mm`; batched products (`bmm`: the attention core) are never saved
_DOTS = (torch.ops.aten.mm.default,)
_in_mlp_product = False   # set while a block runs a product "mlp" saves


@contextlib.contextmanager
def _mlp_product():
    """Marks the products inside as the "mlp" policy's save set (the
    reference's `checkpoint_name` "mlp_gate" / "mlp_up" / "mlp_down")."""
    global _in_mlp_product
    prev, _in_mlp_product = _in_mlp_product, True
    try:
        yield
    finally:
        _in_mlp_product = prev


def _save_policy(policy, ctx, op, *args, **kwargs):
    if op in _DOTS and (policy == "dots" or _in_mlp_product):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str):
    """`torch.utils.checkpoint`'s `context_fn` for `policy` ("full" saves
    nothing inside the block: the default context)."""
    if policy == "full":
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_policy, policy))


LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(
    hidden_size=2048, intermediate_size=8192, num_layers=16,
    num_heads=16, num_kv_heads=8, head_dim=128,
)
LLAMA_TINY = LlamaConfig(
    vocab_size=512, hidden_size=128, intermediate_size=384, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32, dtype=torch.float32,
    remat=False,
)

CONFIGS = {"llama3-8b": LLAMA3_8B, "llama3-1b": LLAMA3_1B,
           "tiny": LLAMA_TINY}


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Logical axis names per param leaf, the reference's tree (the
    layers axis leads the block params); parallel/sharding.py maps them
    onto a mesh."""
    block = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),     # [L, D, n_q * hd]
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    axes: Params = {
        "embed": ("vocab", "embed"),
        "blocks": block,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def param_shapes(cfg: LlamaConfig) -> Params:
    L, D, M = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    shapes: Params = {
        "embed": (cfg.vocab_size, D),
        "blocks": {
            "attn_norm": (L, D),
            "wq": (L, D, cfg.q_dim),
            "wk": (L, D, cfg.kv_dim),
            "wv": (L, D, cfg.kv_dim),
            "wo": (L, cfg.q_dim, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, M),
            "w_up": (L, D, M),
            "w_down": (L, M, D),
        },
        "final_norm": (D,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def leaf_dtype(cfg: LlamaConfig, name: str) -> torch.dtype:
    """Serving storage dtype of leaf `name`."""
    return cfg.dtype if name in MATRICES else torch.float32


def num_params(cfg: LlamaConfig) -> int:
    shapes = param_shapes(cfg)
    leaves = [*shapes.pop("blocks").values(), *shapes.values()]
    return sum(math.prod(shape) for shape in leaves)


def random_params(shapes: Params, dtype_of, seed: int,
                  device: torch.device | str,
                  store: torch.device | str | None = None,
                  by_layer: tuple[str, ...] = ()) -> Params:
    """Random params over a tree of leaf shapes (a model's
    `param_shapes`), drawn in the tree's order from a torch.Generator on
    `device` seeded with `seed`: truncated normal on [-2, 2] times
    fan_in**-0.5, norms zero (identity under the (1 + w) scale) — the
    reference's recipe, though not its values. `dtype_of(name)` is each
    leaf's dtype. `store` (default `device`) is where the leaves live:
    each is moved there once drawn, so host-stored params hold the
    card's draws while the card holds one leaf's draw at a time. The
    leaves named in `by_layer` are drawn one leading index (layer) at a
    time into their stored tensor, so that the fp32 draw of a leaf too
    large to draw whole (a MoE expert stack) is one layer's. On the
    "meta" device the leaves carry shapes and dtypes only, nothing is
    drawn (tools/memplan.py sizes a model so)."""
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def draw(shape, fan_in, dtype):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * fan_in**-0.5).to(dtype)

    def leaf(name, shape):
        if name.endswith("norm"):
            w = torch.zeros(shape, dtype=dtype_of(name), device=device)
            return w if store is None else w.to(store)
        # fan-in is the contraction axis: second-to-last for matrices,
        # the width for the embedding table
        fan_in = shape[-1] if name == "embed" else shape[-2]
        if name in by_layer:
            w = torch.empty(shape, dtype=dtype_of(name),
                            device=device if store is None else store)
            for li in range(shape[0]):
                w[li] = draw(shape[1:], fan_in, dtype_of(name))
            return w
        w = draw(shape, fan_in, dtype_of(name))
        return w if store is None else w.to(store)

    return {k: {n: leaf(n, s) for n, s in v.items()} if k == "blocks"
            else leaf(k, v) for k, v in shapes.items()}


def init(cfg: LlamaConfig, seed: int, device: torch.device | str, *,
         train: bool = False,
         store: torch.device | str | None = None) -> Params:
    """Random params from `seed` (`random_params`; parity tests convert
    the reference's params with `bridge.from_jax` instead). `train=True`
    keeps every leaf in `cfg.param_dtype` (the trainer's masters);
    otherwise leaves take their serving dtype (`leaf_dtype`). `store`:
    where the leaves drawn on `device` live (a live reload stages them
    on the host)."""

    def dtype_of(name):
        return cfg.param_dtype if train else leaf_dtype(cfg, name)

    return random_params(param_shapes(cfg), dtype_of, seed, device, store)


def layer_params(params: Params, li: int) -> Params:
    """Layer `li`'s slice of the stacked block params (views)."""
    return {k: v[li] for k, v in params["blocks"].items()}


def _attention_half(cfg, x, p, positions, inv_freq, kv_mask,
                    contiguous_positions=False):
    """A block's attention half on x [b, s, D] in cfg.dtype: the residual
    after the attention output (models/llama_moe.py shares it). Head
    counts come from the leaves: under tensor parallelism they are the
    rank's (parallel/tensor.py), its wo product a partial sum."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = tensor.enter(rms_norm(x, p["attn_norm"], cfg.norm_eps))
    wk, wv = (tensor.kv_columns(p[n], cfg.num_kv_heads, hd)
              for n in ("wk", "wv"))
    q = (h @ p["wq"].to(cfg.dtype)).reshape(b, s, -1, hd)
    k = (h @ wk.to(cfg.dtype)).reshape(b, s, -1, hd)
    v = (h @ wv.to(cfg.dtype)).reshape(b, s, -1, hd)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = dot_product_attention(q, k, v, positions, positions,
                                 causal=True, kv_mask=kv_mask,
                                 window=cfg.sliding_window,
                                 contiguous_positions=contiguous_positions)
    return x + tensor.exit(attn.reshape(b, s, -1) @ p["wo"].to(cfg.dtype))


def _block(cfg: LlamaConfig, x, p, positions, inv_freq, kv_mask,
           contiguous_positions=False):
    """One transformer block on x [b, s, D] in cfg.dtype."""
    p = read_layer(p)
    x = _attention_half(cfg, x, p, positions, inv_freq, kv_mask,
                        contiguous_positions)
    h = tensor.enter(rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    w_gate, w_up, w_down = (p[n].to(cfg.dtype)
                            for n in ("w_gate", "w_up", "w_down"))
    with _mlp_product():
        gate = h @ w_gate
        up = h @ w_up
    ff = torch.nn.functional.silu(gate) * up
    with _mlp_product():
        down = ff @ w_down
    return x + tensor.exit(down)


def hidden(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
           positions: torch.Tensor | None = None,
           kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [b, s] -> final NORMED hidden [b, s, D] in cfg.dtype."""
    b, s = tokens.shape
    contiguous = positions is None  # safe for the index-masked kernels
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    inv_freq = rope_frequencies(cfg.head_dim, theta=cfg.rope_theta,
                                device=tokens.device)
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    # one unbind per leaf: its backward stacks the layers' gradients
    # once, where indexing per layer would write a full-size zero
    # gradient per layer and sum them
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    context = _remat_context(cfg.remat_policy)
    block = tensor.bind(_block)
    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in layers.items()}
        args = (cfg, x, p, positions, inv_freq, kv_mask, contiguous)
        x = (checkpoint(block, *args, use_reentrant=False,
                        context_fn=context) if remat
             else block(*args))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def unembed_matrix(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    """[D, vocab] unembedding (the tied table transposed, or lm_head);
    under tensor parallelism the rank's vocab block."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def apply(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None,
          kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Forward -> logits [b, s, vocab] in fp32; under tensor parallelism
    the rank's vocab block of them [b, s, vocab / t]."""
    x = hidden(params, cfg, tokens, positions, kv_mask)
    return tensor.enter(x.float()) @ unembed_matrix(params, cfg).float()
