"""Llama-3 family forward, for serving and training (counterpart:
kubeflow_tpu/models/llama.py).

Parameters are a nested dict with every transformer block STACKED on a
leading layers axis, the reference's layout: `params["blocks"]["wq"]`
is `[L, D, n_q * hd]`. The forward is a Python loop over L where the
reference scans; with `remat` (and gradients on) each block runs under
`torch.utils.checkpoint`, the reference's "full" remat policy. No
sharding: the port runs on one card.

Storage dtypes: serving stores the block matrices in the activation
dtype (the reference casts them to it at every use) and the embedding,
head and norm weights in fp32; training (`init(..., train=True)`) keeps
every leaf in `param_dtype` (fp32 masters), cast at each use as the
reference does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rope, rope_frequencies

Params = dict

# Block matrices, stored in the activation dtype; every other leaf is fp32.
MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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
    # What a checkpointed block keeps: only "full" (block boundaries; the
    # backward reruns the whole block forward) is ported. The reference's
    # "mlp" and "dots" policies are ROADMAP work.
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy in ("mlp", "dots"):
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not ported yet "
                f"(ROADMAP Queue 1); use 'full'")
        if self.remat_policy != "full":
            raise ValueError(
                f"remat_policy {self.remat_policy!r} unknown "
                f"(choose from ['dots', 'full', 'mlp'])")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


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


def init(cfg: LlamaConfig, seed: int, device: torch.device | str, *,
         train: bool = False) -> Params:
    """Random params from `seed`: truncated normal on [-2, 2] times
    fan_in**-0.5, norms zero (identity under the (1 + w) scale) — the
    reference's recipe, from a torch.Generator on `device`, so the
    values differ from the reference's (parity tests convert the
    reference's params with `bridge.from_jax` instead). `train=True`
    keeps every leaf in `cfg.param_dtype` (the trainer's masters);
    otherwise leaves take their serving dtype (`leaf_dtype`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = param_shapes(cfg)

    def dtype_of(name):
        return cfg.param_dtype if train else leaf_dtype(cfg, name)

    def leaf(name, shape):
        if name.endswith("norm"):
            return torch.zeros(shape, dtype=dtype_of(name), device=device)
        # fan-in is the contraction axis: second-to-last for matrices,
        # the width for the embedding table
        fan_in = shape[-1] if name == "embed" else shape[-2]
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * fan_in**-0.5).to(dtype_of(name))

    params: Params = {
        "embed": leaf("embed", shapes["embed"]),
        "blocks": {n: leaf(n, s) for n, s in shapes["blocks"].items()},
        "final_norm": leaf("final_norm", shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = leaf("lm_head", shapes["lm_head"])
    return params


def layer_params(params: Params, li: int) -> Params:
    """Layer `li`'s slice of the stacked block params (views)."""
    return {k: v[li] for k, v in params["blocks"].items()}


def _block(cfg: LlamaConfig, x, p, positions, inv_freq, kv_mask,
           contiguous_positions=False):
    """One transformer block on x [b, s, D] in cfg.dtype."""
    b, s, _ = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = (h @ p["wq"].to(cfg.dtype)).reshape(b, s, cfg.num_heads,
                                            cfg.head_dim)
    k = (h @ p["wk"].to(cfg.dtype)).reshape(b, s, cfg.num_kv_heads,
                                            cfg.head_dim)
    v = (h @ p["wv"].to(cfg.dtype)).reshape(b, s, cfg.num_kv_heads,
                                            cfg.head_dim)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = dot_product_attention(q, k, v, positions, positions,
                                 causal=True, kv_mask=kv_mask,
                                 window=cfg.sliding_window,
                                 contiguous_positions=contiguous_positions)
    x = x + attn.reshape(b, s, cfg.q_dim) @ p["wo"].to(cfg.dtype)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    gate = torch.nn.functional.silu(h @ p["w_gate"].to(cfg.dtype))
    ff = gate * (h @ p["w_up"].to(cfg.dtype))
    return x + ff @ p["w_down"].to(cfg.dtype)


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
    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in layers.items()}
        args = (cfg, x, p, positions, inv_freq, kv_mask, contiguous)
        x = (checkpoint(_block, *args, use_reentrant=False) if remat
             else _block(*args))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def unembed_matrix(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    """[D, vocab] unembedding (the tied table transposed, or lm_head)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def apply(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None,
          kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Forward -> logits [b, s, vocab] in fp32."""
    x = hidden(params, cfg, tokens, positions, kv_mask)
    return x.float() @ unembed_matrix(params, cfg).float()
