"""Gemma family forward, for serving and training (counterpart:
kubeflow_tpu/models/gemma.py).

The same stacked-layers layout as models/llama.py (`params["blocks"]
["wq"]` is `[L, D, n_q * hd]`), with the Gemma differences kept
explicit, as the reference keeps them:
  - the head is ALWAYS the tied embedding (no `lm_head`), in fp32;
  - embeddings are scaled by sqrt(hidden), that constant rounded to the
    activation dtype first (45.25 at bf16 for hidden 2048, not 45.2548);
  - GeGLU MLP: gelu(gate, tanh approximation) * up;
  - norms are initialised to zero under the (1 + w) scale;
  - rope theta 10000, norm eps 1e-6;
  - `q_dim` (num_heads * head_dim) may differ from `hidden_size`
    (gemma-2b: 8 x 256 = 2048 at hidden 2048; other shapes differ).

Storage dtypes follow llama's serving rule (`leaf_dtype`, imported from
it): block matrices in the activation dtype (the reference casts them
to it at every use), the embedding and norms in fp32. `init(...,
train=True)` keeps every leaf in `param_dtype` instead (the trainer's
fp32 masters), and with gradients on `apply` runs each block under
`torch.utils.checkpoint` when `remat` is set, the reference's
`jax.checkpoint` of the whole block. The trainer takes it as the
reference's does: `Trainer(apply_fn=lambda p, t: gemma.apply(p, cfg,
t))`, dense cross entropy over the tied head's logits.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

# the serving storage rule (block matrices in the activation dtype, every
# other leaf fp32) and the random-init recipe are llama's
from kubeflow_tpu_torch.models.llama import (  # noqa: F401
    MATRICES,
    Params,
    leaf_dtype,
    random_params,
)
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rope, rope_frequencies
from kubeflow_tpu_torch.parallel import tensor
from kubeflow_tpu_torch.parallel.sharding import read_layer


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256128
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_layers: int = 18
    num_heads: int = 8
    num_kv_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16   # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # Sliding-window attention, model-wide as in llama.LlamaConfig.
    sliding_window: int | None = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


GEMMA_2B = GemmaConfig()
GEMMA_TINY = GemmaConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, num_kv_heads=1, head_dim=32, dtype=torch.float32,
    remat=False,
)

CONFIGS = {"gemma-2b": GEMMA_2B, "tiny": GEMMA_TINY}


def param_logical_axes(cfg: GemmaConfig) -> Params:
    """Logical axis names per param leaf (the reference's tree)."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
    }


def param_shapes(cfg: GemmaConfig) -> Params:
    L, D, M = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    return {
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


def init(cfg: GemmaConfig, seed: int, device: torch.device | str, *,
         train: bool = False,
         store: torch.device | str | None = None) -> Params:
    """Random params from `seed` (llama's `random_params`: the
    reference's recipe, not its values; parity tests convert the
    reference's params with `bridge.from_jax` instead). `train=True`
    keeps every leaf in `cfg.param_dtype` (the trainer's masters);
    otherwise leaves take their serving dtype (`leaf_dtype`). `store`:
    where the leaves drawn on `device` live."""

    def dtype_of(name):
        return cfg.param_dtype if train else leaf_dtype(cfg, name)

    return random_params(param_shapes(cfg), dtype_of, seed, device, store)


def embed_scale(cfg: GemmaConfig) -> torch.Tensor:
    """sqrt(hidden) rounded to the activation dtype, as the reference
    multiplies by it (45.25 at bf16 for hidden 2048)."""
    return torch.tensor(cfg.hidden_size**0.5, dtype=cfg.dtype)


def _block(cfg: GemmaConfig, x, p, positions, inv_freq, kv_mask,
           contiguous_positions=False):
    """One Gemma block on x [b, s, D] in cfg.dtype."""
    p = read_layer(p)
    b, s, _ = x.shape
    hd = cfg.head_dim
    # head counts from the leaves: the rank's under tensor parallelism
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
    x = x + tensor.exit(attn.reshape(b, s, -1) @ p["wo"].to(cfg.dtype))
    h = tensor.enter(rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    # GeGLU: gelu(gate) * up, the Gemma MLP
    gate = torch.nn.functional.gelu(h @ p["w_gate"].to(cfg.dtype),
                                    approximate="tanh")
    ff = gate * (h @ p["w_up"].to(cfg.dtype))
    return x + tensor.exit(ff @ p["w_down"].to(cfg.dtype))


def apply(params: Params, cfg: GemmaConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None,
          kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Forward -> logits [b, s, vocab] in fp32, through the tied head;
    under tensor parallelism the rank's vocab block of them (its block
    of the table transposed), the lookup summed over the blocks before
    the embedding scale."""
    b, s = tokens.shape
    contiguous = positions is None  # safe for the index-masked kernels
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    inv_freq = rope_frequencies(cfg.head_dim, theta=cfg.rope_theta,
                                device=tokens.device)
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    x = x * embed_scale(cfg)
    # one unbind per leaf, as llama.hidden: its backward stacks the
    # layers' gradients once
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    block = tensor.bind(_block)
    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in layers.items()}
        args = (cfg, x, p, positions, inv_freq, kv_mask, contiguous)
        x = (checkpoint(block, *args, use_reentrant=False) if remat
             else block(*args))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tensor.enter(x.float()) @ params["embed"].T.float()
