"""Vision Transformer, the "ViT-B/16 fine-tune" config (counterpart:
kubeflow_tpu/models/vit.py).

Patchify is a single reshape + dense (a 16x16-stride conv is exactly a
[P*P*C, D] matmul on non-overlapping patches). Blocks are stacked on a
leading layers axis as in models/llama.py; pre-LN, learned position
embeddings, a CLS token (or a mean-pool), biases on q/k/v/o and the MLP,
the tanh-approximated GELU (`jax.nn.gelu`'s default), and an fp32 head
that is zero at init (the fine-tune recipe for fresh classes), so the
logits are 0 at init.

Attention goes through `ops.attention.dot_product_attention(...,
causal=False)` with "auto": 197 tokens at head dim 64 take the plain
path, as the reference's "auto" takes XLA below 1024 tokens; the flash
kernels take only head dims 128 and 256.

Under tensor parallelism (parallel/tensor.py) the head counts come from
the leaves (wq, wk, wv and their biases cut on whole heads, w1 and b1 on
the MLP columns, wo and w2 on their rows, the head on the classes):
`enter` after each layer norm and before the head, `exit` after wo and
w2, and the residual biases bo and b2 are added after the `exit`, once,
not inside per-rank work, where the sum would count them t times.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.norms import layer_norm
from kubeflow_tpu_torch.parallel import tensor
from kubeflow_tpu_torch.parallel.sharding import read_layer

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_classes: int = 1000
    norm_eps: float = 1e-6
    use_cls_token: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        assert self.image_size % self.patch_size == 0
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.num_channels


VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(
    image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_classes=10, dtype=torch.float32,
    remat=False,
)

CONFIGS = {"vit-b16": VIT_B16, "tiny": VIT_TINY}


def param_logical_axes(cfg: ViTConfig) -> Params:
    """Logical axis names per param leaf (the reference's tree)."""
    axes: Params = {
        "patch_embed": (None, "embed"),
        "patch_bias": ("embed",),
        "pos_embed": (None, "embed"),
        "blocks": {
            "ln1_w": ("layers", "embed"), "ln1_b": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "heads"),
            "wv": ("layers", "embed", "heads"),
            "bq": ("layers", "heads"), "bk": ("layers", "heads"),
            "bv": ("layers", "heads"),
            "wo": ("layers", "heads", "embed"), "bo": ("layers", "embed"),
            "ln2_w": ("layers", "embed"), "ln2_b": ("layers", "embed"),
            "w1": ("layers", "embed", "mlp"), "b1": ("layers", "mlp"),
            "w2": ("layers", "mlp", "embed"), "b2": ("layers", "embed"),
        },
        "final_ln_w": ("embed",), "final_ln_b": ("embed",),
        "head_w": ("embed", "vocab"), "head_b": ("vocab",),
    }
    if cfg.use_cls_token:
        axes["cls_token"] = (None, "embed")
    return axes


def init(cfg: ViTConfig, seed: int = 0,
         device: torch.device | str | None = None) -> Params:
    """Random params (the reference's law: truncated-normal [-2, 2]
    dense weights times fan_in^-0.5, normal(0.02) position embedding and
    CLS token, ones/zeros norms, zero biases and head), drawn on `device`
    (default: the card) from a generator there seeded with `seed`, as
    `llama.init` draws: the values depend on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.empty(shape, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * fan_in ** -0.5).to(pd)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * 0.02).to(pd)

    def const(shape, value):
        return torch.full(shape, value, dtype=pd, device=dev)

    L, D, M = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    params: Params = {
        "patch_embed": dense((cfg.patch_dim, D), cfg.patch_dim),
        "patch_bias": const((D,), 0.0),
        "pos_embed": normal((cfg.seq_len, D)),
        "blocks": {
            "ln1_w": const((L, D), 1.0), "ln1_b": const((L, D), 0.0),
            "wq": dense((L, D, D), D), "wk": dense((L, D, D), D),
            "wv": dense((L, D, D), D),
            "bq": const((L, D), 0.0), "bk": const((L, D), 0.0),
            "bv": const((L, D), 0.0),
            "wo": dense((L, D, D), D), "bo": const((L, D), 0.0),
            "ln2_w": const((L, D), 1.0), "ln2_b": const((L, D), 0.0),
            "w1": dense((L, D, M), D), "b1": const((L, M), 0.0),
            "w2": dense((L, M, D), M), "b2": const((L, D), 0.0),
        },
        "final_ln_w": const((D,), 1.0),
        "final_ln_b": const((D,), 0.0),
        # zero head: the standard fine-tune recipe (fresh classes)
        "head_w": const((D, cfg.num_classes), 0.0),
        "head_b": const((cfg.num_classes,), 0.0),
    }
    if cfg.use_cls_token:
        params["cls_token"] = normal((1, D))
    return params


def num_params(cfg: ViTConfig) -> int:
    L, D, M = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    per_layer = 4 * D * D + 2 * D * M + 9 * D + M
    return (cfg.patch_dim * D + D + cfg.seq_len * D + L * per_layer
            + 2 * D + D * cfg.num_classes + cfg.num_classes
            + (D if cfg.use_cls_token else 0))


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[b, H, W, C] -> [b, n_patches, P*P*C] by pure reshape/permute."""
    b, H, W, C = images.shape
    P = cfg.patch_size
    gh, gw = H // P, W // P
    x = images.reshape(b, gh, P, gw, P, C)
    x = x.permute(0, 1, 3, 2, 4, 5)              # [b, gh, gw, P, P, C]
    return x.reshape(b, gh * gw, P * P * C)


def _block(cfg: ViTConfig, x, p):
    p = read_layer(p)
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    h = tensor.enter(layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps))
    q = (h @ p["wq"].to(dt) + p["bq"].to(dt)).reshape(b, s, -1, hd)
    k = (h @ p["wk"].to(dt) + p["bk"].to(dt)).reshape(b, s, -1, hd)
    v = (h @ p["wv"].to(dt) + p["bv"].to(dt)).reshape(b, s, -1, hd)
    attn = dot_product_attention(q, k, v, pos, pos, causal=False)
    attn = attn.reshape(b, s, -1)
    x = x + tensor.exit(attn @ p["wo"].to(dt)) + p["bo"].to(dt)

    h = tensor.enter(layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.norm_eps))
    h = F.gelu(h @ p["w1"].to(dt) + p["b1"].to(dt), approximate="tanh")
    return x + tensor.exit(h @ p["w2"].to(dt)) + p["b2"].to(dt)


def apply(params: Params, cfg: ViTConfig, images: torch.Tensor
          ) -> torch.Tensor:
    """[b, H, W, C] float images -> logits [b, num_classes] fp32; under
    tensor parallelism the rank's block of the classes."""
    dt = cfg.dtype
    x = patchify(cfg, images).to(dt)
    x = x @ params["patch_embed"].to(dt) + params["patch_bias"].to(dt)
    if cfg.use_cls_token:
        cls = params["cls_token"].to(dt).expand(x.shape[0], 1,
                                                cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)

    # one unbind per leaf: its backward stacks the layers' gradients
    # once, where indexing per layer would write a full-size zero
    # gradient per layer and sum them
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    block = tensor.bind(_block)
    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in layers.items()}
        x = (checkpoint(block, cfg, x, p, use_reentrant=False) if remat
             else block(cfg, x, p))

    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"],
                   cfg.norm_eps)
    pooled = x[:, 0] if cfg.use_cls_token else x.mean(dim=1)
    return (tensor.enter(pooled.float()) @ params["head_w"].float()
            + params["head_b"].float())


def apply_fn(cfg: ViTConfig):
    """`Trainer`'s apply_fn for ViT: logits as a [b, 1, classes]
    sequence, so the trainer's next-token CE takes `[b, 1]` class
    targets (pass an explicit `[b, 1]` mask too: the default mask takes
    the images' shape)."""
    return lambda p, images: apply(p, cfg, images)[:, None, :]
