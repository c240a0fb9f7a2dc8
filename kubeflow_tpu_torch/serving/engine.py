"""Shared serving model math (counterpart: kubeflow_tpu/serving/engine.py).

`transformer_block` is the one definition of a decoder block that every
serving path runs, with the KV-cache write and the attention call
injected (`write_kv`, `attn`) and every block matmul behind `proj`.
`InferenceEngine` holds the weights and the embedding, head and
sampling steps the continuous engine builds on; the reference's
one-shot `generate` (dense cache, scan decode) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.llama import layer_params
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class Family:
    """Model-family adapter for the shared llama/gemma block schema."""

    name: str
    gate_act: Callable[[torch.Tensor], torch.Tensor]
    scale_embed: bool          # multiply embeddings by sqrt(hidden)


LLAMA_FAMILY = Family("llama", torch.nn.functional.silu, scale_embed=False)
GEMMA_FAMILY = Family(
    "gemma", lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    scale_embed=True)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_len: int = 1024        # KV cells per sequence
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # keep k highest-logit tokens; 0 = off
    top_p: float = 1.0         # nucleus: smallest set w/ cum prob >= p
    eos_token: int | None = None


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-row sampling knobs as device tensors [b], plus two host flags
    that stand in for the reference's on-device `lax.cond`s: `sampled`
    (some row has temperature > 0) and `filtered` (some row has top-k or
    top-p on). Deciding on the host keeps an all-greedy step free of a
    device-to-host sync and of the filter's full-vocab sorts."""

    temperature: torch.Tensor   # f32; <= 0 means greedy
    top_k: torch.Tensor         # int; 0 disables
    top_p: torch.Tensor         # f32; >= 1 disables
    sampled: bool
    filtered: bool

    @classmethod
    def make(cls, temperature, top_k, top_p, device) -> "SamplingParams":
        t = np.asarray(temperature, np.float32)
        k = np.asarray(top_k, np.int64)
        p = np.asarray(top_p, np.float32)
        return cls(torch.as_tensor(t, device=device),
                   torch.as_tensor(k, device=device),
                   torch.as_tensor(p, device=device),
                   sampled=bool((t > 0).any()),
                   filtered=bool(((k > 0) | (p < 1.0)).any()))

    def rows(self, idx: torch.Tensor) -> "SamplingParams":
        return SamplingParams(self.temperature[idx], self.top_k[idx],
                              self.top_p[idx], self.sampled, self.filtered)


def filter_logits(logits: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Mask logits outside the top-k set and the top-p nucleus to -inf.
    `top_k`/`top_p` broadcast against logits' leading axes ([b, 1] per
    row). HF order: k first, then p over what k kept."""
    vocab = logits.shape[-1]
    order = torch.argsort(logits, dim=-1, descending=True, stable=True)
    desc = torch.gather(logits, -1, order)
    idx = torch.arange(vocab, device=logits.device)
    keep_desc = torch.where(top_k > 0, idx < top_k, True)
    probs_desc = torch.where(keep_desc, torch.softmax(desc, dim=-1), 0.0)
    probs_desc = probs_desc / probs_desc.sum(dim=-1, keepdim=True)
    before = torch.cumsum(probs_desc, dim=-1) - probs_desc
    keep_desc = keep_desc & (before < top_p)
    keep = torch.empty_like(keep_desc).scatter_(-1, order, keep_desc)
    return torch.where(keep, logits, -torch.inf)


def scaled_filtered_logits(logits: torch.Tensor,
                           sp: SamplingParams) -> torch.Tensor:
    """Temperature-scale then top-k/top-p filter: the one definition of
    the sampled distribution's logits."""
    scaled = logits.float() / torch.clamp(sp.temperature[:, None], min=1e-6)
    if not sp.filtered:
        return scaled
    return filter_logits(scaled, sp.top_k[:, None], sp.top_p[:, None])


def transformer_block(cfg, fam: Family, p, x, rope_positions, inv_freq,
                      write_kv, attn, proj=None):
    """One decoder block on x [b, s, h]: norms, QKV/output projections,
    rotary, gated MLP. `write_kv(k, v) -> (k_cache, v_cache)` and
    `attn(q, k_cache, v_cache) -> out` are the cache policy and the
    attention call; `proj(name, h, w)` wraps every block matmul."""
    if proj is None:
        def proj(name, h, w):
            return h @ w.to(cfg.dtype)

    b, s = x.shape[:2]
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = proj("wq", h, p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = proj("wk", h, p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = proj("wv", h, p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, rope_positions, inv_freq)
    k = apply_rope(k, rope_positions, inv_freq)
    k_cache, v_cache = write_kv(k, v)
    out = attn(q, k_cache, v_cache)
    x = x + proj("wo", out.reshape(b, s, cfg.q_dim), p["wo"])
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    gate = fam.gate_act(proj("w_gate", h, p["w_gate"]))
    ff = gate * proj("w_up", h, p["w_up"])
    x = x + proj("w_down", ff, p["w_down"])
    return x, (k_cache, v_cache)


class InferenceEngine:
    """Weights + model family + engine config on one device, with the
    embedding, head and sampling steps of the serving paths.

    `device=None` is the CUDA card (raises when there is none); the CPU
    tests pass `device="cpu"`. `params` must already live there
    (`models.llama.init` or `bridge.from_jax`)."""

    def __init__(self, params, cfg, family: Family,
                 engine_config: EngineConfig = EngineConfig(),
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.family = family
        self.ec = engine_config
        self.layers = [layer_params(params, li)
                       for li in range(cfg.num_layers)]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed_lookup(self.params["embed"], tokens, cfg.dtype)
        if self.family.scale_embed:
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, as the reference (engine.py:279-282)."""
        head = self.params.get("lm_head")
        if head is None:
            head = self.params["embed"].T
        return x.float() @ head.float()

    def _sample(self, logits: torch.Tensor, gen: torch.Generator,
                sp: SamplingParams):
        """-> (tokens [b] int32, logprobs [b] f32). The logprob is the
        chosen token's log-softmax under the RAW model distribution
        (temperature and filters do not rescale it). Greedy is the
        argmax of the fp32 logits; sampled rows draw from `gen`, so
        their tokens cannot match the reference's RNG."""
        tok = torch.argmax(logits, dim=-1)
        if sp.sampled:
            probs = torch.softmax(scaled_filtered_logits(logits, sp), -1)
            drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
            tok = torch.where(sp.temperature > 0.0, drawn, tok)
        raw = torch.log_softmax(logits.float(), dim=-1)
        lp = torch.gather(raw, -1, tok[:, None])[:, 0]
        return tok.to(torch.int32), lp

    def rms_final(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.params["final_norm"], self.cfg.norm_eps)
