"""Serving model math and one-shot generation on a dense KV cache
(counterpart: kubeflow_tpu/serving/engine.py).

`transformer_block` is the one definition of a decoder block that every
serving path runs, with the KV-cache write and the attention call
injected (`write_kv`, `attn`) and the block matmuls behind `proj`, which
takes the products that read one h together (wq, wk, wv; w_gate, w_up;
wo; w_down): `quant.qdot_many` by default (plain weights' products, or
int8 `QTensor`s' in one `int8_proj` launch a group: four a layer),
`multilora.lora_proj` for rows that carry adapter ids. A family's `mlp`
replaces the FFN half: `MOE_LLAMA_FAMILY` routes it through the
experts (parallel/moe.py) at a capacity where nothing drops, while the
attention products stay behind `proj`: an adapter pack that targets
wq/wk/wv/wo serves there, one that targets the dense MLP is refused,
and int8 expert stacks are dequantized whole each step (`QTensor.to`,
the reference's `.astype`).
`InferenceEngine` holds the weights, the embedding, head and sampling
steps the continuous engine builds on, and the reference's one-shot
entry points: `generate`, `generate_stream`, `prefill_chunked`, `score`
and `precompute_prefix`.

The one-shot paths keep a dense cache `[L, b, max_len, n_kv, hd]`
(`DecodeState`) written IN PLACE: each forward assigns its s new rows
per layer at the shared cursor, and nothing copies the cache. Where the
reference scans its decode steps inside one compiled program, this
engine captures one decode step as a CUDA graph per batch size and
sampling key (serving/graphs.py) and replays it `length` times, with EOS
forcing on the device and no host read in between. The graph needs
fixed addresses, so the engine owns one cache per batch size (a
`_Lane`) and the step advances a device cursor; the host int
`DecodeState.length` stays the cursor of prefill, scoring and the
speculative engine, which run eagerly. Every decode step's attention
(one token per row, against the whole cache, with the left-pad mask)
goes through `ops.attention.dot_product_attention`'s "auto" rule, which
takes the dense decode kernel (ops/cuda/decode_attention.py) for CUDA
tensors.

With an `adapter_pack` (serving/multilora.py), `generate(adapter=...)`,
`prefill_chunked` and `score` take one adapter name for the batch or one
a row; the lane's decode graph then reads the pack and the lane's static
`aid` ids, and is keyed apart from the plain step.

Tensor parallelism (`group=`, an `AxisGroup` of the "tensor" axis of
size t > 1): the engine holds one rank's params (`bridge.
tensor_rank_params`: its query heads, its K/V heads or the one head
they share, its MLP columns and rows, its vocab block of the embedding
and the head) and runs its forward inside `tensor.parallel(group)`:
`transformer_block` reshapes to the rank's head counts, sums the wo and
w_down products over the ranks (`tensor.exit`, fp32, rounded once), the
embedding is the vocab-parallel lookup and the head's vocab-local
logits are gathered (`tensor.gather_vocab`), so sampling, filtering,
logprobs and EOS forcing see the whole vocabulary on every rank. The
dense cache holds the rank's KV heads. Every rank of the group must run
the same calls in the same order: serving/gang.py steps them. Refused
at t > 1, each naming the ROADMAP item that will port it:
`cuda_graphs=True` (a gloo collective stages through host memory, which
a graph cannot capture: every step runs eagerly), `warmup`, an adapter
pack, int8 `QTensor` weights and the MoE family.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.llama import layer_params
from kubeflow_tpu_torch.models.llama_moe import MOE_LEAVES
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rope, rope_frequencies
from kubeflow_tpu_torch.parallel import tensor
from kubeflow_tpu_torch.parallel.moe import moe_mlp
from kubeflow_tpu_torch.serving.graphs import GraphCache, upload
from kubeflow_tpu_torch.serving.multilora import lora_proj
from kubeflow_tpu_torch.serving.quant import QTensor, qdot_many


@dataclasses.dataclass(frozen=True)
class Family:
    """Model-family adapter for the shared llama/gemma block schema.

    `mlp` overrides the block's FFN half entirely (signature `(cfg,
    layer_params, normed_h) -> delta`): the MoE family routes through
    experts there while the attention half, the KV caches and sampling
    stay shared."""

    name: str
    gate_act: Callable[[torch.Tensor], torch.Tensor]
    scale_embed: bool          # multiply embeddings by sqrt(hidden)
    mlp: Callable[..., torch.Tensor] | None = None


LLAMA_FAMILY = Family("llama", torch.nn.functional.silu, scale_embed=False)
GEMMA_FAMILY = Family(
    "gemma", lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    scale_embed=True)


def _moe_serving_mlp(cfg, p, h: torch.Tensor) -> torch.Tensor:
    """Dropless MoE FFN for serving (models/llama_moe.py's block schema:
    router [D, E] and per-expert SwiGLU stacks [E, D, M]). Training's
    capacity factor trades dropped choices for load balance; serving
    must never drop: capacity_factor E / k makes the capacity the token
    count T, and a token takes at most one slot of an expert, so every
    choice fits and a row's output does not depend on its batch-mates
    (pads, retired and frozen rows included)."""
    mcfg = dataclasses.replace(
        cfg.moe_config(), capacity_factor=cfg.num_experts / cfg.top_k)
    params = {k: p[k].to(cfg.dtype) for k in MOE_LEAVES}
    y, _aux = moe_mlp(params, h, mcfg)
    return y


# the LoRA targets a family with its own FFN (`Family.mlp`) lacks
DENSE_MLP_TARGETS = ("w_gate", "w_up", "w_down")

MOE_LLAMA_FAMILY = Family("llama-moe", torch.nn.functional.silu,
                          scale_embed=False, mlp=_moe_serving_mlp)


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
        device = torch.device(device)
        return cls(upload(t, torch.float32, device),
                   upload(k, torch.int64, device),
                   upload(p, torch.float32, device),
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


def race_draw(probs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One token per row of [..., vocab] probabilities by the exponential
    race, argmax(p / E) with E ~ Exp(1) from `gen`: token i wins with
    probability p_i (the law of torch.multinomial's one sample), a
    zero-probability token never wins and a one-hot row draws its token.
    Nothing is read back to the host, so a CUDA graph holds the draw."""
    race = torch.empty_like(probs).exponential_(generator=gen)
    race.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(probs / race, dim=-1)


def scaled_filtered_logits(logits: torch.Tensor,
                           sp: SamplingParams) -> torch.Tensor:
    """Temperature-scale then top-k/top-p filter: the one definition of
    the sampled distribution's logits."""
    scaled = logits.float() / torch.clamp(sp.temperature[:, None], min=1e-6)
    if not sp.filtered:
        return scaled
    return filter_logits(scaled, sp.top_k[:, None], sp.top_p[:, None])


def sampling_dist(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """[n, vocab] logits -> the sampling distribution under sp (its
    knobs broadcast over the n rows). Greedy is the temperature->0
    limit, a one-hot on the argmax, so one accept/reject rule serves
    greedy and sampled decoding: for one-hots the ratio test is exact
    token match."""
    greedy = torch.nn.functional.one_hot(
        torch.argmax(logits, -1), logits.shape[-1]).float()
    if not sp.sampled:
        return greedy
    probs = torch.softmax(scaled_filtered_logits(logits, sp), -1)
    return torch.where(sp.temperature[:, None] > 0.0, probs, greedy)


class DecodeState:
    """Dense KV cache + cursor of the one-shot paths.

    `k`/`v` [L, b, max_len, n_kv, hd] are written in place by
    `InferenceEngine._forward_cached`; `length` is the number of filled
    cells, shared by every row (a host int). `pad` [b, max_len] marks
    cells holding left-pad keys (excluded from attention); `offset` [b]
    is each row's pad count, so a token in cell i has LOGICAL position
    i - offset (what rope sees)."""

    def __init__(self, k, v, length: int, pad=None, offset=None):
        self.k = k
        self.v = v
        self.length = int(length)
        if pad is None:
            pad = torch.zeros((k.shape[1], k.shape[2]), dtype=torch.bool,
                              device=k.device)
        if offset is None:
            offset = torch.zeros((k.shape[1],), dtype=torch.int32,
                                 device=k.device)
        self.pad = pad
        self.offset = offset


# (sampled, filtered) host flags of a step: each pair runs other ops, so
# each has its graph; filtering without sampling draws nothing
SAMPLING_KEYS = ((False, False), (True, False), (True, True))


def pack_layers(pack) -> list | None:
    """An adapter pack's per-layer views (None without a pack)."""
    if pack is None:
        return None
    n = next(iter(pack.blocks.values()))["A"].shape[0]
    return [pack.layer(li) for li in range(n)]


class _Lane:
    """One batch size's dense cache and the static tensors its decode
    graph reads and writes: each row's cursor (a device [b] int32, so a
    step depends on no host value), last token, EOS flag and sampling
    knobs; a step counter; and the history of tokens and logprobs the
    steps log at it. The engine owns one lane per batch size, so the
    graph's tensor addresses never change; prefill writes cells [0, n)
    and the pad mask covers the rest."""

    def __init__(self, eng: "InferenceEngine", b: int):
        dev, max_len = eng.device, eng.ec.max_len

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        st = eng.init_state(b)
        self.b = b
        self.k, self.v, self.pad, self.offset = st.k, st.v, st.pad, st.offset
        self.rows = torch.arange(b, device=dev)
        self.cursor, self.tok = zeros(b), zeros(b)
        self.done = zeros(b, dtype=torch.bool)
        self.temperature = zeros(b, dtype=torch.float32)
        self.top_k = zeros(b, dtype=torch.int64)
        self.top_p = torch.ones(b, dtype=torch.float32, device=dev)
        self.aid = zeros(b, dtype=torch.int64)    # adapter id per row
        self.step = zeros(1, dtype=torch.int64)
        self.toks = zeros(b, max_len)
        self.lps = zeros(b, max_len, dtype=torch.float32)
        self.gen = torch.Generator(device=dev)
        self.graphs = GraphCache(dev, eager=not eng.cuda_graphs)
        self.busy = False

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.k, self.v, self.pad, self.toks, self.lps))


def transformer_block(cfg, fam: Family, p, x, rope_positions, inv_freq,
                      write_kv, attn, proj=None):
    """One decoder block on x [b, s, h]: norms, QKV/output projections,
    rotary, gated MLP (or the family's `mlp`). `write_kv(k, v) ->
    (k_cache, v_cache)` and `attn(q, k_cache, v_cache) -> out` are the
    cache policy and the
    attention call; `proj(names, h, ws)` computes the block matmuls that
    read one h, in order (default `qdot_many`: plain weights' products,
    or int8 QTensors' in one launch).

    Head counts come from the leaves: under tensor parallelism (inside
    `tensor.parallel`) they are the rank's, K/V read through
    `tensor.kv_columns`, and the wo and w_down products are partial sums
    that `tensor.exit` sums over the ranks, where models/llama.py's
    `_attention_half` and `_block` place them. Serving has no backward,
    so there is no `tensor.enter` after the norms."""
    if proj is None:
        def proj(names, h, ws):
            return qdot_many(h, ws, cfg.dtype)

    b, s = x.shape[:2]
    hd = cfg.head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    wk, wv = (tensor.kv_columns(p[n], cfg.num_kv_heads, hd)
              for n in ("wk", "wv"))
    q, k, v = proj(("wq", "wk", "wv"), h, (p["wq"], wk, wv))
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    q = apply_rope(q, rope_positions, inv_freq)
    k = apply_rope(k, rope_positions, inv_freq)
    k_cache, v_cache = write_kv(k, v)
    out = attn(q, k_cache, v_cache)
    (o,) = proj(("wo",), out.reshape(b, s, -1), (p["wo"],))
    x = x + tensor.exit(o)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if fam.mlp is not None:
        return x + fam.mlp(cfg, p, h), (k_cache, v_cache)
    gate, up = proj(("w_gate", "w_up"), h, (p["w_gate"], p["w_up"]))
    ff = fam.gate_act(gate) * up
    (down,) = proj(("w_down",), ff, (p["w_down"],))
    x = x + tensor.exit(down)
    return x, (k_cache, v_cache)


def refuse_graphs_at_tensor(cuda_graphs: bool) -> None:
    """The one graph policy of tensor-parallel serving: CUDA graphs are
    refused at tensor > 1 (the engines' `cuda_graphs=True`)."""
    if cuda_graphs:
        raise ValueError(
            "cuda_graphs=True at tensor > 1: a gloo collective stages "
            "through host memory, which a CUDA graph cannot capture; pass "
            "cuda_graphs=False (every step then runs eagerly; NCCL gangs "
            "across cards with graph capture: ROADMAP Queue 1 item 3k)")


def refuse_tensor_weights(params, cfg, size: int) -> bool:
    """The refusals of serving weights at tensor `size` > 1, for the full
    tree (`bridge.tensor_rank_params`) and a rank's cut (the engine): the
    MoE family's, int8 `QTensor` leaves, and a vocab or head count the
    axis does not divide. -> whether the KV heads are held whole."""
    if "router" in params["blocks"]:
        raise ValueError("tensor-parallel serving of the MoE family is not "
                         "ported yet (ROADMAP Queue 1 item 3d)")
    if any(isinstance(v, QTensor) for v in params["blocks"].values()):
        raise ValueError("int8 QTensor weights are not cut for tensor-"
                         "parallel serving yet (ROADMAP Queue 1 item 3e)")
    tensor.vocab_divides(cfg.vocab_size, size)
    return tensor.kv_held_whole(cfg.num_heads, cfg.num_kv_heads, size)


def _tensor_serving(params, cfg, size: int, cuda_graphs: bool,
                    adapter_pack) -> int:
    """The refusals of a tensor-parallel engine of `size` ranks and a
    check that `params` are a rank's cut. -> the rank's KV heads (one
    where they are held whole)."""
    refuse_graphs_at_tensor(cuda_graphs)
    if adapter_pack is not None:
        raise ValueError("adapter packs at tensor > 1 are not ported yet "
                         "(ROADMAP Queue 1 item 3f)")
    whole = refuse_tensor_weights(params, cfg, size)
    want = cfg.num_heads // size * cfg.head_dim
    got = params["blocks"]["wq"].shape[-1]
    if got != want:
        raise ValueError(f"wq has {got} columns, a rank's cut at "
                         f"tensor={size} has {want}: pass the rank's params "
                         "(bridge.tensor_rank_params)")
    return 1 if whole else cfg.num_kv_heads // size


class InferenceEngine:
    """Weights + model family + engine config on one device, with the
    embedding, head and sampling steps of the serving paths.

    `device=None` is the CUDA card (raises when there is none); the CPU
    tests pass `device="cpu"`. `params` must already live there
    (`models.llama.init`, `models.gemma.init` or `bridge.from_jax`).
    `cuda_graphs=False` launches the decode step's ops one by one on the
    card instead of replaying its graph: an explicit control, never a
    fallback. `adapter_pack` (`multilora.build_pack`, on the engine's
    device) makes K fine-tunes resident over these weights; a request
    names one per row (`generate(adapter=...)`).

    `group` (an `AxisGroup` of the "tensor" axis, or None): the engine
    is one rank of a tensor-parallel replica (the module docstring),
    `params` that rank's cut; `gang` is set on the rank that leads the
    replica's gang (serving/gang.py)."""

    def __init__(self, params, cfg, family: Family,
                 engine_config: EngineConfig = EngineConfig(),
                 device: torch.device | str | None = None, *,
                 cuda_graphs: bool = True, adapter_pack=None,
                 group=None):
        self.device = resolve_device(device)
        self.group = group if group is not None and group.size > 1 else None
        self.gang = None
        # the rank's KV heads: the cache and the pool hold these
        self.kv_heads = cfg.num_kv_heads
        if self.group is not None:
            self.kv_heads = _tensor_serving(params, cfg, self.group.size,
                                            cuda_graphs, adapter_pack)
        self.cuda_graphs = cuda_graphs
        self._lanes: dict[int, _Lane] = {}
        self._retired = [0, 0]   # captures, replays of private lanes
        # generate calls and streams may run on several threads
        self._lane_lock = threading.Lock()
        self.params = params
        self.cfg = cfg
        self.family = family
        self.ec = engine_config
        self.layers = [layer_params(params, li)
                       for li in range(cfg.num_layers)]
        mlp_targets = sorted(set(getattr(adapter_pack, "blocks", ()))
                             & set(DENSE_MLP_TARGETS))
        if family.mlp is not None and mlp_targets:
            # a family with its own FFN has no dense w_gate / w_up /
            # w_down to adapt (the reference fails in build_pack there:
            # its config has no intermediate_size); attention-only packs
            # ride the shared attention half
            raise ValueError(
                f"adapter packs that target {mlp_targets} are refused for "
                f"the {family.name} family: its FFN is routed experts, "
                f"not the dense w_gate/w_up/w_down; target wq/wk/wv/wo")
        self.adapter_pack = adapter_pack
        self._pack_layers = pack_layers(adapter_pack)
        self._inv_freq = rope_frequencies(cfg.head_dim, theta=cfg.rope_theta,
                                          device=self.device)
        self._cells = torch.arange(engine_config.max_len, dtype=torch.int32,
                                   device=self.device)

    def parallel(self):
        """The context the forward runs in: tensor-parallel over the
        engine's group (a no-op on one device)."""
        return tensor.parallel(self.group)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The (vocab-parallel, under the group) lookup; gemma's
        sqrt(hidden) scale after the ranks' sum."""
        cfg = self.cfg
        with self.parallel():
            x = embed_lookup(self.params["embed"], tokens, cfg.dtype)
        if self.family.scale_embed:
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, as the reference (engine.py:279-282): under the
        group, the rank's vocab block of the head (the tied embedding's
        transpose for gemma), then the blocks gathered."""
        head = self.params.get("lm_head")
        if head is None:
            head = self.params["embed"].T
        with self.parallel():
            return tensor.gather_vocab(x.float() @ head.float())

    def _sample(self, logits: torch.Tensor, gen: torch.Generator,
                sp: SamplingParams):
        """-> (tokens [b] int32, logprobs [b] f32). The logprob is the
        chosen token's log-softmax under the RAW model distribution
        (temperature and filters do not rescale it). Greedy is the
        argmax of the fp32 logits; sampled rows draw from `gen`, so
        their tokens cannot match the reference's RNG. The draw is the
        exponential race, argmax(p / E) with E ~ Exp(1) from `gen`,
        which picks token i with probability p_i (what torch.multinomial
        does for one sample) and reads nothing back to the host, so a
        CUDA graph holds it."""
        tok = torch.argmax(logits, dim=-1)
        if sp.sampled:
            probs = torch.softmax(scaled_filtered_logits(logits, sp), -1)
            drawn = race_draw(probs, gen)
            tok = torch.where(sp.temperature > 0.0, drawn, tok)
        raw = torch.log_softmax(logits.float(), dim=-1)
        lp = torch.gather(raw, -1, tok[:, None])[:, 0]
        return tok.to(torch.int32), lp

    def rms_final(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.params["final_norm"], self.cfg.norm_eps)

    # -- dense-cache forward -----------------------------------------------

    def layer_proj(self, li: int, aid: torch.Tensor | None):
        """Layer li's `proj` hook: `lora_proj` over the pack's layer view
        for rows with adapter ids `aid` [b], else None (`qdot`)."""
        if aid is None:
            return None
        if self.adapter_pack is None:
            raise ValueError("no adapter_pack loaded on this engine")
        return lora_proj(self._pack_layers[li], aid,
                         self.adapter_pack.scaling, self.cfg)

    def adapter_ids(self, adapter, batch: int) -> torch.Tensor | None:
        """`adapter` (one name for the batch, a list of one a row, or
        None) -> [batch] int64 ids on the device, or None. Raises as the
        reference does: no pack, a wrong count, an unknown name."""
        if adapter is None:
            return None
        if self.adapter_pack is None:
            raise ValueError("no adapter_pack loaded on this engine")
        names = ([adapter] * batch if isinstance(adapter, str)
                 else list(adapter))
        if len(names) != batch:
            raise ValueError(f"{len(names)} adapter names for a batch of "
                             f"{batch}")
        return upload([self.adapter_pack.resolve(n) for n in names],
                      torch.int64, self.device)

    def _stack(self, tokens, positions, rope_positions, kv_valid, write,
               aid=None):
        """The decoder stack over a dense cache: tokens [b, s] at cache
        cells `positions` [b, s]; `write(li, k, v) -> (k_cache, v_cache)`
        puts layer li's new K/V in place; `aid` [b] adapter ids or None.
        -> final-normed x [b, s, h]."""
        cfg, fam, ec = self.cfg, self.family, self.ec
        kv_positions = self._cells.expand(tokens.shape[0], ec.max_len)

        def attn(q, kc, vc):
            # this cache's cell index IS the token position: the
            # declaration the decode kernel dispatches on
            return dot_product_attention(
                q, kc, vc, positions, kv_positions, causal=True,
                kv_mask=kv_valid, window=cfg.sliding_window,
                contiguous_positions=True)

        x = self._embed(tokens)
        with self.parallel():
            for li, p in enumerate(self.layers):
                x, _ = transformer_block(
                    cfg, fam, p, x, rope_positions, self._inv_freq,
                    lambda k, v, li=li: write(li, k, v), attn,
                    self.layer_proj(li, aid))
        return self.rms_final(x)

    def _forward_cached(self, tokens: torch.Tensor, state: DecodeState, *,
                        prompt_mask: torch.Tensor | None = None,
                        return_all: bool = False, aid=None):
        """Run tokens [b, s] from cell `state.length`; returns (last
        position's logits [b, vocab] fp32, or every position's [b, s,
        vocab] with `return_all`, and the advanced state). The s new K/V
        rows are written into `state.k`/`state.v` in place, so the
        returned state shares the cache with `state`.

        `prompt_mask` [b, s] bool (False = pad) batches variable-length
        rows; pads are LEFT-aligned, excluded from every later
        attention, and rope sees logical positions (cell - pad count), so
        a padded row computes what its unpadded prompt would. `aid` [b]:
        each row's adapter id (None: no adapter pass)."""
        b, s = tokens.shape
        start = state.length
        if start + s > self.ec.max_len:
            raise ValueError(f"cells {start} + {s} exceed the cache bucket "
                             f"{self.ec.max_len}")
        positions = (start + torch.arange(
            s, dtype=torch.int32, device=self.device)).expand(b, s)
        pad, offset = state.pad, state.offset
        if prompt_mask is not None:
            offset = offset + (~prompt_mask).sum(1, dtype=torch.int32)
            pad = pad.clone()
            pad[:, start:start + s] = ~prompt_mask
        rope_positions = torch.clamp(positions - offset[:, None], min=0)
        kv_valid = (self._cells < start + s)[None, :] & ~pad

        def write(li, k, v):
            kc, vc = state.k[li], state.v[li]
            kc[:, start:start + s] = k.to(kc.dtype)
            vc[:, start:start + s] = v.to(vc.dtype)
            return kc, vc

        x = self._stack(tokens, positions, rope_positions, kv_valid, write,
                        aid)
        logits = self._head(x if return_all else x[:, -1])
        return logits, DecodeState(state.k, state.v, start + s, pad, offset)

    def init_state(self, batch: int) -> DecodeState:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, self.ec.max_len, self.kv_heads,
                 cfg.head_dim)
        return DecodeState(
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.dtype, device=self.device), 0)

    def kv_cache_bytes(self, batch: int, cells: int | None = None) -> int:
        """KV-cache bytes for `batch` rows of `cells` cache cells (K+V,
        all layers; defaults to max_len, what the dense cache holds): a
        rank's, under tensor parallelism."""
        cfg = self.cfg
        if cells is None:
            cells = self.ec.max_len
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        return (2 * cfg.num_layers * batch * cells
                * self.kv_heads * cfg.head_dim * itemsize)

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        """A tensor, numpy array or nested list as `dtype` on the
        engine's device (host data through pinned memory)."""
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.to(device=self.device, dtype=dtype)
        return upload(x, dtype, self.device)

    # -- decode lanes -------------------------------------------------------

    def _acquire(self, b: int) -> "_Lane":
        """Batch size b's lane: the engine's own, or a private one while
        the own lane is held (a stream in progress)."""
        with self._lane_lock:
            lane = self._lanes.get(b)
            if lane is None:
                lane = self._lanes[b] = _Lane(self, b)
            elif lane.busy:
                lane = _Lane(self, b)
            lane.busy = True
        return lane

    def _release(self, lane: "_Lane") -> None:
        with self._lane_lock:
            lane.busy = False
            if self._lanes.get(lane.b) is not lane:   # a private lane
                self._retired[0] += lane.graphs.captures
                self._retired[1] += lane.graphs.replays

    @property
    def captures(self) -> int:
        """Decode graphs captured (on the CPU: step bodies built)."""
        return self._retired[0] + sum(
            lane.graphs.captures for lane in self._lanes.values())

    @property
    def replays(self) -> int:
        return self._retired[1] + sum(
            lane.graphs.replays for lane in self._lanes.values())

    def lane_bytes(self) -> int:
        """Device bytes of the engine's own lanes (caches + history)."""
        return sum(lane.nbytes() for lane in self._lanes.values())

    def _step_at_cursor(self, lane: "_Lane", lora: bool) -> torch.Tensor:
        """One token per row from the lane's device cursor: the s = 1
        case of `_forward_cached` with the cursor a [b] tensor, so that
        nothing about the step depends on a host value. -> logits."""
        positions = lane.cursor[:, None]
        rope_positions = torch.clamp(positions - lane.offset[:, None],
                                     min=0)
        kv_valid = (self._cells[None, :] <= positions) & ~lane.pad
        at = lane.cursor.long()

        def write(li, k, v):
            kc, vc = lane.k[li], lane.v[li]
            kc[lane.rows, at] = k[:, 0].to(kc.dtype)
            vc[lane.rows, at] = v[:, 0].to(vc.dtype)
            return kc, vc

        x = self._stack(lane.tok[:, None], positions, rope_positions,
                        kv_valid, write, lane.aid if lora else None)
        return self._head(x[:, -1])

    def _lane_step(self, lane: "_Lane", sp: SamplingParams,
                   lora: bool = False) -> torch.Tensor:
        """The one-shot decode step, the body the card captures: sample
        from the lane's cursor, force EOS on finished rows, log the token
        and its logprob at the step counter, advance. Reads and writes
        only the lane's static tensors and generator (and, with `lora`,
        the adapter pack and the lane's `aid`)."""
        nxt, lp = self._sample(self._step_at_cursor(lane, lora), lane.gen,
                               sp)
        eos = self.ec.eos_token
        if eos is not None:
            nxt = torch.where(lane.done, torch.full_like(nxt, eos), nxt)
            lane.done |= nxt == eos
        lane.toks.index_copy_(1, lane.step, nxt[:, None])
        lane.lps.index_copy_(1, lane.step, lp[:, None])
        lane.tok.copy_(nxt)
        lane.cursor += 1
        lane.step += 1
        return nxt

    def _load(self, lane: "_Lane", state: DecodeState, first, done,
              sp: SamplingParams, aid=None) -> None:
        """Point the lane at a prefilled state (its cache is the lane's),
        the first sampled token and the rows' adapter ids."""
        lane.pad.copy_(state.pad)
        lane.offset.copy_(state.offset)
        lane.cursor.fill_(state.length)
        lane.tok.copy_(first)
        lane.done.copy_(done)
        lane.temperature.copy_(sp.temperature)
        lane.top_k.copy_(sp.top_k)
        lane.top_p.copy_(sp.top_p)
        if aid is not None:
            lane.aid.copy_(aid)
        lane.step.zero_()

    def _replay(self, lane: "_Lane", gen: torch.Generator, sampled: bool,
                filtered: bool, n: int, lora: bool = False) -> None:
        """n decode steps on the lane: n replays of the step graph of its
        sampling key (and `lora`: the adapter step), no host read in
        between. `gen` is the caller's generator; the lane's own (the one
        its graphs hold) takes its state before and gives it back
        after."""
        key = (sampled, sampled and filtered)
        sp = SamplingParams(lane.temperature, lane.top_k, lane.top_p, *key)
        run = lane.graphs.runner(
            key + (("lora",) if lora else ()),
            lambda: self._lane_step(lane, sp, lora), generator=lane.gen)
        lane.gen.set_state(gen.get_state())
        for _ in range(n):
            run()
        gen.set_state(lane.gen.get_state())

    @torch.inference_mode()
    def warmup(self, batch_sizes=(1,)) -> int:
        """Capture the decode step of every sampling key for each batch
        size ahead of traffic (the window batcher's rows are powers of
        two up to its max_batch); a batch size left out captures on first
        use; with an adapter pack each key's adapter step too. Returns the
        number of graphs warmed. Refused at tensor > 1, where nothing is
        captured."""
        if self.group is not None:
            raise ValueError(
                "warmup captures CUDA graphs, which tensor-parallel serving "
                "refuses (host-staged gloo collectives; NCCL gangs with "
                "graph capture: ROADMAP Queue 1 item 3k)")
        gen = torch.Generator(device=self.device).manual_seed(0)
        loras = (False, True) if self.adapter_pack is not None else (False,)
        n = 0
        for b in batch_sizes:
            lane = self._acquire(b)
            try:
                for (sampled, filtered), lora in (
                        (k, lo) for k in SAMPLING_KEYS for lo in loras):
                    lane.cursor.zero_()   # a throwaway step at cell 0
                    lane.step.zero_()
                    self._replay(lane, gen, sampled, filtered, 1, lora)
                    n += 1
            finally:
                self._release(lane)
        return n

    # -- sampling setup ----------------------------------------------------

    def _resolve_sampling(self, temperature, top_k, top_p,
                          rng: torch.Generator | None,
                          batch: int | None = None):
        """EngineConfig defaulting, validation and the default generator,
        shared with SpeculativeEngine. Each knob is a scalar or a per-row
        vector; the result holds [batch] vectors (or [n], n the length
        of a vector knob, when batch is None)."""
        temperature = np.asarray(
            self.ec.temperature if temperature is None else temperature,
            np.float32)
        top_k = np.asarray(self.ec.top_k if top_k is None else top_k,
                           np.int64)
        top_p = np.asarray(self.ec.top_p if top_p is None else top_p,
                           np.float32)
        for name, arr in (("temperature", temperature), ("top_k", top_k),
                          ("top_p", top_p)):
            if arr.ndim > 1:
                raise ValueError(f"{name} must be scalar or 1-D, "
                                 f"got shape {arr.shape}")
            if (arr.ndim == 1 and batch is not None
                    and len(arr) != batch):
                raise ValueError(
                    f"{name} has {len(arr)} entries for a batch of "
                    f"{batch}")
        if (top_k < 0).any():
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if (top_k >= 2**31).any():
            raise ValueError(f"top_k must be < 2**31, got {top_k}")
        if not ((0.0 < top_p) & (top_p <= 1.0)).all():
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        n = batch if batch is not None else max(
            (a.shape[0] for a in (temperature, top_k, top_p) if a.ndim == 1),
            default=1)
        sp = SamplingParams.make(*(np.broadcast_to(a, (n,)).copy()
                                   for a in (temperature, top_k, top_p)),
                                 self.device)
        if rng is None:
            # fresh entropy when some row samples: a constant default
            # would make every sampled completion identical; greedy never
            # draws, so a constant seed costs nothing there
            seed = (int.from_bytes(os.urandom(8), "little") >> 1
                    if sp.sampled else 0)
            rng = torch.Generator(device=self.device).manual_seed(seed)
        return sp, rng

    def _prep(self, prompt_tokens, max_new, rng, temperature, top_k, top_p,
              prompt_mask):
        """Shared validation + sampling setup of the entry points.
        -> (sp, rng, tokens [b, s] int64 on the device, prompt_mask
        [b, s] bool on the device)."""
        tokens = self._tensor(prompt_tokens, torch.int64)
        if tokens.ndim != 2:
            raise ValueError(f"prompt_tokens must be [b, s], got shape "
                             f"{tuple(tokens.shape)}")
        b, s = tokens.shape
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if s + max_new > self.ec.max_len:
            raise ValueError(
                f"prompt {s} + max_new {max_new} exceeds cache bucket "
                f"{self.ec.max_len}")
        if prompt_mask is not None:
            m = (prompt_mask.cpu().numpy()
                 if isinstance(prompt_mask, torch.Tensor)
                 else np.asarray(prompt_mask)).astype(bool)
            if m.shape != (b, s):
                raise ValueError(
                    f"prompt_mask shape {m.shape} != {(b, s)}")
            if not (np.sort(m, axis=1) == m).all() or not m[:, -1].all():
                raise ValueError(
                    "prompt_mask pads must be LEFT-aligned (False... "
                    "then True...) with a real final token per row")
            mask = upload(m, torch.bool, self.device)
        else:
            mask = torch.ones((b, s), dtype=torch.bool, device=self.device)
        sp, rng = self._resolve_sampling(temperature, top_k, top_p, rng,
                                         batch=b)
        return sp, rng, tokens, mask

    # -- one-shot generation -----------------------------------------------

    def _prefill_sample(self, prompt, state, gen, sp: SamplingParams,
                        prompt_mask, aid=None):
        """Prefill + sample token #1 (and its logprob). -> (state, first
        [b], done [b], logprob [b])."""
        logits, state = self._forward_cached(prompt, state,
                                             prompt_mask=prompt_mask, aid=aid)
        first, lp = self._sample(logits, gen, sp)
        eos = self.ec.eos_token
        done = (first == eos) if eos is not None else torch.zeros_like(
            first, dtype=torch.bool)
        return state, first, done, lp

    @torch.inference_mode()
    def generate(self, prompt_tokens, *, max_new: int = 32,
                 rng: torch.Generator | None = None, temperature=None,
                 top_k=None, top_p=None, prompt_mask=None,
                 prefill_chunk: int | None = None, adapter=None,
                 return_logprobs: bool = False):
        """Generate `max_new` tokens after the prompt -> [b, max_new]
        int32 on the engine's device (EOS trimming is the caller's job),
        or (tokens, logprobs) with `return_logprobs`: each chosen
        token's raw-model log-softmax (entries past a row's first EOS
        are undefined: a row past its first EOS emits EOS, forced on the
        device).

        temperature/top_k/top_p default from EngineConfig (scalars or
        per-row vectors); `rng` is a torch.Generator on the engine's
        device. `prompt_mask` batches variable-length prompts, pads
        LEFT-aligned. `prefill_chunk` prefills in fixed slices
        (`prefill_chunked`): same tokens, bounded activation memory.
        `adapter` (needs an adapter_pack) picks a resident fine-tune: one
        name for the batch or one a row; '' rows decode the plain base.
        Decode replays the lane's step graph max_new - 1 times."""
        sp, gen, prompt, mask = self._prep(
            prompt_tokens, max_new, rng, temperature, top_k, top_p,
            prompt_mask)
        b, n = prompt.shape
        aid = self.adapter_ids(adapter, b)
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            pad = (-n) % prefill_chunk
            if n + pad + max_new > self.ec.max_len:
                raise ValueError(
                    f"chunk-padded prompt {n + pad} + max_new {max_new} "
                    f"exceeds cache bucket {self.ec.max_len}")
            if pad:
                prompt = torch.cat([prompt.new_zeros((b, pad)), prompt], 1)
                mask = torch.cat([mask.new_zeros((b, pad)), mask], 1)
        lane = self._acquire(b)
        try:
            state = DecodeState(lane.k, lane.v, 0)
            if prefill_chunk is None:
                state, first, done, lp1 = self._prefill_sample(
                    prompt, state, gen, sp, mask, aid)
            else:
                state, first, done, lp1 = self.prefill_chunked(
                    prompt, state, gen, sp, mask, chunk=prefill_chunk,
                    aid=aid)
            self._load(lane, state, first, done, sp, aid)
            self._replay(lane, gen, sp.sampled, sp.filtered, max_new - 1,
                         lora=aid is not None)
            toks = torch.cat([first[:, None], lane.toks[:, :max_new - 1]], 1)
            lps = torch.cat([lp1[:, None], lane.lps[:, :max_new - 1]], 1)
        finally:
            self._release(lane)
        return (toks, lps) if return_logprobs else toks

    def generate_stream(self, prompt_tokens, *, max_new: int = 32,
                        chunk: int = 8, rng: torch.Generator | None = None,
                        temperature=None, top_k=None, top_p=None,
                        prompt_mask=None):
        """Yield [b, <=chunk] numpy token chunks as they decode. Same
        sampling law and generator discipline as `generate`: with equal
        arguments (and a generator in the same state) the concatenated
        stream equals a prefix of `generate`'s output. The stream stops
        early once every row has hit EOS. Validation is eager: bad
        arguments raise here, not at the first next(). The stream holds
        its lane across yields: a `generate` or another stream of the
        same batch size meanwhile gets a lane of its own."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        sp, gen, prompt, mask = self._prep(
            prompt_tokens, max_new, rng, temperature, top_k, top_p,
            prompt_mask)

        def _iter():
            # inference mode per step, never across a yield: it is
            # thread-wide state the consumer would run under
            with torch.inference_mode():
                lane = self._acquire(prompt.shape[0])
            try:
                with torch.inference_mode():
                    state, tok, done, _ = self._prefill_sample(
                        prompt, DecodeState(lane.k, lane.v, 0), gen, sp,
                        mask)
                    self._load(lane, state, tok, done, sp)
                    out = tok[:, None].cpu().numpy()
                yield out
                emitted = 1
                while emitted < max_new:
                    if self.ec.eos_token is not None and bool(
                            lane.done.all()):
                        return
                    n = min(chunk, max_new - emitted)
                    with torch.inference_mode():
                        self._replay(lane, gen, sp.sampled, sp.filtered, n)
                        out = lane.toks[:, emitted - 1:
                                        emitted - 1 + n].cpu().numpy()
                    yield out
                    emitted += n
            finally:
                self._release(lane)

        return _iter()

    @torch.inference_mode()
    def prefill_chunked(self, prompt, state, gen, sp: SamplingParams,
                        prompt_mask, *, chunk: int, aid=None):
        """Prefill in fixed `chunk`-token slices through the cache, then
        sample token #1 from the final slice (`_prefill_sample`, so the
        sampled law equals the one-shot prefill's; earlier slices draw
        nothing). A slice whose rows are all pads attends nothing (finite
        NEG_INF masking, no NaN) and is never sampled. `prompt` width
        must be a multiple of `chunk` (callers left-pad first). `aid` [b]:
        the rows' adapter ids, or None."""
        b, n = prompt.shape
        if n % chunk:
            raise ValueError(f"prompt width {n} not a multiple of "
                             f"chunk {chunk} (left-pad first)")
        for i in range(n // chunk - 1):
            sl = slice(i * chunk, (i + 1) * chunk)
            _, state = self._forward_cached(prompt[:, sl], state,
                                            prompt_mask=prompt_mask[:, sl],
                                            aid=aid)
        return self._prefill_sample(prompt[:, n - chunk:], state, gen, sp,
                                    prompt_mask[:, n - chunk:], aid)

    @torch.inference_mode()
    def score(self, tokens, prompt_mask=None, adapter=None) -> torch.Tensor:
        """Teacher-forced scoring: log P(token_i | tokens_<i) for every
        position past the first, [b, s-1] fp32 on the engine's device
        (pad positions 0). One forward with every position's logits;
        `adapter` as in `generate`."""
        tokens = self._tensor(tokens, torch.int64)
        b, s = tokens.shape
        if s < 2:
            raise ValueError("scoring needs at least 2 tokens")
        if s > self.ec.max_len:
            raise ValueError(
                f"sequence {s} exceeds cache bucket {self.ec.max_len}")
        if prompt_mask is None:
            mask = torch.ones((b, s), dtype=torch.bool, device=self.device)
        else:
            mask = self._tensor(prompt_mask, torch.bool)
        logits, _ = self._forward_cached(tokens, self.init_state(b),
                                         prompt_mask=mask, return_all=True,
                                         aid=self.adapter_ids(adapter, b))
        lp = torch.log_softmax(logits, -1)
        got = torch.gather(lp[:, :-1], -1, tokens[:, 1:, None])[:, :, 0]
        return got * mask[:, 1:].float()

    @torch.inference_mode()
    def precompute_prefix(self, tokens: list[int]) -> DecodeState:
        """Run a shared prefix (system prompt) once; returns a batch-1
        state at length len(tokens). A forward continuing from it writes
        its cells past `length` in place and leaves the prefix's cells
        untouched, so the state can seed one continuation after
        another."""
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if len(tokens) >= self.ec.max_len:
            raise ValueError(
                f"prefix {len(tokens)} leaves no cache room "
                f"(max_len {self.ec.max_len})")
        arr = torch.as_tensor([tokens], dtype=torch.int64,
                              device=self.device)
        _, state = self._forward_cached(
            arr, self.init_state(1),
            prompt_mask=torch.ones_like(arr, dtype=torch.bool))
        return state
