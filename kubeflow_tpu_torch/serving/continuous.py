"""Slot-based continuous batching over a paged KV pool (counterpart:
kubeflow_tpu/serving/continuous.py).

Requests join and leave the decode batch at token boundaries. The
device half (`ContinuousEngine`) keeps one `SlotState`: a block pool
`[L, num_blocks, block_size, n_kv, hd]` shared by every slot through
per-slot block tables, plus per-slot cursors. The host half
(`ContinuousBatcher`) owns the queue, block admission, chunked-prefill
slices interleaved with decode chunks, and EOS / max_new retirement.

Where the reference donates its state to each jitted program and gets
a new one back, this engine updates the state's tensors IN PLACE. The
layout keeps cell index == token position (the kernels' precondition):
a row's prompt lands from cell 0 and each decode step writes at the
row's cursor.

Where the reference compiles its decode step (a scan of `steps` tokens)
and its prefill slice as programs, warmed at start-up, this engine
captures them as CUDA graphs (serving/graphs.py), keyed as the
reference's programs are: one step graph per `steps` in [1, chunk] and
sampling key, one slice graph per sampling key. A graph bakes tensor
addresses, so the engine owns ONE slot state (`slots()`) for its
lifetime, and the graphs read static sampling knobs and slice inputs
that the host stages in place.

Admission, as in the reference, goes through the radix prefix cache
(serving/paged.py): pool blocks hold a canonical form (cell index ==
token position, no pads), so a prompt's full blocks are indexed by its
tokens and a later prompt sharing them prefills only its suffix, from
a seed of m cached cells (a partially shared block is copied into the
request's own block: copy-on-write). Then
- monolithic (the default): requests group by (prefill bucket, prefix,
  m); each group, padded to a power of two (at most max_slots) with
  greedy dummy rows, gathers its seed from the pool (`gather_seed`),
  prefills its suffixes in one `prefill_batch` on a dense cache (plain
  attention) and lands in its tables in one `insert_many`;
- chunked (`prefill_chunk_tokens`): a request takes a frozen slot at
  cursor m, and its suffix is fed in slices of at most
  `prefill_chunk_tokens` tokens through the prefill-append path
  (`ops.paged_prefill_attention`), one slice per worker iteration.
Decode steps run every slot through `ops.paged_attention`, with up to
`pipeline_depth` chunks in flight. Eviction can demote cached blocks to
a host spill tier (`export_blocks`), and admission restores them
(`import_blocks`).

Every request carries its stop sequences (retired the moment one
completes as the output's suffix, trimmed off), an optional token queue
(`open_stream` / `stream`: one item per emitted token, then None) and a
`RequestTimeline` (`timelines`: enqueue, admit with its prefill split,
every token, finish), whose decode gaps and queue waits feed the
`on_itl` / `on_queue_wait` hooks.

With a draft engine (`draft=`, `spec_gamma=`), every live slot decodes
speculatively, as in the reference: a round drafts gamma tokens for all
slots on the draft's dense per-slot cache (`DraftSlots`, the dense
decode kernel on the card), verifies [tok, d_1..d_gamma] of every slot
in one pass through the prefill-append path (S rows x gamma + 1 tokens
at their own cursors), keeps the accepted prefix and one more token by
the ratio test (`spec_accept`), and rolls both caches back by cursor
motion. Both rounds are CUDA graphs; the draws are exponential races
from the engine's generator. A slot's draft row is seeded from its
prompt before its first token is emitted. `spec_enabled` is the kill
switch: off, plain decode chunks carry on.

With a tenancy config (`tenancy=`, kubeflow_tpu_torch/tenancy/), the
FIFO queue becomes a priority + weighted fair-share queue, a ledger
enforces per-tenant rate limits (`Throttled` at the door) and KV shares
(admission defers), prefix-isolated tenants match and cache in their
own radix namespace, and an interactive arrival that cannot admit
preempts the youngest batch-class decode: its full blocks are donated to
the radix tree and it is re-queued at its tenant's head, so its replay
prefills only the partial tail block. Instant drain: `export_sequences`
parks the worker and packs every admitted request into a migration
wire record (serving/migration.py) with its full KV blocks;
`import_sequence` scatters a record's blocks into the pool and indexes
them, so the re-issued generation resumes from them. Admission also
runs the reference's peer block fetch: a request that names a peer
(`X-KV-Peer`) pulls the blocks its prompt would otherwise prefill
(server.py's `_peer_fetch_blocks`).

With an adapter pack on the engine (serving/multilora.py), every slot
carries an adapter id (`SlotState.aid`, 0 = the plain base), set at
admission; the decode step and the prefill slices add each row's
low-rank delta inside the captured graphs, and a request names its
adapter in the sampling channel (`"adapter"`). The radix tree, the
spill tier and imported blocks are keyed by (namespace, adapter id)
(`cache_ns`): K/V computed under one adapter is never reused under
another, where the reference keys by namespace alone and serves an
adapter request over a base request's cells.

Tensor-parallel serving (an engine built with `group=`, t > 1 ranks):
every rank holds a `ContinuousEngine` over its rank's engine, whose
pool is `[L, blocks, block, n_kv_rank, hd]` (its KV heads, or the one
head its query heads share) and whose forwards run inside the group.
The batcher runs on one rank only; serving/gang.py mirrors its device
calls on the others, and the engine's seed, resolved on that rank, is
the seed of every rank's generator, so sampled rows draw alike and the
ranks' caches stay one. The engine's `cuda_graphs` (False, the only
setting at t > 1) is the `ContinuousEngine`'s by default, so every
runner is eager; an explicit `cuda_graphs=True` is refused. Refused at
t > 1 too, each naming its ROADMAP item: `warmup`, a draft (speculative
decoding), the spill tier and the block export and import of migration
and the fleet plane.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import time

import numpy as np
import torch

from kubeflow_tpu_torch.obs.cachestats import CacheLedger
from kubeflow_tpu_torch.obs.profiling import CompileWatch, PhaseProfiler
from kubeflow_tpu_torch.obs.timeline import RequestTimeline, TimelineStore
from kubeflow_tpu_torch.ops.attention import (
    paged_attention,
    paged_prefill_attention,
)
from kubeflow_tpu_torch.ops.rotary import rope_frequencies
from kubeflow_tpu_torch.serving.engine import (
    SAMPLING_KEYS,
    DecodeState,
    InferenceEngine,
    SamplingParams,
    race_draw,
    refuse_graphs_at_tensor,
    sampling_dist,
    transformer_block,
)
from kubeflow_tpu_torch.serving.graphs import (
    GraphCache,
    HostCopy,
    stage,
    upload,
)
from kubeflow_tpu_torch.serving import migration
from kubeflow_tpu_torch.serving.paged import (
    BlockPool,
    HostSpillTier,
    RadixPrefixCache,
)
from kubeflow_tpu_torch.tenancy import (
    FairShareQueue,
    ReqMeta,
    TenancyConfig,
    TenantLedger,
)

log = logging.getLogger(__name__)

GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


def cache_ns(ns: str, aid: int) -> str:
    """The radix / spill-tier namespace of K/V computed under adapter id
    `aid` in tenant namespace `ns`: `ns` itself for the base (0), so the
    base keeps its keys; apart for every adapter, whose `wk`/`wv` deltas
    make other cells."""
    return ns if not aid else f"{ns}\x00adapter{int(aid)}"


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def bucket_pow2(n: int, cap: int) -> int:
    """Round up to a power of two (>= 16), capped: the reference's
    bucketing of prefill widths, window batches and max_new."""
    return min(max(pow2_ceil(n), 16), cap)


def group_sizes(max_slots: int) -> list[int]:
    """Admission group sizes: the powers of two below max_slots, and
    max_slots. A group of g rows pads to min(pow2_ceil(g), max_slots),
    so warming these sizes covers every arrival count."""
    sizes, g = [], 1
    while g < max_slots:
        sizes.append(g)
        g *= 2
    return sizes + [max_slots]


class SlotState:
    """Per-slot KV pool + cursors, all tensors on the engine's device and
    updated in place by the engine."""

    def __init__(self, k, v, length, offset, pad, tok, block_table,
                 frozen, aid):
        self.k = k            # [L, num_blocks, block_size, n_kv, hd]
        self.v = v            # (block 0 is the trash block)
        self.length = length  # [S] int32 — filled cache cells per row
        self.offset = offset  # [S] int32 — left-pad count (rope shift)
        self.pad = pad        # [S, W] bool — padded cache cells
        self.tok = tok        # [S] int32 — last sampled token per row
        # [S, blocks_per_slot] int32: cell c of slot s lives at
        # pool[:, table[s, c // bs], c % bs]
        self.block_table = block_table
        # [S] bool — mid-chunked-prefill rows: a decode step writes their
        # K/V to the trash block and leaves their cursors alone
        self.frozen = frozen
        self.aid = aid        # [S] int64 — adapter id per row (0 = base)


class DraftSlots:
    """The draft model's per-slot KV cache for continuous speculative
    decoding, updated in place by the engine. Dense where the target's
    is paged: the draft is small, and a second block table would only
    complicate the rollback. Rows are compact (cell index == position,
    no pads) and `length` follows the target row's cursor: after every
    speculative round both caches hold the same committed tokens."""

    def __init__(self, k, v, length):
        self.k = k            # [L_d, S, W_d, n_kv_d, hd_d]
        self.v = v
        self.length = length  # [S] int32 — committed cells per row


def _slot_dists(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """[S, n, V] logits -> [S, n, V] sampling distributions, every
    position under its slot's knobs (`sampling_dist` over the flattened
    rows)."""
    S, n, V = logits.shape

    def rep(t):
        return t[:, None].expand(S, n).reshape(-1)

    flat = SamplingParams(rep(sp.temperature), rep(sp.top_k),
                          rep(sp.top_p), sp.sampled, sp.filtered)
    return sampling_dist(logits.reshape(S * n, V), flat).reshape(S, n, V)


def spec_accept(ps: torch.Tensor, qs: torch.Tensor, drafted: torch.Tensor,
                us: torch.Tensor):
    """The acceptance arithmetic of a verify round (Leviathan et al.), per
    slot: accept drafted[j] while u_j q_j(d_j) < p_j(d_j); k = the
    accepted count. One more token is drawn from `dist`: the target's
    (gamma+1)-th distribution after a fully accepted window, else the
    clipped residual max(p_k - q_k, 0) (p_k itself where that is all
    zero). ps [S, gamma+1, V], qs [S, gamma, V], drafted [S, gamma],
    us [S, gamma] uniforms -> (k [S] int64, dist [S, V])."""
    S, gamma = drafted.shape
    idx = drafted[..., None].long()
    p_d = ps[:, :gamma].gather(2, idx)[..., 0]
    q_d = qs.gather(2, idx)[..., 0]
    accept = us * q_d < p_d           # u < p/q without the 0/0 hazard
    k = torch.cumprod(accept.long(), 1).sum(1)
    rows = torch.arange(S, device=ps.device)
    pk = ps[rows, k]
    qk = qs[rows, torch.clamp(k, max=gamma - 1)]
    resid = torch.clamp(pk - qk, min=0.0)
    resid = torch.where(resid.sum(1, keepdim=True) > 0.0, resid, pk)
    return k, torch.where((k == gamma)[:, None], ps[:, gamma], resid)


def spec_emit(drafted: torch.Tensor, k: torch.Tensor, extra: torch.Tensor,
              logits: torch.Tensor):
    """The round's emitted tokens [S, gamma+1] (row i's valid ones are
    emit[i, :k[i] + 1]: the accepted drafts, then `extra`) and their
    logprobs under the target's raw logits [S, gamma+1, V]."""
    S = drafted.shape[0]
    emit = torch.cat([drafted.long(), drafted.new_zeros(S, 1).long()], 1)
    emit[torch.arange(S, device=emit.device), k] = extra.long()
    lsm = torch.log_softmax(logits.float(), -1)
    return emit, lsm.gather(2, emit[..., None])[..., 0]


class ContinuousEngine:
    """Device half of continuous batching for one `InferenceEngine`.

    Two ways in: the explicit calls on a state the caller holds
    (`init_slots`, `step`, `append_rows`, ...), as the reference's; and
    the graphed calls on the engine's own state (`slots()`): `decode`
    and `prefill_slice` replay CUDA graphs of `step` and of the slice
    body, `warmup` captures them ahead of traffic. `cuda_graphs=False`
    runs the same bodies as eager launches: an explicit control, never a
    fallback; None (the default) takes the engine's own setting, and
    True is refused at tensor > 1. `seed` seeds the generator every
    sampled draw takes.

    With a `draft` engine (continuous speculative decoding), the engine
    also owns the draft's per-slot cache (`draft_slots()`), seeds a row
    of it at admission (`draft_prefill`), and replays two more graphs a
    round: `spec_draft` (gamma draft tokens for every slot, dense decode
    attention) and `spec_verify` (the target over [tok, d_1..d_gamma]
    through the paged prefill-append path, the acceptance test and both
    caches' rollback)."""

    def __init__(self, engine: InferenceEngine, max_slots: int = 8,
                 block_size: int = 64, *, num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 seed: int | None = None, cuda_graphs: bool | None = None,
                 draft: InferenceEngine | None = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if draft is not None and (engine.group is not None
                                  or draft.group is not None):
            raise ValueError("speculative decoding at tensor > 1 is not "
                             "ported yet (ROADMAP Queue 1 item 3g)")
        if draft is not None:
            # the ratio test compares draft and target distributions
            # token by token, and a draft row follows its target cursor
            if draft.cfg.vocab_size != engine.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft.cfg.vocab_size} != target "
                    f"vocab {engine.cfg.vocab_size}")
            if draft.ec.max_len < engine.ec.max_len:
                raise ValueError(
                    f"draft max_len {draft.ec.max_len} < target "
                    f"max_len {engine.ec.max_len}: the draft cache row "
                    "must cover every target cursor position")
            if engine.adapter_pack is not None:
                raise ValueError(
                    "speculative decoding does not compose with a "
                    "multi-LoRA adapter pack (the verify pass would "
                    "score base-model logits against adapter rows)")
        self.draft = draft
        if block_size < 2 or block_size & (block_size - 1):
            raise ValueError(
                f"block_size must be a power of two >= 2, got {block_size}")
        self.engine = engine
        self.S = max_slots
        self.block_size = block_size
        # long monolithic prefills run in slices of this many tokens
        # (buckets become its multiples)
        self.prefill_chunk = prefill_chunk
        self.blocks_per_slot = -(-engine.ec.max_len // block_size)
        self.kv_width = self.blocks_per_slot * block_size
        # default: trash block + every slot at max_len, the dense
        # equivalent; a smaller pool caps KV memory below it, and then
        # admission waits on blocks (evicting idle cached ones first)
        if num_blocks is None:
            num_blocks = 1 + max_slots * self.blocks_per_slot
        if num_blocks < 1 + self.blocks_per_slot:
            raise ValueError(
                f"num_blocks {num_blocks} < {1 + self.blocks_per_slot} "
                f"(trash + one slot's worth at max_len "
                f"{engine.ec.max_len} / block_size {block_size}): a "
                "single max-length request could never be admitted")
        self.num_blocks = num_blocks
        self.pool = BlockPool(self.num_blocks, block_size)
        dev = engine.device
        cfg = engine.cfg
        self._inv_freq = rope_frequencies(cfg.head_dim,
                                          theta=cfg.rope_theta, device=dev)
        self._kv_positions = torch.arange(
            self.kv_width, dtype=torch.int32, device=dev).expand(
                max_slots, self.kv_width)
        self._rows = torch.arange(max_slots, device=dev)
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "little") >> 1
        self.seed = seed
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        if cuda_graphs is None:
            cuda_graphs = engine.cuda_graphs
        if engine.group is not None:
            refuse_graphs_at_tensor(cuda_graphs)
        self.graphs = GraphCache(dev, eager=not cuda_graphs)
        self._st: SlotState | None = None
        self._knobs = None     # static [S] temperature, top_k, top_p
        self._slice_in = {}    # prompt-slice width -> static slice inputs
        self._dst: DraftSlots | None = None
        self._spec_in = {}     # gamma -> static (drafted, qs)
        if engine.gang is not None:
            # the gang's leading rank: every other rank builds its own
            # engine with these arguments (this seed) and mirrors its
            # device calls
            engine.gang.adopt(self, dict(
                max_slots=max_slots, block_size=block_size,
                num_blocks=num_blocks, prefill_chunk=prefill_chunk,
                seed=seed, cuda_graphs=cuda_graphs))

    @property
    def attention_impl(self) -> str:
        """The paged attention path decode resolves to: the CUDA kernels
        for a CUDA engine, the plain version on the CPU."""
        return "cuda" if self.engine.device.type == "cuda" else "torch"

    # -- state ------------------------------------------------------------

    @torch.inference_mode()
    def init_slots(self) -> SlotState:
        return self._new_slots()

    def _new_slots(self) -> SlotState:
        cfg, dev, S = self.engine.cfg, self.engine.device, self.S
        shape = (cfg.num_layers, self.num_blocks, self.block_size,
                 self.engine.kv_heads, cfg.head_dim)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return SlotState(
            zeros(*shape, dtype=cfg.dtype), zeros(*shape, dtype=cfg.dtype),
            zeros(S), zeros(S), zeros(S, self.kv_width, dtype=torch.bool),
            zeros(S), zeros(S, self.blocks_per_slot),
            zeros(S, dtype=torch.bool), zeros(S, dtype=torch.int64))

    @torch.inference_mode()
    def slots(self) -> SlotState:
        """The engine's own state, which the graphs read and write;
        allocated once and never replaced."""
        if self._st is None:
            dev, S = self.engine.device, self.S
            # not `init_slots`, which a serving gang mirrors: every rank
            # builds its own state where its first use reaches it
            self._st = self._new_slots()
            self._knobs = (torch.zeros(S, dtype=torch.float32, device=dev),
                           torch.zeros(S, dtype=torch.int64, device=dev),
                           torch.ones(S, dtype=torch.float32, device=dev))
        return self._st

    @torch.inference_mode()
    def init_draft_slots(self) -> DraftSlots:
        cfg, dev = self.draft.cfg, self.draft.device
        shape = (cfg.num_layers, self.S, self.draft.ec.max_len,
                 cfg.num_kv_heads, cfg.head_dim)
        return DraftSlots(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                          torch.zeros(shape, dtype=cfg.dtype, device=dev),
                          torch.zeros(self.S, dtype=torch.int32, device=dev))

    @torch.inference_mode()
    def draft_slots(self) -> DraftSlots:
        """The engine's own draft cache, which the spec graphs read and
        write; allocated once and never replaced."""
        if self._dst is None:
            self._dst = self.init_draft_slots()
        return self._dst

    @torch.inference_mode()
    def clear_slots(self) -> None:
        """Every slot back to the trash block with zero cursors, in place:
        the graphs keep their addresses (the pool's contents are garbage
        that admission overwrites or the cursors mask)."""
        if self._st is None:
            return
        st = self._st
        for t in (st.length, st.offset, st.pad, st.tok, st.block_table,
                  st.frozen, st.aid):
            t.zero_()
        if self._dst is not None:
            self._dst.length.zero_()

    def kv_block_bytes(self) -> int:
        """Device bytes one pool block holds (K+V, all layers): a rank's,
        under tensor parallelism."""
        return self.engine.kv_cache_bytes(1, self.block_size)

    def _index(self, values) -> torch.Tensor:
        return upload(values, torch.int64, self.engine.device)

    @torch.inference_mode()
    def reset_slots(self, st: SlotState, slots) -> SlotState:
        """Point retired slots back at the trash block and zero their
        cursors, so a freed block sees no further writes from them once
        it is handed to another request."""
        idx = self._index(slots)
        st.block_table[idx] = 0
        st.length[idx] = 0
        st.offset[idx] = 0
        st.pad[idx] = False
        st.frozen[idx] = False
        st.aid[idx] = 0
        return st

    @torch.inference_mode()
    def adopt_slot(self, st: SlotState, slot: int, table, seed_len: int,
                   tok: int, aid: int = 0) -> SlotState:
        """Point `slot` at its planned block `table` with `seed_len`
        cells already holding KV, FROZEN for chunked prefill until
        `append_rows` has fed the rest of its prompt; `aid` is its
        adapter id."""
        st.length[slot] = seed_len
        st.offset[slot] = 0
        st.pad[slot] = False
        st.tok[slot] = tok
        stage(st.block_table[slot], table)
        st.frozen[slot] = True
        st.aid[slot] = aid
        return st

    @torch.inference_mode()
    def copy_cells(self, st: SlotState, src: int, dst: int,
                   n: int) -> SlotState:
        """Copy cells [0, n) of pool block `src` into block `dst` (all
        layers): the copy half of copy-on-write for a partially shared
        block."""
        st.k[:, dst, :n] = st.k[:, src, :n]
        st.v[:, dst, :n] = st.v[:, src, :n]
        return st

    # -- cached blocks ----------------------------------------------------

    @torch.inference_mode()
    def gather_seed(self, st: SlotState, chains, m: int) -> DecodeState:
        """A batch-g prefill seed from cached pool blocks: row i's cells
        [0, m) read through block chain `chains[i]` ([g, blocks_per_slot],
        trash-padded past ceil(m / block_size)). Offset 0 and no pads, by
        the blocks' canonical form; the cells are copied as they are (the
        dense state has the pool's dtype), so `insert_many` writes a
        shared block back bit for bit."""
        chains = self._index(np.asarray(chains).reshape(-1))
        g = chains.numel() // self.blocks_per_slot
        max_len = self.engine.ec.max_len
        k, v = (pool[:, chains].reshape(
            pool.shape[0], g, self.kv_width,
            *pool.shape[3:])[:, :, :max_len] for pool in (st.k, st.v))
        dev = self.engine.device
        return DecodeState(k, v, m,
                           torch.zeros(g, max_len, dtype=torch.bool,
                                       device=dev),
                           torch.zeros(g, dtype=torch.int32, device=dev))

    def _refuse_blocks(self) -> None:
        if self.engine.group is not None:
            raise ValueError(
                "block export and import (the spill tier, migration and "
                "the fleet plane) at tensor > 1 are not ported yet "
                "(ROADMAP Queue 1 items 3h and 3i)")

    @torch.inference_mode()
    def export_blocks(self, st: SlotState, block_ids):
        """Host copies of the K/V held by physical blocks `block_ids`:
        `(k, v)`, each a CPU tensor `[L, n, block_size, n_kv, hd]` of the
        pool's dtype, in id order. A synchronous device-to-host copy: it
        waits for the work queued before it. Does not touch the state."""
        self._refuse_blocks()
        ids = self._index(list(block_ids))
        return tuple(pool[:, ids].cpu() for pool in (st.k, st.v))

    @torch.inference_mode()
    def import_blocks(self, st: SlotState, block_ids, k, v) -> SlotState:
        """Write block payloads (as `export_blocks` returns them) into
        blocks `block_ids`, in place. Payloads keep the exporter's
        canonical form (cell index == token position), so the blocks
        are radix-shareable at once. Raises ValueError when a payload's
        shape disagrees with the pool's block geometry."""
        self._refuse_blocks()
        cfg = self.engine.cfg
        block_ids = list(block_ids)
        want = (cfg.num_layers, len(block_ids), self.block_size,
                self.engine.kv_heads, cfg.head_dim)
        k, v = (x if isinstance(x, torch.Tensor)
                else torch.tensor(np.asarray(x)) for x in (k, v))
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(
                f"import_blocks: payload shape k={tuple(k.shape)} "
                f"v={tuple(v.shape)} does not match pool block geometry "
                f"[L, n, block_size, n_kv, hd] = {want}")
        ids = self._index(block_ids)
        for pool, payload in ((st.k, k), (st.v, v)):
            pool[:, ids] = upload(payload, pool.dtype, self.engine.device)
        return st

    # -- monolithic admission ---------------------------------------------

    def bucket_for(self, n_tokens: int, max_new: int,
                   reserve: int = 0) -> int:
        """Prefill bucket for one request: a power of two (or, past one
        `prefill_chunk`, the ceil chunk multiple), falling back to the
        EXACT length when the bucket plus this request's max_new would
        overrun the cache (bucket pads occupy dense-cache cells).
        `reserve` is cache already spoken for (a shared prefix)."""
        cap = self.engine.ec.max_len - reserve
        c = self.prefill_chunk
        if c and n_tokens > c:
            bc = -(-n_tokens // c) * c
            if bc + max_new <= cap:
                return bc
            return n_tokens
        b = bucket_pow2(n_tokens, max(cap - max_new, 0))
        return b if b >= n_tokens else n_tokens

    @torch.inference_mode()
    def prefill_batch(self, token_lists: list[list[int]], bucket: int,
                      samplings: list[dict], gen: torch.Generator,
                      prefix_state=None, adapter_ids=None):
        """Prefill g prompts left-padded to one bucket on a dense cache in
        one pass (plain attention, as the reference's) and sample each
        one's first token. -> (batch-g DecodeState, first [g], done [g],
        logprobs [g]), ready for `insert_many`. `prefix_state` (a
        `DecodeState` of batch 1 or g) seeds every row with KV already
        computed, so only the suffix prefills. With an adapter pack every
        row takes its adapter id (`adapter_ids`, default the base's 0),
        as the reference always passes them."""
        eng = self.engine
        ec = eng.ec
        g = len(token_lists)
        arr = np.zeros((g, bucket), np.int64)
        mask = np.zeros((g, bucket), bool)
        for i, toks in enumerate(token_lists):
            arr[i, bucket - len(toks):] = toks
            mask[i, bucket - len(toks):] = True
        sp, gen = eng._resolve_sampling(
            [s.get("temperature", ec.temperature) for s in samplings],
            [s.get("top_k", ec.top_k) for s in samplings],
            [s.get("top_p", ec.top_p) for s in samplings], gen, batch=g)
        if prefix_state is None:
            state0 = eng.init_state(g)
        elif prefix_state.k.shape[1] == g:
            state0 = prefix_state
        else:
            ps = prefix_state
            state0 = type(ps)(
                ps.k.repeat_interleave(g, 1), ps.v.repeat_interleave(g, 1),
                ps.length, ps.pad.repeat_interleave(g, 0),
                ps.offset.repeat_interleave(g, 0))
        dev = eng.device
        tokens = upload(arr, torch.int64, dev)
        maskd = upload(mask, torch.bool, dev)
        aid = None
        if eng.adapter_pack is not None:
            aid = upload(adapter_ids if adapter_ids is not None else [0] * g,
                         torch.int64, dev)
        c = self.prefill_chunk
        if c and bucket > c and bucket % c == 0:
            return eng.prefill_chunked(tokens, state0, gen, sp, maskd,
                                       chunk=c, aid=aid)
        return eng._prefill_sample(tokens, state0, gen, sp, maskd, aid)

    def _auto_table(self, slot: int) -> np.ndarray:
        """Engine-managed block table for direct `insert_many` callers
        (tests, warmup): slot s owns blocks [1 + s*MB, 1 + (s+1)*MB), the
        dense-equivalent layout. The batcher passes explicit tables."""
        usable = self.num_blocks - 1
        base = slot * self.blocks_per_slot
        return np.asarray([1 + (base + j) % usable
                           for j in range(self.blocks_per_slot)], np.int32)

    @torch.inference_mode()
    def insert_many(self, st: SlotState, slots: list[int], pstate,
                    rows: list[int], first, *, tables=None,
                    seed_lens: list[int] | None = None,
                    aids: list[int] | None = None) -> SlotState:
        """Scatter rows `rows` of a prefilled batch-g DecodeState into the
        pool blocks of `tables` ([n, blocks_per_slot], trash-padded) and
        point `slots` at them, in one pass. Each row is COMPACTED on the
        way in: its left pads are dropped, so cell index == position,
        offset 0, no pads. `seed_lens`: cells [0, seed_len) of a row are
        an already-compact prefix seed; `aids` the slots' adapter ids
        (default 0). The write covers EVERY cell of
        every block of a table (unused entries must be trash block 0), so
        whatever a freed block held is overwritten."""
        n = len(slots)
        if len(rows) != n:
            raise ValueError(f"insert_many: {n} slots vs {len(rows)} rows")
        if tables is None:
            tables = np.stack([self._auto_table(s) for s in slots])
        if seed_lens is None:
            seed_lens = [0] * n
        cfg, dev = self.engine.cfg, self.engine.device
        max_len = self.engine.ec.max_len
        slot_i = self._index(slots)
        row_i = self._index(rows)
        tab = self._index(np.asarray(tables).reshape(-1))
        seed = upload(seed_lens, torch.int32, dev)
        npad = pstate.offset[row_i]                           # [n]
        j = self._kv_positions[0][None, :]                    # [1, w]
        src = torch.clamp(torch.where(j < seed[:, None], j,
                                      j + npad[:, None]),
                          max=max_len - 1).long()             # [n, w]
        shape = (cfg.num_layers, n * self.blocks_per_slot, self.block_size,
                 self.engine.kv_heads, cfg.head_dim)
        for pool, dense in ((st.k, pstate.k), (st.v, pstate.v)):
            rows_kv = dense[:, row_i[:, None], src]       # [L, n, w, ...]
            pool[:, tab] = rows_kv.reshape(shape).to(pool.dtype)
        st.length[slot_i] = pstate.length - npad
        st.offset[slot_i] = 0
        st.pad[slot_i] = False
        st.tok[slot_i] = first[row_i].to(torch.int32)
        st.block_table[slot_i] = tab.view(n, -1).to(torch.int32)
        st.frozen[slot_i] = False
        st.aid[slot_i] = upload(aids if aids is not None else [0] * n,
                                torch.int64, dev)
        return st

    def insert(self, st: SlotState, slot: int, pstate, first,
               row: int = 0, aid: int = 0, *, table=None,
               seed_len: int = 0) -> SlotState:
        """Single-row `insert_many`."""
        return self.insert_many(
            st, [slot], pstate, [row], first,
            tables=None if table is None else np.asarray(table)[None],
            seed_lens=[seed_len], aids=[aid])

    # -- decode -----------------------------------------------------------

    def _lora_ids(self, st: SlotState, idx=None):
        """The rows' adapter ids for `engine.layer_proj`: every slot's
        (or rows `idx`'s) with an adapter pack, None without one."""
        if self.engine.adapter_pack is None:
            return None
        return st.aid if idx is None else st.aid[idx]

    def _decode_one(self, st: SlotState, sp: SamplingParams,
                    gen: torch.Generator):
        """One decode token for ALL slots at per-slot cursors. Frozen
        rows write to the trash block and keep their cursors; retired
        rows compute garbage the host ignores, their cursors clamped at
        max_len so they never write out of range. With an adapter pack
        each row adds its adapter's delta (id 0: exactly nothing)."""
        eng = self.engine
        cfg, fam, ec = eng.cfg, eng.family, eng.ec
        bs = self.block_size
        positions = st.length[:, None]
        rope_positions = torch.clamp(positions - st.offset[:, None], min=0)
        kv_valid = ~st.pad
        write_at = torch.clamp(st.length, max=ec.max_len - 1).long()
        write_blk = torch.where(
            st.frozen, 0,
            st.block_table[self._rows, write_at // bs]).long()
        write_off = write_at % bs
        window = cfg.sliding_window
        aid = self._lora_ids(st)
        x = eng._embed(st.tok[:, None])
        for li, p in enumerate(eng.layers):
            kp, vp = st.k[li], st.v[li]

            def write_kv(k, v, kp=kp, vp=vp):
                kp[write_blk, write_off] = k[:, 0].to(kp.dtype)
                vp[write_blk, write_off] = v[:, 0].to(vp.dtype)
                return kp, vp

            def attn(q, kc, vc):
                return paged_attention(
                    q, kc, vc, st.block_table, positions,
                    self._kv_positions, causal=True, kv_mask=kv_valid,
                    window=window)

            with eng.parallel():
                x, _ = transformer_block(cfg, fam, p, x, rope_positions,
                                         self._inv_freq, write_kv, attn,
                                         eng.layer_proj(li, aid))
        logits = eng._head(eng.rms_final(x)[:, -1])
        nxt, lp = eng._sample(logits, gen, sp)
        st.length.copy_(torch.where(
            st.frozen, st.length, torch.clamp(st.length + 1,
                                              max=ec.max_len)))
        st.tok.copy_(torch.where(st.frozen, st.tok, nxt))
        return nxt, lp

    @torch.inference_mode()
    def step(self, st: SlotState, sp: SamplingParams, gen: torch.Generator,
             steps: int = 1):
        """`steps` decode tokens for all slots -> (state, tokens
        [S, steps], logprobs [S, steps]), both on the device."""
        toks, lps = [], []
        for _ in range(steps):
            t, lp = self._decode_one(st, sp, gen)
            toks.append(t)
            lps.append(lp)
        return st, torch.stack(toks, 1), torch.stack(lps, 1)

    @torch.inference_mode()
    def sampling(self, temperature, top_k, top_p) -> SamplingParams:
        """Stage per-slot knobs ([S] each, host values) into the static
        tensors the graphs read; the copy queues behind the chunks in
        flight, so those keep the knobs they were dispatched with."""
        self.slots()
        for dst, values in zip(self._knobs, (temperature, top_k, top_p)):
            stage(dst, values)
        t = np.asarray(temperature)
        filtered = (np.asarray(top_k) > 0) | (np.asarray(top_p) < 1.0)
        return SamplingParams(*self._knobs, bool((t > 0).any()),
                              bool(filtered.any()))

    def _key(self, sp: SamplingParams) -> tuple[bool, bool]:
        return sp.sampled, sp.sampled and sp.filtered

    @torch.inference_mode()
    def decode(self, sp: SamplingParams, steps: int):
        """`steps` decode tokens for every slot of the engine's own state
        through the step graph of (steps, sampling key): one replay.
        `sp` comes from `sampling()`. -> (tokens [S, steps], logprobs
        [S, steps]) on the device: the graph's static outputs, which the
        next replay overwrites."""
        st = self.slots()
        key = self._key(sp)
        gsp = SamplingParams(*self._knobs, *key)
        run = self.graphs.runner(
            ("step", steps) + key,
            lambda: self.step(st, gsp, self.gen, steps)[1:],
            generator=self.gen)
        return run()

    # -- chunked prefill --------------------------------------------------

    def _paged_forward(self, st: SlotState, idx, tokens, n_valid):
        """Forward tokens [g, s] for slot rows `idx` THROUGH the paged
        pool: each layer's K/V of row r's first n_valid[r] tokens land at
        cells [cursor, cursor + n_valid) through the row's table and are
        attended in the same fused op (`ops.paged_prefill_attention`).
        Shared by the prefill slices (`_append`) and the speculative
        verify pass (`_spec_verify`), so that the two cannot drift.
        -> final-normed hidden states [g, s, D]. A row writes only cells
        at or above its own cursor, which lie in its exclusively owned
        blocks (radix-shared blocks sit strictly below it)."""
        eng = self.engine
        cfg, fam = eng.cfg, eng.family
        table = st.block_table[idx]
        start = st.length[idx]
        s = tokens.shape[1]
        positions = start[:, None] + torch.arange(
            s, dtype=torch.int32, device=eng.device)[None, :]
        rope_positions = torch.clamp(positions - st.offset[idx][:, None],
                                     min=0)
        kv_valid = ~st.pad[idx]
        window = cfg.sliding_window
        aid = self._lora_ids(st, idx)
        x = eng._embed(tokens)
        for li, p in enumerate(eng.layers):
            new = {}

            def write_kv(k, v, li=li):
                # deferred: the fused op writes K/V and attends in one go
                new["kv"] = (k, v)
                return st.k[li], st.v[li]

            def attn(q, kp, vp):
                kn, vn = new["kv"]
                out, _, _ = paged_prefill_attention(
                    q, kn, vn, kp, vp, table, start, n_valid,
                    kv_mask=kv_valid, window=window)
                return out

            with eng.parallel():
                x, _ = transformer_block(cfg, fam, p, x, rope_positions,
                                         self._inv_freq, write_kv, attn,
                                         eng.layer_proj(li, aid))
        return eng.rms_final(x)

    def _append(self, st: SlotState, idx, tokens, n_valid, finish,
                sp: SamplingParams, gen: torch.Generator):
        """The slice body: device inputs only (slot indices [g] int64,
        tokens [g, s] int64, n_valid [g] int32, finish [g] bool)."""
        eng = self.engine
        ec, dev = eng.ec, eng.device
        x = self._paged_forward(st, idx, tokens, n_valid)
        last = torch.clamp(n_valid - 1, min=0).long()
        x_last = x[torch.arange(x.shape[0], device=dev), last]
        nxt, lp = eng._sample(eng._head(x_last), gen, sp.rows(idx))
        st.length.index_add_(0, idx, n_valid)
        st.length.clamp_(max=ec.max_len)
        st.tok[idx] = torch.where(finish, nxt, st.tok[idx])
        st.frozen[idx] = st.frozen[idx] & ~finish
        return nxt, lp

    @torch.inference_mode()
    def append_rows(self, st: SlotState, slots, tokens, n_valid, finish,
                    sp: SamplingParams, gen: torch.Generator):
        """One chunked-prefill slice: feed `tokens[i, :n_valid[i]]` of each
        listed slot's prompt through the paged pool at the slot's cursor,
        advancing the cursor by n_valid. Rows with `finish` sample their
        first output token and unfreeze. -> (state, first_token [g],
        logprob [g]); both only meaningful for rows with finish.

        Precondition: cursor + n_valid <= max_len, which admission
        guarantees (prompt + max_new <= max_len)."""
        dev = self.engine.device
        nxt, lp = self._append(
            st, self._index(slots), upload(tokens, torch.int64, dev),
            upload(n_valid, torch.int32, dev), upload(finish, torch.bool, dev),
            sp, gen)
        return st, nxt, lp

    @torch.inference_mode()
    def prefill_slice(self, sp: SamplingParams, slot: int, tokens, n: int,
                      finish: bool):
        """One chunked-prefill slice of one slot of the engine's own
        state (`tokens` [1, width]) through the slice graph of (width,
        sampling key): the inputs are staged into the graph's static
        tensors, then one replay. -> (first token [1], logprob [1]) on
        the device, meaningful with `finish`."""
        st = self.slots()
        tokens = np.asarray(tokens)
        width = tokens.shape[1]
        ins = self._slice_in.get(width)
        if ins is None:
            dev = self.engine.device
            ins = self._slice_in[width] = (
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(1, width, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.bool, device=dev))
        for dst, values in zip(ins, (slot, tokens, n, finish)):
            stage(dst, values)
        key = self._key(sp)
        gsp = SamplingParams(*self._knobs, *key)
        run = self.graphs.runner(
            ("slice", width) + key,
            lambda: self._append(st, *ins, gsp, self.gen),
            generator=self.gen)
        return run()

    # -- speculative decoding on paged KV -----------------------------------

    def _draft_decode_one(self, dst: DraftSlots, feed) -> torch.Tensor:
        """One draft token for ALL slots against the dense draft cache
        (the draft's mirror of `_decode_one`, through the draft engine's
        dense stack): row r's K/V at cell min(length, W - 1), attention
        over cells [0, length] (the dense decode kernel on the card),
        length + 1 capped at W. Cell index == position, so causal masking
        alone hides stale cells past a cursor; every cell is written
        before it is first attended. -> logits [S, V]."""
        deng = self.draft
        W = deng.ec.max_len
        positions = dst.length[:, None]
        write_at = torch.clamp(dst.length, max=W - 1).long()

        def write(li, k, v):
            kc, vc = dst.k[li], dst.v[li]
            kc[self._rows, write_at] = k[:, 0].to(kc.dtype)
            vc[self._rows, write_at] = v[:, 0].to(vc.dtype)
            return kc, vc

        x = deng._stack(feed[:, None], positions, positions, None, write)
        dst.length.copy_(torch.clamp(dst.length + 1, max=W))
        return deng._head(x[:, -1])

    @torch.inference_mode()
    def draft_prefill(self, dst: DraftSlots, slot: int, tokens) -> None:
        """Seed draft row `slot` with the KV of `tokens` (the slot's whole
        prompt): one batch-1 draft forward written straight into the row
        from cell 0, compact as the row must be (the reference pads to a
        bucket and strips the pad in a second scatter; an eager forward
        has no shape to keep stable, so there is no pad here)."""
        row = DecodeState(dst.k[:, slot:slot + 1], dst.v[:, slot:slot + 1],
                          0)
        self.draft._forward_cached(
            upload([list(tokens)], torch.int64, self.draft.device), row)
        dst.length[slot] = len(tokens)

    def _spec_draft(self, st: SlotState, dst: DraftSlots, sp: SamplingParams,
                    gen: torch.Generator, drafted, qs):
        """The draft body: gamma draft tokens for every slot from its last
        token, each drawn by the race from its draft distribution, into
        the static `drafted` [S, gamma] and `qs` [S, gamma, V] (the
        distributions ride along for the residual in the verify)."""
        feed = st.tok.long()
        for j in range(drafted.shape[1]):
            q = sampling_dist(self._draft_decode_one(dst, feed), sp)
            feed = race_draw(q, gen)
            drafted[:, j] = feed
            qs[:, j] = q
        return drafted, qs

    def _spec_verify(self, st: SlotState, dst: DraftSlots, drafted, qs,
                     sp: SamplingParams, gen: torch.Generator):
        """The verify body: the target over [tok, d_1..d_gamma] of every
        slot through `_paged_forward` (the prefill-append path, S rows x
        gamma + 1), `spec_accept`, the extra token's race draw, and both
        caches rolled back to the accepted frontier. Rollback is cursor
        motion: rejected cells sit above the new cursor and are written
        again before they are attended, and shared radix blocks, all
        below every cursor, are never written.

        A row within gamma cells of the pool window feeds only
        min(gamma + 1, kv_width - cursor) tokens: the kernel writes
        nothing past the window and the plain path refuses to, and every
        token the host keeps lies below max_len, where the queries
        attend only cells at or below their own. Frozen rows (mid
        chunked prefill) ride along: their writes land above their
        prefill frontier, which the next slice writes again, and their
        cursors and tokens do not move. Free rows write the trash
        block.
        -> (emit [S, gamma+1], logprobs [S, gamma+1], k [S])."""
        eng = self.engine
        S, gamma = drafted.shape
        tin = torch.cat([st.tok[:, None].long(), drafted], 1)
        n_valid = torch.clamp(self.kv_width - st.length,
                              max=gamma + 1).to(torch.int32)
        logits = eng._head(self._paged_forward(st, self._rows, tin, n_valid))
        ps = _slot_dists(logits, sp)
        us = torch.rand(S, gamma, generator=gen, device=eng.device)
        k, dist = spec_accept(ps, qs, drafted, us)
        extra = race_draw(dist, gen)
        emit, lps = spec_emit(drafted, k, extra, logits)
        st.length.copy_(torch.where(
            st.frozen, st.length,
            torch.clamp(st.length + k + 1, max=eng.ec.max_len)))
        st.tok.copy_(torch.where(st.frozen, st.tok, extra.to(torch.int32)))
        # the draft advanced every row by gamma: keep the min(k + 1,
        # gamma) cells the accepted tokens fed, then feed d_gamma
        # unconditionally; its cell commits only when k == gamma (else it
        # lies above the kept cursor and is written again next round)
        kept = dst.length - gamma + torch.clamp(k + 1, max=gamma)
        dst.length.copy_(kept)
        self._draft_decode_one(dst, drafted[:, gamma - 1])
        dst.length.copy_(torch.where(k == gamma, dst.length, kept))
        return emit, lps, k

    def _spec_buffers(self, gamma: int):
        """The static (drafted, qs) of `gamma`: the draft graph's outputs
        and the verify graph's inputs."""
        bufs = self._spec_in.get(gamma)
        if bufs is None:
            dev, S = self.engine.device, self.S
            bufs = self._spec_in[gamma] = (
                torch.zeros(S, gamma, dtype=torch.int64, device=dev),
                torch.zeros(S, gamma, self.engine.cfg.vocab_size,
                            dtype=torch.float32, device=dev))
        return bufs

    @torch.inference_mode()
    def spec_draft(self, sp: SamplingParams, gamma: int):
        """gamma draft tokens for every slot of the engine's own state
        through the draft graph of (gamma, sampling key): one replay.
        `sp` comes from `sampling()`. -> (drafted [S, gamma], qs [S,
        gamma, V]) on the device, which `spec_verify` reads."""
        st, dst = self.slots(), self.draft_slots()
        drafted, qs = self._spec_buffers(gamma)
        key = self._key(sp)
        gsp = SamplingParams(*self._knobs, *key)
        run = self.graphs.runner(
            ("spec_draft", gamma) + key,
            lambda: self._spec_draft(st, dst, gsp, self.gen, drafted, qs),
            generator=self.gen)
        return run()

    @torch.inference_mode()
    def spec_verify(self, sp: SamplingParams, gamma: int):
        """Verify the last `spec_draft` of `gamma` through the verify graph
        of (gamma, sampling key): one replay. -> (emit [S, gamma+1],
        logprobs [S, gamma+1], accepted counts k [S]) on the device; row
        i's valid tokens are emit[i, :k[i] + 1]."""
        st, dst = self.slots(), self.draft_slots()
        drafted, qs = self._spec_buffers(gamma)
        key = self._key(sp)
        gsp = SamplingParams(*self._knobs, *key)
        run = self.graphs.runner(
            ("spec_verify", gamma) + key,
            lambda: self._spec_verify(st, dst, drafted, qs, gsp, self.gen),
            generator=self.gen)
        return run()

    # -- warmup -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, buckets=(16,), step_sizes=(1,),
               slice_tokens: int | None = None,
               spec_gamma: int | None = None) -> int:
        """Run every serving shape once ahead of traffic, as the
        reference compiles its programs: `prefill_batch` and
        `insert_many` for every admission group size x bucket, the step
        graph for every chunk size and sampling key, the slice graph of
        `slice_tokens` for every sampling key, with a draft and
        `spec_gamma` a draft row's seed and the spec draft and verify
        graphs for every sampling key, and `reset_slots`. Then clears
        the state. -> the number of shapes run. Refused at tensor > 1,
        where nothing is captured."""
        if self.engine.group is not None:
            raise ValueError(
                "warmup captures CUDA graphs, which tensor-parallel serving "
                "refuses (host-staged gloo collectives; NCCL gangs with "
                "graph capture: ROADMAP Queue 1 item 3k)")
        st = self.slots()
        spec = self.draft is not None and bool(spec_gamma)
        if spec:
            self.draft_prefill(self.draft_slots(), 0, [0])
        n = 0
        for g in group_sizes(self.S):
            for b in buckets:
                pstate, first, _, _ = self.prefill_batch(
                    [[0]] * g, b, [GREEDY] * g, self.gen)
                self.insert_many(st, list(range(g)), pstate,
                                 list(range(g)), first)
                n += 2
        for sampled, filtered in SAMPLING_KEYS:
            sp = SamplingParams(*self._knobs, sampled, filtered)
            for steps in step_sizes:
                self.decode(sp, steps)
                n += 1
            if slice_tokens:
                self.prefill_slice(sp, 0, np.zeros((1, slice_tokens)), 1,
                                   True)
                n += 1
            if spec:
                self.spec_draft(sp, spec_gamma)
                self.spec_verify(sp, spec_gamma)
                n += 2
        self.reset_slots(st, [0])
        self.clear_slots()
        return n + 1 + spec


# -- host half -------------------------------------------------------------


class Overloaded(RuntimeError):
    """Admission queue is full — callers should shed load (HTTP 429)."""


class MigratedAway(RuntimeError):
    """The request's state was exported to a peer replica (instant
    drain). Not a failure: the generation resumes on the peer from the
    migrated KV; the server maps it to a retryable 503."""

    def __init__(self, request_id: str = ""):
        super().__init__(
            f"request {request_id or '<unknown>'} migrated to a peer "
            "replica")
        self.request_id = request_id


class _Request:
    """One queued or admitted request. The fair-share queue reads its
    `fut` and `meta`."""

    __slots__ = ("tokens", "max_new", "sampling", "prefix", "fut", "out",
                 "lps", "kv_toks", "owned", "node_refs", "freed",
                 "prefilling", "stop", "queue", "meta", "table",
                 "block_charge", "resumed", "aid", "cache_ns")

    def __init__(self, tokens, max_new, sampling, fut, meta: ReqMeta,
                 queue=None, aid: int = 0):
        self.tokens = list(tokens)
        self.max_new = max_new
        self.sampling = sampling
        # a registered prefix's name rides the sampling channel, as in
        # the reference ("" = none)
        self.prefix = sampling.get("prefix") or ""
        # token-id sequences that end generation
        self.stop = tuple(tuple(seq) for seq in sampling.get("stop", ()))
        self.fut = fut
        self.queue = queue          # per-request token stream, or None
        # the scheduling record: tenant, priority, namespace, request id,
        # timeline, enqueue time, and (after a preemption) `resume`
        self.meta = meta
        # the adapter id (0 = the plain base; its name rides the sampling
        # channel) and the radix / spill namespace its K/V is keyed by
        self.aid = aid
        self.cache_ns = cache_ns(meta.ns, aid)
        self.table = None           # the slot's block table, once admitted
        self.block_charge = 0       # pool blocks charged to the tenant
        self.resumed = False        # admitted again after a preemption
        self.out: list[int] = []
        self.lps: list[float] = []   # chosen-token logprobs, out-aligned
        # paged-KV bookkeeping: the tokens whose KV the slot's blocks
        # hold (the full prompt, a registered prefix included, then every
        # emitted token; never trimmed, not even by a stop sequence: the
        # radix index describes the cache), the exclusively owned blocks by
        # logical block index, the radix nodes this request holds refs
        # on, and whether its blocks were released already
        self.kv_toks: list[int] = []
        self.owned: dict[int, int] = {}
        self.node_refs: list = []
        self.freed = False
        # {"suffix": [...], "fed": n} while the prompt's uncached suffix
        # is being fed in slices; None once the row decodes
        self.prefilling: dict | None = None


class ContinuousBatcher:
    """Host orchestrator: queue, block admission, prefill, dispatch-ahead
    decode chunks, EOS / max_new retirement.

    Each worker iteration: reset retired slots' tables, admit queued
    requests into free slots (monolithic: one prefill + insert per
    group; chunked: a frozen slot each), feed ONE prompt slice of at
    most `prefill_chunk_tokens` tokens (shortest remaining suffix
    first), process the chunks in flight that have finished, then
    dispatch the next decode chunk of up to `chunk` tokens for every
    live slot while fewer than `pipeline_depth` chunks are in flight,
    else wait for the oldest. Device calls run in the default executor
    under `gpu_lock`, which is held for the dispatch only: a chunk's
    tokens come back through pinned host memory behind an event, and
    the host waits for them off the lock and off the event loop. Every
    device call goes to one stream, which orders a freed block's last
    write before its next owner's first.

    Admission goes through the radix prefix cache, as the reference's:
    `_plan_blocks` matches the prompt against the cached full blocks
    (and a partially matching block, copied into the request's own
    fresh block: copy-on-write), refs what it reuses and takes fresh
    blocks from the pool, evicting idle cached blocks when the pool is
    short; a request the pool cannot cover waits at the queue head.
    Only the uncached suffix is prefilled: monolithic groups by
    (bucket, prefix, seed length) and seeds each group from the pool
    (`gather_seed`) or a registered prefix's state; chunked adopts the
    slot at the seed length and feeds the suffix. A prompt's full
    blocks enter the tree once written (at admission, or when its last
    slice is fed), and retirement donates the request's full blocks
    below its last written cell. With `kv_spill_bytes`, eviction
    demotes block contents to host memory and admission restores them.
    `cache_ledger` books every block's birth and death to a cause.

    Dispatch-ahead (`pipeline_depth`, default 2 on CUDA and 1 on the
    CPU, as the reference picks 2 on an accelerator): the next chunk is
    queued while the previous one computes, so the host's emit and
    retirement work overlaps device time. A slot that retires early
    decodes up to (depth - 1) x chunk tokens the host drops; a chunk's
    tokens go only to the request that held the slot at dispatch.

    What survives an exception in a device call: nothing of the slot
    state is trusted. `_fail_all` fails every admitted request, returns
    their blocks, drops the radix tree, and clears the state in place
    (the graphs keep its addresses). Queued requests are kept.

    Stop sequences and streams, as the reference's: `_emit` puts each
    token on the request's queue, and when a stop sequence completes as
    the output's suffix it trims it from `out`/`lps` and retires the slot
    through the same path as EOS (a chunk in flight for it is dropped).
    Every way out of the batcher (finish, failure, close) puts None on
    the queue; a stream consumer that goes away cancels the future, and
    the worker's cancellation checks release the slot.

    Speculative decoding (`draft`, `spec_gamma`): while `spec_enabled`,
    each worker iteration runs one synchronous spec round (`_spec_round`)
    in place of the decode chunks, after processing any chunk still in
    flight; a slot's draft row is seeded inside the device call that
    admits it (monolithic) or feeds its last slice (chunked).
    `.spec_rounds`, `.spec_proposed` and `.spec_accepted` count rounds
    and draft tokens; `on_spec_round(proposed, accepted)` feeds the
    server's acceptance SLO.

    Tenancy (`tenancy`, a `TenancyConfig`): `_enqueue` resolves the
    request's tenant (`"tenant"` in the sampling channel; unknown names
    are `default`) and charges its request bucket (`Throttled` when it
    is empty); the queue is a `FairShareQueue` (strict priority classes,
    weighted virtual time, token-paced tenants skipped); `_plan_blocks`
    matches in the tenant's namespace and defers a request that would
    take its tenant past its KV share (`kv_quota`). At the top of each
    worker iteration, before the dirty-slot reset, `_maybe_preempt`
    evicts the youngest batch-class decode when an interactive request
    waits and cannot admit: its full blocks are donated to the radix
    tree, it is released with cause `pressure`, and re-queued at its
    tenant's head with `resume` (the tokens already out) and the
    remaining budget; re-admitted, it prefills only the partial tail
    and emits nothing twice. Without tenancy the queue is the plain
    deque and nothing of this runs. `.preemptions`, `tenant_stats()`.

    Instant drain: `export_sequences()` stops admission, parks the
    worker at a loop boundary (after processing every chunk in flight,
    so each record's `out` is exactly what its consumer received and
    the host's token log matches the device cursors), and packs every
    admitted request into a wire record: active slots with their full
    blocks below len(kv_toks) - 1, pending ones tokens-only. Their
    futures fail with `MigratedAway`. `import_sequence(record)` scatters
    a record's blocks into fresh pool blocks and indexes them under the
    record's namespace (every failure frees them), `export_prefix`
    packs a cached prefix. `drain(timeout)` waits out admitted work
    (`in_flight()`), `begin_drain` / `end_drain` close and open the door.

    `profiler` (obs/profiling.py) splits every worker iteration into
    exclusive host-time phases (admit, prefill, prefill_chunk, decode,
    draft, verify, sample, detokenize, preempt, resume, idle, and the
    host_gap residual); `flush_cache()` forgets every cached KV (the
    tree, the spill tier, the registered prefixes' states) after a
    weight swap. `compile_watch` (obs/profiling.py) counts a novel
    signature of an engine entry point past its first as a recompile,
    under the reference's fn names: the graphed entry points keyed by
    their graph key, so a count that rises in traffic is a CUDA graph
    captured in traffic. `tracer` (set by the server) makes each decode
    chunk's dispatch a `decode.attention` span.

    `.calls` counts dispatched decode steps (over-decoded ones included;
    a spec round counts one);
    `occupancy()` is tokens emitted per decode step; `.tokens_dropped`
    counts decode tokens computed for a request after it retired (the
    dispatch-ahead overhang). `.slices` counts
    chunked-prefill slices and `.prefills` monolithic prefill groups.
    `.decode_s` is wall seconds in dispatching decode chunks (lock wait
    included) and waiting for their results; `.prefill_s` the same for
    prefill slices and admission groups.
    """

    def __init__(self, engine: InferenceEngine, gpu_lock: asyncio.Lock, *,
                 max_slots: int = 8, chunk: int = 4,
                 prefill_chunk: int | None = None,
                 prefill_chunk_tokens: int | None = None,
                 prefixes: dict[str, list[int]] | None = None,
                 max_pending: int = 256, pipeline_depth: int | None = None,
                 kv_block_size: int = 64,
                 kv_pool_blocks: int | None = None,
                 kv_spill_bytes: int | None = None,
                 seed: int | None = None, cuda_graphs: bool | None = None,
                 draft: InferenceEngine | None = None,
                 spec_gamma: int = 4,
                 tenancy: TenancyConfig | None = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if spec_gamma < 1:
            raise ValueError(f"spec_gamma must be >= 1, got {spec_gamma}")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got "
                f"{prefill_chunk_tokens}")
        if pipeline_depth is None:
            pipeline_depth = 2 if engine.device.type == "cuda" else 1
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if kv_spill_bytes is not None and kv_spill_bytes < 0:
            raise ValueError(
                f"kv_spill_bytes must be >= 0, got {kv_spill_bytes}")
        if kv_spill_bytes is not None and engine.group is not None:
            raise ValueError("the spill tier at tensor > 1 is not ported "
                             "yet (ROADMAP Queue 1 item 3h)")
        self.engine = engine
        self.gpu_lock = gpu_lock
        self.chunk = chunk
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.pipeline_depth = pipeline_depth
        self.max_pending = max_pending
        self.spec_gamma = spec_gamma
        self.cengine = ContinuousEngine(
            engine, max_slots, block_size=kv_block_size,
            num_blocks=kv_pool_blocks, prefill_chunk=prefill_chunk,
            seed=seed, cuda_graphs=cuda_graphs, draft=draft)
        pool = self.cengine.pool
        self._radix = RadixPrefixCache(pool)
        # attached before the first alloc: births - frees == in_use
        self.cache_ledger = CacheLedger()
        pool.attach_ledger(self.cache_ledger)
        self._spill_tier: HostSpillTier | None = None
        if kv_spill_bytes is not None:
            self._spill_tier = HostSpillTier(kv_spill_bytes,
                                             self.cengine.kv_block_bytes())
            self._radix.attach_spill(self._spill_tier, self._spill_reader)
        # registered prefixes (system prompts): each one's KV is computed
        # once, on first use, through `precompute_prefix`
        self._prefixes = {name: list(toks)
                          for name, toks in (prefixes or {}).items()}
        for name, toks in self._prefixes.items():
            if not toks or len(toks) >= engine.ec.max_len:
                raise ValueError(
                    f"prefix {name!r}: length {len(toks)} invalid for "
                    f"max_len {engine.ec.max_len}")
        self._prefix_states: dict[str, asyncio.Task] = {}
        self.calls = 0            # dispatched decode steps
        self.requests = 0         # admitted requests
        self.tokens_emitted = 0   # decode tokens (first tokens excluded)
        self.iterations = 0
        self.slices = 0           # chunked-prefill slices
        self.prefills = 0         # monolithic prefill groups
        self.prefix_hits = 0      # admissions that reused cached cells
        self.prefix_misses = 0
        self.tokens_prefilled = 0   # prompt tokens computed
        self.tokens_reused = 0      # prompt cells seeded from cache
        self.tokens_dropped = 0     # decoded after retirement, dropped
        self.decode_s = 0.0
        self.prefill_s = 0.0
        self.spec_rounds = 0        # speculative verify rounds
        self.spec_proposed = 0      # draft tokens proposed
        self.spec_accepted = 0      # draft tokens the target accepted
        # the kill switch (POST /v1/spec): off, rounds and draft seeding
        # stop and plain decode chunks carry on; the draft and its cache
        # stay allocated. Turn it back on with the batcher drained: a
        # slot admitted while it was off has no draft row, so its
        # rounds would draft from a stale cache (the output law holds,
        # acceptance falls)
        self.spec_enabled = True
        # optional hook on_spec_round(proposed, accepted) per verify
        # round; the server feeds the spec-acceptance SLO through it
        self.on_spec_round = None
        # optional hook(computed, reused, hit, tenant, restored=) per
        # admission; the server wires the prefix metrics through it
        self.on_prefix = None
        # per-request token timelines (enqueue, admit, every token,
        # finish), kept in a bounded store for
        # `/v1/requests/{id}/timeline`; the optional hooks on_itl(gap_s)
        # per decode token and on_queue_wait(wait_s) per admission feed
        # the server's histograms and must never kill the worker
        self._clock = time.monotonic
        self.timelines = TimelineStore()
        # the step anatomy (obs/profiling.py): every worker iteration's
        # wall split into exclusive host-time phases, on the timelines'
        # clock; the server binds its families through `on_phase`
        self.profiler = PhaseProfiler(clock=self._clock)
        # optional obs Tracer (the server sets it): each decode chunk's
        # dispatch opens a `decode.attention` span in the executor
        # thread, under the context the worker task was created in
        self.tracer = None
        self.compile_watch = CompileWatch()
        self._watch_entry_points()
        self.on_itl = None
        self.on_queue_wait = None
        # EWMA of enqueue -> finish service time, feeding the server's
        # Retry-After on an Overloaded 429
        self.service_ewma = 0.0
        self._seq = 0        # enqueue sequence: fallback ids, preempt youngest
        # multi-tenant QoS: with a config the FIFO deque becomes a
        # priority + weighted fair-share queue and a ledger enforces
        # rate limits and KV shares; tenant-blind keeps the plain deque
        self.tenancy = tenancy
        self._ledger = (TenantLedger(tenancy)
                        if tenancy is not None else None)
        self._pending = (FairShareQueue(tenancy, self._ledger)
                         if tenancy is not None else collections.deque())
        self.preemptions = 0     # batch decodes evicted for interactive
        self._interactive_blocked = False   # an interactive plan deferred
        self._active: dict[int, _Request] = {}
        self._free = list(range(max_slots))
        self._dirty: list[int] = []   # freed slots awaiting table reset
        self._prefill_q: list[int] = []   # frozen slots, admission order
        # greedy filler knobs on free slots
        self._temp = np.zeros(max_slots, np.float32)
        self._topk = np.zeros(max_slots, np.int64)
        self._topp = np.ones(max_slots, np.float32)
        self._sp_cache: SamplingParams | None = None
        self._wake = asyncio.Event()
        self._worker: asyncio.Task | None = None
        self._closed = False
        self._draining = False
        # export_sequences asks the worker to park at its loop top
        self._halt = False
        # admitted-but-unfinished requests: up at enqueue, down when the
        # future resolves, whichever way (a done callback)
        self._unfinished = 0
        # the worker's decode chunks in flight
        self._inflight: collections.deque = collections.deque()

    def _watch_entry_points(self) -> None:
        """Wrap the engine's entry points in the compile watch, under the
        reference's fn names. A graphed entry point is keyed by what
        picks its CUDA graph (its tensor arguments are static buffers of
        one shape): the decode step by (steps, sampling key), a prefill
        slice by (width, sampling key), the spec rounds by (gamma,
        sampling key). The eager admission calls are keyed as the
        reference compiles them: the prefill by (padded rows, bucket),
        the insert and the seed gather by the prefilled batch's rows.
        `reset_slots` takes any count in one eager call (the reference
        pads it to a power of two to bound its compiles): one
        signature. `warmup` runs through the wrappers, so the counts
        start at the warmed signatures less one a fn."""
        ce, watch = self.cengine, self.compile_watch.watch
        ce.decode = watch(ce.decode, "decode_step",
                          key=lambda sp, steps: (steps, *ce._key(sp)))
        ce.prefill_batch = watch(
            ce.prefill_batch, "prefill",
            key=lambda token_lists, bucket, *a, **k: (len(token_lists),
                                                      bucket))
        ce.insert_many = watch(
            ce.insert_many, "insert_many",
            key=lambda st, slots, pstate, *a, **k: (pstate.k.shape[1],))
        ce.gather_seed = watch(
            ce.gather_seed, "gather_seed",
            key=lambda st, chains, m: (len(chains),))
        ce.reset_slots = watch(ce.reset_slots, "reset_slots",
                               key=lambda st, slots: ())
        ce.prefill_slice = watch(
            ce.prefill_slice, "prefill_append",
            key=lambda sp, slot, tokens, n, finish: (
                np.shape(tokens)[1], *ce._key(sp)))
        if ce.draft is not None:
            ce.spec_draft = watch(
                ce.spec_draft, "spec_draft",
                key=lambda sp, gamma: (gamma, *ce._key(sp)))
            ce.spec_verify = watch(
                ce.spec_verify, "spec_verify",
                key=lambda sp, gamma: (gamma, *ce._key(sp)))

    def occupancy(self) -> float:
        return self.tokens_emitted / self.calls if self.calls else 0.0

    def kv_blocks_in_use(self) -> int:
        """Pool blocks held by active requests and the radix cache (x
        `cengine.kv_block_bytes()` for device bytes)."""
        return self.cengine.pool.in_use

    def prefix_cache_stats(self) -> dict:
        tier = self._spill_tier
        return {
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "tokens_prefilled": self.tokens_prefilled,
            "tokens_reused": self.tokens_reused,
            "cached_blocks": self._radix.cached_blocks,
            "blocks_in_use": self.cengine.pool.in_use,
            "spilled_blocks": tier.spilled_blocks if tier else 0,
            "spilled_bytes": tier.spilled_bytes if tier else 0,
            "heat": self._radix.heat_digest(16),
        }

    def cache_anatomy(self) -> dict:
        """`/debug/profile`'s `cache`: the lifecycle ledger's snapshot
        (eviction causes, reuse and age quantiles, defers, spill books,
        conservation) and the prefix heat digest."""
        return {"ledger": self.cache_ledger.snapshot(),
                "heat": self._radix.heat_digest(16)}

    def flush_cache(self) -> None:
        """Forget every cached KV of the current weights (after a weight
        swap they describe a model that no longer exists): the radix
        tree (blocks freed as `refdrop`), every host spill tier entry
        (booked as content deaths, so the ledger stays conserved) and
        the registered prefixes' memoized states. The reference clears
        the tree only. Only safe with no request admitted: active
        requests hold refs the clear would strand."""
        self._radix.clear(cause="refdrop")
        if self._spill_tier is not None:
            self.cache_ledger.note_spill_drop(self._spill_tier.clear())
        self._prefix_states.clear()

    def warmup(self, buckets=None) -> int:
        """Blocking ahead-of-traffic run of the whole serving shape set
        (before traffic; the app's on_startup hook calls it when
        create_serving_app(warmup=True)): every group size x bucket of
        admission, the step graph for every chunk size, the slice graph
        in chunked mode, the spec draft and verify graphs with a draft.
        With `prefill_chunk` the default buckets add a two-chunk prompt,
        as the reference's. Seeded admission's
        `gather_seed`, `copy_cells` and `import_blocks` run eagerly and
        need no warming. -> shapes run."""
        if buckets is None:
            buckets = [16]
            c = self.cengine.prefill_chunk
            if c and 2 * c <= self.engine.ec.max_len and 2 * c != 16:
                buckets.append(2 * c)
        return self.cengine.warmup(
            buckets=tuple(buckets), step_sizes=range(1, self.chunk + 1),
            slice_tokens=self.prefill_chunk_tokens,
            spec_gamma=self.spec_gamma)

    # -- public API -------------------------------------------------------

    async def submit(self, tokens: list[int], max_new: int,
                     sampling: dict | None = None, *,
                     with_logprobs: bool = False):
        """Generate up to `max_new` tokens for one prompt; resolves when
        THIS request finishes. The result is EOS-padded to exactly
        max_new, except with stop sequences, whose trimmed output comes
        back unpadded (stopping short is the ask); with_logprobs=True
        returns (tokens, logprobs), the logprobs unpadded (one per
        computed token). `sampling` may name a registered prefix
        (`"prefix"`), whose tokens go before `tokens`, stop sequences
        (`"stop"`: token-id lists), an adapter of the engine's pack
        (`"adapter"`) and the timeline's key (`"request_id"`)."""
        sampling = dict(sampling or {})
        fut = self._enqueue(tokens, max_new, sampling, queue=None)
        out, lps = await fut
        eos = self.engine.ec.eos_token
        if eos is not None and len(out) < max_new \
                and not sampling.get("stop"):
            out = out + [eos] * (max_new - len(out))
        return (out, lps) if with_logprobs else out

    def open_stream(self, tokens: list[int], max_new: int,
                    sampling: dict | None = None):
        """Enqueue a streaming request now and return (future, queue):
        admission errors, Overloaded included, raise here, synchronously,
        so a server can answer them before it sends SSE headers. The
        queue yields each token as it is emitted, then None."""
        q: asyncio.Queue = asyncio.Queue()
        return self._enqueue(tokens, max_new, dict(sampling or {}),
                             queue=q), q

    async def stream(self, tokens: list[int], max_new: int,
                     sampling: dict | None = None):
        """Async-iterate the tokens as they decode; the stream ends at
        EOS, a stop sequence or max_new. A consumer that stops iterating
        cancels the request, which releases its slot."""
        fut, q = self.open_stream(tokens, max_new, sampling)
        try:
            while True:
                item = await q.get()
                if item is None:
                    break
                yield item
            await fut   # surface admission and step errors after drain
        finally:
            if not fut.done():
                fut.cancel()

    def _enqueue(self, tokens, max_new, sampling, *,
                 queue) -> asyncio.Future:
        if self._closed:
            raise RuntimeError("batcher is shut down")
        if self._draining:
            raise RuntimeError("batcher is draining")
        if len(self._pending) >= self.max_pending:
            raise Overloaded(
                f"{len(self._pending)} requests already queued "
                f"(max_pending={self.max_pending})")
        cap = self.engine.ec.max_len
        if not tokens:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(tokens) + max_new > cap:
            raise ValueError(
                f"prompt {len(tokens)} + max_new {max_new} exceeds model "
                f"max_len {cap}")
        # the tenant and the request id ride the sampling channel, as in
        # the reference, and are popped back out: routing metadata, not
        # sampling knobs. Direct callers get a sequence-derived id so
        # every timeline has a key
        tenant = sampling.pop("tenant", "")
        request_id = str(sampling.pop("request_id", "")) \
            or f"req-{self._seq:06d}"
        spec = (self.tenancy.resolve(tenant)
                if self.tenancy is not None else None)
        if self._ledger is not None:
            # the rate-limit door: Throttled (HTTP 429 with the bucket's
            # refill time) before anything is spent
            self._ledger.check_request(spec.name)
        # multi-LoRA: the adapter name rides the sampling channel; it is
        # resolved (unknown names raise) here, before a slot is spent
        adapter = sampling.get("adapter", "")
        pack = self.engine.adapter_pack
        if adapter and pack is None:
            raise ValueError(
                f"adapter {adapter!r} requested but no adapter pack "
                "is loaded on this engine")
        aid = pack.resolve(adapter) if pack else 0
        prefix = sampling.get("prefix", "")
        if prefix:
            if prefix not in self._prefixes:
                raise ValueError(
                    f"unknown prefix {prefix!r}; registered: "
                    f"{sorted(self._prefixes)}")
            if adapter:
                # the prefix's KV is computed with the base weights:
                # reusing it under an adapter would serve a hybrid
                raise ValueError(
                    "prefix does not compose with adapter (the shared "
                    "KV is base-model KV)")
            plen = len(self._prefixes[prefix])
            if plen + len(tokens) + max_new > cap:
                raise ValueError(
                    f"prefix {plen} + prompt {len(tokens)} + max_new "
                    f"{max_new} exceeds model max_len {cap}")
        loop = asyncio.get_running_loop()
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._run())
        fut = loop.create_future()
        self._unfinished += 1
        fut.add_done_callback(self._req_done)
        tl = RequestTimeline(
            request_id, tenant=spec.name if spec is not None else tenant,
            prompt_tokens=len(tokens), max_new=max_new, clock=self._clock)
        meta = ReqMeta(
            tenant=spec.name if spec is not None else "",
            priority=spec.priority if spec is not None else "standard",
            weight=spec.weight if spec is not None else 1.0,
            cost=float(max_new), t_enqueue=self._clock(), seq=self._seq,
            ns=(spec.name if spec is not None and spec.prefix_isolation
                else ""),
            request_id=request_id, timeline=tl)
        self._seq += 1
        tl.event("enqueue", tokens=len(tokens), max_new=max_new,
                 priority=meta.priority)
        self.timelines.add(tl)
        self._pending.append(_Request(tokens, max_new, sampling, fut, meta,
                                      queue=queue, aid=aid))
        self._wake.set()
        return fut

    def _req_done(self, _fut) -> None:
        self._unfinished -= 1

    def _take_pending(self) -> list[_Request]:
        """Empty the queue (the fair-share queue's `drain_all`)."""
        if self._ledger is not None:
            return self._pending.drain_all()
        items = list(self._pending)
        self._pending.clear()
        return items

    async def close(self) -> None:
        """Stop the worker and fail whatever is queued or admitted."""
        self._closed = True
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
        exc = RuntimeError("batcher is shut down")
        for req in self._take_pending():
            self._fail(req, exc)
        for slot in list(self._active):
            req = self._active[slot]
            self._release(slot)
            self._fail(req, exc)

    # -- bookkeeping ------------------------------------------------------

    def _sp(self) -> SamplingParams:
        """The static knobs, restaged when a knob changed. Device side:
        call it inside a device call."""
        if self._sp_cache is None:
            self._sp_cache = self.cengine.sampling(self._temp, self._topk,
                                                   self._topp)
        return self._sp_cache

    def _set_knobs(self, slot: int, sampling: dict) -> None:
        ec = self.engine.ec
        self._temp[slot] = sampling.get("temperature", ec.temperature)
        self._topk[slot] = sampling.get("top_k", ec.top_k)
        self._topp[slot] = sampling.get("top_p", ec.top_p)
        self._sp_cache = None

    def _release(self, slot: int, *, cause: str = "refdrop") -> None:
        """Return a slot with greedy filler knobs and release its blocks
        (deaths booked to `cause`); its device table is reset before the
        next admission."""
        req = self._active.pop(slot, None)
        self._free.append(slot)
        self._set_knobs(slot, GREEDY)
        if slot in self._prefill_q:
            self._prefill_q.remove(slot)
        if req is not None:
            self._release_blocks(req, cause=cause)
            self._dirty.append(slot)

    def _release_blocks(self, req: _Request, *,
                        cause: str = "refdrop") -> None:
        """Drop a request's claim on pool blocks: unref its radix nodes
        (tree-owned blocks stay cached, evictable once idle) and free the
        exclusively owned ones. Idempotent."""
        if req.freed:
            return
        req.freed = True
        if self._ledger is not None:
            self._ledger.note_slot_released(req.meta.tenant, req.block_charge)
        if req.node_refs:
            self._radix.unref(req.node_refs)
            req.node_refs = []
        if req.owned:
            self.cengine.pool.free(req.owned.values(), cause=cause)
            req.owned = {}

    def _cache_blocks(self, req: _Request) -> None:
        """At retirement, donate the request's full KV blocks to the
        radix tree instead of freeing them. Only cells [0, len(kv_toks) -
        1) are surely written (the last token's KV may still be in
        flight, and a chunk in flight writes over-decoded KV from there
        on), so only full blocks below that line are indexed. Runs
        before `_release_blocks` frees the rest."""
        if req.freed or not req.kv_toks or req.prefilling is not None:
            # mid-chunked-prefill retirement: cells past the fed
            # frontier are unwritten
            return
        bs = self.cengine.block_size
        n_full = (len(req.kv_toks) - 1) // bs
        if n_full <= 0:
            return
        blocks = {i: req.owned[i] for i in range(n_full) if i in req.owned}
        adopted, _ = self._radix.insert(req.kv_toks[:n_full * bs], blocks,
                                        ns=req.cache_ns)
        for i in adopted:
            del req.owned[i]
        # blocks the tree declined already have an edge for their token
        # path (a concurrent twin won the insert): duplicates
        dup = [b for i, b in blocks.items() if i not in adopted]
        if dup:
            for i in [i for i, b in req.owned.items() if b in dup]:
                del req.owned[i]
            self.cengine.pool.free(dup, cause="divergence")

    def _index_inflight(self, req: _Request) -> None:
        """Index the prompt's full blocks in the radix tree as soon as
        they are written, so a concurrent request sharing the prefix
        seeds from them while this one decodes (its gather queues behind
        our writes on the stream). Nodes created here start with a ref
        held by this request, whose table points at them."""
        bs = self.cengine.block_size
        n_full = len(req.kv_toks) // bs
        if n_full <= 0:
            return
        blocks = {i: req.owned[i] for i in range(n_full) if i in req.owned}
        adopted, held = self._radix.insert(req.kv_toks[:n_full * bs],
                                           blocks, hold=True, ns=req.cache_ns)
        for i in adopted:
            del req.owned[i]
        req.node_refs.extend(held)

    @staticmethod
    def _fail(req: _Request, exc: BaseException) -> None:
        if not req.fut.done():
            if req.queue is not None:
                req.queue.put_nowait(None)   # unblock a stream consumer
            req.fut.set_exception(exc)

    def _fail_all(self, exc: BaseException) -> None:
        for slot in list(self._active):
            req = self._active[slot]
            self._release(slot)
            self._fail(req, exc)
        self._dirty.clear()
        self._prefill_q.clear()
        # the pool's contents are not trusted any more: cached blocks
        # describe nothing
        self._radix.clear()
        try:
            self.cengine.clear_slots()
        except Exception:  # noqa: BLE001 — a dead device fails the next call
            log.exception("clearing the slot state failed")

    def _maybe_preempt(self) -> None:
        """When an interactive request waits and cannot admit (every slot
        is busy, or its block plan deferred), evict the youngest
        batch-class decode. One victim per worker iteration; the next
        preempts again if the pressure persists. A request mid chunked
        prefill is never a victim: its blocks hold no complete KV to
        donate."""
        blocked = self._interactive_blocked
        self._interactive_blocked = False
        if self._free and not blocked:
            return
        if not self._pending.has_waiting("interactive"):
            return
        victim, vseq = None, -1
        for slot, req in self._active.items():
            meta = req.meta
            if (meta.priority != "batch" or req.fut.done()
                    or req.prefilling is not None):
                continue
            if meta.seq > vseq:
                victim, vseq = slot, meta.seq
        if victim is not None:
            self._preempt(victim)

    def _preempt(self, slot: int) -> None:
        """Evict one decode and re-queue it at the head of its tenant's
        queue: retirement without resolving the future. Its full blocks
        are donated to the radix tree and the slot is released (its table
        is reset to trash before the next admission can reuse the freed
        blocks, as for any retirement: the worker preempts before the
        dirty-slot reset; a chunk in flight for it writes only above its
        donated cells, and its tokens are dropped). The replay prompt is
        the prompt and every token emitted, its budget the remainder;
        the stream and the timeline carry on across the hole."""
        with self.profiler.phase("preempt"):
            req = self._active[slot]
            meta = req.meta
            self._cache_blocks(req)
            self._release(slot, cause="pressure")
            self.preemptions += 1
            self._ledger.note_preempted(meta.tenant)
            meta.timeline.event("preempt", slot=slot, emitted=len(req.out))
            meta.resume = {"out": list(req.out), "lps": list(req.lps),
                           "max_new": req.max_new}
            remaining = max(1, req.max_new - len(req.out))
            # the fair-share charge drops to the remainder: no double billing
            meta.cost = float(remaining)
            # the replay tokens already hold a registered prefix's tokens
            sampling = {k: v for k, v in req.sampling.items() if k != "prefix"}
            self._pending.appendleft(_Request(
                req.kv_toks, remaining, sampling, req.fut, meta,
                queue=req.queue, aid=req.aid))
            self._wake.set()

    def tenant_stats(self) -> dict:
        """Per-tenant usage and queue depth ({} when tenant-blind): the
        `serving_tenant_*` collector and `/v1/models` read it."""
        if self._ledger is None:
            return {}
        stats = self._ledger.stats()
        for tenant, depth in self._pending.depths().items():
            stats.setdefault(tenant, {})["queued"] = depth
        return stats

    def _finish(self, slot: int, req: _Request) -> None:
        self._cache_blocks(req)
        self._release(slot)
        dt = self._clock() - req.meta.t_enqueue
        self.service_ewma = (0.8 * self.service_ewma + 0.2 * dt
                             if self.service_ewma > 0 else dt)
        if self._ledger is not None:
            self._ledger.note_completed(req.meta.tenant)
        req.meta.timeline.event("finish", tokens=len(req.out))
        if not req.fut.done():
            if req.queue is not None:
                req.queue.put_nowait(None)
            req.fut.set_result((req.out[:req.max_new],
                                req.lps[:req.max_new]))

    def _admitted(self, slot: int, req: _Request, computed: int,
                  reused: int) -> None:
        """The timeline's admit event (with its prefill split; `resume`
        for a preempted request's re-admission) and the queue wait (first
        admissions only): at adoption in chunked mode, after the group
        prefill in monolithic mode, where the reference stamps them."""
        req.meta.timeline.event("resume" if req.resumed else "admit",
                                slot=slot, prefill_computed=computed,
                                prefill_reused=reused)
        if req.resumed:
            self.profiler.record("resume", 0.0)
        if not req.resumed and self.on_queue_wait is not None:
            try:
                self.on_queue_wait(self._clock() - req.meta.t_enqueue)
            except Exception:  # noqa: BLE001 — a metrics hook never
                log.exception("on_queue_wait hook failed")   # kills us

    def _prefilled(self, req: _Request, computed: int, reused: int) -> None:
        """The admission's prefix hit or miss, through `on_prefix`, once
        the prompt's suffix is computed."""
        if self.on_prefix is not None:
            try:
                self.on_prefix(computed, reused, reused > 0, req.meta.tenant,
                               restored=req.meta.restored)
            except Exception:  # noqa: BLE001 — a metrics hook never
                log.exception("on_prefix hook failed")       # kills us

    def _emit(self, slot: int, req: _Request, token: int, lp: float, *,
              decode: bool = True) -> None:
        req.out.append(token)
        req.lps.append(lp)
        req.kv_toks.append(token)   # cache-content log, never trimmed
        gap = req.meta.timeline.token()
        # the first token (and the first after a preempt/resume hole) has
        # no predecessor: not an inter-token gap
        if decode and gap is not None and self.on_itl is not None:
            try:
                self.on_itl(gap)
            except Exception:  # noqa: BLE001 — a metrics hook never
                log.exception("on_itl hook failed")      # kills us
        if self._ledger is not None:
            # tokens/s pacing: a tenant in debt is not popped until its
            # bucket refills
            self._ledger.charge_tokens(req.meta.tenant, 1)
        if decode:
            self.tokens_emitted += 1
        if req.queue is not None and not req.fut.done():
            req.queue.put_nowait(token)
        # a stop sequence that completes as the output's suffix is
        # trimmed off (OpenAI semantics) and retires the slot at once
        for seq in req.stop:
            n = len(seq)
            if n and len(req.out) >= n and tuple(req.out[-n:]) == seq:
                req.out = req.out[:-n]
                req.lps = req.lps[:-n]
                self._finish(slot, req)
                return
        eos = self.engine.ec.eos_token
        if len(req.out) >= req.max_new or (eos is not None
                                           and token == eos):
            self._finish(slot, req)

    # -- worker -----------------------------------------------------------

    async def _device(self, fn, *args):
        """Dispatch one device call in the executor under the gpu lock."""
        loop = asyncio.get_running_loop()
        async with self.gpu_lock:
            return await loop.run_in_executor(None, fn, *args)

    @staticmethod
    async def _fetch(copy: HostCopy) -> list[np.ndarray]:
        """Wait for a result's host copy off the lock and off the event
        loop (the device may still be busy with earlier chunks)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, copy.wait)

    async def _get_prefix_state(self, name: str):
        """A registered prefix's batch-1 `DecodeState`, computed once
        (single flight: concurrent first users await the same task; a
        failed computation is forgotten so the next use retries)."""
        task = self._prefix_states.get(name)
        if task is None:
            task = asyncio.get_running_loop().create_task(self._device(
                self.engine.precompute_prefix, self._prefixes[name]))
            self._prefix_states[name] = task
        try:
            return await task
        except Exception:
            if self._prefix_states.get(name) is task:
                self._prefix_states.pop(name)
            raise

    def _spill_reader(self, block: int):
        """Host copy of one pool block's K/V: the reader the radix
        cache's eviction demotes through. Synchronous: it waits for the
        chunks in flight."""
        return self.cengine.export_blocks(self.cengine.slots(), [block])

    async def _restore_spilled(self, req: _Request) -> None:
        """Bring this request's spilled full-block prefix back into the
        pool before block planning, so `_plan_blocks` hits it as if it
        had never been evicted. Token-identical by the canonical form:
        the tier's key is the full token prefix. Best-effort: whatever
        fails degrades to plain prefill of the missing cells."""
        tier = self._spill_tier
        if tier is None or tier.spilled_blocks == 0 or req.prefix:
            return
        full = req.tokens
        ns = req.cache_ns
        bs = self.cengine.block_size
        nodes, _, _ = self._radix.match(full, ns=ns)
        # walk the tier forward from the cached frontier; the planner
        # always leaves >= 1 token to prefill, so a block whose last
        # cell is the final prompt token is of no use
        i = end = len(nodes) * bs
        while end + bs <= len(full) - 1 and tier.contains(ns,
                                                          full[:end + bs]):
            end += bs
        n = (end - i) // bs
        if n <= 0:
            return
        # evicting to restore may demote colder blocks: the tier's LRU
        # decides which contents keep host memory; the matched frontier
        # the restored blocks hang from is spared
        fresh = self._alloc_evicting(n, nodes)
        if fresh is None:
            return
        pool = self.cengine.pool
        payloads = []
        for j in range(n):
            p = tier.pop(ns, full[:i + (j + 1) * bs])
            if p is None:
                break   # the budget dropped it during our own evict
            payloads.append(p)
        if len(payloads) < n:
            pool.free(fresh[len(payloads):], cause="refdrop")
            fresh, n = fresh[:len(payloads)], len(payloads)
        if not n:
            return
        k = torch.cat([p[0] for p in payloads], 1)
        v = torch.cat([p[1] for p in payloads], 1)
        try:
            await self._device(self.cengine.import_blocks,
                               self.cengine.slots(), fresh, k, v)
        except BaseException as e:
            # the payloads left the tier and never became cached content
            pool.free(fresh, cause="refdrop")
            self.cache_ledger.note_spill_drop(n)
            if not isinstance(e, Exception):
                raise   # cancelled: the batcher is closing
            log.exception("restoring %d spilled blocks failed", n)
            return   # best-effort: plain prefill covers the cells
        self.cache_ledger.note_restore(n)
        blocks = {len(nodes) + j: b for j, b in enumerate(fresh)}
        adopted, _ = self._radix.insert(full[:end], blocks, ns=ns)
        dup = [b for j, b in blocks.items() if j not in adopted]
        if dup:
            # someone cached (part of) this prefix meanwhile
            pool.free(dup, cause="divergence")
        # the metrics split these cells out of the reused ones
        req.meta.restored += (n - len(dup)) * bs

    def _alloc_evicting(self, n: int, keep) -> list[int] | None:
        """`n` fresh pool blocks, evicting idle cached blocks other than
        the nodes in `keep` when the pool is short. -> None when even
        that does not cover them."""
        pool = self.cengine.pool
        fresh = pool.alloc(n)
        if fresh is None:
            self._radix.evict(n - pool.num_free, keep=keep)
            fresh = pool.alloc(n)
        return fresh

    def _plan_blocks(self, req: _Request) -> dict | None:
        """Match one request against the radix cache and reserve its
        blocks. -> a plan, or None when the pool cannot cover it even
        after evicting idle cached blocks (booked as a
        `pool_exhausted` defer; the caller re-queues it).

        With tenancy, a tenant already holding blocks may not take the
        pool past its KV share: such a request is deferred (a `kv_quota`
        defer and throttle), until its own retirements free some.

        Plan fields: `full` (the prompt, a registered prefix included:
        what the slot's KV will hold), `suffix` (what prefill computes),
        `m` (cells seeded from cache; cell index == token index), `chain`
        (ref'd nodes backing cells [0, m - m % bs)), `extra` (a ref'd
        node whose block holds the match's partial tail: a read-only
        seed source, copied into the row's first fresh block), `fresh`
        (newly allocated blocks) and `table` (the slot's block table,
        trash-padded)."""
        ce = self.cengine
        bs = ce.block_size
        chain: list = []
        extra = None
        if req.prefix:
            # seeded from the registered prefix's state, not the tree
            full = self._prefixes[req.prefix] + req.tokens
            m = len(self._prefixes[req.prefix])
        else:
            full = list(req.tokens)
            nodes, pnode, plen = self._radix.match(full, ns=req.cache_ns)
            # leave >= 1 token to prefill: the first output token needs
            # a forward pass over something
            m = min(len(nodes) * bs + plen, len(full) - 1)
            cut = m // bs
            if cut < len(nodes):
                # capped inside the chain: the node at the cut becomes
                # the partial (copy-on-write) seed
                extra = nodes[cut] if m % bs else None
                nodes = nodes[:cut]
            elif m % bs:
                extra = pnode
            chain = nodes
        n_total = -(-min(len(full) + req.max_new, self.engine.ec.max_len)
                    // bs)
        n_fresh = n_total - len(chain)
        if self._ledger is not None:
            # a tenant holding nothing always admits: the share bounds
            # concurrent holdings, and a lone oversized request would
            # otherwise wait forever
            tenant = req.meta.tenant
            lim = self._ledger.block_limit(tenant, ce.pool.capacity)
            held = self._ledger.blocks_held(tenant)
            if lim is not None and held > 0 and held + n_fresh > lim:
                self._ledger.note_throttled(tenant, "kv_quota")
                self.cache_ledger.note_defer("kv_quota")
                return None
        # the match is ref'd only once the plan stands, so the eviction
        # that makes room spares it: a chain block evicted here would come
        # back as a fresh block and sit in the table twice, and the
        # partial seed's block would be overwritten before it is copied
        fresh = self._alloc_evicting(
            n_fresh, chain if extra is None else chain + [extra])
        if fresh is None and extra is not None and not self._active:
            # nothing active will ever free more: the partial seed's
            # block is the one in the way, so plan without it
            extra, m = None, len(chain) * bs
            fresh = self._alloc_evicting(n_fresh, chain)
        if fresh is None:
            self.cache_ledger.note_defer("pool_exhausted")
            return None
        self._radix.ref(chain)
        if extra is not None:
            self._radix.ref([extra])
        # one ledger tick per admitted request; reused blocks record
        # their reuse distance
        self.cache_ledger.note_admission()
        reused = [n.block for n in chain]
        if extra is not None:
            reused.append(extra.block)
        if reused:
            self.cache_ledger.note_reuse(reused)
        table = np.zeros(ce.blocks_per_slot, np.int32)
        phys = [n.block for n in chain] + fresh
        table[:len(phys)] = phys
        return {"full": full, "suffix": full[m:], "m": m, "chain": chain,
                "extra": extra, "fresh": fresh, "table": table}

    def _take_slot(self, req: _Request, plan: dict) -> int:
        """Give a planned request a slot and the plan's blocks, charge
        them to its tenant, and count its cache hit or miss. A preempted
        request gets back the tokens it had emitted and its whole
        budget (it was queued with the remainder, for block planning)."""
        slot = self._free.pop()
        resume = req.meta.resume
        if resume is not None:
            req.out = list(resume["out"])
            req.lps = list(resume["lps"])
            req.max_new = resume["max_new"]
            req.meta.resume = None
            req.resumed = True
        req.table = plan["table"]
        req.block_charge = len(plan["fresh"])
        if self._ledger is not None:
            self._ledger.note_slot_taken(req.meta.tenant, req.block_charge)
        req.kv_toks = list(plan["full"])
        req.node_refs = list(plan["chain"])
        cut = len(plan["chain"])
        req.owned = {cut + i: b for i, b in enumerate(plan["fresh"])}
        self._active[slot] = req
        self._set_knobs(slot, req.sampling)
        self.requests += 1
        self.tokens_reused += plan["m"]
        if plan["m"]:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        return slot

    async def _admit(self, reqs: list[_Request]) -> None:
        """Plan and admit each request; one the pool cannot cover waits
        at the queue head. Chunked mode adopts a frozen slot per request
        (a registered-prefix request takes the monolithic path: its seed
        is a dense state, not pool blocks); monolithic mode plans every
        request, then prefills each (bucket, prefix, seed length) group
        in one pass."""
        if self.prefill_chunk_tokens:
            rest, deferred = [], []
            for req in reqs:
                if req.prefix:
                    rest.append(req)
                    continue
                await self._restore_spilled(req)
                plan = self._plan_blocks(req)
                if plan is None:
                    self._defer(req, deferred)
                else:
                    await self._adopt(req, plan)
            self._requeue(deferred)
            reqs = rest
        planned, deferred = [], []
        for req in reqs:
            await self._restore_spilled(req)
            plan = self._plan_blocks(req)
            if plan is None:
                self._defer(req, deferred)
            else:
                planned.append((self._take_slot(req, plan), req, plan))
        self._requeue(deferred)
        groups: dict[tuple, list] = {}
        for slot, req, plan in planned:
            b = self.cengine.bucket_for(len(plan["suffix"]), req.max_new,
                                        reserve=plan["m"])
            groups.setdefault((b, req.prefix, plan["m"]), []).append(
                (slot, req, plan))
        for (bucket, prefix, m), group in groups.items():
            await self._admit_group(bucket, prefix, m, group)

    def _defer(self, req: _Request, deferred: list) -> None:
        deferred.append(req)
        if req.meta.priority == "interactive":
            # an interactive request cannot get blocks: the worker may
            # preempt a batch decode although free slots exist
            self._interactive_blocked = True

    def _requeue(self, reqs: list) -> None:
        """Deferred requests back at the queue head, in order (the
        fair-share queue refunds the virtual time their pop charged)."""
        for req in reversed(reqs):
            self._pending.appendleft(req)

    async def _adopt(self, req: _Request, plan: dict) -> None:
        """Chunked admission: a frozen slot pointed at the planned table
        with its cursor at the seed length m, and the partially matched
        block's cells [m - m % bs, m) copied into the row's first fresh
        block (copy-on-write); the suffix follows in slices."""
        slot = self._take_slot(req, plan)
        req.prefilling = {"suffix": plan["suffix"], "fed": 0}
        self._prefill_q.append(slot)
        self._admitted(slot, req, len(plan["suffix"]), plan["m"])
        ce = self.cengine
        m, extra = plan["m"], plan["extra"]

        def run():
            st = ce.slots()
            ce.adopt_slot(st, slot, plan["table"], m, plan["full"][m],
                          req.aid)
            if extra is not None:
                ce.copy_cells(st, extra.block, plan["fresh"][0],
                              m % ce.block_size)

        await self._device(run)
        if extra is not None:
            # the copy is queued ahead of any later write to the block
            self._radix.unref([extra])

    async def _admit_group(self, bucket: int, prefix: str, m: int,
                           group: list) -> None:
        """Monolithic admission of one (bucket, prefix, seed length)
        group: the seed gathered from the pool (m > 0) or the registered
        prefix's state, ONE prefill of the suffixes padded to
        min(pow2_ceil(g), max_slots) rows with greedy dummies (sizes
        `warmup` covers), ONE insert of the real rows into their tables,
        then each prompt's blocks are indexed and its first token
        emitted."""
        ce = self.cengine
        n = len(group)
        pad = min(pow2_ceil(n), ce.S) - n
        lists = [plan["suffix"] for _, _, plan in group] + [[0]] * pad
        samplings = [req.sampling for _, req, _ in group] + [GREEDY] * pad
        aids = [req.aid for _, req, _ in group] + [0] * pad
        slots = [slot for slot, _, _ in group]
        tables = np.stack([plan["table"] for _, _, plan in group])
        seed = chains = None
        if prefix:
            seed = await self._get_prefix_state(prefix)
        elif m:
            chains = np.zeros((n + pad, ce.blocks_per_slot), np.int32)
            for i, (_, _, plan) in enumerate(group):
                phys = [nd.block for nd in plan["chain"]]
                if plan["extra"] is not None:
                    phys.append(plan["extra"].block)
                chains[i, :len(phys)] = phys

        seed_draft = self._spec_on()

        def run():
            st = ce.slots()
            pstate0 = (seed if chains is None
                       else ce.gather_seed(st, chains, m))
            pstate, first, _, lps = ce.prefill_batch(
                lists, bucket, samplings, ce.gen, prefix_state=pstate0,
                adapter_ids=aids)
            ce.insert_many(st, slots, pstate, list(range(n)), first,
                           tables=tables, seed_lens=[m] * n,
                           aids=aids[:n])
            if seed_draft:
                # before the first token is emitted: each draft row holds
                # the prompt, its cursor the target's
                for slot, _, plan in group:
                    ce.draft_prefill(ce.draft_slots(), slot, plan["full"])
            return HostCopy(first[:n], lps[:n])

        t0 = time.perf_counter()
        with self.profiler.phase(
                "prefill", tokens=sum(len(plan["suffix"])
                                      for _, _, plan in group)):
            firsts, flps = await self._fetch(await self._device(run))
        self.prefill_s += time.perf_counter() - t0
        self.prefills += 1
        for i, (slot, req, plan) in enumerate(group):
            if plan["extra"] is not None:
                # its cells now live in the row's own fresh block
                self._radix.unref([plan["extra"]])
            self.tokens_prefilled += len(plan["suffix"])
            if self._active.get(slot) is not req:
                continue
            self._admitted(slot, req, len(plan["suffix"]), plan["m"])
            self._prefilled(req, len(plan["suffix"]), plan["m"])
            self._index_inflight(req)
            if req.fut.done():   # cancelled while prefilling
                self._finish(slot, req)
                continue
            self._emit(slot, req, int(firsts[i]), float(flps[i]),
                       decode=False)

    async def _advance_prefill(self) -> None:
        """Feed one slice of the unfinished suffix with the fewest tokens
        left (admission order on ties), from the slot's cursor. The
        finishing slice samples the request's first token, unfreezes the
        row, and indexes the now-written prompt blocks."""
        for slot in list(self._prefill_q):
            if self._active[slot].fut.done():   # cancelled mid-prefill
                self._finish(slot, self._active[slot])
        if not self._prefill_q:
            return

        def left(s):
            pf = self._active[s].prefilling
            return len(pf["suffix"]) - pf["fed"]

        slot = min(self._prefill_q, key=left)
        req = self._active[slot]
        budget = self.prefill_chunk_tokens
        suffix, fed = req.prefilling["suffix"], req.prefilling["fed"]
        n = min(budget, len(suffix) - fed)
        finish = fed + n == len(suffix)
        toks = np.zeros((1, budget), np.int64)
        toks[0, :n] = suffix[fed:fed + n]

        seed_draft = finish and self._spec_on()

        def run():
            ce = self.cengine
            nxt, lp = ce.prefill_slice(self._sp(), slot, toks, n, finish)
            if seed_draft:
                # the prompt is whole: seed the draft row before the
                # first token is emitted
                ce.draft_prefill(ce.draft_slots(), slot, req.kv_toks)
            return HostCopy(nxt, lp) if finish else None

        t0 = time.perf_counter()
        with self.profiler.phase("prefill_chunk", tokens=n):
            out = await self._device(run)
            if out is not None:
                first, flp = await self._fetch(out)
        self.prefill_s += time.perf_counter() - t0
        self.slices += 1
        self.tokens_prefilled += n
        req.prefilling["fed"] = fed + n
        if finish:
            self._prefill_q.remove(slot)
            req.prefilling = None
            self._prefilled(req, len(suffix), len(req.kv_toks) - len(suffix))
            self._index_inflight(req)
            self._emit(slot, req, int(first[0]), float(flp[0]),
                       decode=False)

    def _spec_on(self) -> bool:
        return self.cengine.draft is not None and self.spec_enabled

    async def _spec_round(self) -> None:
        """One speculative round for every live (non-frozen) slot: gamma
        draft tokens, one verify over gamma + 1 tokens a row, then k + 1
        tokens emitted a row (the tail dropped where a row retires mid
        window). Synchronous, as the reference's: the accepted counts
        decide retirement, so the host reads each round before it plans
        the next; emit, logprobs and k come back through one host copy."""
        snap = {s: r for s, r in self._active.items()
                if r.prefilling is None}
        if not snap:
            return
        gamma = self.spec_gamma

        def run():
            sp = self._sp()
            self.cengine.spec_draft(sp, gamma)
            return HostCopy(*self.cengine.spec_verify(sp, gamma))

        t0 = time.perf_counter()
        # one device call queues both legs: `draft` is its dispatch,
        # `verify` the wait for the round's results
        with self.profiler.phase("draft", tokens=gamma * len(snap)):
            out = await self._device(run)
        with self.profiler.phase("verify"):
            emit, lps, k = await self._fetch(out)
        self.decode_s += time.perf_counter() - t0
        self.calls += 1
        self.spec_rounds += 1
        proposed = gamma * len(snap)
        self.spec_proposed += proposed
        emitted0 = self.tokens_emitted
        with self.profiler.phase("detokenize"):
            accepted = 0
            for slot, req in snap.items():
                n = int(k[slot]) + 1
                if self._active.get(slot) is not req:
                    self.tokens_dropped += n
                    continue
                if req.fut.done():   # caller cancelled mid-round
                    self.tokens_dropped += n
                    self._finish(slot, req)
                    continue
                accepted += n - 1
                for j in range(n):
                    self._emit(slot, req, int(emit[slot, j]),
                               float(lps[slot, j]))
                    if slot not in self._active:
                        # retired mid-window: the tail is dropped, and
                        # never enters kv_toks (its KV lies past the
                        # cache line)
                        self.tokens_dropped += n - j - 1
                        break
        self.profiler.add_tokens("verify", self.tokens_emitted - emitted0)
        self.spec_accepted += accepted
        if self.on_spec_round is not None:
            try:
                self.on_spec_round(proposed, accepted)
            except Exception:  # noqa: BLE001 — a metrics hook never
                log.exception("on_spec_round hook failed")   # kills us

    def _plan_steps(self, inflight) -> int:
        """Next chunk size: the longest remaining budget among live
        (non-frozen) slots NOT already covered by chunks in flight (per
        request: a slot re-admitted after a dispatch is not covered by
        it), capped at `chunk`; 0 = nothing useful to dispatch."""
        best = 0
        for slot, req in self._active.items():
            if req.prefilling is not None:
                continue
            cover = sum(r["steps"] for r in inflight
                        if r["snap"].get(slot) is req)
            best = max(best, req.max_new - len(req.out) - cover)
        return min(self.chunk, best) if best > 0 else 0

    async def _dispatch_chunk(self, steps: int) -> dict:
        """Queue one decode chunk and its host copy, without waiting for
        the device. The snapshot maps slot -> the request live at
        dispatch: the chunk's tokens belong to that request only (a slot
        retired and re-admitted meanwhile holds a new one)."""
        snap = {s: r for s, r in self._active.items()
                if r.prefilling is None}

        def run():
            return HostCopy(*self.cengine.decode(self._sp(), steps))

        if self.tracer is not None:
            # wrap carries the worker's context into the executor thread
            run = self.tracer.wrap(run, "decode.attention",
                                   impl=self.cengine.attention_impl,
                                   steps=steps)
        t0 = time.perf_counter()
        # tokens are booked where the host reads them (_process_chunk),
        # so over-decoded rows never count
        with self.profiler.phase("decode"):
            out = await self._device(run)
        self.decode_s += time.perf_counter() - t0
        self.calls += steps
        return {"out": out, "steps": steps, "snap": snap}

    async def _sync_chunk(self, rec: dict) -> None:
        """Wait for the oldest chunk's host copy: the wait is decode
        time."""
        t0 = time.perf_counter()
        with self.profiler.phase("decode"):
            await self._fetch(rec["out"])
        self.decode_s += time.perf_counter() - t0

    def _process_chunk(self, rec: dict) -> None:
        with self.profiler.phase("sample"):
            toks, lps = rec["out"].wait()
        steps = rec["steps"]
        emitted0 = self.tokens_emitted
        with self.profiler.phase("detokenize"):
            for slot, req in rec["snap"].items():
                if self._active.get(slot) is not req:
                    # retired (and maybe re-admitted) meanwhile
                    self.tokens_dropped += steps
                    continue
                if req.fut.done():   # caller cancelled mid-decode
                    self.tokens_dropped += steps
                    self._finish(slot, req)
                    continue
                for j in range(steps):
                    self._emit(slot, req, int(toks[slot, j]),
                               float(lps[slot, j]))
                    if slot not in self._active:
                        # retired mid-chunk: the tail is dropped, and
                        # never enters kv_toks (its KV lies past the
                        # cache line)
                        self.tokens_dropped += steps - j - 1
                        break
        # each emitted token once: a resumed request's replay restores
        # its output, it is never emitted twice
        self.profiler.add_tokens("decode", self.tokens_emitted - emitted0)

    async def _run(self) -> None:
        # decode chunks on the device, oldest first (`drain` reads it)
        inflight = self._inflight = collections.deque()
        while True:
            if not self._active and not self._pending and not inflight:
                self._wake.clear()
                # no work is not a bubble: idle leaves goodput's books
                with self.profiler.phase("idle"):
                    await self._wake.wait()
            if self._halt:
                # export_sequences parks the worker here; the chunks in
                # flight are processed first, so each request's tokens
                # are exactly what its consumer received
                try:
                    while inflight:
                        head = inflight.popleft()
                        await self._sync_chunk(head)
                        self._process_chunk(head)
                except Exception as e:  # noqa: BLE001
                    log.exception("continuous batcher device call failed")
                    inflight.clear()
                    self._fail_all(e)
                return
            # one profiled iteration: end_iteration books what no phase
            # claimed as host_gap
            self.profiler.begin_iteration()
            try:
                # preemption runs BEFORE the dirty-slot reset, so the
                # victim's table is reset in this same iteration: the
                # admission below may hand its freed blocks to the
                # interactive request that triggered it
                if self._ledger is not None and self._pending:
                    self._maybe_preempt()
                # reset retired slots' tables BEFORE admission can hand
                # their freed blocks to a new request (queued behind the
                # chunks in flight, which may still write them)
                if self._dirty:
                    dirty = sorted(set(self._dirty))
                    self._dirty.clear()
                    # slot recycling is admission's block management
                    with self.profiler.phase("admit"):
                        await self._device(self.cengine.reset_slots,
                                           self.cengine.slots(), dirty)
                if self._free and self._pending:
                    take = []
                    while self._pending and len(take) < len(self._free):
                        req = self._pending.popleft()
                        if req is None:
                            # fair-share queue: every queued tenant is
                            # token-paced
                            break
                        if not req.fut.done():
                            take.append(req)
                    if take:
                        with self.profiler.phase("admit"):
                            await self._admit(take)
                    elif not self._active and not inflight and self._pending:
                        # nothing to decode and nothing admittable: nap
                        # for the shortest refill instead of spinning
                        delay = 0.05
                        if self._ledger is not None:
                            delay = min(max(self._pending.pacing_delay(),
                                            0.001), 0.05)
                        await asyncio.sleep(delay)
                if self._prefill_q:
                    await self._advance_prefill()
                while inflight and inflight[0]["out"].ready():
                    self._process_chunk(inflight.popleft())
                if self._spec_on():
                    # spec rounds replace decode chunks; a chunk still in
                    # flight (spec just turned on) is processed first, or
                    # its tokens would come out after the round's
                    while inflight:
                        head = inflight.popleft()
                        await self._sync_chunk(head)
                        self._process_chunk(head)
                    await self._spec_round()
                    steps = 0
                else:
                    steps = self._plan_steps(inflight)
                if steps and len(inflight) < self.pipeline_depth:
                    inflight.append(await self._dispatch_chunk(steps))
                elif inflight:
                    head = inflight.popleft()
                    await self._sync_chunk(head)
                    self._process_chunk(head)
                elif not self._prefill_q and self._pending:
                    # queued work the pool cannot take yet: wait for a
                    # retirement instead of spinning
                    await asyncio.sleep(0.01)
                self.iterations += 1
            except Exception as e:  # noqa: BLE001 — fail admitted requests
                log.exception("continuous batcher device call failed")
                inflight.clear()
                self._fail_all(e)
                continue
            pool = self.cengine.pool
            self.profiler.note_pool(pool.in_use, pool.capacity)
            self.profiler.note_occupancy(len(self._active),
                                         len(self._active) + len(self._free))
            self.profiler.end_iteration()
            # let submissions and cancellations in between iterations
            await asyncio.sleep(0)

    # -- migration and drain ----------------------------------------------

    def checkpoints(self) -> list[dict]:
        """Resume records (tokens only, no KV) of every admitted request:
        `tokens` is the full replay prompt (a registered prefix expanded,
        every emitted token appended), so a peer resumes by prefilling it
        with budget `max_new - len(out)`, the replay contract preemption
        relies on."""
        out: list[dict] = []
        for req in self._active.values():
            if req.fut.done():
                continue
            # the replay tokens already hold the prefix's tokens
            samp = {k: v for k, v in req.sampling.items() if k != "prefix"}
            out.append({"request_id": req.meta.request_id,
                        "tenant": req.meta.tenant,
                        "tokens": list(req.kv_toks), "out": list(req.out),
                        "max_new": req.max_new, "sampling": samp})
        pending = (self._pending.items() if self._ledger is not None
                   else list(self._pending))
        for req in pending:
            if req.fut.done():
                continue
            emitted, _, max_new, samp = self._queued_view(req)
            out.append({"request_id": req.meta.request_id,
                        "tenant": req.meta.tenant, "tokens": list(req.tokens),
                        "out": emitted, "max_new": max_new,
                        "sampling": samp})
        return out

    @staticmethod
    def _queued_view(req: _Request):
        """A queued request's (emitted tokens, their logprobs, whole
        budget, sampling knobs). A preempted one is queued with its
        replay prompt (a registered prefix's tokens already in it) and
        the remainder of its budget; `resume` holds the rest."""
        samp = dict(req.sampling)
        resume = req.meta.resume
        if resume is None:
            return [], [], req.max_new, samp
        samp.pop("prefix", None)
        return (list(resume["out"]), list(resume["lps"]), resume["max_new"],
                samp)

    async def export_sequences(self) -> list[dict]:
        """Instant drain: stop admission, park the worker at its loop top
        (it processes the chunks in flight first), and pack EVERY
        admitted request into a migration wire record: active slots with
        their full KV blocks below len(kv_toks) - 1 (the cells a chunk
        may still have written past are above that line), requests mid
        chunked prefill and queued ones tokens-only. Each exported future
        fails with `MigratedAway` and every block is released (cause
        `migration`), so the replica can exit at once."""
        self._draining = True
        w = self._worker
        if w is not None and not w.done():
            self._halt = True
            self._wake.set()
            try:
                await w
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            finally:
                self._halt = False
        ce = self.cengine
        bs = ce.block_size
        geometry = migration.pool_geometry(ce)
        exports = []
        for slot, req in list(self._active.items()):
            if req.fut.done():
                self._release(slot)
                continue
            n_full = 0
            if req.prefilling is None and req.kv_toks:
                n_full = (len(req.kv_toks) - 1) // bs
            exports.append((slot, req, [int(b) for b in req.table[:n_full]]))
        all_ids = [b for _, _, phys in exports for b in phys]
        k_host = v_host = None
        if all_ids:
            k_host, v_host = await self._device(ce.export_blocks, ce.slots(),
                                                all_ids)
        records: list[dict] = []
        off = 0
        for slot, req, phys in exports:
            n = len(phys)
            kv = (k_host[:, off:off + n], v_host[:, off:off + n]) if n else None
            off += n
            meta = req.meta
            samp = {k: v for k, v in req.sampling.items() if k != "prefix"}
            records.append(migration.pack_record(
                request_id=meta.request_id, tenant=meta.tenant, ns=meta.ns,
                tokens=list(req.kv_toks), out=list(req.out),
                lps=list(req.lps), max_new=req.max_new, sampling=samp,
                geometry=geometry, kv=kv))
            meta.timeline.event("migrate_out", emitted=len(req.out), blocks=n)
            self._release(slot, cause="migration")
            self._fail(req, MigratedAway(meta.request_id))
        for req in self._take_pending():
            if req.fut.done():
                continue
            meta = req.meta
            out, lps, max_new, samp = self._queued_view(req)
            records.append(migration.pack_record(
                request_id=meta.request_id, tenant=meta.tenant, ns=meta.ns,
                tokens=list(req.tokens), out=out, lps=lps, max_new=max_new,
                sampling=samp, geometry=geometry, kv=None))
            meta.timeline.event("migrate_out", emitted=len(out), blocks=0)
            self._fail(req, MigratedAway(meta.request_id))
        return records

    async def import_sequence(self, record: dict, *,
                              wedge: bool = False) -> int:
        """Import one migrated sequence's KV blocks into fresh pool blocks
        and index them in the radix cache under the record's namespace:
        the re-issued generation (`tokens`, the remaining budget) hits
        them and prefills only the tail. -> blocks the cache adopted (0
        for a tokens-only record or a prefix cached already). Raises
        ValueError on a wire or geometry mismatch, before anything is
        allocated. On ANY failure, a wedged transfer (`wedge=True`, a
        fault injected mid-transfer) included, every allocated block is
        freed (cause `migration`): a failed import leaks nothing."""
        rec = migration.unpack_record(record)
        ce = self.cengine
        migration.validate_geometry(rec["geometry"], ce)
        # K/V computed under an adapter is indexed under that adapter's
        # key, so only its own requests reuse it
        adapter = rec["sampling"].get("adapter", "")
        pack = self.engine.adapter_pack
        if adapter and pack is None:
            raise ValueError(f"migration record names adapter {adapter!r} "
                             "but no adapter pack is loaded")
        ns = cache_ns(rec["ns"], pack.resolve(adapter) if pack else 0)
        if rec["kv"] is None:
            return 0
        k, v = migration.decode_kv(rec["kv"])
        n_full = int(k.shape[1])
        bs = ce.block_size
        if n_full * bs > len(rec["tokens"]):
            raise ValueError(
                f"migration record claims {n_full} full blocks "
                f"({n_full * bs} cells) but carries only "
                f"{len(rec['tokens'])} tokens")
        pool = ce.pool
        fresh = pool.alloc(n_full)
        if fresh is None:
            self._radix.evict(n_full - pool.num_free)
            fresh = pool.alloc(n_full)
            if fresh is None:
                raise RuntimeError(
                    f"migration import needs {n_full} blocks, pool has "
                    f"{pool.num_free} free")
        done = False
        dup: list[int] = []
        try:
            if wedge:
                raise RuntimeError(
                    "migration transfer wedged (fault injection)")
            await self._device(ce.import_blocks, ce.slots(), fresh, k, v)
            # indexed last: once the tree adopts a block it owns it, and
            # the rollback must never free a tree-owned block
            blocks = dict(enumerate(fresh))
            adopted, _ = self._radix.insert(rec["tokens"][:n_full * bs],
                                            blocks, ns=ns)
            dup = [b for i, b in blocks.items() if i not in adopted]
            done = True
        finally:
            if not done:
                pool.free(fresh, cause="migration")
        if dup:
            # the prefix (or part of it) was cached here already: the
            # tree kept its own blocks, ours are duplicates
            pool.free(dup, cause="divergence")
        return n_full - len(dup)

    async def export_prefix(self, tokens: list[int], *, ns: str = "",
                            request_id: str = "") -> dict | None:
        """The cached full-block KV prefix of `tokens` in namespace `ns`
        as a migration wire record with `out=[]` (the peer side of
        `/v1/blocks/export`). -> None when nothing is exportable (no
        cached full block, or no device state yet). The matched nodes
        are ref'd for the copy, so admission cannot evict them
        meanwhile."""
        ce = self.cengine
        bs = ce.block_size
        if ce._st is None or len(tokens) < bs:
            return None
        nodes, _, _ = self._radix.match(tokens, ns=ns)
        if not nodes:
            return None
        self._radix.ref(nodes)
        try:
            phys = [n.block for n in nodes]
            k_host, v_host = await self._device(ce.export_blocks, ce.slots(),
                                                phys)
        finally:
            self._radix.unref(nodes)
        return migration.pack_record(
            request_id=request_id, tenant="", ns=ns,
            tokens=[int(t) for t in tokens[:len(phys) * bs]], out=[],
            lps=[], max_new=0, sampling={},
            geometry=migration.pool_geometry(ce), kv=(k_host, v_host))

    def in_flight(self) -> int:
        """Admitted-but-unfinished requests (queued, mid-prefill or in a
        slot). Zero means `close()` has nothing to abandon."""
        return self._unfinished

    def begin_drain(self) -> None:
        """Stop admission (new requests raise) while admitted ones decode
        to completion. Sticky until `end_drain()` or `close()`."""
        self._draining = True

    def end_drain(self) -> None:
        """Open admission again after a completed drain."""
        self._draining = False

    async def drain(self, timeout: float | None = None) -> bool:
        """Stop admission and wait for the admitted work to finish. ->
        True when everything finished, False on timeout or with work
        admitted and no worker left to finish it. A preempted request
        is re-queued past the closed door and finishes too. Finished
        means quiescent: no slot is held (a cancelled request's slot is
        released by the worker) and no decode chunk is in flight, so a
        weight swap after the drain races no device read and no cached
        block arrives after a flush."""
        self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._unfinished > 0 or self._active or self._inflight:
            if self._worker is None or self._worker.done():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            await asyncio.sleep(0.01)
        return True
