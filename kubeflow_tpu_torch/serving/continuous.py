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
a row's prompt is appended from cell 0 by chunked prefill and each
decode step writes at the row's cursor.

Admission is chunked prefill only: a request takes a frozen slot and
fresh blocks, and its prompt is fed in slices of at most
`prefill_chunk_tokens` tokens through the prefill-append path
(`ops.paged_prefill_attention`), one slice per worker iteration; decode
steps run every slot through `ops.paged_attention`. The reference's
radix prefix reuse, monolithic prefill/insert, spill tier, tenancy,
preemption, speculation and migration are not ported yet.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import time

import numpy as np
import torch

from kubeflow_tpu_torch.ops.attention import (
    paged_attention,
    paged_prefill_attention,
)
from kubeflow_tpu_torch.ops.rotary import rope_frequencies
from kubeflow_tpu_torch.serving.engine import (
    InferenceEngine,
    SamplingParams,
    transformer_block,
)
from kubeflow_tpu_torch.serving.paged import BlockPool

log = logging.getLogger(__name__)


class SlotState:
    """Per-slot KV pool + cursors, all tensors on the engine's device and
    updated in place by the engine."""

    def __init__(self, k, v, length, offset, pad, tok, block_table,
                 frozen):
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


class ContinuousEngine:
    """Device half of continuous batching for one `InferenceEngine`."""

    def __init__(self, engine: InferenceEngine, max_slots: int = 8,
                 block_size: int = 64):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if block_size < 2 or block_size & (block_size - 1):
            raise ValueError(
                f"block_size must be a power of two >= 2, got {block_size}")
        self.engine = engine
        self.S = max_slots
        self.block_size = block_size
        self.blocks_per_slot = -(-engine.ec.max_len // block_size)
        self.kv_width = self.blocks_per_slot * block_size
        # trash block + every slot at max_len: admission never waits on
        # blocks while a slot is free
        self.num_blocks = 1 + max_slots * self.blocks_per_slot
        self.pool = BlockPool(self.num_blocks, block_size)
        dev = engine.device
        cfg = engine.cfg
        self._inv_freq = rope_frequencies(cfg.head_dim,
                                          theta=cfg.rope_theta, device=dev)
        self._kv_positions = torch.arange(
            self.kv_width, dtype=torch.int32, device=dev).expand(
                max_slots, self.kv_width)
        self._rows = torch.arange(max_slots, device=dev)

    # -- state ------------------------------------------------------------

    @torch.inference_mode()
    def init_slots(self) -> SlotState:
        cfg, dev, S = self.engine.cfg, self.engine.device, self.S
        shape = (cfg.num_layers, self.num_blocks, self.block_size,
                 cfg.num_kv_heads, cfg.head_dim)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return SlotState(
            zeros(*shape, dtype=cfg.dtype), zeros(*shape, dtype=cfg.dtype),
            zeros(S), zeros(S), zeros(S, self.kv_width, dtype=torch.bool),
            zeros(S), zeros(S, self.blocks_per_slot),
            zeros(S, dtype=torch.bool))

    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.engine.device)

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
        return st

    @torch.inference_mode()
    def adopt_slot(self, st: SlotState, slot: int, table, seed_len: int,
                   tok: int) -> SlotState:
        """Point `slot` at its planned block `table` with `seed_len`
        cells already holding KV, FROZEN for chunked prefill until
        `append_rows` has fed the rest of its prompt."""
        st.length[slot] = seed_len
        st.offset[slot] = 0
        st.pad[slot] = False
        st.tok[slot] = tok
        st.block_table[slot] = torch.as_tensor(
            np.asarray(table, np.int32), device=st.block_table.device)
        st.frozen[slot] = True
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

    # -- decode -----------------------------------------------------------

    def _decode_one(self, st: SlotState, sp: SamplingParams,
                    gen: torch.Generator):
        """One decode token for ALL slots at per-slot cursors. Frozen
        rows write to the trash block and keep their cursors; retired
        rows compute garbage the host ignores, their cursors clamped at
        max_len so they never write out of range."""
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

            x, _ = transformer_block(cfg, fam, p, x, rope_positions,
                                     self._inv_freq, write_kv, attn)
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

    # -- chunked prefill --------------------------------------------------

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
        eng = self.engine
        cfg, fam, ec = eng.cfg, eng.family, eng.ec
        dev = eng.device
        idx = self._index(slots)
        tokens = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        n_valid = torch.as_tensor(np.asarray(n_valid, np.int32), device=dev)
        finish = torch.as_tensor(np.asarray(finish, bool), device=dev)
        table = st.block_table[idx]
        start = st.length[idx]
        s = tokens.shape[1]
        positions = start[:, None] + torch.arange(
            s, dtype=torch.int32, device=dev)[None, :]
        rope_positions = torch.clamp(positions - st.offset[idx][:, None],
                                     min=0)
        kv_valid = ~st.pad[idx]
        window = cfg.sliding_window
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

            x, _ = transformer_block(cfg, fam, p, x, rope_positions,
                                     self._inv_freq, write_kv, attn)
        x = eng.rms_final(x)
        last = torch.clamp(n_valid - 1, min=0).long()
        x_last = x[torch.arange(x.shape[0], device=dev), last]
        nxt, lp = eng._sample(eng._head(x_last), gen, sp.rows(idx))
        st.length.index_add_(0, idx, n_valid)
        st.length.clamp_(max=ec.max_len)
        st.tok[idx] = torch.where(finish, nxt, st.tok[idx])
        st.frozen[idx] = st.frozen[idx] & ~finish
        return st, nxt, lp


# -- host half -------------------------------------------------------------


class Overloaded(RuntimeError):
    """Admission queue is full — callers should shed load (HTTP 429)."""


class _Request:
    """One queued or admitted request."""

    __slots__ = ("tokens", "max_new", "sampling", "fut", "out", "lps",
                 "owned", "prefilling")

    def __init__(self, tokens, max_new, sampling, fut):
        self.tokens = list(tokens)
        self.max_new = max_new
        self.sampling = sampling
        self.fut = fut
        self.out: list[int] = []
        self.lps: list[float] = []   # chosen-token logprobs, out-aligned
        self.owned: list[int] = []   # pool blocks, by logical block index
        # {"fed": n} while the prompt is being fed in slices; None once
        # the row decodes
        self.prefilling: dict | None = None


class ContinuousBatcher:
    """Host orchestrator: queue, block admission, chunked prefill
    interleaved with decode chunks, EOS / max_new retirement.

    Each worker iteration: reset retired slots' tables, admit queued
    requests into free slots (fresh blocks, frozen), feed ONE prompt
    slice of at most `prefill_chunk_tokens` tokens (shortest remaining
    prompt first), then decode up to `chunk` tokens for every live slot.
    Device work runs in the default executor under `gpu_lock`; its
    results come back to the host there.

    What survives an exception in a device call: nothing of the slot
    state is trusted. The engine updates the pool in place, so a step
    that fails midway may have written some layers' cells and not
    others. `_fail_all` fails every admitted request, returns their
    blocks, and drops the state; the next admission builds a fresh one.
    Queued requests are kept.

    `.calls` counts decode steps; `occupancy()` is tokens emitted per
    decode step. `.iterations` counts worker iterations;
    `.decode_s` and `.prefill_s` are the wall seconds spent in decode
    chunks and prefill slices (lock wait, dispatch and, where the call
    reads a result back, the device time too).
    """

    def __init__(self, engine: InferenceEngine, gpu_lock: asyncio.Lock, *,
                 max_slots: int = 8, chunk: int = 4,
                 prefill_chunk_tokens: int = 64, max_pending: int = 256,
                 kv_block_size: int = 64, seed: int | None = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got "
                f"{prefill_chunk_tokens}")
        self.engine = engine
        self.gpu_lock = gpu_lock
        self.chunk = chunk
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.max_pending = max_pending
        self.cengine = ContinuousEngine(engine, max_slots,
                                        block_size=kv_block_size)
        self.calls = 0            # decode steps
        self.requests = 0         # admitted requests
        self.tokens_emitted = 0   # decode tokens (first tokens excluded)
        self.iterations = 0
        self.decode_s = 0.0
        self.prefill_s = 0.0
        self._pending: collections.deque[_Request] = collections.deque()
        self._active: dict[int, _Request] = {}
        self._free = list(range(max_slots))
        self._dirty: list[int] = []   # freed slots awaiting table reset
        self._prefill_q: list[int] = []   # frozen slots, admission order
        self._st: SlotState | None = None
        # greedy filler knobs on free slots
        self._temp = np.zeros(max_slots, np.float32)
        self._topk = np.zeros(max_slots, np.int64)
        self._topp = np.ones(max_slots, np.float32)
        self._sp_cache: SamplingParams | None = None
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "little") >> 1
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._wake = asyncio.Event()
        self._worker: asyncio.Task | None = None
        self._closed = False

    def occupancy(self) -> float:
        return self.tokens_emitted / self.calls if self.calls else 0.0

    # -- public API -------------------------------------------------------

    async def submit(self, tokens: list[int], max_new: int,
                     sampling: dict | None = None, *,
                     with_logprobs: bool = False):
        """Generate up to `max_new` tokens for one prompt; resolves when
        THIS request finishes. The result is EOS-padded to exactly
        max_new; with_logprobs=True returns (tokens, logprobs), the
        logprobs unpadded (one per computed token)."""
        fut = self._enqueue(tokens, max_new, dict(sampling or {}))
        out, lps = await fut
        eos = self.engine.ec.eos_token
        if eos is not None and len(out) < max_new:
            out = out + [eos] * (max_new - len(out))
        return (out, lps) if with_logprobs else out

    def _enqueue(self, tokens, max_new, sampling) -> asyncio.Future:
        if self._closed:
            raise RuntimeError("batcher is shut down")
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
        loop = asyncio.get_running_loop()
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._run())
        fut = loop.create_future()
        self._pending.append(_Request(tokens, max_new, sampling, fut))
        self._wake.set()
        return fut

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
        for req in list(self._pending):
            self._fail(req, exc)
        self._pending.clear()
        for slot in list(self._active):
            req = self._active[slot]
            self._release(slot)
            self._fail(req, exc)

    # -- bookkeeping ------------------------------------------------------

    def _sp(self) -> SamplingParams:
        if self._sp_cache is None:
            self._sp_cache = SamplingParams.make(
                self._temp, self._topk, self._topp, self.engine.device)
        return self._sp_cache

    def _set_knobs(self, slot: int, sampling: dict) -> None:
        ec = self.engine.ec
        self._temp[slot] = sampling.get("temperature", ec.temperature)
        self._topk[slot] = sampling.get("top_k", ec.top_k)
        self._topp[slot] = sampling.get("top_p", ec.top_p)
        self._sp_cache = None

    def _release(self, slot: int) -> None:
        """Return a slot with greedy filler knobs and free its blocks;
        its device table is reset before the next admission."""
        req = self._active.pop(slot, None)
        self._free.append(slot)
        self._set_knobs(slot, {"temperature": 0.0, "top_k": 0,
                               "top_p": 1.0})
        if slot in self._prefill_q:
            self._prefill_q.remove(slot)
        if req is not None:
            self.cengine.pool.free(req.owned)
            req.owned = []
            self._dirty.append(slot)

    @staticmethod
    def _fail(req: _Request, exc: BaseException) -> None:
        if not req.fut.done():
            req.fut.set_exception(exc)

    def _fail_all(self, exc: BaseException) -> None:
        for slot in list(self._active):
            req = self._active[slot]
            self._release(slot)
            self._fail(req, exc)
        self._st = None
        self._dirty.clear()
        self._prefill_q.clear()

    def _finish(self, slot: int, req: _Request) -> None:
        self._release(slot)
        if not req.fut.done():
            req.fut.set_result((req.out[:req.max_new],
                                req.lps[:req.max_new]))

    def _emit(self, slot: int, req: _Request, token: int, lp: float, *,
              decode: bool = True) -> None:
        req.out.append(token)
        req.lps.append(lp)
        if decode:
            self.tokens_emitted += 1
        eos = self.engine.ec.eos_token
        if len(req.out) >= req.max_new or (eos is not None
                                           and token == eos):
            self._finish(slot, req)

    # -- worker -----------------------------------------------------------

    async def _device(self, fn, *args):
        """Run one device call in the executor under the gpu lock."""
        loop = asyncio.get_running_loop()
        async with self.gpu_lock:
            return await loop.run_in_executor(None, fn, *args)

    async def _admit(self, reqs: list[_Request]) -> None:
        """Reserve fresh blocks for each request and adopt a frozen slot;
        a request the pool cannot cover waits at the queue head."""
        bs = self.cengine.block_size
        mb = self.cengine.blocks_per_slot
        deferred = []
        for req in reqs:
            n_blocks = -(-min(len(req.tokens) + req.max_new,
                              self.engine.ec.max_len) // bs)
            blocks = self.cengine.pool.alloc(n_blocks)
            if blocks is None:
                deferred.append(req)
                continue
            table = np.zeros(mb, np.int32)
            table[:n_blocks] = blocks
            slot = self._free.pop()
            req.owned = blocks
            req.prefilling = {"fed": 0}
            self._active[slot] = req
            self._prefill_q.append(slot)
            self._set_knobs(slot, req.sampling)
            self.requests += 1
            if self._st is None:
                self._st = await self._device(self.cengine.init_slots)
            await self._device(self.cengine.adopt_slot, self._st, slot,
                               table, 0, req.tokens[0])
        self._pending.extendleft(reversed(deferred))

    async def _advance_prefill(self) -> None:
        """Feed one slice of the unfinished prompt with the fewest tokens
        left (admission order on ties). The finishing slice samples the
        request's first token and unfreezes the row."""
        for slot in list(self._prefill_q):
            if self._active[slot].fut.done():   # cancelled mid-prefill
                self._finish(slot, self._active[slot])
        if not self._prefill_q:
            return
        slot = min(self._prefill_q, key=lambda s: (
            len(self._active[s].tokens)
            - self._active[s].prefilling["fed"]))
        req = self._active[slot]
        budget = self.prefill_chunk_tokens
        fed = req.prefilling["fed"]
        n = min(budget, len(req.tokens) - fed)
        finish = fed + n == len(req.tokens)
        toks = np.zeros((1, budget), np.int64)
        toks[0, :n] = req.tokens[fed:fed + n]
        sp = self._sp()

        def run():
            _, nxt, lp = self.cengine.append_rows(
                self._st, [slot], toks, [n], [finish], sp, self._gen)
            if finish:
                return int(nxt[0]), float(lp[0])
            return None, None

        t0 = time.perf_counter()
        first, flp = await self._device(run)
        self.prefill_s += time.perf_counter() - t0
        req.prefilling["fed"] = fed + n
        if finish:
            self._prefill_q.remove(slot)
            req.prefilling = None
            self._emit(slot, req, first, flp, decode=False)

    def _plan_steps(self) -> int:
        """Next decode chunk: the longest remaining budget among live
        (non-frozen) slots, capped at `chunk`; 0 = nothing to decode."""
        best = max((r.max_new - len(r.out) for r in self._active.values()
                    if r.prefilling is None), default=0)
        return min(self.chunk, best)

    async def _decode_chunk(self, steps: int) -> None:
        sp = self._sp()
        # tokens are valid only for the requests live at dispatch
        snap = {s: r for s, r in self._active.items()
                if r.prefilling is None}

        def run():
            _, toks, lps = self.cengine.step(self._st, sp, self._gen,
                                             steps)
            return toks.cpu().numpy(), lps.cpu().numpy()

        t0 = time.perf_counter()
        toks, lps = await self._device(run)
        self.decode_s += time.perf_counter() - t0
        self.calls += steps
        for slot, req in snap.items():
            if self._active.get(slot) is not req:
                continue
            if req.fut.done():   # caller cancelled mid-decode
                self._finish(slot, req)
                continue
            for j in range(steps):
                self._emit(slot, req, int(toks[slot, j]),
                           float(lps[slot, j]))
                if slot not in self._active:
                    break   # retired mid-chunk; the tail is dropped

    async def _run(self) -> None:
        while True:
            if not self._active and not self._pending:
                self._wake.clear()
                await self._wake.wait()
            try:
                # reset retired slots' tables BEFORE admission can hand
                # their freed blocks to a new request
                if self._dirty and self._st is not None:
                    dirty = sorted(set(self._dirty))
                    self._dirty.clear()
                    await self._device(self.cengine.reset_slots, self._st,
                                       dirty)
                self._dirty.clear()
                if self._free and self._pending:
                    take = []
                    while self._pending and len(take) < len(self._free):
                        req = self._pending.popleft()
                        if not req.fut.done():
                            take.append(req)
                    await self._admit(take)
                if self._prefill_q:
                    await self._advance_prefill()
                steps = self._plan_steps()
                if steps:
                    await self._decode_chunk(steps)
                elif not self._prefill_q and self._pending:
                    # queued work the pool cannot take yet: wait for a
                    # retirement instead of spinning
                    await asyncio.sleep(0.01)
                self.iterations += 1
            except Exception as e:  # noqa: BLE001 — fail admitted requests
                log.exception("continuous batcher device call failed")
                self._fail_all(e)
                continue
            # let submissions and cancellations in between iterations
            await asyncio.sleep(0)
