#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubeflow_tpu_torch) on one
NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
1. build   — nvcc builds every kernel (serving and training) from csrc/,
             one nvcc per source, all at once.
2. kernels — each CUDA kernel against its plain PyTorch version at
             llama3-1b shapes (n_q 16, n_kv 8, hd 128, block 64, bf16,
             max_len 1024, 8 slots): ragged cursors, a sliding window,
             copy-on-write-shared table prefixes, ragged q_lens with 0,
             the path's own prefill shape (one row, 64-token slices at a
             300-token prompt's cursors) and the capped repeat (one token
             per row at cells 63, 127, 255 and 511 over a shared block
             chain); then times kernel, plain
             version and one library call
             (SDPA over the gathered K/V, a yardstick the port never
             calls) and computes the card's bound for the same work.
             The paged decode kernel (split and combine launches, one
             call) is timed at 64, 128 and 256 cells a split. The bf16
             prefill kernel (tensor cores, P rounded to bf16) is held
             to the flash kernels' bf16 bound with mag = |P| |V|, which
             a plain version without each query's own cell must exceed.
             The flash forward, dQ and dK/dV kernels at llama3-1b's
             training shape (b 2, s 2048, n_q 16, n_kv 8, hd 128, bf16
             and fp32): causal, window 700, non-causal and s 1000; the
             bf16 kernels (tensor cores, P, dS, P^T and dS^T rounded to
             bf16) within a bound that adds 2^-8 of each product's
             absolute terms; plain versions without each query's own
             key must exceed the bf16 bound and the fp32 one; times at
             the causal bf16 shape against
             one SDPA call captured in a CUDA graph (forward; forward +
             backward for the backward kernels; the eager times logged
             beside) and the CUDA-core kernels' recorded times, with
             ptxas registers and spills.
             The dense decode kernel at the one-shot path's shapes
             (llama3-8b: b 8, n_q 32, n_kv 8, max_len 1024, bf16): the
             window batch (one shared cursor, a left-pad run of another
             length per row), ragged cursors 0/255/256/1023, window 256,
             the draft's batch 1 (llama3-1b heads, cursor 300), the
             continuous spec rounds' draft step (8 rows of llama3-1b
             heads at the verify cursors below, no kv_mask) and the
             window batch in fp32, each at 64- and 128-cell splits;
             times at the window batch and at batch 1 at both splits
             (and how many splits the pad skip drops) against SDPA over
             each row's cells up to its cursor.
             Then the kernels again at gemma-2b's shapes (n_q 8, n_kv 1,
             hd 256, 18 layers' pools): paged decode at the same cursors
             and splits, prefill-append as the 4-row batch, the
             300-token prompt's slices and the capped repeat, the flash
             forward, dQ and dK/dV (bf16 and fp32) over the same four
             cases at b 2 (dK/dV also timed without its query-head
             split; the fp32 CUDA-core kernels timed at the causal shape
             against fp32 SDPA and their bound at the fp32 rate, 67
             TFLOP/s, as `<name>@fp32-256` rows, and likewise at
             llama3-1b's shape as `<name>@fp32-128` rows; fp32 dK/dV
             checked at the shapes' query-head split and a forced one,
             timed at every split, and a sum of the split's partials
             without one subgroup's must exceed the fp32 bound), dense
             decode at the window batch and at batch 1; the same bounds
             and controls, SDPA with K/V
             repeated over the group, ptxas registers and spills of
             every hd-256 instantiation.
             Then the flash forward, dQ and dK/dV at Mixtral-8x7B's
             attention (n_q 32, n_kv 8, hd 128: group 4; b 2, s 2048;
             bf16 and fp32, the four cases), phase 15a's shape, with
             the same bounds, controls and SDPA yardstick.
             Then prefill-append at the speculative verify pass's shape
             (phase 9), at llama3-8b's heads (n_q 32, n_kv 8, hd 128)
             and again at gemma-2b's: 8 rows x gamma + 1 = 5 tokens at
             cursors 0, 17, 255, 300, 511, 1019, 1021 (q_lens clamped to
             the 3 cells left in the window) and a frozen-style row at
             640; the bf16 bound and its control, timed against SDPA
             over the gathered K/V.
             Then `int8_proj` (the int8-weight projection) at the seven
             projection shapes of llama3-8b at M 8, 300 and 2400 (phase
             12a's decode, probe and window-batch prefill) and of
             llama3-1b at M 1 and 8 (decode), 16, 17 and 18 (the path
             switch's M - 1, M and M + 1), 40 (the verify pass), 64 (a
             slice), 128, and 512 and 513 (8 rows of a slice; the
             wgmma tile's switch), a bf16 weight of the
             models' init quantized per channel: within 1e-4 max|ref| +
             2^-7 |ref| + 2^-12 mag, mag = (|h| @ |q|) scale, a bound
             that a control with bf16 accumulators must fail; each
             product's path and split logged; timed against its int8
             bound and graph-replayed bf16 torch.matmul of the same h by
             the bf16 weight, cycling weight copies past the L2. Then a
             layer's four launches (wq, wk, wv and w_gate, w_up grouped;
             each grouped output bit-identical to its product alone),
             summed against the seven matmuls.
3. serve   — boots the port's HTTP server in-process (the CLI's
             `--model llama3-1b --random --seed 0 --continuous --warmup
             --prefill-chunk-tokens 64`; dispatch-ahead depth 2), whose
             start-up captures every decode-step and prefill-slice CUDA
             graph; POSTs 4 `:generate` requests (prompts of 17, 130,
             300 and again 17 tokens, max_new 16), with every kernel
             launch counter set to 0 just before and read just after;
             checks traffic captured no graph, the counts are exact
             under replay (16 paged decode launches per dispatched
             decode step, 16 prefill-append launches per slice, 10
             slices), the repeated prompt's greedy tokens are identical,
             every served token's logprob matches a teacher-forced pass
             of the plain dense model at the same weights, and the same
             requests through the explicit eager path (no graphs) give
             the same greedy tokens. The same requests again under the
             profiler hit the radix prefix cache: the 130- and 300-token
             prompts seed 128 and 256 cells (checked). Prints the
             batcher's host ms per decode step, the device-busy share
             (profiler) and peak memory.
3b. serve  — the same with the reference's default monolithic admission
             (no `--prefill-chunk-tokens`): each bucket group prefills in
             one pass through the plain attention path, so
             `paged_prefill_append` must launch 0 times; the same
             checks otherwise (counts, no capture in traffic, repeated
             prompt, cache hits, teacher-forced logprobs and argmax).
3c. reuse  — radix prefix reuse at full width, chunked (64) and then
             monolithic: the CLI's app (`--warmup`, depth 2, 8 slots),
             counters set to 0 before and read after three waves: A,
             four prompts on one 320-token prefix (suffixes of 20, 40,
             70 and 100 tokens) sent at once; B, wave A again and a
             256-token prompt twice (under the profiler); C, that prompt
             again through `:generate` (seeded from 255 cells: its one
             token at cell 255 after a 63-cell copy-on-write copy).
             Checks hits, misses, tokens reused and prefilled, slices or
             groups against what the prompt lengths reckon, exact launch
             counts, no capture in traffic, the block ledger conserved,
             wave B's chunked repeats identical to wave A's tokens, and
             every logprob against the teacher-forced model. Then a
             batcher with a 17-block pool and a 32-block host spill tier:
             a 1000-token prompt evicts a cached 320-token prefix to host
             memory, the prefix's prompt again restores it and gives its
             first tokens again; prints the export's synchronous cost.
4. train   — `Trainer` on llama3-1b at full width (fp32 masters, bf16
             activations, full remat, chunked CE in 16 chunks, AdamW
             warmup 10 / total 1000), random weights from seed 0, batch
             2 x 2048 tokens from numpy seed 0 with rolled targets.
             First the gradients at the initial weights through the
             flash kernels against the plain attention path's (and two
             controls: P rounded to bf16, and a dQ that misses each
             query's own key, which the check must catch); then three
             steps through the plain path, and from the same weights
             two uncounted and 6 counted steps through the kernels,
             every launch counter set to 0 just before and read just
             after. Checks the kernels ran exactly as the design implies
             (32 forward, 16 dQ, 16 dK/dV launches a step), the losses
             are finite and fall, and the first three agree with the
             plain path's (lr is 0 on the first update, as in optax, so
             loss 3 is the first after an update); prints step time,
             tokens/s, model-FLOPs utilisation and peak memory, then
             profiles one more step. The trainer's obs bridge (its own
             registry and tracer) over those 9 steps:
             `train_step_seconds` counts each, `train_compile_seconds`
             the first, `train_recompiles_total{fn="train_step"}` is 0,
             one `train.step` span a step (`compile` on the first only),
             `train_step_phase_seconds` holds `step` (9) and `host_gap`
             (8).
5. one-shot — llama3-8b (random, seed 0) served in-process by
             `create_serving_app` in its default mode (50 ms window
             batcher, 8 rows, `warmup=True`: start-up captures the decode
             step graph of rows 1, 2, 4 and 8) with a llama3-1b draft
             (seed 1); counters set to 0 just before and read just after
             8 concurrent single prompts (17, 45, 60, 90, 130, 200, 300
             and again 17 tokens; max_new 32, logprobs), one explicit
             2-row batch (direct path) and one `speculative` request
             (gamma 4). Checks the one-shot decode replayed its graph 31
             times per call and captured nothing in traffic,
             `decode_attention` launched exactly 32 x 31 times per
             one-shot call and 16 x (gamma + 1) per speculative round
             (the draft's steps stay eager), no other kernel ran, the
             repeated prompt's tokens are identical, every
             non-speculative logprob is within 0.1 of a teacher-forced
             pass of the plain dense 8B over the unpadded prompt, every
             token is its argmax wherever the top-2 margin exceeds 0.2,
             and llama3-1b with its lm_head x50 drafting for itself
             equals its greedy output at acceptance 1.0. Prints host ms
             per decode step of the window batch, speculative and
             target-alone tokens/s at batch 1, peak memory, and profiles
             one window-batch call.
6. gemma  — gemma-2b at full width and depth (18 layers, hidden 2048,
             8 / 1 heads, hd 256, vocab 256128, bf16, tied fp32 head),
             random weights from seed 0, served three ways with phase
             3's and phase 5's checks: continuous with chunked prefill
             and with monolithic admission (as phases 3 and 3b: 8
             slots, block 64, `--warmup`, depth 2; 18 paged decode
             launches per dispatched step and 18 prefill-append launches
             per slice; cache hits on the repeated pass; the eager
             control), then one-shot (as phase 5 without the draft: the
             window batch of 8 and a 2-row direct batch; 18 dense decode
             launches per replayed step). Logprobs within 0.1 of a
             teacher-forced pass of the plain gemma model.
7. train gemma — gemma-2b trained as the reference trains it:
             `Trainer(apply_fn=lambda p, t: gemma.apply(p, cfg, t))` at
             full width and depth, fp32 masters, bf16 activations, remat
             of every block, dense CE over the tied fp32 head, AdamW
             (warmup 10 / total 1000), random weights from seed 0, batch
             2 x 2048 from numpy seed 0 with rolled targets. Gradients at
             the initial weights through the flash kernels (hd 256, group
             8) against the plain attention path's, and a dQ that misses
             each query's own key, which the check must catch (so a
             tolerance below the kernels' noise or above that fault fails
             the phase); three plain-path steps, then from the same
             weights two uncounted and 4 counted steps through the
             kernels, counters set to 0 just before and read just after:
             36 forward, 18 dQ and 18 dK/dV launches a step, losses
             finite and falling, the first three within 1e-3 of the
             plain path's; prints step time, tokens/s, MFU (6 N T, N =
             2,506,434,560) and peak memory, then profiles one more step.
8. door    — checkpoints from trainer to server, then the replica's
             request door. Phase 4's llama3-1b trainer (full width and
             depth unless the disk under build/ cannot hold the 12-byte
             a parameter state: then depth is cut and logged) takes two
             steps at batch 2 x 2048, saves asynchronously (a BPE the
             port fits at vocab 512 on README.md carried beside it) and
             waits; a fresh Trainer restores it to the host, every
             tensor bit-equal; one step from the in-memory state and one
             from the restored state give identical losses (4 steps: 32
             / 16 / 16 flash launches a step). Prints bytes written,
             save, wait and restore seconds. Then the CLI's own loader
             (`--checkpoint build/ckpt --tokenizer auto --continuous
             --warmup --prefill-chunk-tokens 64`, depth 2) serves it
             over HTTP, counters set to 0 just before the traffic and
             read after: (a) a 300-token prompt streamed with 64 new
             tokens equals the non-streamed greedy tokens and a control
             app's on the in-memory params; (b) 8 concurrent streams
             (17-300 prompt tokens) print client TTFT and ITL, median
             and p95; (c) tokens 20-21 of (a) as `stop` trim as
             `_apply_stop` does and retire the slot (emitted tokens end
             at the stop, at most depth x chunk decoded past it); (d)
             `text` through the BPE decodes as the tokenizer does; (e)
             `:score` of the prompt and its continuation within 0.1 of
             the teacher-forced plain pass and of (a)'s logprobs; (f)
             (a)'s timeline by its X-Request-Id holds 64 token stamps;
             (g) `/metrics` counts TTFT for every answered request, ITL
             for every decode token and the prefix hits the prompts
             reckon; exact paged launches (16 per decode step and per
             slice); (i) `adapter` and `stream` + `stop` get the
             reference's 400s. (h) a one-shot app (window batcher) on
             the same params streams a request equal to
             `engine.generate`'s tokens, `decode_attention` exactly 16 x
             63 per call. The checkpoint is deleted at the end.
9. spec   — continuous speculative decoding: the CLI's app (`--model
             llama3-8b --random --seed 0 --continuous --warmup
             --prefill-chunk-tokens 64 --spec-decode --draft-model
             llama3-1b --spec-gamma 4`: 8 slots, max_len 1024, the
             draft random at seed 1), counters set to 0 just before the
             traffic and read just after: 8 concurrent greedy prompts
             (17, 45, 60, 90, 130, 200, 300 and again 17 tokens, max_new
             32), then a 992-token prompt (prompt + max_new == max_len),
             the 300-token prompt again (a radix hit seeding 299 cells)
             and a sampled request (temperature 0.8, top_k 20). Checks no
             graph is captured in traffic, exact launches
             (`paged_prefill_append` 32 x (verify rounds + slices),
             `decode_attention` 16 x (gamma + 1) per round,
             `paged_decode_attention` 0), the repeats' tokens identical,
             logprobs within 0.1 of the teacher-forced plain dense 8B
             and the argmax where the top-2 margin exceeds 0.2, every
             sampled token in the teacher-forced top 20 (boundary ties
             within 0.05). Then `POST /v1/spec {"enabled": false}`: the
             same 8 prompts decode through the plain graph chunks (paged
             decode launches, no round), their tokens part from the
             spec pass's only at near ties; `GET /v1/spec` reports it;
             spec back on once drained. `/metrics` carries the
             `serving_spec_acceptance` burn rates, one event per
             proposed draft token. The switch-off wave starts from a
             flushed radix cache, as the spec wave did; one round is
             profiled in a wave of its own that nothing times. A
             self-draft control (llama3-1b, lm_head x50, drafting for
             itself): in fp32 it accepts every proposal and equals the
             plain batcher's tokens; in bf16 it accepts at least 0.8 of
             them and parts from the plain batcher's tokens only where
             the teacher-forced margin is at most 50 x 0.2. Prints
             rounds and acceptance, host ms a round, tokens/s of both
             waves whole and of their decode alone, the device-busy
             share of the profiled round and peak memory.
10. tenants — (a) llama3-1b as a multi-tenant replica: the CLI's app
             (`--model llama3-1b --random --seed 0 --continuous
             --warmup --prefill-chunk-tokens 64 --max-batch 2 --tenants
             FILE`, depth 2, max_len 1024; tenants `live` interactive,
             `bulk` batch, `iso` standard with prefix isolation,
             `paced` at 0.5 requests/s, burst 1). Four waves, counters
             set to 0 just before each and read just after: the oracle
             (bulk's 300- and 130-token prompts alone, 96 new; then a
             flushed cache), contention (both bulk prompts together;
             once both have emitted 16 tokens, `live` sends 17 tokens,
             16 new), isolation (`iso` sends the 300-token prompt) and
             throttling (`paced` twice, back to back). Checks at least
             one preemption, of the younger bulk request, whose
             re-admission reuses at least 64 x floor((len(kv_toks) -
             1) / 64) cells; exact launches (16 paged decode a
             dispatched step, 16 prefill-append a slice, slices as the
             admit and resume events reckon); no capture in traffic;
             bulk's outputs equal the oracle up to the first position
             whose teacher-forced top-2 margin is at most 0.2 (logged
             with its margin), every logprob within 0.1 of the teacher;
             `iso` misses bulk's cache and gives its tokens by the same
             rule; `paced`'s second request 429 with Retry-After >= 1;
             `/metrics`' tenant preemptions, tokens and rate throttles
             equal the traffic; the block ledger conserved. (b) the
             instant drain: replicas A and B from the CLI (4 slots,
             chunk 64, `--warmup`, depth 2) served on local ports. B's
             oracle (prompts of 17, 130, 300, 520 and 64 tokens, 96
             new, one at a time; then a flushed cache). Wave M1 at
             batcher level: A streams the five, four admitted, read to
             70, 40, 5 and 0 tokens; A's `export_sequences()`; each
             record into B's `import_sequence` (adopted blocks = n_full,
             B's blocks bit-equal to A's and to the wire's), resumed
             through B's `:generate` (cells reused >= 64 x n_full,
             exact launches, the tie rule against the oracle, logprobs
             against the teacher); A holds no block. Wave M2 over HTTP:
             four streams and a plain request on A, then `POST
             A/drain {"migrate": true, "peers": [B]}`: migrated 5,
             failed 0, every stream ends with its MigratedAway event,
             the plain request 503 `migrated`, A's `/healthz` 503, B's
             migration counters equal A's. B's refusals: a wedged
             record 500 and a gemma-2b geometry 400 with the free
             blocks unchanged; `/v1/blocks/export` of the cached
             300-token prompt equal to B's pool, 404 uncached, 400 bad
             hash; both ledgers conserved. Prints the synchronous
             export and import ms a block and the card.
11. fleet  — the fleet plane: replicas P (`--pool prefill`) and D
             (`--pool decode`, a 1 GiB host spill tier), llama3-1b from
             the CLI (`--random --seed 0 --continuous --warmup
             --prefill-chunk-tokens 64 --max-batch 4 --fleet-router URL
             --advertise URL --model-version v1`, depth 2), registered
             with a stub router inside this script that records every
             register, heartbeat and deregister body. Counters set to 0
             before each wave and read after. (a) five prompts of
             phase 10's lengths (17-520 tokens) to P's `:prefill` with
             `peer` D: blocks and handoff as the lengths give (0 for 17
             tokens), 19 prefill slices on P and no decode step, D's
             imported blocks bit-equal to P's; then `:generate` on D (96
             new):
             cells reused exactly min(64 n, len - 1) a prompt, 5 tail
             slices, exact launches, tokens equal P's own `:generate` or
             part at a near tie (`_tie_rule`), logprobs against the
             teacher. (b) three new prompts to D with `X-KV-Peer`: one P
             served (`ok`, 64 x n cells `peer_fetched`), one P never saw
             (`miss`), a dead URL (`failed`), all with P's tokens by the
             same rule; a fourth fetch timed alone. (c) `/v1/reload
             {"version": "v2", "source": {"seed": 7}}` on D: every
             parameter's `data_ptr()` and every graph runner kept, no
             capture, the radix, spill tier and prefix memo empty, a
             registration with version v2 at the stub before the answer;
             the replayed tokens pass the teacher check against
             `init(cfg, 7)` built apart and differ from seed 0's; an
             empty source answers 400 and changes nothing; a planted
             `ttft_delay_s` 1 lifts TTFT past 1 s and the next reload
             heals it. (d) each replica beats within a quiet 2.5 s with
             the reference's keys, its pool, P's prefill and D's decode
             seconds above 0, P's heat digest non-empty, and each
             deregisters at cleanup. Prints the handoff and fetch ms a
             block, `reload_s` and both replicas' phase totals.
12. quant  — (a) the CLI's app `--model llama3-8b --random --seed 0
             --quant int8 --batch-window-ms 50 --max-batch 8` (the CLI
             refuses `--warmup` without `--continuous`, as the
             reference's: the decode graphs of rows 1, 2, 4, 8 are warmed
             as `create_serving_app(warmup=True)` warms them): every
             block matrix int8 on the card and `param_bytes` as
             reckoned; one 300-token prompt's prefill logits within 0.05
             max|l| of the bf16 model's at the same seed (128
             `int8_proj` launches); counters set to 0 just before eight
             concurrent prompts (17-300 tokens, 32 new) and read just
             after: `int8_proj` 4 x 32 a forward and a decode step,
             `decode_attention` 32 a step, nothing else, no capture in
             traffic, the repeated prompt's tokens identical, logprobs
             within 0.1 of a teacher-forced plain pass over the int8
             weights (argmax where the margin exceeds 0.2), an
             `adapter` refused 400 (no pack). Prints the window
             prefill's `int8_proj` device time (its trace, 128
             launches), the device ms a decode step (profiled calls to
             9 and 1 token) beside phase 5's bf16 step and peak memory.
             (b) llama3-1b continuous
             through `create_serving_app` (8 slots, chunk 64, warmed,
             depth 2) with a pack of three adapters (rank 8, alpha 16,
             the seven targets, B non-zero), once in bf16 and once over
             `quantize_blocks`: eight concurrent rows mixing the base and
             the adapters (16 new), exact launches (16 paged decode a
             step, 16 prefill-append a slice, `int8_proj` 4 x 16 a step
             and a slice in the int8 pass), no capture in traffic; one
             200-token prompt as base, alice, alice again reuses 0, 0
             and 192 cells (the radix keys adapters apart) with alice's
             tokens identical; every row within 0.1 of a teacher-forced
             plain pass over its merged weights (int8: the dequantized
             base plus the scaled delta); the 400s of an unknown name, a
             non-string and `speculative`. Prints host ms a decode step
             beside phase 3's and the device busy share.
13. replay — llama3-1b from the serving CLI (`--random --seed 0
             --continuous --warmup --prefill-chunk-tokens 64 --max-batch
             8`, depth 2) in a subprocess (`--replica`: every launch
             counter set to 0 after the warmup, the counts written at
             shutdown), so the client threads share no interpreter with
             the server. First the tracer doors: a request's root
             `http.request` carries the `X-Trace-Id` the client got, with
             `batcher.submit` and the batcher's `decode.attention` chunks
             under it, a stream's root holds `stream.continuous`, a valid
             `X-Trace-Id` / `X-Parent-Span` pair is adopted and a
             malformed one replaced, `?limit=x` is a 400, the counter
             tracks carry the model's name. Then three traces from
             `kubeflow_tpu_torch.scenarios` (`heavy_tail` seed 0, n 120,
             8 rps, prompts to 900 tokens, 32 new; `agent_swarm` and
             `abandon_retry` seed 0 at their defaults) replayed open-loop
             through `HttpTarget` (SSE, TTFT at the first frame, hang-ups
             at `abandon_at`): each meets its `expect` block; the compile
             watch (`/debug/profile`'s `recompiles`, equal to
             `serving_recompiles_total`) reads the same before and after;
             no slot is held after; the block ledger is conserved with
             `serving_kv_evictions_total` summing to its frees and
             `unattributed` 0; `record` of the run off
             `/v1/requests/timelines` gives a trace `describe` reads with
             every request sent. At exit: exact paged launches (16 a
             decode step, 16 a slice) and no capture in traffic. Prints
             each replay's summary, phase 3's host ms a decode step with
             the tracer attached and detached, and the card.
14. moe    — the MoE family (models/llama_moe.py, `MOE_LLAMA_FAMILY`) at
             Mixtral-8x7B's widths and 16 of its 32 layers (hidden 4096,
             32/8 heads of 128, 8 experts, top 2, expert width 14336,
             vocab 32000, bf16; random, seed 0, the expert stacks drawn
             a layer at a time): 46.44 GB of block weights. Served three
             ways by one engine, as phase 6 serves gemma-2b: continuous
             chunked (64-token slices) and monolithic through the app the
             CLI would build (8 slots, `--warmup`, depth 2), then one-shot
             (window batcher at 8 rows, direct 2-row batch), 16 new
             tokens a request. The checks of phases 3 and 6 (exact
             launches: 16 paged decode a dispatched step, 16
             prefill-append a slice, 16 dense decode a one-shot step; no
             capture in traffic; the repeated prompt; graph against
             eager; `/v1/models` reporting `llama-moe`), with the
             teacher-forced pass through `llama_moe.apply` at capacity E
             / k: served logprobs within 0.1, the argmax where the top-2
             margin exceeds 0.2, at every position whose smallest router
             gap (k-th minus (k+1)-th probability, over the layers) is at
             least MOE_GAP_TOL; the positions under it are excused and
             printed; a position past a limit is served again alone by
             an eager copy of the engine, and its experts at each layer
             printed beside the teacher's: excused if the served path
             chose other experts (a route flip), else a failure; at most
             10% of the phase's distinct positions excused; a control
             with the gates renormalised over the k chosen must exceed
             0.1. Prints the load seconds and peak memory, a
             one-shot decode step's device ms (graph replay) against the
             13.86 ms bound of its block weights, the same step of an
             eager engine split into expert products (`aten::bmm`),
             decode attention kernel and the rest, one layer's expert
             products graph-replayed, how many of the 8 experts each
             decode step's layers route to, and the phase's seconds.
             Then the same bf16 base with a pack of three attention-only
             adapters (wq, wk, wv, wo; rank 8): phase 12b's eight rows
             served continuously, exact paged launches, each row
             against the plain MoE model on its merged weights. Then
             the weights under --quant int8 (expert stacks per expert
             and output channel, the router kept; param bytes as
             reckoned), served continuously chunked (the checks above,
             the teacher on the same int8 weights) and one-shot.
15. train  — (a) the MoE family at Mixtral-8x7B's widths (hidden 4096,
             32/8 heads of 128, 8 experts, top 2, expert width 14336,
             vocab 32000, capacity factor 1.25, aux weight 0.01), at the
             depth the card's free memory holds (20 bytes a block
             parameter, 16 an embedding or head one, a margin: 2 of 32
             layers on an 80 GB card), fp32 masters, bf16 activations,
             AdamW, full remat, batch 2 x 2048. First the loss and every
             gradient leaf at the initial weights at fp32 activations:
             the kernel path (the fp32 flash kernels) routed as the
             plain attention path routed, against it (MOE_GRAD_TOL); the
             routes that would differ are counted and allowed only at
             router gaps under MOE_ROUTE_GAP_TOL; a control with the aux
             term's gradient detached must exceed the bound on the
             router. Then 6 steps: exact flash launches (per layer and
             step 2 forward, 1 dQ, 1 dK/dV), dropped choices and the
             routed-expert histogram per layer, step ms, tokens/s, peak
             memory, and MFU from the FLOPs the step runs (expert
             products at capacity) beside the reference's 6 N T.
             (b) llama3-1b at phase 4's configuration under the remat
             policies full, mlp and dots: loss and gradients against
             full (REMAT_GRAD_TOL), the `aten.mm` calls each backward
             reruns (6, 4 and 0 a layer), the GEMM kernels of forward
             and backward, 32 flash forwards a step under each, step ms
             and peak memory. (c) llama3-1b at full width and depth: 4
             Adafactor steps (loss falls; state bytes against AdamW's
             9.9 GB; a checkpoint under build/ckpt/ restored bit-equal,
             the next step equal to the uninterrupted one), then LoRA
             (rank 8, the seven targets) over a frozen fp32 base for 8
             steps (loss falls, base bitwise unchanged, adapter-only
             moments), the trained adapters then served as a pack
             through the continuous app (exact paged launches, logprobs
             and argmax against the merged model).
Phase 16:    single-card models and the data path. (a) The data story
             at llama3-1b: `tools.prepare_data` on a fixed list of the
             repository's markdown that its work does not rewrite
             (CORPUS_FILES; BPE at vocab 1024, KTSH shards of ~65,536
             tokens under build/phase16/, the last held out), the native
             word encoder's ids against the Python loop's over every
             word of the corpus (both rates), the native
             loader's first 16 batches against PyTokenLoader's and a
             resume ticket, then phase 4's configuration trained 8 steps
             from the native loader and 4 from PyTokenLoader at its
             ticket, each batch through the loader's `next_batch_on`
             (exact flash launches, the loss falling, no batch
             repeated, host_gap for each loader), and `tools.eval_ppl`'s
             function on the held-out shard at seq 2048 for the trained
             and the initial weights (16 flash forwards a batch, no
             backward; the trained perplexity lower). (b) ViT-B/16 at
             full width and depth: loss and every gradient leaf on the
             card against the CPU at fp32 after one step, then bf16 at
             batch 64 through the Trainer (images/s, StepTimer, MFU by
             bench.py's accounting, peak memory, time to the first step,
             the loss falling on a fixed synthetic batch, no kernel
             launched). (c) The MNIST MLP smoke (test accuracy >= 0.90),
             its images/s at bench_mnist's 200 steps x 256, and a TPE
             sweep of the learning rate over 8 shortened smokes.
Phase 17:    the distributed set (kubeflow_tpu_torch/parallel/,
             train/fsdp.py, models/llama_pp.py) in gangs of worker
             processes (`--dist-worker`) on cuda:0 in a gloo group over
             a file:// store, their collectives staged through host
             memory (NCCL refuses two ranks of one device; the staged
             time is logged apart). (a) Ring flash attention over 4
             ranks at llama3-1b's attention (n_q 16, n_kv 8, hd 128),
             bf16, b 1, s 8192 (2048 a rank), causal and bidirectional,
             forward and backward: o within 2^-8 max|ref| + 2^-7 |ref|
             of one-device flash_attention over the whole sequence and
             of the plain ring, gradients within TRAIN_GRAD_TOL, flash
             launches over the ranks exactly 10 forward, 10 dQ and 10
             dK/dV causal (rank r runs r + 1: its future blocks are
             skipped) and 16 each bidirectional (the off-diagonal blocks
             non-causal, the backward against the merged (o, lse)).
             (b) Ulysses (impl "flash") at the same shapes against the
             same result. (c) llama3-1b at full width and FSDP_LAYERS
             of its 16 layers (depth cut for the phase's time), FSDP on
             (data 1, fsdp 2), global batch 2 x 2048, 3 steps from the
             weights of a one-device Trainer run on the same batch:
             losses within TRAIN_LOSS_TOL, optimizer state a rank half
             the one-device run's, exact flash launches; a rank's peak
             memory below the one-device run's by at least half its
             params and moments, and a forward through the mesh view
             leaving for its backward no more than the plain model's
             forward on the same rows plus the leaves gathered once and
             one layer (a gathered layer must not outlive its block). (d)
             PipelineTrainer on llama3-1b over 2 stages, 4 microbatches:
             the loss against the dense forward's, flash launches as the
             schedule implies. (e) One MoE layer at Mixtral-8x7B's
             widths, 4 experts on each of 2 ranks, forward and backward
             against `moe_mlp` on each rank's token block. (f) Tensor
             parallelism in the mesh trainer on (tensor 2): llama3-1b at
             full width, FSDP_LAYERS layers, 3 steps from (c)'s weights
             and batch, losses within TRAIN_LOSS_TOL of (c)'s one-device
             run, exact flash launches (12 forward, 6 dQ, 6 dK/dV a
             rank), wq held as [2, 2048, 1024], a rank's peak below the
             one device's by at least half the tensor-cut leaves'
             params and moments; gemma-2b's widths at 2 of 18 layers
             (its one KV head held whole), TP_GEMMA_STEPS steps against
             a one-device run of the same. (g) The mesh trainer's
             recipes on (tensor 2), RECIPE_STEPS steps each against one
             device: llama3-1b at (c)'s depth under Adafactor (losses
             within RECIPE_LOSS_TOL, wq's gathered v_row the one
             device's shape) and under AdamW at grad_accum RECIPE_ACC
             (within RECIPE_LOSS_TOL of (f)'s full-batch run on the same
             mesh, TRAIN_LOSS_TOL of (c)'s one-device run);
             Mixtral-8x7B's widths at the depth the card holds for both
             ranks (15a's batch, seed and config; 15a's first
             RECIPE_STEPS steps are the yardstick where it ran at that
             depth, else a one-device run before the gang), the ranks
             forced onto the yardstick's routes (at the initial
             weights at most MOE_EXCUSE_MAX of their own routings
             choose other experts: rounding moves near-ties only),
             losses within TRAIN_LOSS_TOL, w_gate [L, 4, 4096, 14336] a
             rank, the router moved, a rank's peak below one device's;
             ViT-B/16
             (6 heads and 500 classes a rank) against a one-device run;
             exact flash launches. Then the ring and an FSDP step on a
             one-rank NCCL group (its process runs beside the ring
             gang and is awaited before 17g-b reckons its depth).
Phase 18:    fp32 flash at head dim 256 on a path, and the elastic
             trainer fleet (train/elastic.py, train/goodput.py,
             train/checkpoint.py over the mesh trainer,
             tools/memplan.py). (a) gemma-2b's widths at
             dtype=float32, 2 of its 18 layers, batch 1 x 2048, 3 steps
             through the fp32 flash kernels at head dim 256 against the
             plain attention path from the same weights (TRAIN_LOSS_TOL;
             exact launches). (b) `elastic._build_trainer(1, llama3-1b)`
             at phase 4's 2 x 2048 under a GoodputLedger and the
             Checkpointer: 4 steps with a save at step 2, then a rebuild
             and `restore_or_init` as a restarted worker does and steps
             3-4 again (booked to replay, their losses within
             ELASTIC_LOSS_TOL of the first run's; the ledger's causes
             within 1% of its wall; exact launches; save, wait and
             restore seconds, bytes written, the goodput fraction). (c)
             a 2-rank gloo gang on cuda:0, llama3-1b at full width and
             FSDP_LAYERS layers on (data 2) with ZeRO moments, 3 steps
             and a save; one device restores it (moments bit-equal to
             the gang's gathered ones, the resize logged) and takes 2
             steps against the gang's own 2 (TRAIN_LOSS_TOL). (d) the
             coordinator CLI (--min-replicas 2) and 3 worker CLIs on
             cuda:0 at the reference's defaults (llama-tiny, batch 12,
             seq 16, 16 steps, a save every 4, a 1 s slow save); the
             chief is SIGKILLed while /elastic/world shows it saving step
             8 (or a later save); the survivors restart from the last committed step and
             finish; one restart, a later generation, every loss line
             against a one-worker uninterrupted run (ELASTIC_LOSS_TOL),
             /elastic/metrics federating both survivors, /elastic/traces
             merging their tracks, each survivor's goodput book. (e)
             `memplan.plan` for phase 4's run beside phase 4's measured
             peak (a finding: the planner's budget is a TPU chip's).
Phase 19:    tensor-parallel serving (serving/gang.py, the engines at
             tensor > 1): two worker processes (`--dist-worker
             serving`) on cuda:0 in a gloo group, each holding its
             rank's cut of random weights from seed 0, rank 0 running
             the HTTP app and the batcher, rank 1 following its device
             calls; eager (graphs are refused at tensor > 1). First the
             one-device yardsticks in this process (greedy tokens and
             the teacher-forced plain pass), then the card is freed
             for the ranks. (a) llama3-1b continuous, 8 slots, chunked
             prefill: phase 3's four requests, the 130-token prompt
             again (a radix hit, the same tokens), a decode step and a
             prefill slice timed alone with their staged collectives,
             then a monolithic wave through a second batcher; (b)
             gemma-2b (one KV head held whole, the 256,000-token
             vocabulary cut in two) one-shot, a direct 2-row request
             through the app. Checks: every rank's tokens rank 0's;
             served tokens the one-device run's, logprobs within
             LOGPROB_TOL of the teacher-forced pass, to the first token
             that differs, which must sit at a top-2 margin of at most 2
             x LOGPROB_TOL (bf16 exit sums round once per rank); exact
             launches a rank (16 paged decode a decode step, 16
             prefill-append a slice, 18 dense decode a one-shot step);
             no graph captured; a rank's KV bytes against one device's;
             a control in which rank 1 drops layer 0's attention exit sum
             during a one-shot generate must fail the check. Phase 2's
             tensor-2 serving lines check the three kernels at the
             ranks' heads (llama3-1b 8 / 4, llama3-8b 16 / 4, gemma-2b 4 /
             1 at hd 256).
Phase 3 also times the tracer: the same cold requests twice with the
app's tracer detached and twice attached, host ms a decode step each.
Then prints the `kernels` JSON line (launches: the paged kernels' over
phases 3, 3b, 3c, 8, 9's spec-off pass, 10, 11, 13, 14 and 15c, each
other kernel's over its phases (4, 8, 15b, 15c, 16a and 17's ranks for
flash, 5, 8, 9 and 14 for dense decode); each kernel
again as `<name>@gemma-2b`, timed in phase 2 at gemma-2b's shapes and
counted over phase 6, or phase 7 for the flash kernels; the flash
kernels as `<name>@fp32-256`, timed in phase 2 in fp32 at gemma-2b's
shapes and counted over phase 18a (18b and 18c count under the plain
names), and as `<name>@fp32-128`, timed in phase 2 in fp32 at
llama3-1b's shapes and counted over phase 15a's fp32 gradient pass; the
flash kernels as `<name>@mixtral`, timed in phase 2 at Mixtral's attention
and counted over phase 15a (15b and 15c count under the plain names,
15c's serving under the paged kernels'); and
`paged_prefill_append@verify`, timed at the verify pass's shape and
counted over phase 9's verify rounds, whose prefill slices count under
`paged_prefill_append`; `int8_proj`, no Pallas kernel's port (it replaces
the reference's `qdot`), timed as one llama3-8b decode layer's four
launches and counted over phases 12 and 14, with its kernel functions;
`paged_decode_attention@llama3-1b-tp2` and
`paged_prefill_append@llama3-1b-tp2`, timed in phase 2 at a tensor-2
rank's llama3-1b heads and counted over phase 19a's ranks, and
`decode_attention@gemma-2b-tp2`, timed at a rank's gemma-2b heads and
counted over phase 19b's ranks), the card's name and power limit,
and last `{"ok": true, "device": {...}}`.

Exits non-zero without a result when CUDA is unavailable or the port's
package is not beside this script. `--phases 1,8` runs only the phases
named (a debugging call: it prints no result line). `--replica OUT --
<serving CLI args>` is phase 13's server process and `--dist-worker
CASE RANK WORLD STORE OUT BACKEND` one rank of the gangs of phases 17,
18 and 19, not smoke runs.
"""

from __future__ import annotations

import asyncio
import atexit
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import time
import weakref
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))

# llama3-1b serving geometry (models/llama.py, serving defaults)
N_Q, N_KV, HD, BS, MAX_LEN, SLOTS, CHUNK = 16, 8, 128, 64, 1024, 8, 64
NB = MAX_LEN // BS                 # blocks per slot
NUM_BLOCKS = 1 + SLOTS * NB        # trash + every slot at max_len
LAYERS = 16
HBM_BYTES_S = 3.35e12              # H100 SXM device memory rate
BF16_FLOPS_S = 989e12              # H100 SXM dense bf16 tensor rate
FP32_FLOPS_S = 67e12               # H100 SXM fp32 on the CUDA cores
# Decode kernels vs plain versions, bf16: both accumulate in fp32 and
# round the result once, so they differ by at most one bf16 ulp of it
# (<= 2**-7 of its value); the absolute floor covers fp32 summation
# order near 0. A cell dropped or added on a 1000-cell row (an error of
# ~|v|/1000, up to ~3e-3) exceeds it. The bf16 prefill kernel rounds P
# to bf16 on the tensor cores: it holds the flash kernels' bf16 bound
# below, with mag = |P| |V| (`prefill_bf16_slack`).
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 2**-7
TOL_TEXT = f"tol {KERNEL_ATOL} + 2^-7 |ref|"
BF16_TOL_TEXT = "tol 1e-4 max|ref| + 2^-7 |ref| + 2^-8 mag"
# Flash kernels vs plain versions: |err| <= c * max|ref| + rtol * |ref|.
# Both accumulate in fp32; sums over up to 2 s terms taken in another
# order differ by a small multiple of fp32 epsilon times the size of the
# terms, which max|ref| bounds (c = 1e-5 fp32, 1e-4 bf16); a bf16 result
# is rounded once by both, so they may differ by one bf16 ulp of it
# (rtol 2^-7); fp32 rtol 1e-4. lse is fp32 for both dtypes: 1e-5 max|ref|.
# The bf16 forward, dQ and dK/dV kernels run on the tensor cores and round
# P, dS, P^T and dS^T to bf16 before their products: each rounded term
# errs by at most 2^-8 of itself, so their bound adds 2^-8 times the sum
# of the product's absolute terms (`flash_bf16_slack`). A plain forward,
# dQ and dK/dV that leave out each query's own key must exceed it (the
# control).
FLASH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 2**-7)}
BF16_ROUNDING = 2**-8
# device ms of the first, CUDA-core flash kernels at the causal bf16
# training shape, recorded on an NVIDIA H100 80GB HBM3 at 700 W
CUDA_CORE_MS = {"fwd": 1.3685, "dq": 1.8999, "dkv": 2.4789}
FLASH_B, FLASH_S = 2, 2048         # llama3-1b training batch (bench.py)
# name: (s, causal, window)
FLASH_CASES = {"causal": (FLASH_S, True, None),
               "window_700": (FLASH_S, True, 700),
               "noncausal": (FLASH_S, False, None),
               "odd_s1000": (1000, True, None)}
TRAIN_STEPS = 6                    # counted, after two uncounted steps
GEMMA_TRAIN_STEPS = 4              # phase 7: the same, at gemma-2b
GEMMA_2B_PARAMS = 2_506_434_560    # the tied head counted once
# Kernel path vs plain path. Gradients at the initial weights, worst
# leaf (per layer for block leaves) by relative L2 error: read 1.92e-2
# on an H100 80GB HBM3, the bf16 noise of this model (the bf16-P
# control reads 2.25e-2), while a dQ that misses each query's own key
# reads 0.237; the limit sits between, 2.6x the reading and 4.7x below
# that fault. The first three losses from the same weights on the same
# batch: read 1.54e-4 (loss 3, the first after an update, 1.9e-5);
# limit 6.5x that.
TRAIN_GRAD_TOL = 0.05
TRAIN_LOSS_TOL = 1e-3
LOGPROB_TOL = 0.1                  # served vs teacher-forced
PROMPT_LENS = (17, 130, 300, 17)
MAX_NEW = 16
# phase 3c: four prompts on one shared prefix, and a prompt of a whole
# number of blocks sent again (its repeat seeds all but its last cell)
SHARED_PREFIX, SUFFIX_LENS, REPEAT_LEN = 320, (20, 40, 70, 100), 256
SPILL_BLOCKS = 32                  # host tier budget of phase 3c's spill run
# llama3-8b one-shot serving (phase 5): 32 layers, 32/8 heads, hd 128
DENSE_LAYERS, DENSE_NQ, DENSE_B = 32, 32, 8
DENSE_PROMPTS = (17, 45, 60, 90, 130, 200, 300, 17)   # the last repeats
DENSE_BUCKET = 512                 # bucket_pow2 of the longest prompt
DENSE_MAX_NEW = 32
WINDOW_MS = 50.0
GAMMA = 4
DECODE_SPLITS = (64, 128, 256)     # paged decode cells a split, timed
DENSE_SPLITS = (64, 128)           # dense decode cells a split, timed


class Geom(NamedTuple):
    """A served model's attention geometry, for phase 2's kernel cases.
    `repeat_kv`: the SDPA yardstick gets K/V repeated over the GQA group
    (gemma) instead of `enable_gqa` (llama, as in its earlier timings)."""
    model: str
    n_q: int
    n_kv: int
    hd: int
    layers: int
    repeat_kv: bool = False


LLAMA_1B = Geom("llama3-1b", N_Q, N_KV, HD, LAYERS)
LLAMA_8B = Geom("llama3-8b", DENSE_NQ, N_KV, HD, DENSE_LAYERS)
# gemma-2b (phase 6): 18 layers, 8 query heads over one kv head of 256
GEMMA_2B = Geom("gemma-2b", 8, 1, 256, 18, repeat_kv=True)
# a rank's heads at tensor 2 (phases 17f and 17g): llama3-1b's cut on
# whole heads (group 2), gemma-2b's query heads over its one KV head held
# whole (group 4, whose dK/dV subgroups no other case picks), Mixtral's
# cut on whole heads (group 4 over half the KV heads of phase 2's
# `@mixtral` case)
TP2_SHAPES = (Geom("llama3-1b at tensor 2", N_Q // 2, N_KV // 2, HD, LAYERS),
              Geom("gemma-2b at tensor 2", 4, 1, 256, 18),
              Geom("Mixtral-8x7B at tensor 2", 16, 4, 128, 32))


# a rank's heads at tensor 2 on the serving paths (phase 19): llama3-1b
# cut on whole heads (n_q 8, n_kv 4: group 2), llama3-8b's (16, 4: group
# 4), gemma-2b's query heads over its one KV head held whole (4, 1: group
# 4 at head dim 256, which no served path ran before)
TP2_SERVING = (
    Geom("llama3-1b at tensor 2", N_Q // 2, N_KV // 2, HD, LAYERS),
    Geom("llama3-8b at tensor 2", DENSE_NQ // 2, N_KV // 2, HD, DENSE_LAYERS),
    Geom("gemma-2b at tensor 2", 4, 1, 256, 18, repeat_kv=True))

# suffix of a `kernels`-line name measured at gemma-2b's shapes (phase 2)
# and launched by phase 6
GEMMA = "@gemma-2b"
# suffixes of the serving kernels measured at a tensor-2 rank's heads
# (phase 2's check_serving_tp) and launched by phase 19's gang: llama3-1b
# continuous (paged decode, prefill-append) and gemma-2b one-shot (dense
# decode)
TP2 = "@llama3-1b-tp2"
GEMMA_TP2 = "@gemma-2b-tp2"
# suffix of the prefill-append kernel measured at the speculative verify
# pass's shape (phase 2) and launched by phase 9's spec waves
VERIFY = "@verify"
# suffix of the fp32 flash kernels measured at gemma-2b's head dim 256
# (phase 2) and launched by phase 18a's fp32 training
FP32_256 = "@fp32-256"
# the same at llama3-1b's head dim 128 (phase 2), launched by phase 15a's
# fp32 gradient pass at Mixtral's attention (group 4, hd 128)
FP32_128 = "@fp32-128"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 2 helpers -------------------------------------------------------


def _tables(gen, torch, rows, cells_needed, shared_prefix=0):
    """Per-row block tables over one pool: the first `shared_prefix`
    blocks shared by every row (radix/copy-on-write sharing, read-only
    below every row's cursor), the rest exclusive; trash-padded tails."""
    perm = torch.randperm(NUM_BLOCKS - 1 - shared_prefix,
                          generator=gen).tolist()
    free = [shared_prefix + 1 + b for b in perm]
    shared = list(range(1, shared_prefix + 1))
    table = torch.zeros(rows, NB, dtype=torch.int32)
    for r, cells in enumerate(cells_needed):
        n = -(-cells // BS)
        ids = shared[:n] + [free.pop() for _ in range(n - len(shared[:n]))]
        table[r, :n] = torch.tensor(ids, dtype=torch.int32)
    return table


def _chain_tables(gen, torch, starts):
    """Block tables of rows that each repeat a cached prompt of a
    multiple of 64 tokens, seeded from all but its last cell: row r
    shares the first starts[r] // BS blocks of one chain (read-only,
    strictly below its start) and owns the block its start falls in,
    which copy-on-write filled with the cells below the start."""
    free = (torch.randperm(NUM_BLOCKS - 1, generator=gen) + 1).tolist()
    chain = [free.pop() for _ in range(max(starts) // BS)]
    table = torch.zeros(len(starts), NB, dtype=torch.int32)
    for r, start in enumerate(starts):
        ids = chain[:start // BS] + [free.pop()]
        table[r, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return table


def _time_ms(torch, fn, n):
    """-> (device ms per call, host-clock ms per eager call). Device time:
    n calls captured in one CUDA graph and replayed between two CUDA
    events, so the host's per-call launch cost (the Python wrapper) is
    left out; the eager time includes it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capture stream
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3 / n
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return t0.elapsed_time(t1) / n, eager_ms


def _summary(kind, worst, kernel, plain, library_ms, bytes_moved, flops,
             library="SDPA", flops_s=BF16_FLOPS_S):
    """Log one kernel's timings and return its `kernels`-line numbers.
    The bound is the larger of bytes over the memory rate and flops over
    the inputs' peak rate (`flops_s`: the bf16 tensor rate unless
    given), for this run's inputs."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / flops_s * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    log(f"  {kind}: device {kernel[0]:.4f} ms (eager call {kernel[1]:.4f} "
        f"ms), plain {plain[0]:.4f} ms (eager {plain[1]:.4f}), {library} "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({bytes_moved:.0f} B, {flops:.0f} flop)")
    return dict(max_abs_err=worst, ms=kernel[0], plain_ms=plain[0],
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def _err(got, want):
    """-> (max abs error, max of error / (atol + rtol |ref|)); the second
    must stay <= 1."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return (float(d.max()),
            float((d / (KERNEL_ATOL + KERNEL_RTOL * w.abs())).max()))


def _visible(qpos, mask_row):
    """Cells a query at qpos sees without a window: causal and kv_mask."""
    return int(mask_row[:qpos + 1].sum())


def _sdpa_kv(torch, g, *kv):
    """K/V [b, n_kv, cells, hd] as the SDPA yardstick takes them: as they
    are (with enable_gqa) or repeated over the group."""
    if not g.repeat_kv:
        return kv
    return tuple(t.repeat_interleave(g.n_q // g.n_kv, dim=1) for t in kv)


def check_decode(torch, dev, g=LLAMA_1B, splits=DECODE_SPLITS):
    from kubeflow_tpu_torch.ops.cuda.paged_attention import (
        default_split_cells,
        paged_decode_attention,
        paged_decode_attention_plain,
        split_count,
    )

    kind = f"decode ({g.model})"
    gen = torch.Generator().manual_seed(1)
    dt = torch.bfloat16
    shape = (g.layers, NUM_BLOCKS, BS, g.n_kv, g.hd)
    kp = torch.randn(shape, generator=gen).to(dev, dt)
    vp = torch.randn(shape, generator=gen).to(dev, dt)
    q = torch.randn(SLOTS, 1, g.n_q, g.hd, generator=gen).to(dev, dt)
    pos = torch.tensor([16, 129, 300, 511, 64, 700, 1000, 1023],
                       dtype=torch.int32)
    cases = {
        "ragged": dict(shared=0, window=None),
        "cow_shared_prefix": dict(shared=2, window=None),
        "window_256": dict(shared=0, window=256),
    }
    worst = 0.0
    for name, c in cases.items():
        table = _tables(gen, torch, SLOTS, (pos + 1).tolist(),
                        shared_prefix=c["shared"])
        mask = torch.ones(SLOTS, NB * BS, dtype=torch.bool)
        mask[:, 5] = False            # a left-pad hole below every cursor
        args = (q, kp[0], vp[0], table.to(dev), pos.to(dev), mask.to(dev))
        want = paged_decode_attention_plain(*args, window=c["window"])
        got = paged_decode_attention(*args, window=c["window"])
        torch.cuda.synchronize()
        err, ratio = _err(got, want)
        log(f"  {kind} {name}: max_abs_err {err:.3e}, err/tol max "
            f"{ratio:.3f} ({TOL_TEXT})")
        if not torch.isfinite(got).all() or ratio > 1:
            fail(f"paged_decode_attention {name}: err {err} over {TOL_TEXT}")
        worst = max(worst, err)

    # timing on the ragged case, cycling the layers' pools as a decode
    # step does (working set > L2)
    table = _tables(gen, torch, SLOTS, (pos + 1).tolist()).to(dev)
    mask = torch.ones(SLOTS, NB * BS, dtype=torch.bool, device=dev)
    mask[:, 5] = False
    posd = pos.to(dev)
    split_ms = {}
    default = default_split_cells(g.n_q // g.n_kv, g.hd)
    for split in splits or (default,):
        split_ms[split] = _time_ms(torch, lambda i: paged_decode_attention(
            q, kp[i % g.layers], vp[i % g.layers], table, posd, mask,
            split_cells=split), 20 * g.layers)
        n_split = split_count(NB * BS, split)
        busy = sum(-(-(int(p) + 1) // split) for p in pos)
        log(f"  {kind} split of {split} cells: {n_split} splits a row, "
            f"{busy * g.n_kv} of {n_split * SLOTS * g.n_kv} blocks see a "
            f"cell; "
            f"device {split_ms[split][0]:.4f} ms (eager call "
            f"{split_ms[split][1]:.4f} ms)")
    log(f"  {kind}: the wrapper's default split for this head geometry is "
        f"{default} cells")
    ms, eager = split_ms[default]
    for part in ("split", "combine"):
        marker = f"decode_{part}_kernelI13__nv_bfloat16Li{g.hd}E"
        log(f"  ptxas, bf16 paged decode {part} kernel, hd {g.hd}: "
            f"{_ptxas('paged_decode_attention', marker)}")
    plain_ms, plain_eager = _time_ms(
        torch, lambda i: paged_decode_attention_plain(
            q, kp[i % g.layers], vp[i % g.layers], table, posd, mask), 32)
    # library yardstick: SDPA over K/V gathered beforehand (the gather is
    # not timed), boolean mask = causal & kv_mask
    kg = kp[0][table.long()].reshape(SLOTS, NB * BS, g.n_kv, g.hd)
    vg = vp[0][table.long()].reshape(SLOTS, NB * BS, g.n_kv, g.hd)
    cells = torch.arange(NB * BS, device=dev)
    amask = (mask & (cells[None] <= posd[:, None]))[:, None, None, :]
    qt = q.transpose(1, 2)
    kt, vt = _sdpa_kv(torch, g, kg.transpose(1, 2), vg.transpose(1, 2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, _ = _time_ms(torch, lambda i: sdpa(
        qt, kt, vt, attn_mask=amask, enable_gqa=not g.repeat_kv), 320)
    # bound: each live K/V cell read once per kv head, q read, out written
    live = [int(p) + 1 for p in pos]
    vis = [_visible(int(p), mask[r])
           for r, p in enumerate(pos)]
    bytes_moved = (sum(live) * g.n_kv * g.hd * 2 * 2       # K and V
                   + 2 * SLOTS * g.n_q * g.hd * 2         # q in, out
                   + sum(live)                             # mask cells
                   + sum(-(-c // BS) for c in live) * 4 + SLOTS * 4)
    flops = sum(vis) * g.n_q * g.hd * 4                    # QK and PV
    return _summary(kind, worst, (ms, eager), (plain_ms, plain_eager),
                    library_ms, bytes_moved, flops)


def _dense_need(pos, mask, window, n_q, n_kv, hd):
    """Bytes and flops one dense decode call needs: the K and V of each
    row's visible cells (causal, kv_mask, window), the mask cells of its
    live range, q read and out written, the cursors."""
    vis = live = 0
    for r, p in enumerate(pos.tolist()):
        lo = max(0, p - window + 1) if window else 0
        live += p + 1 - lo
        vis += int(mask[r, lo:p + 1].sum())
    bytes_moved = (vis * n_kv * hd * 2 * 2 + 2 * len(pos) * n_q * hd * 2
                   + live + len(pos) * 4)
    return bytes_moved, vis * n_q * hd * 4


def _pad_splits(pos, mask, split):
    """-> (splits of the rows' live ranges, splits the kv_mask hides
    entirely) for one dense decode call without a window: the blocks
    that find work, and those the pad-split skip sends home."""
    live = blank = 0
    for r, p in enumerate(pos.tolist()):
        for z in range(-(-(p + 1) // split)):
            live += 1
            blank += not bool(mask[r, z * split:min((z + 1) * split, p + 1)]
                              .any())
    return live, blank


def check_dense_decode(torch, dev, wg=LLAMA_8B, g1=LLAMA_1B):
    """The dense decode kernel against its plain version at the one-shot
    path's shapes (the window batch of model `wg`: b 8, max_len 1024,
    bf16; batch 1 of model `g1`, the speculative draft's at llama) and
    at the continuous spec rounds' draft step (b 8 of model `g1` at
    ragged cursors, no kv_mask) at 64- and 128-cell splits, then timings
    at the window batch's shape and at batch 1."""
    from kubeflow_tpu_torch.ops.cuda.decode_attention import (
        SPLIT_CELLS,
        decode_attention,
        decode_attention_plain,
    )
    from kubeflow_tpu_torch.ops.cuda.paged_attention import split_count

    gen = torch.Generator().manual_seed(5)
    dgen = torch.Generator(device=dev).manual_seed(5)
    dt = torch.bfloat16
    b = DENSE_B
    # the window batch: cursor 527 (prompt bucket 512, 16th decode step),
    # each row left-padded to the bucket by 512 - its prompt length
    window_pos = torch.full((b,), DENSE_BUCKET + 15, dtype=torch.int32)
    window_mask = torch.ones(b, MAX_LEN, dtype=torch.bool)
    for r, n in enumerate(DENSE_PROMPTS):
        window_mask[r, :DENSE_BUCKET - n] = False
    ragged_pos = torch.tensor([0, 255, 256, 1023, 17, 511, 700, 64],
                              dtype=torch.int32)
    ragged_mask = torch.ones(b, MAX_LEN, dtype=torch.bool)
    ragged_mask[ragged_pos > 5, 5] = False   # a hole below most cursors
    # name: (rows, geometry, pos, mask, window, dtype)
    cases = {
        "window_batch": (b, wg, window_pos, window_mask, None, dt),
        "ragged_0_255_256_1023": (b, wg, ragged_pos, ragged_mask, None, dt),
        "window_256": (b, wg, ragged_pos, ragged_mask, 256, dt),
        "batch1": (1, g1, torch.tensor([300], dtype=torch.int32),
                   torch.ones(1, MAX_LEN, dtype=torch.bool), None, dt),
        # the continuous spec rounds' draft step: every slot's row of
        # the dense draft cache at its own cursor, no left pad
        "draft_rows": (b, g1, torch.tensor(VERIFY_STARTS, dtype=torch.int32),
                       None, None, dt),
        "window_batch_fp32": (b, wg, window_pos, window_mask, None,
                              torch.float32),
    }
    worst = 0.0
    for name, (rows, g, pos, mask, window, dtype) in cases.items():
        q = torch.randn(rows, 1, g.n_q, g.hd, generator=gen).to(dev, dtype)
        k, v = (torch.randn(rows, MAX_LEN, g.n_kv, g.hd, generator=gen)
                .to(dev, dtype) for _ in range(2))
        args = (q, k, v, pos.to(dev), None if mask is None else mask.to(dev))
        want = decode_attention_plain(*args, window=window)
        for split in DENSE_SPLITS:
            got = decode_attention(*args, window=window, split_cells=split)
            torch.cuda.synchronize()
            err, ratio = _err(got, want)
            log(f"  dense decode ({g.model}) {name}, {split}-cell splits: "
                f"max_abs_err "
                f"{err:.3e}, err/tol max {ratio:.3f} ({TOL_TEXT})")
            if not torch.isfinite(got).all() or ratio > 1:
                fail(f"decode_attention {name} ({split}-cell splits): err "
                     f"{err} over {TOL_TEXT}")
            if dtype == dt:
                worst = max(worst, err)
    for part in ("split", "combine"):
        for label, ty in (("bf16", "I13__nv_bfloat16"), ("fp32", "If")):
            marker = f"decode_{part}_kernel{ty}Li{wg.hd}E"
            log(f"  ptxas, {label} dense decode {part} kernel, hd {wg.hd}: "
                f"{_ptxas('decode_attention', marker)}")

    def timed(kind, rows, g, pos, mask):
        """Kernel (at each split), plain and SDPA times, cycling the
        model's layers' caches as a decode step does (working set >
        L2)."""
        layers = g.layers
        q = torch.randn(rows, 1, g.n_q, g.hd, generator=gen).to(dev, dt)
        shape = (layers, rows, MAX_LEN, g.n_kv, g.hd)
        kc, vc = (torch.randn(shape, generator=dgen, device=dev, dtype=dt)
                  for _ in range(2))
        posd, maskd = pos.to(dev), mask.to(dev)
        split_ms = {}
        for split in DENSE_SPLITS:
            split_ms[split] = _time_ms(torch, lambda i: decode_attention(
                q, kc[i % layers], vc[i % layers], posd, maskd,
                split_cells=split), 10 * layers)
            live, blank = _pad_splits(pos, mask, split)
            log(f"  {kind}, {split}-cell splits: device "
                f"{split_ms[split][0]:.4f} ms (eager call "
                f"{split_ms[split][1]:.4f} ms); of "
                f"{split_count(MAX_LEN, split) * rows * g.n_kv} split "
                f"blocks {live * g.n_kv} meet the live range and the pad "
                f"skip sends {blank * g.n_kv} of those home")
        ms = split_ms[SPLIT_CELLS]
        plain = _time_ms(torch, lambda i: decode_attention_plain(
            q, kc[i % layers], vc[i % layers], posd, maskd), layers)
        # library yardstick: SDPA over each row's cells up to its cursor
        # (K/V views; every row here shares its cursor), boolean mask
        n = int(pos.max()) + 1
        cells = torch.arange(n, device=dev)
        amask = (maskd[:, :n] & (cells[None] <= posd[:, None]))[:, None,
                                                                 None, :]
        qt = q.transpose(1, 2)
        kvt = [_sdpa_kv(torch, g, kc[i, :, :n].transpose(1, 2),
                        vc[i, :, :n].transpose(1, 2)) for i in range(layers)]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms, _ = _time_ms(torch, lambda i: sdpa(
            qt, *kvt[i % layers], attn_mask=amask,
            enable_gqa=not g.repeat_kv), 10 * layers)
        moved, flops = _dense_need(pos, mask, None, g.n_q, g.n_kv, g.hd)
        del kvt
        del kc, vc
        torch.cuda.empty_cache()
        stats = _summary(f"{kind} ({SPLIT_CELLS}-cell splits, the default)",
                         worst, ms, plain, library_ms, moved, flops)
        log(f"    {stats['bound_ms'] / ms[0]:.1%} of the bound, "
            f"{ms[0] / library_ms:.2f}x SDPA's time")
        return stats

    batch1 = timed(f"dense decode, batch 1 ({g1.model}, cursor 300)", 1, g1,
                   torch.tensor([300], dtype=torch.int32),
                   torch.ones(1, MAX_LEN, dtype=torch.bool))
    window = timed(f"dense decode, window batch ({wg.model}, b {b}, cursor "
                   f"{DENSE_BUCKET + 15}, left-pad runs)", b, wg, window_pos,
                   window_mask)
    return window, batch1


def _prefill_need(g, starts, lens, mask):
    """Bytes and flops one prefill call needs: q, k_new and v_new read
    and out written for the valid tokens only (padding is neither
    scattered nor kept), the new cells written once, each row's prefix
    cells [0, start) read once per kv head, their mask cells, the table
    and the row scalars."""
    new = prefix = vis = 0
    for r, (s, n) in enumerate(zip(starts.tolist(), lens.tolist())):
        if n:
            new += n
            prefix += s
            vis += sum(_visible(s + t, mask[r]) for t in range(n))
    n_q, n_kv, hd = g.n_q, g.n_kv, g.hd
    bytes_moved = (new * (n_q * 2 + n_kv * 2) * hd * 2      # q, out, new
                   + new * n_kv * hd * 2 * 2                # cells written
                   + prefix * n_kv * hd * 2 * 2             # prefix read
                   + (prefix + new) + len(starts) * (NB * 4 + 8))
    return bytes_moved, vis * n_q * hd * 4


def _time_prefill(torch, g, kind, worst, calls, kp, vp, n):
    """Time kernel, plain version and SDPA over `calls`, a list of
    (q, k_new, v_new, table, starts, lens, mask) on the card, cycled
    together with the model's layers' pools; the bound is the mean over
    the calls of what each needs."""
    from kubeflow_tpu_torch.ops.cuda.prefill_append import (
        paged_prefill_append,
        paged_prefill_append_plain,
    )

    k = len(calls)

    def run(fn):
        return lambda i: fn(*calls[i % k][:3], kp[i % g.layers],
                            vp[i % g.layers], *calls[i % k][3:])

    ms = _time_ms(torch, run(paged_prefill_append), n)
    plain = _time_ms(torch, run(paged_prefill_append_plain), n // 8)
    # library yardstick: SDPA over K/V gathered beforehand (the gather is
    # not timed), boolean mask = causal & kv_mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_args = []
    for q, _, _, table, starts, _, mask in calls:
        b, dev = q.shape[0], q.device
        kg = kp[0][table.long()].reshape(b, NB * BS, g.n_kv, g.hd)
        vg = vp[0][table.long()].reshape(b, NB * BS, g.n_kv, g.hd)
        cells = torch.arange(NB * BS, device=dev)
        qpos = starts[:, None] + torch.arange(q.shape[1], device=dev)[None]
        amask = (mask[:, None, :] & (cells[None, None] <= qpos[:, :, None])
                 )[:, None]
        lib_args.append((q.transpose(1, 2), *_sdpa_kv(
            torch, g, kg.transpose(1, 2), vg.transpose(1, 2)), amask))
    library_ms, _ = _time_ms(torch, lambda i: sdpa(
        *lib_args[i % k][:3], attn_mask=lib_args[i % k][3],
        enable_gqa=not g.repeat_kv), n)
    need = [_prefill_need(g, c[4], c[5], c[6]) for c in calls]
    return _summary(kind, worst, ms, plain, library_ms,
                    sum(b for b, _ in need) / k, sum(f for _, f in need) / k)


def _prefill_dropped_diagonal():
    """The plain paged attention with each query's own cell left out
    (query positions one lower, a window one shorter): a causal mask off
    by one, the control the bf16 prefill bound must see."""
    from unittest import mock

    from kubeflow_tpu_torch.ops import attention

    attend = attention._torch_attention

    def off_by_one(q, k, v, q_positions, kv_positions, *, causal, kv_mask,
                   window):
        return attend(q, k, v, q_positions - 1, kv_positions, causal=causal,
                      kv_mask=kv_mask,
                      window=None if window is None else window - 1)

    return mock.patch.object(attention, "_torch_attention", off_by_one)


def _compare_prefill(torch, kp0, vp0, calls, window=None):
    """Run the prefill calls (q, k_new, v_new, table, starts, lens, mask)
    in order on the plain version and on the kernel, each on its own copy
    of the pools kp0 / vp0; -> (max abs error over valid tokens, max err
    / bf16 bound, the same for the dropped-diagonal control, pools equal
    outside block 0)."""
    from kubeflow_tpu_torch.ops.cuda.prefill_append import (
        paged_prefill_append,
        paged_prefill_append_plain,
        prefill_bf16_slack,
    )

    c_tol, rtol = FLASH_TOL["bfloat16"]
    want = [kp0.clone(), vp0.clone()]
    got = [kp0.clone(), vp0.clone()]
    seen = {"got": [], "want": [], "bad": [], "mag": []}
    for c in calls:
        valid = [slice(0, n) for n in c[5].tolist()]
        mag = prefill_bf16_slack(*c[:3], *want, *c[3:], window=window)
        with _prefill_dropped_diagonal():
            bad, _, _ = paged_prefill_append_plain(
                *c[:3], want[0].clone(), want[1].clone(), *c[3:],
                window=window)
        wo, *want = paged_prefill_append_plain(
            *c[:3], *want, *c[3:], window=window)
        go, *got = paged_prefill_append(
            *c[:3], *got, *c[3:], window=window)
        torch.cuda.synchronize()
        if not torch.isfinite(go).all():
            fail("paged_prefill_append: non-finite output")
        for key, x in (("got", go), ("want", wo), ("bad", bad),
                       ("mag", mag)):
            seen[key] += [x[i, t] for i, t in enumerate(valid)]
    got_v, want_v, bad_v, mag_v = (torch.cat(seen[k]) for k in
                                   ("got", "want", "bad", "mag"))
    err, ratio = _flash_err(got_v, want_v, c_tol, rtol, mag_v)
    control = _flash_err(bad_v, want_v, c_tol, rtol, mag_v)[1]
    equal = all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))
    return err, ratio, control, equal


def _prefill_pools(torch, dev, g, gen):
    shape = (g.layers, NUM_BLOCKS, BS, g.n_kv, g.hd)
    return tuple(torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                 for _ in range(2))


def _report_prefill(g, name, result):
    """Log one prefill case's check and fail it outside the bound, or
    when the bound cannot see a dropped diagonal. -> its max abs error."""
    err, ratio, control, equal = result
    log(f"  prefill ({g.model}) {name}: max_abs_err {err:.3e}, err/tol "
        f"max {ratio:.3f} ({BF16_TOL_TEXT}); dropped-diagonal control "
        f"err/tol {control:.1f}; pools equal outside block 0: {equal}")
    if ratio > 1 or not equal:
        fail(f"paged_prefill_append {name}: err {err}, pools equal "
             f"{equal}")
    if control <= 1:
        fail(f"the bf16 prefill bound cannot see a dropped diagonal "
             f"({name}: {control})")
    return err


def check_prefill(torch, dev, g=LLAMA_1B):
    gen = torch.Generator().manual_seed(2)
    dt = torch.bfloat16
    kp, vp = _prefill_pools(torch, dev, g, gen)

    def fresh(b):
        return tuple(torch.randn(b, CHUNK, n, g.hd, generator=gen)
                     .to(dev, dt) for n in (g.n_q, g.n_kv, g.n_kv))

    def compare(calls, window=None):
        return _compare_prefill(torch, kp[0], vp[0], calls, window)

    # batches of 4 rows: ragged q_lens including 0
    rows = 4
    q, kn, vn = fresh(rows)
    lens = torch.tensor([64, 64, 44, 0], dtype=torch.int32, device=dev)
    cases = {
        "ragged_lens": dict(starts=[0, 128, 256, 300], shared=0,
                            window=None),
        # two blocks shared by every row, strictly below every row's
        # start: the serving invariant for radix-shared prefixes
        "cow_shared_prefix": dict(starts=[128, 130, 200, 300], shared=2,
                                  window=None),
        "window_100": dict(starts=[0, 128, 256, 300], shared=0,
                           window=100),
    }
    results = {}
    for name, c in cases.items():
        starts = torch.tensor(c["starts"], dtype=torch.int32)
        table = _tables(gen, torch, rows, (starts + CHUNK).tolist(),
                        shared_prefix=c["shared"])
        mask = torch.ones(rows, NB * BS, dtype=torch.bool)
        mask[:, 5] = False
        mask[starts <= 5, 5] = True   # pad hole only below a row's start
        call = (q, kn, vn, table.to(dev), starts.to(dev), lens,
                mask.to(dev))
        results[name] = (call, compare([call], c["window"]))

    # the main path's shape: one row per call, a 64-token slice at a
    # 300-token prompt's cursors 0, 64, ..., 256 (the last 44 tokens)
    prompt = PROMPT_LENS[2]
    table = _tables(gen, torch, 1, [prompt + MAX_NEW]).to(dev)
    mask = torch.ones(1, NB * BS, dtype=torch.bool, device=dev)
    slices = []
    for s0 in range(0, prompt, CHUNK):
        n = min(CHUNK, prompt - s0)
        slices.append((*fresh(1), table,
                       torch.tensor([s0], dtype=torch.int32, device=dev),
                       torch.tensor([n], dtype=torch.int32, device=dev),
                       mask))
    results["path_slices"] = (None, compare(slices))

    # the capped repeat: one token per row at cells 63, 127, 255 and 511
    # (a prompt of 64k tokens sent again seeds all but its last cell),
    # over the chain blocks the rows share below their starts
    gen_c = torch.Generator().manual_seed(12)
    starts = [63, 127, 255, 511]
    q1, kn1, vn1 = (torch.randn(rows, CHUNK, n, g.hd, generator=gen_c).to(
        dev, dt) for n in (g.n_q, g.n_kv, g.n_kv))
    mask = torch.ones(rows, NB * BS, dtype=torch.bool)
    mask[:, 5] = False
    call = (q1, kn1, vn1, _chain_tables(gen_c, torch, starts).to(dev),
            torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.ones(rows, dtype=torch.int32, device=dev), mask.to(dev))
    results["capped_repeat"] = (call, compare([call]))

    worst = max(_report_prefill(g, name, result)
                for name, (_, result) in results.items())
    for part, marker in (("tensor-core attention",
                          f"prefill_attention_tc_kernelILi{g.hd}E"),
                         ("scatter", "scatter_kernelI13__nv_bfloat16")):
        log(f"  ptxas, bf16 prefill {part} kernel, hd {g.hd}: "
            f"{_ptxas('paged_prefill_append', marker)}")

    batch = _time_prefill(
        torch, g, f"prefill ({g.model}), 4-row batch (ragged_lens)", worst,
        [results["ragged_lens"][0]], kp, vp, 10 * g.layers)
    path = _time_prefill(
        torch, g, f"prefill ({g.model}), 1-row slices of a {prompt}-token "
        f"prompt (the main path's shape; mean per slice)", worst, slices, kp,
        vp, 10 * g.layers)
    return path, batch


# the speculative verify pass's shape (phase 9): every slot feeds
# [tok, d_1..d_gamma] at its own cursor; a row near the window's end
# feeds only what fits (q_lens clamped, as `_spec_verify` clamps it)
VERIFY_STARTS = (0, 17, 255, 300, 511, 1019, 1021, 640)


def check_verify(torch, dev, g=LLAMA_8B):
    """The prefill-append kernel at the verify pass's shape: 8 rows x
    gamma + 1 tokens at ragged cursors, q_lens min(gamma + 1, width -
    cursor) (3 at cursor 1021), a frozen-style row (cursor 640, its
    table covering a longer prompt, as a row mid chunked prefill rides
    along), cell 5 masked below the rows past it; against the plain
    version under the bf16 bound, then timed against SDPA over the
    gathered K/V."""
    gen = torch.Generator().manual_seed(21)
    dt = torch.bfloat16
    s = GAMMA + 1
    kp, vp = _prefill_pools(torch, dev, g, gen)
    starts = torch.tensor(VERIFY_STARTS, dtype=torch.int32)
    lens = torch.clamp(NB * BS - starts, max=s).to(torch.int32)
    need = [min(int(st) + s, NB * BS) for st in starts]
    need[-1] = 900                    # the frozen-style row's prompt
    table = _tables(gen, torch, len(starts), need)
    mask = torch.ones(len(starts), NB * BS, dtype=torch.bool)
    mask[:, 5] = False
    mask[starts <= 5, 5] = True
    q, kn, vn = (torch.randn(len(starts), s, n, g.hd, generator=gen)
                 .to(dev, dt) for n in (g.n_q, g.n_kv, g.n_kv))
    call = (q, kn, vn, table.to(dev), starts.to(dev), lens.to(dev),
            mask.to(dev))
    err = _report_prefill(g, f"verify ({len(starts)} rows x {s} tokens, "
                          f"q_lens {lens.tolist()})",
                          _compare_prefill(torch, kp[0], vp[0], [call]))
    return _time_prefill(
        torch, g, f"prefill ({g.model}), the verify pass ({len(starts)} rows "
        f"x {s} tokens)", err, [call], kp, vp, 10 * g.layers)


def _pairs(s, causal, window):
    """(query, key) pairs the attention sees, per head and batch row."""
    if not causal:
        return s * s
    return sum(min(t + 1, window or s) for t in range(s))


def _flash_need(kind, b, s, causal, window, g=LLAMA_1B, elt=2):
    """(bytes, flops) one call needs with `elt`-byte elements (bf16 by
    default): every input read once, every output written once; 2 hd
    flops per visible pair and product (forward: QK, PV; dQ: QK, dO V^T,
    dS K; dK/dV: those and P^T dO)."""
    q = b * s * g.n_q * g.hd * elt
    kv = b * s * g.n_kv * g.hd * elt
    rows = b * g.n_q * s * 4                    # an fp32 lse or delta
    products, moved = {
        "fwd": (2, q + 2 * kv + q + rows),      # q k v -> o lse
        "dq": (3, 2 * q + 2 * kv + 2 * rows + q),
        "dkv": (4, 2 * q + 2 * kv + 2 * rows + 2 * kv),
    }[kind]
    return moved, (products * 2 * g.hd * _pairs(s, causal, window) * g.n_q
                   * b)


def _flash_err(got, want, c, rtol, mag=None):
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bound = c * float(w.abs().max()) + rtol * w.abs()
    if mag is not None:
        bound = bound + BF16_ROUNDING * mag
    return float(d.max()), float((d / bound).max())


def _dropped_diagonal(torch, fa):
    """The plain flash versions of `fa` with each query's own key left
    out (a causal mask off by one): the control the bf16 and fp32 flash
    bounds must see."""
    from unittest import mock

    mask = fa._mask

    def off_by_one(s, causal, window, device):
        eye = torch.eye(s, dtype=torch.bool, device=device)
        return mask(s, causal, window, device) & ~eye

    return mock.patch.object(fa, "_mask", off_by_one)


def _ptxas(name, marker):
    """Registers and spills of the kernel of library `name` whose
    mangled name contains `marker` (the first such instantiation), from
    its fresh build's ptxas -v log."""
    from kubeflow_tpu_torch.ops.cuda import _build

    lines = _build.ptxas_reports.get(name, "").splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and marker in ln:
            props = []
            for nxt in lines[i + 1:]:
                if "spill" in nxt or "Used" in nxt:
                    props.append(nxt.split(":")[-1].strip())
                if "Used" in nxt:
                    return "; ".join(props)
    return "not reported (library not built in this run)"


def _time_events(torch, fn, n):
    """Device ms per eager call (CUDA events around n calls after two
    warm-up calls): the library's eager times, logged beside its
    graph-replayed ones."""
    fn()
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def check_flash(torch, dev, g=LLAMA_1B):
    """Each flash kernel against its plain version over the cases and
    every dtype its kernels take at `g`'s head dim (bf16 and fp32, at
    llama3-1b's 128 and gemma-2b's 256; fp32 dK/dV at the shapes' split
    and a forced one); timings at the causal bf16 shape, and at
    llama3-1b's and gemma-2b's shapes the fp32 kernels' too (their rows
    carry the FP32_128 or FP32_256 suffix)."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator().manual_seed(4)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    worst_fp32 = dict(worst)
    for dtype in (torch.bfloat16, torch.float32):
        if g.hd not in fa.HEAD_DIMS[dtype]:
            continue
        c, rtol = FLASH_TOL[str(dtype).split(".")[1]]
        bf16 = dtype == torch.bfloat16
        for name, (s, causal, window) in FLASH_CASES.items():
            q, do = (torch.randn(FLASH_B, s, g.n_q, g.hd, generator=gen)
                     .to(dev, dtype) for _ in range(2))
            k, v = (torch.randn(FLASH_B, s, g.n_kv, g.hd, generator=gen)
                    .to(dev, dtype) for _ in range(2))
            kw = dict(causal=causal, window=window)
            o, lse = fa.flash_block_fwd(q, k, v, **kw)
            wo, wlse = fa.flash_fwd_plain(q, k, v, **kw)
            delta = fa.flash_delta(wo, do)
            args = (q, k, v, do, wlse, delta)
            dq = fa.flash_dq(*args, **kw)
            dk, dv = fa.flash_dkv(*args, **kw)
            fdk = fdv = None
            if not bf16:  # fp32 dK/dV at a split the shapes do not pick
                chosen = fa.default_head_splits(FLASH_B, s, g.n_q, g.n_kv,
                                                g.hd, dtype)
                forced = 2 if chosen != 2 else 4
                fdk, fdv = fa.flash_dkv(*args, **kw, head_splits=forced)
            torch.cuda.synchronize()
            wdk, wdv = fa.flash_dkv_plain(*args, **kw)
            wdq = fa.flash_dq_plain(*args, **kw)
            # the tensor-core kernels' rounding of P, dS, P^T and dS^T
            o_mag, dq_mag, dk_mag, dv_mag = (
                fa.flash_bf16_slack(*args, **kw) if bf16 else (None,) * 4)
            errs = {"fwd": [_flash_err(o, wo, c, rtol, o_mag),
                            _flash_err(lse, wlse, 1e-5, 0.0)],
                    "dq": [_flash_err(dq, wdq, c, rtol, dq_mag)],
                    "dkv": [_flash_err(dk, wdk, c, rtol, dk_mag),
                            _flash_err(dv, wdv, c, rtol, dv_mag)]}
            if not bf16:
                errs["dkv"] += [_flash_err(fdk, wdk, c, rtol),
                                _flash_err(fdv, wdv, c, rtol)]
                log(f"  fp32 dkv {name}: head splits chosen {chosen}, "
                    f"forced {forced}")
            if not bf16 and name == "causal":
                # a sum of the split's partials without one subgroup's
                # must exceed the fp32 bound
                parts = fa.flash_dkv_partials_plain(*args, forced, **kw)
                dropped = [_flash_err(p[:, :, :, 1:].sum(3), w, c, rtol)[1]
                           for p, w in zip(parts, (wdk, wdv))]
                log(f"  dropped-partial control (the plain partials of "
                    f"{forced} subgroups without the first) err/tol: dk "
                    f"{dropped[0]:.1f}, dv {dropped[1]:.1f}")
                if min(dropped) <= 1:
                    fail("the fp32 flash bound cannot see a dropped "
                         f"partial: {dropped}")
                del parts
            if name == "causal":
                with _dropped_diagonal(torch, fa):
                    bad_o, _ = fa.flash_fwd_plain(q, k, v, **kw)
                    bad_dq = fa.flash_dq_plain(*args, **kw)
                    bad_dk, bad_dv = fa.flash_dkv_plain(*args, **kw)
                controls = {
                    "fwd": [_flash_err(bad_o, wo, c, rtol, o_mag)[1]],
                    "dq": [_flash_err(bad_dq, wdq, c, rtol, dq_mag)[1]],
                    "dkv": [_flash_err(bad_dk, wdk, c, rtol, dk_mag)[1],
                            _flash_err(bad_dv, wdv, c, rtol, dv_mag)[1]]}
                log(f"  {dtype} dropped-diagonal control (plain versions "
                    "without each query's own key) err/tol: " + "; ".join(
                        f"{kind} {min(r):.1f}" for kind, r in
                        controls.items()))
                if min(min(r) for r in controls.values()) <= 1:
                    fail(f"the {dtype} flash bound cannot see a dropped "
                         f"diagonal: {controls}")
                del bad_o, bad_dq, bad_dk, bad_dv
            for kind, pairs in errs.items():
                err = max(e for e, _ in pairs)
                ratio = max(r for _, r in pairs)
                slack = " + 2^-8 mag" if bf16 else ""
                log(f"  flash {kind} {name} {dtype}: max_abs_err "
                    f"{err:.3e}, err/tol max {ratio:.3f} (tol {c} max|ref| "
                    f"+ {rtol:.3g} |ref|{slack})")
                if ratio > 1 or err != err:
                    fail(f"flash {kind} {name} {dtype}: err {err} over tol")
                w = worst if bf16 else worst_fp32
                w[kind] = max(w[kind], err)
            del q, do, k, v, o, lse, wo, wlse, delta, args, dq, dk, dv
            del fdk, fdv, wdq, wdk, wdv, o_mag, dq_mag, dk_mag, dv_mag
            torch.cuda.empty_cache()

    # timings: causal, bf16, the training shape
    s = FLASH_S
    q, do = (torch.randn(FLASH_B, s, g.n_q, g.hd, generator=gen)
             .to(dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(FLASH_B, s, g.n_kv, g.hd, generator=gen)
            .to(dev, torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    kernel = {"fwd": _time_ms(torch, lambda i: fa.flash_block_fwd(
                  q, k, v, causal=True), 20),
              "dq": _time_ms(torch, lambda i: fa.flash_dq(*args), 20),
              "dkv": _time_ms(torch, lambda i: fa.flash_dkv(*args), 20)}
    # dK/dV at every query-head split that divides the group, beside the
    # shapes' choice (`default_head_splits`)
    chosen = fa.default_head_splits(FLASH_B, s, g.n_q, g.n_kv, g.hd)
    sweep = {n: kernel["dkv"][0] if n == chosen else _time_ms(
                 torch, lambda i, n=n: fa.flash_dkv(*args, head_splits=n),
                 20)[0]
             for n in (1, 2, 4, 8, 16) if (g.n_q // g.n_kv) % n == 0}
    log("  flash dkv by query-head subgroups: " + "; ".join(
        f"{n}: {ms:.4f} ms" + (" (the shapes' choice)" if n == chosen
                               else "") for n, ms in sweep.items()))
    plain = {"fwd": _time_ms(torch, lambda i: fa.flash_fwd_plain(q, k, v),
                             4),
             "dq": _time_ms(torch, lambda i: fa.flash_dq_plain(*args), 4),
             "dkv": _time_ms(torch, lambda i: fa.flash_dkv_plain(*args),
                             4)}
    # library yardstick: SDPA on [b, heads, s, hd] views with K/V
    # repeated over the group beforehand (not timed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = g.n_q // g.n_kv
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for x in (k, v))
    dot = do.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True),
                                   (qt, kt, vt), dot)

    # the yardstick: SDPA captured in a CUDA graph and replayed, as the
    # kernels are; the eager times (which follow the host) beside it
    lib_fwd = _time_ms(torch, lambda i: fwd(), 20)[0]
    lib_fb = _time_ms(torch, lambda i: fwd_bwd(), 20)[0]
    eager_fwd = _time_events(torch, fwd, 20)
    eager_fb = _time_events(torch, fwd_bwd, 20)
    out = sdpa(qt, kt, vt, is_causal=True)
    eager_bwd = _time_events(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    log(f"  SDPA (K/V repeated over the group), graph-replayed: forward "
        f"{lib_fwd:.4f} ms, forward + backward {lib_fb:.4f} ms; eager: "
        f"forward {eager_fwd:.4f} ms, forward + backward {eager_fb:.4f} "
        f"ms, backward alone {eager_bwd:.4f} ms")
    stats = {}
    for kind, lib in (("fwd", lib_fwd), ("dq", lib_fb), ("dkv", lib_fb)):
        moved, flops = _flash_need(kind, FLASH_B, s, True, None, g)
        st = stats[f"flash_attention_{kind}"] = _summary(
            f"flash {kind} ({g.model}: b {FLASH_B}, s {s}, n_q {g.n_q}, "
            f"n_kv {g.n_kv}, hd {g.hd}, causal, bf16)", worst[kind],
            kernel[kind], plain[kind], lib, moved, flops)
        ms = st["ms"]
        core = (f"{ms:.4f} ms vs the CUDA-core kernel's {CUDA_CORE_MS[kind]}"
                f" ms ({CUDA_CORE_MS[kind] / ms:.1f}x faster); "
                if g is LLAMA_1B else "")
        log(f"    {core}{ms / lib:.2f}x SDPA's time; "
            f"{st['bound_ms'] / ms:.1%} of the bound")
    for kind in ("fwd", "dq", "dkv"):
        marker = f"flash_{kind}_tc_kernelILi{g.hd}E"
        log(f"    ptxas, bf16 {kind} kernel at hd {g.hd}: "
            f"{_ptxas(f'flash_attention_{kind}', marker)}")
    del q, k, v, do, o, lse, delta, args, qt, kt, vt, dot, out
    torch.cuda.empty_cache()
    if g in (LLAMA_1B, GEMMA_2B):
        stats.update(_time_flash_fp32(torch, dev, g, gen, worst_fp32))
    return stats


def check_flash_tp(torch, dev):
    """The bf16 flash kernels at a rank's heads under tensor parallelism
    (TP2_SHAPES; b 2, s 2048, causal), each against its plain version
    under the phase's bounds, and timed (device ms, graph-replayed)."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator().manual_seed(5)
    c, rtol = FLASH_TOL["bfloat16"]
    card = _card()
    for g in TP2_SHAPES:
        q, do = (torch.randn(FLASH_B, FLASH_S, g.n_q, g.hd, generator=gen)
                 .to(dev, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(FLASH_B, FLASH_S, g.n_kv, g.hd, generator=gen)
                .to(dev, torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_block_fwd(q, k, v, causal=True)
        wo, wlse = fa.flash_fwd_plain(q, k, v, causal=True)
        args = (q, k, v, do, wlse, fa.flash_delta(wo, do))
        dq = fa.flash_dq(*args)
        dk, dv = fa.flash_dkv(*args)
        wdq = fa.flash_dq_plain(*args)
        wdk, wdv = fa.flash_dkv_plain(*args)
        o_mag, dq_mag, dk_mag, dv_mag = fa.flash_bf16_slack(*args)
        errs = {"fwd": [_flash_err(o, wo, c, rtol, o_mag),
                        _flash_err(lse, wlse, 1e-5, 0.0)],
                "dq": [_flash_err(dq, wdq, c, rtol, dq_mag)],
                "dkv": [_flash_err(dk, wdk, c, rtol, dk_mag),
                        _flash_err(dv, wdv, c, rtol, dv_mag)]}
        ms = {"fwd": _time_ms(torch, lambda i: fa.flash_block_fwd(
                  q, k, v, causal=True), 20)[0],
              "dq": _time_ms(torch, lambda i: fa.flash_dq(*args), 20)[0],
              "dkv": _time_ms(torch, lambda i: fa.flash_dkv(*args), 20)[0]}
        splits = fa.default_head_splits(FLASH_B, FLASH_S, g.n_q, g.n_kv,
                                        g.hd)
        for kind, pairs in errs.items():
            err = max(e for e, _ in pairs)
            ratio = max(r for _, r in pairs)
            log(f"  flash {kind} at {g.model} (b {FLASH_B}, s {FLASH_S}, "
                f"n_q {g.n_q}, n_kv {g.n_kv}, hd {g.hd}, causal, bf16"
                + (f", {splits} query-head subgroups" if kind == "dkv"
                   else "") + f"): max_abs_err {err:.3e}, err/tol max "
                f"{ratio:.3f} ({BF16_TOL_TEXT}); device {ms[kind]:.4f} ms "
                f"({card})")
            if ratio > 1 or err != err:
                fail(f"flash {kind} at {g.model}: err {err} over tol")
        del q, do, k, v, o, lse, wo, wlse, args, dq, dk, dv, wdq, wdk, wdv
        del o_mag, dq_mag, dk_mag, dv_mag
        torch.cuda.empty_cache()


def check_serving_tp(torch, dev) -> dict:
    """The serving kernels at a tensor-2 rank's heads (TP2_SERVING), each
    against its plain version under phase 2's bounds and timed by graph
    replay: paged decode and prefill-append at every rank geometry,
    dense decode at gemma-2b's (phase 19b's one-shot path). -> the
    `kernels`-line numbers of the shapes phase 19 launches."""
    llama1b, _, gemma2b = TP2_SERVING
    out = {}
    for g in TP2_SERVING:
        t0 = time.perf_counter()
        log(f"  {g.model}: n_q {g.n_q}, n_kv {g.n_kv}, hd {g.hd} (group "
            f"{g.n_q // g.n_kv}); paged decode timed at its default split")
        dec = check_decode(torch, dev, g, splits=())
        pre = check_prefill(torch, dev, g)[0]
        log(f"  {g.model}: {time.perf_counter() - t0:.1f} s")
        if g is llama1b:
            out["paged_decode_attention" + TP2] = dec
            out["paged_prefill_append" + TP2] = pre
    out["decode_attention" + GEMMA_TP2] = check_dense_decode(
        torch, dev, gemma2b, gemma2b)[0]
    return out


def _time_flash_fp32(torch, dev, g, gen, worst):
    """The fp32 CUDA-core kernels at `g`'s shape, causal, the training
    shape: device ms against their plain versions, fp32 SDPA (forward,
    and forward + backward for dQ and dK/dV; K/V repeated over the
    group, graph-replayed) and the bound at the fp32 CUDA-core rate;
    dK/dV at every query-head split that divides the group. `worst`:
    each kernel's max error over phase 2's fp32 cases."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    suffix = {128: FP32_128, 256: FP32_256}[g.hd]
    s = FLASH_S
    q, do = (torch.randn(FLASH_B, s, g.n_q, g.hd, generator=gen).to(dev)
             for _ in range(2))
    k, v = (torch.randn(FLASH_B, s, g.n_kv, g.hd, generator=gen).to(dev)
            for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    kernel = {"fwd": _time_ms(torch, lambda i: fa.flash_block_fwd(
                  q, k, v, causal=True), 10),
              "dq": _time_ms(torch, lambda i: fa.flash_dq(*args), 10),
              "dkv": _time_ms(torch, lambda i: fa.flash_dkv(*args), 10)}
    chosen = fa.default_head_splits(FLASH_B, s, g.n_q, g.n_kv, g.hd,
                                    torch.float32)
    sweep = {n: kernel["dkv"][0] if n == chosen else _time_ms(
                 torch, lambda i, n=n: fa.flash_dkv(*args, head_splits=n),
                 10)[0]
             for n in (1, 2, 4, 8) if (g.n_q // g.n_kv) % n == 0}
    log(f"  fp32 flash dkv ({g.model}) by query-head subgroups: " + "; ".join(
        f"{n}: {ms:.4f} ms" + (" (the shapes' choice)" if n == chosen
                               else "") for n, ms in sweep.items()))
    plain = {"fwd": _time_ms(torch, lambda i: fa.flash_fwd_plain(q, k, v),
                             2),
             "dq": _time_ms(torch, lambda i: fa.flash_dq_plain(*args), 2),
             "dkv": _time_ms(torch, lambda i: fa.flash_dkv_plain(*args),
                             2)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = g.n_q // g.n_kv
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for x in (k, v))
    dot = do.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True)

    lib_fwd = _time_ms(torch, lambda i: fwd(), 10)[0]
    lib_fb = _time_ms(torch, lambda i: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot), 10)[0]
    log(f"  fp32 SDPA ({g.model}, K/V repeated over the group), "
        f"graph-replayed: forward {lib_fwd:.4f} ms, forward + backward "
        f"{lib_fb:.4f} ms; the kernels' dQ + dK/dV "
        f"{kernel['dq'][0] + kernel['dkv'][0]:.4f} ms against SDPA's "
        f"backward alone (the difference) {lib_fb - lib_fwd:.4f} ms")
    stats = {}
    for kind, lib in (("fwd", lib_fwd), ("dq", lib_fb), ("dkv", lib_fb)):
        moved, flops = _flash_need(kind, FLASH_B, s, True, None, g, elt=4)
        st = stats[f"flash_attention_{kind}{suffix}"] = _summary(
            f"flash {kind} fp32 ({g.model}: b {FLASH_B}, s {s}, n_q "
            f"{g.n_q}, n_kv {g.n_kv}, hd {g.hd}, causal, CUDA cores)",
            worst[kind], kernel[kind], plain[kind], lib, moved, flops,
            flops_s=FP32_FLOPS_S)
        log(f"    {st['ms'] / lib:.2f}x fp32 SDPA's time; "
            f"{st['bound_ms'] / st['ms']:.1%} of the bound (fp32 at "
            f"{FP32_FLOPS_S / 1e12:.0f} TFLOP/s)")
        marker = f"flash_{kind}_kernelILi{g.hd}E"
        log(f"    ptxas, fp32 {kind} kernel at hd {g.hd}: "
            f"{_ptxas(f'flash_attention_{kind}', marker)}")
    return stats


# -- phase 2, int8_proj -----------------------------------------------------

# (K, N) of the seven block projections, by model (models/llama.py)
def _proj_shapes(d, q, kv, ffn):
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, ffn), "w_up": (d, ffn), "w_down": (ffn, d)}


INT8_SHAPES = {"llama3-8b": _proj_shapes(4096, 4096, 1024, 14336),
               "llama3-1b": _proj_shapes(2048, 2048, 1024, 8192)}
# (model, M): decode at 8 live rows (both models) and at 1; the path
# switch's M - 1, M and M + 1 (16, 17, 18: mma.sync, then wgmma, a ragged
# last tile on each side); the spec verify pass's 8 rows x (gamma + 1) =
# 40, one 64-token prefill slice and two (llama3-1b); then the prefill
# shapes of phase 12: llama3-8b's 300-token probe and its 8-row window
# batch left-padded to 300 tokens (2400), and a llama3-1b slice group of
# 8 rows x 64 tokens (512) and one row past it (513: the wgmma tile's
# switch from 64 to 256 rows)
INT8_CASES = (("llama3-8b", 8), ("llama3-1b", 1), ("llama3-1b", 8),
              ("llama3-1b", 16), ("llama3-1b", 17), ("llama3-1b", 18),
              ("llama3-1b", 40), ("llama3-1b", 64), ("llama3-1b", 128),
              ("llama3-8b", 300), ("llama3-8b", 2400), ("llama3-1b", 512),
              ("llama3-1b", 513))
# a layer's launches: the products that read one h go out together
INT8_LAUNCHES = (("wq", "wk", "wv"), ("wo",), ("w_gate", "w_up"),
                 ("w_down",))
INT8_LAYERS = {"llama3-8b": 32, "llama3-1b": 16}
# No operand is rounded (int8 -> bf16 is exact, h is bf16). The kernel
# rounds its fp32 sum once, after the scale; the plain version rounds the
# product to bf16 and then the scaled value, so the two land within one
# bf16 ulp of each other, <= 2^-7 |ref|. The two sum in other orders in
# fp32: 2^-12 mag, with mag = (|h| @ |q|) * scale, leaves that far more
# room than it needs (K 2^-24 mag at most) and is still seen by a kernel
# whose accumulators are rounded to bf16 after each K tile (the control).
INT8_SUM_ORDER = 2**-12
INT8_TOL_TEXT = ("tol 1e-4 max|ref| + 2^-7 |ref| + 2^-12 mag, mag = "
                 "(|h| @ |q|) scale")
L2_BYTES = 50 * 2**20              # H100 L2: timed weights cycle past it
# the kernel functions of csrc/int8_proj.cu (the `kernels` line)
INT8_FUNCTIONS = ("int8_proj_mma_kernel", "int8_proj_wgmma_kernel<64>",
                  "int8_proj_wgmma_kernel<256>")


def _int8_ratio(got, want, mag):
    g, w = got.float(), want.float()
    bound = (1e-4 * w.abs().max() + 2**-7 * w.abs()
             + INT8_SUM_ORDER * mag)
    return float(((g - w).abs() / bound).max())


def _int8_bf16_accumulators(torch, h, q, scale):
    """The control: the product with its accumulators rounded to bf16
    after each K tile of 64 (fp32 within a tile), then scaled."""
    acc = torch.zeros(h.shape[0], q.shape[1], dtype=torch.bfloat16,
                      device=h.device)
    for k0 in range(0, q.shape[0], 64):
        acc = (acc.float() + h[:, k0:k0 + 64].float()
               @ q[k0:k0 + 64].float()).to(torch.bfloat16)
    return (acc.float() * scale.float()).to(torch.bfloat16)


def _int8_weights(torch, dev, gen, model):
    """A model's seven projections: a bf16 weight of the model's init
    scale and its per-channel int8 quantization, each with as many copies
    as exceed the L2 twice (timed calls cycle over them)."""
    from kubeflow_tpu_torch.serving.quant import quantize

    out = {}
    for name, (k, n) in INT8_SHAPES[model].items():
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k**-0.5).to(torch.bfloat16)
        qt = quantize(w)
        copies = -(-2 * L2_BYTES // (k * n))
        out[name] = dict(k=k, n=n, w=[w] + [w.clone()
                                           for _ in range(copies - 1)],
                         q=[qt.q] + [qt.q.clone()
                                     for _ in range(copies - 1)],
                         scale=qt.scale, copies=copies)
    return out


def _int8_layer_ms(torch, ip, ws, hs):
    """Device ms of a layer's four launches (INT8_LAUNCHES), each timed
    alone, cycling weight copies."""
    total = 0.0
    for names in INT8_LAUNCHES:
        h = hs[ws[names[0]]["k"]]
        copies = min(ws[n]["copies"] for n in names)
        total += _time_ms(torch, lambda i: ip.int8_proj_many(
            h, [(ws[n]["q"][i % copies], ws[n]["scale"]) for n in names]),
            max(10, copies))[0]
    return total


def check_int8_proj(torch, dev):
    """The int8 projection kernel against its plain version at every
    projection of INT8_CASES (a bf16 weight of the model's init, its
    per-channel int8 quantization, bf16 activations), under the int8
    bound, which must also fail the bf16-accumulator control; each timed
    (CUDA-graph replay, the call cycling over as many copies of the
    weight as exceed the L2) beside the plain version and the library
    call the bf16 path runs: torch.matmul of the same h by the bf16
    weight. Then a layer's four launches (INT8_LAUNCHES: wq, wk, wv and
    w_gate, w_up grouped), each grouped output bit-identical to its
    product alone and their times summed against the seven matmuls. The
    plain version is computed for the check with cuBLAS held to fp32
    reductions (no bf16 split-K reduction). -> the `kernels`-line numbers of one
    llama3-8b decode layer (its four launches at M = 8, summed)."""
    from kubeflow_tpu_torch.ops.cuda import int8_proj as ip

    gen = torch.Generator(device=dev).manual_seed(31)
    worst = 0.0
    layer = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
    matmul = torch.backends.cuda.matmul
    weights = {model: _int8_weights(torch, dev, gen, model)
               for model in INT8_SHAPES}
    for model, m in INT8_CASES:
        ws = weights[model]
        seven = dict(ms=0.0, library_ms=0.0, ratio=0.0,
                     control=float("inf"))
        hs = {k: torch.randn(m, k, generator=gen, device=dev).to(
            torch.bfloat16) for k in {w["k"] for w in ws.values()}}
        alone = {}
        for name, wt in ws.items():
            k, n, q, scale, copies = (wt["k"], wt["n"], wt["q"][0],
                                      wt["scale"], wt["copies"])
            h = hs[k]
            got = ip.int8_proj(h, q, scale)
            reduced = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = False
            want = ip.int8_proj_plain(h, q, scale)
            matmul.allow_bf16_reduced_precision_reduction = reduced
            control = _int8_bf16_accumulators(torch, h, q, scale)
            torch.cuda.synchronize()
            mag = (h.float().abs() @ q.float().abs()) * scale.float()
            err = float((got.float() - want.float()).abs().max())
            ratio = _int8_ratio(got, want, mag)
            c_ratio = _int8_ratio(control, want, mag)
            worst = max(worst, err)
            if ratio > 1:
                fail(f"int8_proj at {model} {name} M {m}: error {err:.3e} "
                     f"is {ratio:.2f}x the bound ({INT8_TOL_TEXT})")
            if c_ratio <= 1:
                fail(f"the int8 bound cannot see bf16 accumulators at "
                     f"{model} {name} M {m}: {c_ratio:.2f}")
            alone[name] = got
            n_calls = max(10, copies)
            kern = _time_ms(torch, lambda i: ip.int8_proj(
                h, wt["q"][i % copies], scale), n_calls)
            plain = _time_ms(torch, lambda i: ip.int8_proj_plain(
                h, wt["q"][i % copies], scale), n_calls)
            lib = _time_ms(torch, lambda i: torch.matmul(
                h, wt["w"][i % copies]), n_calls)[0]
            moved = k * n + 2 * n + 2 * m * k + 2 * m * n
            flops = 2 * m * n * k
            bound = max(moved / HBM_BYTES_S, flops / BF16_FLOPS_S) * 1e3
            path, cluster = ip.plan(m, n, k)
            log(f"  int8_proj {model} {name} [{m} x {k}] @ [{k} x {n}]: "
                f"max_abs_err {err:.3e} ({ratio:.3f} of the bound; bf16-"
                f"accumulator control {c_ratio:.2f}), {path} path, "
                f"cluster {cluster}; device {kern[0]:.4f} ms (eager call "
                f"{kern[1]:.4f}), {bound / kern[0]:.1%} of the int8 bound "
                f"{bound:.4f} ms; bf16 torch.matmul {lib:.4f} ms "
                f"({lib / kern[0]:.2f}x the kernel's time); plain "
                f"{plain[0]:.4f} ms")
            seven["ms"] += kern[0]
            seven["library_ms"] += lib
            seven["ratio"] = max(seven["ratio"], ratio)
            seven["control"] = min(seven["control"], c_ratio)
            if (model, m) == ("llama3-8b", 8):
                layer["plain_ms"] += plain[0]
                layer["library_ms"] += lib
                layer["bytes"] += moved
                layer["flops"] += flops
            del want, control, mag
        for names in INT8_LAUNCHES[::2]:
            outs = ip.int8_proj_many(hs[ws[names[0]]["k"]], [
                (ws[n]["q"][0], ws[n]["scale"]) for n in names])
            for n, y in zip(names, outs):
                if not torch.equal(y, alone[n]):
                    fail(f"int8_proj_many at {model} M {m}: {n} in "
                         f"{names} differs from its product alone")
        grouped = _int8_layer_ms(torch, ip, ws, hs)
        if (model, m) == ("llama3-8b", 8):
            layer["ms"] = grouped
        layers = INT8_LAYERS[model]
        log(f"  int8_proj {model} M {m}, a layer: {len(INT8_LAUNCHES)} "
            f"launches (grouped outputs bit-identical to the products "
            f"alone) {grouped:.4f} ms, the seven products alone "
            f"{seven['ms']:.4f} ms, bf16 torch.matmul "
            f"{seven['library_ms']:.4f} ms "
            f"({seven['library_ms'] / grouped:.2f}x"
            f" the grouped time); x {layers} layers {grouped * layers:.3f} "
            f"ms against {seven['library_ms'] * layers:.3f} ms; err/tol "
            f"max {seven['ratio']:.3f}, control min {seven['control']:.2f}")
        del hs, alone
        torch.cuda.empty_cache()
    del weights
    torch.cuda.empty_cache()
    log(f"  int8_proj: every case within {INT8_TOL_TEXT}; every "
        f"bf16-accumulator control outside it")
    st = _summary("int8_proj, one llama3-8b decode layer's four launches "
                  "at M 8 (plain and library: the seven products; eager: "
                  "not summed)", worst,
                  (layer["ms"], 0.0), (layer["plain_ms"], 0.0),
                  layer["library_ms"], layer["bytes"], layer["flops"],
                  library="bf16 torch.matmul")
    log(f"    {st['bound_ms'] / st['ms']:.1%} of the bound; "
        f"{st['library_ms'] / st['ms']:.2f}x bf16 torch.matmul's time")
    return st


# -- phase 3 ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _teacher_check(torch, engine, prompts, outs, lps, label):
    """Every served sequence teacher-forced through the plain dense model
    of the engine's family at the same weights: logprobs (where given)
    within LOGPROB_TOL, and the argmax wherever the top-2 margin exceeds
    2 x LOGPROB_TOL. A MoE engine takes `_moe_teacher_check`."""
    from kubeflow_tpu_torch.models import gemma, llama

    if engine.family.mlp is not None:
        _moe_teacher_check(torch, engine, prompts, outs, lps, label)
        return

    model = gemma if engine.family.name == "gemma" else llama
    cfg, dev = engine.cfg, engine.device
    worst, argmax_ok, argmax_n = 0.0, 0, 0
    with torch.inference_mode():
        for p, o, lp in zip(prompts, outs, lps):
            toks = torch.tensor([p + o[:-1]], device=dev)
            logp = torch.log_softmax(
                model.apply(engine.params, cfg, toks)[0, len(p) - 1:], -1)
            if lp is not None:
                ref = logp[torch.arange(len(o), device=dev),
                           torch.tensor(o, device=dev)].cpu()
                worst = max(worst,
                            float((ref - torch.tensor(lp)).abs().max()))
            top2 = torch.topk(logp, 2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
            for j in range(len(o)):
                if margin[j] > 2 * LOGPROB_TOL:
                    argmax_n += 1
                    argmax_ok += int(top2.indices[j, 0]) == o[j]
    log(f"  {label}: teacher-forced logprob max_abs_err {worst:.4f} "
        f"(tol {LOGPROB_TOL}); greedy argmax agrees on {argmax_ok}/"
        f"{argmax_n} steps with margin > {2 * LOGPROB_TOL}")
    if worst > LOGPROB_TOL or argmax_ok != argmax_n:
        fail(f"{label}: served tokens disagree with the plain dense model")


async def serve_and_check(torch, chunked: bool, model: str = "llama3-1b",
                          engine=None, teacher=None):
    """`model` (llama3-1b in phases 3 and 3b, gemma-2b in phase 6) served
    continuously in-process through the HTTP app the CLI builds, warmed
    at start-up, at dispatch-ahead depth 2: chunked prefill or
    monolithic admission. With `engine` (phase 14's MoE model, which the
    CLI's registry does not hold) the app is the one the CLI would build
    around it: `create_serving_app` with the same arguments. `teacher`
    (default the engine) is what the served sequences are held to."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY,
        ENGINES_KEY,
        create_serving_app,
    )

    label = "chunked" if chunked else "monolithic"
    port = _free_port()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    argv = ["--model", model, "--random", "--seed", "0",
            "--continuous", "--warmup", "--host", "127.0.0.1",
            "--port", str(port)]
    if chunked:
        argv += ["--prefill-chunk-tokens", str(CHUNK)]
    if engine is None:
        app = build_app(parse_args(argv))
    else:
        app = create_serving_app(
            {model: engine}, max_batch=SLOTS, continuous=True, warmup=True,
            prefill_chunk_tokens=CHUNK if chunked else None, seed=0)
    runner = web.AppRunner(app)
    t1 = time.perf_counter()
    await runner.setup()          # on_startup: the batcher's warmup
    warm_s = time.perf_counter() - t1
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    engine = app[ENGINES_KEY][model]
    batcher = app[BATCHERS_KEY][model]
    graphs = batcher.cengine.graphs
    cfg = engine.cfg
    captures = graphs.captures
    log(f"  server up in {time.perf_counter() - t0:.1f} s ({model} "
        f"random weights, seed 0, port {port}, {label} admission, "
        f"pipeline depth {batcher.pipeline_depth}); warmup {warm_s:.2f} s "
        f"captured {captures} CUDA graphs")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in PROMPT_LENS[:3]]
    prompts.append(prompts[0])        # the repeated prompt
    url = f"http://127.0.0.1:{port}/v1/models/{model}:generate"
    try:
        async with aiohttp.ClientSession() as sess:
            batcher.calls = batcher.iterations = 0
            batcher.slices = batcher.prefills = 0
            batcher.decode_s = batcher.prefill_s = 0.0
            replays0 = graphs.replays
            reset_launch_counts()
            t0 = time.perf_counter()

            async def post(p):
                async with sess.post(url, json={
                        "tokens": [p], "max_new": MAX_NEW,
                        "logprobs": True}) as r:
                    if r.status != 200:
                        fail(f":generate returned {r.status}: "
                             f"{await r.text()}")
                    return await r.json()

            bodies = await asyncio.gather(*(post(p) for p in prompts))
            serve_s = time.perf_counter() - t0
            counts = launch_counts()
            calls, slices, prefills = (batcher.calls, batcher.slices,
                                       batcher.prefills)
            replays = graphs.replays - replays0
            async with sess.get(f"http://127.0.0.1:{port}/healthz") as r:
                if r.status != 200:
                    fail(f"/healthz returned {r.status}")
            async with sess.get(f"http://127.0.0.1:{port}/v1/models") as r:
                family = (await r.json())["models"][0]["family"]
                if family != engine.family.name:
                    fail(f"/v1/models reports family {family!r}, not "
                         f"{engine.family.name!r}")
            if batcher.prefix_hits:
                fail(f"cold pass: {batcher.prefix_hits} prefix hits, but no "
                     f"prompt shares a full block with another")
            log(f"  served {len(prompts)} requests in {serve_s:.3f} s: "
                f"{calls} decode steps dispatched, {slices} prefill slices, "
                f"{prefills} prefill groups, {replays} graph replays; "
                f"kernel launches {counts}")
            its = max(batcher.iterations, 1)
            if chunked and model == "llama3-1b":
                MEASURED["phase3_step_ms"] = round(
                    batcher.decode_s / max(calls, 1) * 1e3, 3)
            log(f"  batcher (host clock): {batcher.iterations} worker "
                f"iterations, {serve_s / its * 1e3:.2f} ms each; decode "
                f"(dispatch + wait) {batcher.decode_s:.3f} s over {calls} "
                f"steps = {batcher.decode_s / max(calls, 1) * 1e3:.2f} ms "
                f"per step; prefill {batcher.prefill_s:.3f} s over "
                f"{slices + prefills} slices/groups")
            # the same requests again under torch.profiler: where the
            # time goes (host clock inflated by the profiler itself)
            from torch.profiler import ProfilerActivity, profile

            hits0, reused0 = batcher.prefix_hits, batcher.tokens_reused
            slices0, prefills0 = batcher.slices, batcher.prefills
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                await asyncio.gather(*(post(p) for p in prompts))
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
            hits = batcher.prefix_hits - hits0
            reused = batcher.tokens_reused - reused0
            log(f"  profiled pass (the same prompts, now cached): {hits} "
                f"prefix hits, {reused} cells reused, "
                f"{batcher.slices - slices0} prefill slices, "
                f"{batcher.prefills - prefills0} prefill groups")
            # the 130- and 300-token prompts seed from their full blocks
            # below the cache line (len + max_new - 1): 128 and 256 cells
            want_reused = sum(min((n + MAX_NEW - 1) // BS * BS, n - 1)
                              for n in PROMPT_LENS if n > BS)
            if hits != 2 or reused != want_reused:
                fail(f"profiled pass: {hits} hits, {reused} cells reused; "
                     f"the prompts reckon 2 and {want_reused}")
            if graphs.captures != captures:
                fail(f"traffic captured {graphs.captures - captures} CUDA "
                     f"graphs after warmup")
            if chunked and model == "llama3-1b":
                await _tracer_cost(batcher, post, prompts)
    finally:
        await runner.cleanup()
    _report_profile(prof, prof_s)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    layers = cfg.num_layers
    want = {"paged_decode_attention": layers * calls,
            "paged_prefill_append": layers * slices if chunked else 0}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches, the design implies {n} "
                 f"({layers} layers x {calls} steps / {slices} slices)")
    if chunked and slices != sum(-(-n // CHUNK) for n in PROMPT_LENS):
        fail(f"{slices} prefill slices for prompts {PROMPT_LENS}")
    if not calls or replays < 1:
        fail("the decode chunks did not replay their graphs")
    outs = [b["tokens"][0] for b in bodies]
    lps = [b["logprobs"][0] for b in bodies]
    for o, lp in zip(outs, lps):
        if len(o) != MAX_NEW or len(lp) != MAX_NEW or not all(
                0 <= t < cfg.vocab_size for t in o):
            fail(f"malformed output {o} / {lp}")
    if outs[0] != outs[3]:
        fail(f"repeated prompt gave different greedy tokens: {outs[0]} vs "
             f"{outs[3]}")
    _teacher_check(torch, teacher or engine, prompts, outs, lps, label)
    if chunked:
        # control: the same requests through the explicit eager path
        control = ContinuousBatcher(engine, asyncio.Lock(), max_slots=SLOTS,
                                    prefill_chunk_tokens=CHUNK, seed=0,
                                    cuda_graphs=False)
        try:
            eager = await asyncio.gather(*(
                control.submit(p, MAX_NEW, with_logprobs=True)
                for p in prompts))
        finally:
            await control.close()
        lp_diff = max(abs(a - b) for (_, elp), lp in zip(eager, lps)
                      for a, b in zip(elp, lp))
        log(f"  eager control: greedy tokens identical "
            f"{[list(t) for t, _ in eager] == outs}, logprobs within "
            f"{lp_diff:.2e}")
        if [list(t) for t, _ in eager] != outs:
            fail("graph replay and eager launches gave different greedy "
                 "tokens")
    return counts


async def _tracer_cost(batcher, post, prompts) -> None:
    """Host ms a decode step (dispatch + wait) over the same cold
    requests with the app's tracer detached and attached, alternated
    twice (the radix cache flushed before each pass, so each prefills
    the same slices). The compile watch and the counter tracks stay on
    in both: they are not the tracer's."""
    tracer = batcher.tracer
    ms = {"off": [], "on": []}
    for mode in ("off", "on", "off", "on"):
        if not await batcher.drain(timeout=30):
            fail("phase 3: the batcher did not drain between passes")
        batcher.end_drain()
        batcher.flush_cache()
        batcher.tracer = tracer if mode == "on" else None
        batcher.calls, batcher.decode_s = 0, 0.0
        await asyncio.gather(*(post(p) for p in prompts))
        ms[mode].append(batcher.decode_s / max(batcher.calls, 1) * 1e3)
    batcher.tracer = tracer
    on, off = (sum(ms[k]) / len(ms[k]) for k in ("on", "off"))
    MEASURED["tracer_ms"] = {"on": [round(x, 3) for x in ms["on"]],
                             "off": [round(x, 3) for x in ms["off"]]}
    log(f"  tracer cost (host clock): {on:.3f} ms a decode step with the "
        f"tracer attached {MEASURED['tracer_ms']['on']}, {off:.3f} without "
        f"{MEASURED['tracer_ms']['off']}: {on - off:+.3f} ms")


# -- phase 3c ---------------------------------------------------------------


def _bucket(n, reserve, max_len, prefill_chunk):
    """The monolithic prefill bucket of an n-token suffix over `reserve`
    seeded cells, restated from the reference: the ceil multiple of
    `prefill_chunk` past one chunk, else a power of two (>= 16); either
    falls back to n itself when the bucket plus MAX_NEW would overrun
    the cells left."""
    cap = max_len - reserve
    if prefill_chunk and n > prefill_chunk:
        b = -(-n // prefill_chunk) * prefill_chunk
        return b if b + MAX_NEW <= cap else n
    return max(min(max(1 << (n - 1).bit_length(), 16),
                   max(cap - MAX_NEW, 0)), n)


def _reckon(max_len, prefill_chunk, waves, chunked):
    """What the radix prefix cache must do with `waves`, each admitted
    in one pass: a prompt seeds from its longest full-block prefix that
    an earlier wave's prompt holds, capped at len - 1 (one token is
    always prefilled). Suffixes start with distinct tokens, and no cached
    block past a prompt holds generated tokens a later prompt matches,
    so nothing else hits. Monolithic groups are keyed (bucket, m).
    -> (hits, misses, reused, prefilled, slices or groups)."""
    cached = set()
    hits = misses = reused = prefilled = units = 0
    for wave in waves:
        groups = set()
        for p in wave:
            k = len(p) // BS
            while k and tuple(p[:k * BS]) not in cached:
                k -= 1
            m = min(k * BS, len(p) - 1)
            hits, misses = hits + (m > 0), misses + (m == 0)
            reused, prefilled = reused + m, prefilled + len(p) - m
            units += -(-(len(p) - m) // CHUNK) if chunked else 0
            groups.add((_bucket(len(p) - m, m, max_len, prefill_chunk), m))
        units += 0 if chunked else len(groups)
        cached.update(tuple(p[:k * BS]) for p in wave
                      for k in range(1, len(p) // BS + 1))
    return hits, misses, reused, prefilled, units


async def prefix_reuse_and_check(torch, chunked: bool):
    """llama3-1b served by the app the CLI builds (warmed, depth 2, 8
    slots) over traffic that reuses cached prefixes: wave A is four
    prompts on one 320-token prefix (suffixes of 20, 40, 70 and 100
    tokens); wave B is wave A again and a 256-token prompt twice; wave C
    is that prompt once more, through `:generate`. Waves A and B go to
    the app's batcher in one event-loop turn each, so each is one
    admission pass and the counts are exact. Then a batcher with a pool
    of one max-length request and a host spill tier evicts a cached
    prefix and restores it."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.server import BATCHERS_KEY, ENGINES_KEY

    label = "chunked" if chunked else "monolithic"
    port = _free_port()
    argv = ["--model", "llama3-1b", "--random", "--seed", "0",
            "--continuous", "--warmup", "--pipeline-depth", "2",
            "--host", "127.0.0.1", "--port", str(port)]
    if chunked:
        argv += ["--prefill-chunk-tokens", str(CHUNK)]
    app = build_app(parse_args(argv))
    runner = web.AppRunner(app)
    await runner.setup()          # on_startup: the batcher's warmup
    await web.TCPSite(runner, "127.0.0.1", port).start()
    engine = app[ENGINES_KEY]["llama3-1b"]
    batcher = app[BATCHERS_KEY]["llama3-1b"]
    cfg, graphs = engine.cfg, batcher.cengine.graphs
    captures = graphs.captures
    gen = torch.Generator().manual_seed(7)

    def draw(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    prefix = draw(SHARED_PREFIX)
    wave_a = [prefix + draw(n) for n in SUFFIX_LENS]
    repeat = draw(REPEAT_LEN)
    firsts = [p[SHARED_PREFIX] for p in wave_a] + [repeat[0]]
    if len(set(firsts)) != len(firsts) or repeat[0] == prefix[0]:
        fail("phase 3c's prompts share a first token: reseed them")
    waves = [wave_a, wave_a + [repeat, repeat], [repeat]]
    want = _reckon(engine.ec.max_len, batcher.cengine.prefill_chunk, waves,
                   chunked)
    url = f"http://127.0.0.1:{port}/v1/models/llama3-1b:generate"
    outs, lps = [], []
    try:
        batcher.calls = batcher.slices = batcher.prefills = 0
        batcher.decode_s = batcher.prefill_s = 0.0
        reset_launch_counts()
        t0 = time.perf_counter()
        for toks, lp in await asyncio.gather(*(
                batcher.submit(p, MAX_NEW, with_logprobs=True)
                for p in waves[0])):
            outs.append(toks)
            lps.append(lp)
        wave_a_s = time.perf_counter() - t0
        from torch.profiler import ProfilerActivity, profile

        calls0, decode_s0 = batcher.calls, batcher.decode_s
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = await asyncio.gather(*(
                batcher.submit(p, MAX_NEW, with_logprobs=True)
                for p in waves[1]))
            torch.cuda.synchronize()
            wave_b_s = time.perf_counter() - t0
        b_calls = batcher.calls - calls0
        b_ms = (batcher.decode_s - decode_s0) / max(b_calls, 1) * 1e3
        outs += [t for t, _ in got]
        lps += [lp for _, lp in got]
        async with aiohttp.ClientSession() as sess:
            async with sess.post(url, json={"tokens": waves[2],
                                            "max_new": MAX_NEW,
                                            "logprobs": True}) as r:
                if r.status != 200:
                    fail(f":generate returned {r.status}: {await r.text()}")
                body = await r.json()
        outs += body["tokens"]
        lps += body["logprobs"]
        counts = launch_counts()
        calls, slices, prefills = (batcher.calls, batcher.slices,
                                   batcher.prefills)
        if graphs.captures != captures:
            fail(f"traffic captured {graphs.captures - captures} CUDA graphs "
                 f"after warmup")
        stats = batcher.prefix_cache_stats()
        ledger = batcher.cache_ledger.snapshot()
    finally:
        await runner.cleanup()
    got = (stats["hits"], stats["misses"], stats["tokens_reused"],
           stats["tokens_prefilled"], slices if chunked else prefills)
    log(f"  {label}: waves A (4 requests, {wave_a_s:.3f} s), B (6, "
        f"{wave_b_s:.3f} s, profiler on), C (1, :generate): hits "
        f"{got[0]}, misses {got[1]}, tokens reused {got[2]}, prefilled "
        f"{got[3]}, {slices} prefill slices, {prefills} prefill groups "
        f"(the prompts reckon {want}); {calls} decode steps; kernel "
        f"launches {counts}")
    log(f"  ledger: births {ledger['births']}, frees {ledger['frees']}, "
        f"live {ledger['live_blocks']}, conserved {ledger['conserved']}; "
        f"{stats['cached_blocks']} blocks cached")
    log(f"  wave B: host ms per decode step {b_ms:.2f} (dispatch + wait, "
        f"{b_calls} steps, profiler on)")
    _report_profile(prof, wave_b_s)
    if got != want:
        fail(f"{label}: (hits, misses, reused, prefilled, slices/groups) "
             f"{got}, the prompts reckon {want}")
    if not ledger["conserved"]:
        fail(f"{label}: the block ledger does not balance: {ledger}")
    layers = cfg.num_layers
    want_launches = {"paged_decode_attention": layers * calls,
                     "paged_prefill_append": layers * slices if chunked
                     else 0}
    for name, n in want_launches.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches, the design implies {n}")
    prompts = waves[0] + waves[1] + waves[2]
    if chunked and outs[4:8] != outs[:4]:
        # seeded slices keep the cold pass's starts and shapes
        fail("chunked: wave B's seeded repeats gave other greedy tokens "
             "than wave A's cold prefills")
    _teacher_check(torch, engine, prompts, outs, lps, f"3c {label}")
    if not chunked:
        return counts

    # the spill tier: a pool of one max-length request (17 blocks), so a
    # 1000-token prompt evicts the 340-token prompt's cached prefix to
    # host memory, and the 340-token prompt sent again restores it
    spill = ContinuousBatcher(
        engine, asyncio.Lock(), max_slots=2, prefill_chunk_tokens=CHUNK,
        pipeline_depth=2, kv_pool_blocks=1 + NB,
        kv_spill_bytes=SPILL_BLOCKS * batcher.cengine.kv_block_bytes(),
        seed=0)
    spill.warmup()
    warmed = spill.cengine.graphs.captures
    reader, export_s = spill._radix.spill_reader, []

    def timed_reader(block):
        t = time.perf_counter()
        out = reader(block)
        export_s.append(time.perf_counter() - t)
        return out

    spill._radix.spill_reader = timed_reader
    x = wave_a[0]
    try:
        first = await spill.submit(x, MAX_NEW)
        await spill.submit(draw(1000), MAX_NEW)
        evicted = spill.cache_ledger.snapshot()["spill"]["demotions"]
        t0 = time.perf_counter()
        again = await spill.submit(x, MAX_NEW)
        again_s = time.perf_counter() - t0
    finally:
        await spill.close()
    snap = spill.cache_ledger.snapshot()
    sp = snap["spill"]
    log(f"  spill run (pool 17 blocks, tier {SPILL_BLOCKS} blocks of "
        f"{batcher.cengine.kv_block_bytes() / 2**20:.0f} MiB): "
        f"{evicted} blocks demoted before the repeat; then demotions "
        f"{sp['demotions']}, restores {sp['restores']}, drops "
        f"{sp['drops']}, spilled {sp['spilled']}; the repeat took "
        f"{again_s * 1e3:.1f} ms ({spill.prefix_hits} hits, "
        f"{spill.tokens_reused} cells reused); conserved "
        f"{snap['conserved']}")
    log(f"  spill export (synchronous device-to-host copy inside "
        f"admission): {len(export_s)} blocks, "
        f"{sum(export_s) * 1e3:.2f} ms in all, "
        f"{max(export_s, default=0) * 1e3:.2f} ms the longest")
    if sp["restores"] < 1 or evicted < SHARED_PREFIX // BS:
        fail(f"spill run: {evicted} demoted, {sp['restores']} restored")
    if again != first:
        fail(f"spill run: the restored prefix gave {again}, the cold "
             f"prefill {first}")
    if not snap["conserved"]:
        fail(f"spill run: the block ledger does not balance: {snap}")
    if spill.cengine.graphs.captures != warmed:
        fail("spill run: traffic captured a CUDA graph after warmup")
    return counts

# -- phase 4 ----------------------------------------------------------------


def _control_attention(torch, kind):
    """The plain causal attention of the phase-4 controls (llama3-1b has
    no window and training no kv_mask): "bf16_p" rounds P to bf16 before
    P V, as a tensor-core kernel may; "dq_no_diagonal" leaves each
    query's own key out of dQ and nothing else, as a dQ kernel whose
    causal mask were off by one would."""
    from kubeflow_tpu_torch.ops.attention import NEG_INF

    def attend(q, k, v, *_, **__):
        b, s, n_q, hd = q.shape
        n_kv = k.shape[2]

        def logits(qq, kk):
            qg = qq.float().reshape(b, s, n_kv, n_q // n_kv, hd)
            return torch.einsum("bsngh,btnh->bngst", qg,
                                kk.float()) * hd**-0.5

        x = logits(q, k)
        if kind == "dq_no_diagonal":
            diag = torch.eye(s, dtype=torch.bool, device=q.device)
            x = torch.where(diag, logits(q.detach(), k), x)
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(x.masked_fill(~keep, NEG_INF), dim=-1)
        if kind == "bf16_p":
            p = p.to(torch.bfloat16).float()
        o = torch.einsum("bngst,btnh->bsngh", p, v.float())
        return o.reshape(b, s, n_q, hd).to(q.dtype)

    return attend


def _grads(torch, loss_fn, params, *batch, only=None):
    """-> (loss, gradient of every leaf (or of leaf `only`) at `params`
    (untouched), by leaf name)."""
    live = {k: ({n: x.detach().requires_grad_(True) for n, x in v.items()}
                if isinstance(v, dict) else v.detach().requires_grad_(True))
            for k, v in params.items()}
    named = {**{f"blocks.{n}": x for n, x in live["blocks"].items()},
             **{k: v for k, v in live.items() if k != "blocks"}}
    if only is not None:
        named = {only: named[only]}
    loss = loss_fn(live, *batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


def _worst_grad_err(torch, got, want):
    """-> (max over leaves, and over layers of the stacked block leaves,
    of |got - want| / |want| in L2, that leaf's name)."""
    worst = (0.0, "")
    for name, w in want.items():
        d, w = (got[name] - w).float(), w.float()
        if name.startswith("blocks."):
            errs = (torch.linalg.vector_norm(d.flatten(1), dim=1)
                    / torch.linalg.vector_norm(w.flatten(1), dim=1)).tolist()
            labels = [f"{name}[{i}]" for i in range(len(errs))]
        else:
            errs = [float(torch.linalg.vector_norm(d)
                          / torch.linalg.vector_norm(w))]
            labels = [name]
        worst = max(worst, *zip(errs, labels))
    return worst


def train_and_check(torch):
    from unittest import mock

    import numpy as np

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.obs.tracing import Tracer
    from kubeflow_tpu_torch.ops import attention
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import (
        TrainConfig,
        Trainer,
        chunked_cross_entropy_from_hidden,
    )

    dev = torch.device("cuda")
    cfg = llama.LLAMA3_1B           # fp32 masters, bf16, remat "full"
    tc = TrainConfig(warmup_steps=10, total_steps=1000)
    b, s = FLASH_B, FLASH_S
    # explicit positions are not declared contiguous: the plain path
    plain_positions = torch.arange(s, device=dev).expand(b, s)

    def loss_fn(positions):
        def fn(params, tokens, targets, mask):
            h = llama.hidden(params, cfg, tokens, positions=positions)
            return chunked_cross_entropy_from_hidden(
                h, llama.unembed_matrix(params, cfg), targets, mask,
                num_chunks=16)
        return fn

    def trainer_for(positions, **obs_kw):
        return Trainer(apply_fn=lambda p, t: llama.apply(p, cfg, t),
                       init_fn=lambda seed: llama.init(cfg, seed, dev,
                                                       train=True),
                       train_config=tc, loss_fn=loss_fn(positions),
                       device=dev, **obs_kw)

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(b, s, device=dev)
    params0 = llama.init(cfg, 0, dev, train=True)
    n_params = llama.num_params(cfg)
    log(f"  llama3-1b: {n_params} params (fp32 masters), batch {b} x {s}")

    # gradients at the initial weights: the kernel path and two controls
    # against the plain path, worst leaf (and layer) by relative L2 error
    batch = (tokens, targets, mask)
    _, want = _grads(torch, loss_fn(plain_positions), params0, *batch)
    grad_err = {}
    for kind in ("bf16_p", "dq_no_diagonal"):
        with mock.patch.object(llama, "dot_product_attention",
                               _control_attention(torch, kind)):
            _, got = _grads(torch, loss_fn(plain_positions), params0, *batch)
        grad_err[kind] = _worst_grad_err(torch, got, want)
        del got
    _, got = _grads(torch, loss_fn(None), params0, *batch)
    grad_err["kernel"] = _worst_grad_err(torch, got, want)
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    log("  gradients at the initial weights vs the plain path, worst "
        "leaf |diff| / |plain| in L2: " + "; ".join(
            f"{kind} {e:.3e} ({leaf})" for kind, (e, leaf) in
            grad_err.items()) + f" (tol {TRAIN_GRAD_TOL})")
    if grad_err["kernel"][0] > TRAIN_GRAD_TOL:
        fail("kernel-path gradients disagree with the plain path's")
    if grad_err["dq_no_diagonal"][0] <= TRAIN_GRAD_TOL:
        fail("the gradient check cannot see a dQ that misses the diagonal")

    # the plain attention path, three steps from a copy of the weights:
    # lr is 0 on the first update (optax counts from 0), so losses 1 and
    # 2 are one forward pass at the initial weights and loss 3 is the
    # first after an update
    plain_trainer = trainer_for(plain_positions)
    state = plain_trainer.init_from_params(
        {k: ({n: x.clone() for n, x in v.items()} if isinstance(v, dict)
             else v.clone()) for k, v in params0.items()})
    plain_losses = []
    for _ in range(3):
        state, loss = plain_trainer.step(state, tokens, targets)
        plain_losses.append(float(loss))
    del state, plain_trainer
    gc.collect()
    torch.cuda.empty_cache()

    tracer = Tracer()
    trainer = trainer_for(None, tracer=tracer, registry=Registry())
    state = trainer.init_from_params(params0)
    del params0
    reset_launch_counts()
    attention.reset_impl_counts()
    t0 = time.perf_counter()
    state, loss = trainer.step(state, tokens, targets)
    warm_s = time.perf_counter() - t0
    state, loss2 = trainer.step(state, tokens, targets)
    losses = [float(loss), float(loss2)]
    torch.cuda.reset_peak_memory_stats()
    pending = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss = trainer.step(state, tokens, targets)
        pending.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = launch_counts()
    impl = attention.impl_counts()
    losses += [float(x) for x in pending]
    peak = torch.cuda.max_memory_allocated()
    MEASURED["phase4_peak"] = peak       # phase 18e sets the plan beside it
    steps = 2 + TRAIN_STEPS
    tok_s = b * s / step_s
    mfu = trainer.step_flops(b, s) / step_s / BF16_FLOPS_S
    log(f"  losses {[round(x, 4) for x in losses]}; plain path's first "
        f"three {[round(x, 4) for x in plain_losses]}")
    log(f"  step (host clock, {TRAIN_STEPS} steps after a warm-up of "
        f"{warm_s:.3f} s and one more step): {step_s * 1e3:.1f} ms, "
        f"{tok_s:.0f} tokens/s, model FLOPs (6 N T) "
        f"{trainer.step_flops(b, s):.4e} per step = {mfu:.1%} of 989 "
        f"TFLOP/s; peak memory {peak / 2**30:.2f} GiB; optimizer state "
        f"{trainer.opt_state_bytes() / 2**30:.2f} GiB")
    log(f"  attention impl counts {impl}; kernel launches {counts} over "
        f"{steps} steps")
    expect = {"flash_attention_fwd": 2 * cfg.num_layers * steps,
              "flash_attention_dq": cfg.num_layers * steps,
              "flash_attention_dkv": cfg.num_layers * steps}
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches on the training path, "
                 f"the design implies {n} (remat: forward + recompute)")
    if impl["flash"] == 0 or impl["torch"] != 0:
        fail(f"training did not route every attention call through the "
             f"flash kernels: {impl}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses}")
    diff = max(abs(a - p) for a, p in zip(losses, plain_losses))
    log(f"  kernel vs plain path, first three losses: max |diff| "
        f"{diff:.2e}, loss 3 |diff| {abs(losses[2] - plain_losses[2]):.2e} "
        f"(tol {TRAIN_LOSS_TOL})")
    if diff > TRAIN_LOSS_TOL:
        fail("kernel-path losses disagree with the plain path's")

    # one more step under torch.profiler: where a step's time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    _report_profile(prof, prof_s, top=16)
    _check_train_bridge(trainer, tracer, steps + 1)
    return counts


def _check_train_bridge(trainer, tracer, steps: int) -> None:
    """The trainer's obs bridge over `steps` steps of one batch shape:
    `train_step_seconds` counts each, no recompile, one `train.step` span
    a step, the `step` and `host_gap` phases in
    `train_step_phase_seconds`."""
    spans = tracer.traces(name="train.step", limit=None)
    got = {"train_step_seconds": trainer.step_seconds.count(),
           "train_compile_seconds": trainer.compile_seconds.count(),
           "train_recompiles_total": trainer.recompiles.value(
               fn="train_step"),
           "train.step spans": len(spans),
           "phase step": trainer.phase_seconds.count(phase="step"),
           "phase host_gap": trainer.phase_seconds.count(phase="host_gap")}
    want = {"train_step_seconds": steps, "train_compile_seconds": 1,
            "train_recompiles_total": 0, "train.step spans": steps,
            "phase step": steps, "phase host_gap": steps - 1}
    totals = trainer.profiler.totals()
    log(f"  obs bridge: {got}; step {totals['step']:.3f} s, host_gap "
        f"{totals['host_gap']:.3f} s (host clock)")
    if got != want:
        fail(f"the trainer's obs bridge reads {got}, want {want}")
    if [t["spans"][-1]["attrs"]["compile"] for t in reversed(spans)] != \
            [True] + [False] * (steps - 1):
        fail("train.step spans: only the first step compiles")


# -- phase 5 ----------------------------------------------------------------


async def serve_dense_and_check(torch, name="llama3-8b", spec=True,
                                engine=None, max_new=DENSE_MAX_NEW,
                                teacher=None):
    """`name` (llama3-8b in phase 5, gemma-2b in phase 6; the CLI's
    registry entry, random weights from seed 0) served one-shot (window
    batcher and direct path) and, with `spec`, speculatively (llama3-1b
    draft) through the HTTP app, in-process. `engine`: phase 14's MoE
    model, built by the caller, served `max_new` tokens a request;
    `teacher` (default the engine) is what the sequences are held to."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import model_registry
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY,
        SPEC_KEY,
        create_serving_app,
    )
    from kubeflow_tpu_torch.serving.speculative import SpeculativeEngine

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ec = EngineConfig(max_len=MAX_LEN)
    if engine is None:
        cfg, init, family = model_registry()[name]
        target = InferenceEngine(init(cfg, 0, dev), cfg, family, ec,
                                 device=dev)
    else:
        target, cfg = engine, engine.cfg
    drafts = {}
    if spec:
        drafts[name] = draft = InferenceEngine(
            llama.init(llama.LLAMA3_1B, 1, dev), llama.LLAMA3_1B,
            LLAMA_FAMILY, ec, device=dev)
    torch.cuda.synchronize()
    leaves = [*target.params["blocks"].values(),
              *(v for k, v in target.params.items() if k != "blocks")]
    n_params = sum(getattr(t, "q", t).numel() for t in leaves)  # QTensor
    log(f"  {name} (seed 0, {n_params} params)"
        f"{' and llama3-1b draft (seed 1)' if spec else ''} built in "
        f"{time.perf_counter() - t0:.1f} s")
    app = create_serving_app({name: target}, batch_window_ms=WINDOW_MS,
                             max_batch=DENSE_B, drafts=drafts, warmup=True)
    batcher = app[BATCHERS_KEY][name]
    port = _free_port()
    runner = web.AppRunner(app)
    t0 = time.perf_counter()
    await runner.setup()          # on_startup: the decode graphs' warmup
    log(f"  warmup {time.perf_counter() - t0:.2f} s captured "
        f"{target.captures} CUDA graphs (rows 1, 2, 4, 8 x 3 sampling "
        f"keys); the lanes' dense caches "
        f"{target.lane_bytes() / 2**30:.2f} GiB")
    await web.TCPSite(runner, "127.0.0.1", port).start()
    url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
    gen = torch.Generator().manual_seed(6)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    prompts = [prompt(n) for n in DENSE_PROMPTS[:-1]]
    prompts.append(prompts[0])          # the repeated prompt
    pair = [prompt(40), prompt(40)]     # the explicit 2-row batch
    spec_prompt = prompt(60)
    try:
        async with aiohttp.ClientSession() as sess:
            async def post(body):
                t = time.perf_counter()
                async with sess.post(url, json=body) as r:
                    if r.status != 200:
                        fail(f":generate returned {r.status}: "
                             f"{await r.text()}")
                    return await r.json(), time.perf_counter() - t

            # warm-up (cuBLAS handles, first allocations), not counted
            await post({"tokens": [prompts[0]], "max_new": 2})
            calls0 = batcher.calls
            captures, replays0 = target.captures, target.replays
            reset_launch_counts()
            t0 = time.perf_counter()
            window = await asyncio.gather(*(post(
                {"tokens": [p], "max_new": max_new, "logprobs": True})
                for p in prompts))
            window_s = time.perf_counter() - t0
            direct, direct_s = await post(
                {"tokens": pair, "max_new": max_new, "logprobs": True})
            if spec:
                spec_out, spec_s = await post(
                    {"tokens": [spec_prompt], "max_new": max_new,
                     "speculative": True, "gamma": GAMMA})
            torch.cuda.synchronize()
            counts = launch_counts()
            calls = batcher.calls - calls0
            replays = target.replays - replays0
    finally:
        await runner.cleanup()
    log(f"  window: {len(prompts)} requests in {window_s:.3f} s as {calls} "
        f"batcher call(s); direct 2-row batch {direct_s:.3f} s")
    expect = cfg.num_layers * (max_new - 1) * (calls + 1)
    why = (f"{cfg.num_layers} x {max_new - 1} per one-shot call over "
           f"{calls + 1} calls")
    if spec:
        stats = spec_out["speculative"]
        rounds = stats["proposed"] // stats["gamma"]
        log(f"  speculative {spec_s:.3f} s ({rounds} rounds, acceptance "
            f"{stats['acceptance_rate']}, gamma {stats['gamma']})")
        expect += draft.cfg.num_layers * (stats["gamma"] + 1) * rounds
        why += (f", {draft.cfg.num_layers} x {stats['gamma'] + 1} per "
                f"speculative round over {rounds} rounds")
    log(f"  kernel launches {counts}")
    if counts["decode_attention"] != expect:
        fail(f"decode_attention: {counts['decode_attention']} launches, the "
             f"design implies {expect} ({why})")
    # int8 weights' projections (phase 14's int8 MoE) run int8_proj
    own = ("decode_attention",) + (("int8_proj",) if _is_int8(target)
                                   else ())
    others = {k: n for k, n in counts.items() if k not in own}
    if any(others.values()):
        fail(f"one-shot serving launched other kernels: {others}")
    draft_captures = draft.captures if spec else 0
    log(f"  one-shot decode: {replays} graph replays, "
        f"{target.captures - captures} captures in traffic, draft "
        f"captures {draft_captures}")
    if replays != (max_new - 1) * (calls + 1) \
            or target.captures != captures or draft_captures:
        fail(f"one-shot decode: {replays} replays (the design implies "
             f"{(max_new - 1) * (calls + 1)}), "
             f"{target.captures - captures} captures in traffic")

    # every served sequence teacher-forced through the plain dense model
    # over its unpadded prompt: logprobs (non-speculative) and
    # margin-gated argmax (all)
    outs = [(p, b["tokens"][0], b["logprobs"][0]) for p, (b, _) in
            zip(prompts, window)]
    outs += [(p, o, lp) for p, o, lp in zip(pair, direct["tokens"],
                                            direct["logprobs"])]
    if spec:
        outs.append((spec_prompt, spec_out["tokens"][0], None))
    for p, o, lp in outs:
        if len(o) != max_new or (lp is not None and len(lp) != len(o)) \
                or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"malformed output {o} / {lp}")
    if outs[0][1] != outs[len(prompts) - 1][1]:
        fail(f"repeated prompt gave different greedy tokens: {outs[0][1]} "
             f"vs {outs[len(prompts) - 1][1]}")
    _teacher_check(torch, teacher or target, *zip(*outs),
                   f"one-shot {name}")

    if spec:
        # the confident draft: llama3-1b with its lm_head x50 as its own
        # draft must equal its plain greedy output at acceptance 1.0
        conf = InferenceEngine(dict(draft.params,
                                    lm_head=draft.params["lm_head"] * 50.0),
                               draft.cfg, LLAMA_FAMILY, ec, device=dev)
        want = conf.generate([spec_prompt], max_new=max_new)
        got, cstats = SpeculativeEngine(conf, conf).generate(
            [spec_prompt], max_new=max_new, gamma=GAMMA)
        log(f"  confident self-draft (llama3-1b, lm_head x50): acceptance "
            f"{cstats.acceptance_rate}, tokens equal: "
            f"{torch.equal(got, want)}")
        if not torch.equal(got, want) or cstats.acceptance_rate != 1.0:
            fail("confident self-draft speculative decoding disagrees with "
                 "plain greedy decoding")
        del conf, got, want

    # host time per decode step of the window batch: the same padded
    # batch generated to 1 and to max_new tokens
    arr = torch.zeros(DENSE_B, DENSE_BUCKET, dtype=torch.long)
    mask = torch.zeros(DENSE_B, DENSE_BUCKET, dtype=torch.bool)
    for r, p in enumerate(prompts):
        arr[r, DENSE_BUCKET - len(p):] = torch.tensor(p)
        mask[r, DENSE_BUCKET - len(p):] = True

    def wall(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        target.generate(arr, prompt_mask=mask, max_new=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t1, tn = wall(1), wall(max_new)
    step_ms = (tn - t1) / (max_new - 1) * 1e3
    batch1 = ""
    if spec:
        spec_eng = app[SPEC_KEY][name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, sstats = spec_eng.generate([spec_prompt], max_new=max_new,
                                      gamma=GAMMA)
        torch.cuda.synchronize()
        spec_tok_s = max_new / (time.perf_counter() - t)
        batch1 = (f"speculative (gamma {GAMMA}) {spec_tok_s:.2f} tokens/s at "
                  f"acceptance {sstats.acceptance_rate:.4f}, ")
    torch.cuda.synchronize()
    t = time.perf_counter()
    target.generate([spec_prompt], max_new=max_new)
    torch.cuda.synchronize()
    plain_tok_s = max_new / (time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    log(f"  window batch of {DENSE_B} (host clock): prefill + first token "
        f"{t1 * 1e3:.1f} ms, {step_ms:.2f} ms per decode step "
        f"({DENSE_B * 1e3 / step_ms:.1f} tokens/s); batch 1: {batch1}"
        f"target alone {plain_tok_s:.2f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # one window-batch call under torch.profiler (prefill and 31 decode
    # steps): where the time goes; the same call to 1 token under the
    # profiler too, so that the difference of their device time is the
    # device time of the 31 decode steps
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for n in (1, max_new):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            target.generate(arr, prompt_mask=mask, max_new=n)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t
        busy[n] = sum(_dev_us(e) for e in _device_events(prof))
    _report_profile(prof, prof_s, top=10)
    dev_step_ms = (busy[max_new] - busy[1]) / (max_new - 1) / 1e3
    if name == "llama3-8b":
        MEASURED["phase5_step_ms"] = dev_step_ms
    MEASURED[f"oneshot_step_ms@{name}"] = dev_step_ms
    log(f"  device time per decode step of the window batch: "
        f"{dev_step_ms:.3f} ms (profiled calls to {max_new} and to 1 "
        f"token)")
    return counts


# -- phase 7 ----------------------------------------------------------------


def train_gemma_and_check(torch):
    """gemma-2b trained as the reference trains it: `Trainer(apply_fn=
    lambda p, t: gemma.apply(p, cfg, t))`, dense CE over the tied fp32
    head, fp32 masters, bf16 activations, remat of every block, AdamW;
    the flash kernels at head dim 256 and a group of 8."""
    from unittest import mock

    import numpy as np

    from kubeflow_tpu_torch.models import gemma
    from kubeflow_tpu_torch.ops import attention
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import (
        TrainConfig,
        Trainer,
        cross_entropy_loss,
    )

    dev = torch.device("cuda")
    cfg = gemma.GEMMA_2B            # fp32 masters, bf16, remat
    tc = TrainConfig(warmup_steps=10, total_steps=1000)
    b, s = FLASH_B, FLASH_S
    # explicit positions are not declared contiguous: the plain path
    plain_positions = torch.arange(s, device=dev).expand(b, s)

    def apply_fn(positions):
        return lambda p, t: gemma.apply(p, cfg, t, positions=positions)

    def dense_loss(positions):
        return lambda p, t, y, m: cross_entropy_loss(
            apply_fn(positions)(p, t), y, m)

    def trainer_for(positions):
        return Trainer(apply_fn=apply_fn(positions),
                       init_fn=lambda seed: gemma.init(cfg, seed, dev,
                                                       train=True),
                       train_config=tc, device=dev)

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(b, s, device=dev)

    # gradients at the initial weights: the kernel path and a dQ that
    # misses each query's own key against the plain path, worst leaf (and
    # layer) by relative L2 error. The check has a window: the kernel
    # path must fall below TRAIN_GRAD_TOL and the broken dQ above it.
    params0 = gemma.init(cfg, 0, dev, train=True)
    batch = (tokens, targets, mask)
    _, want = _grads(torch, dense_loss(plain_positions), params0, *batch)
    grad_err = {}
    with mock.patch.object(gemma, "dot_product_attention",
                           _control_attention(torch, "dq_no_diagonal")):
        _, got = _grads(torch, dense_loss(plain_positions), params0, *batch)
    grad_err["dq_no_diagonal"] = _worst_grad_err(torch, got, want)
    del got
    _, got = _grads(torch, dense_loss(None), params0, *batch)
    grad_err["kernel"] = _worst_grad_err(torch, got, want)
    del got, want, params0
    gc.collect()
    torch.cuda.empty_cache()
    log("  gradients at the initial weights vs the plain path, worst "
        "leaf |diff| / |plain| in L2: " + "; ".join(
            f"{kind} {e:.3e} ({leaf})" for kind, (e, leaf) in
            grad_err.items()) + f" (tol {TRAIN_GRAD_TOL})")
    if grad_err["kernel"][0] > TRAIN_GRAD_TOL:
        fail("gemma-2b kernel-path gradients disagree with the plain path's")
    if grad_err["dq_no_diagonal"][0] <= TRAIN_GRAD_TOL:
        fail("the gemma-2b gradient check cannot see a dQ that misses the "
             "diagonal")

    # the plain path, three steps from the same weights (the seed's):
    # losses 1 and 2 are one forward pass at the initial weights (lr 0 on
    # the first update), loss 3 the first after an update
    plain_trainer = trainer_for(plain_positions)
    state = plain_trainer.init(0)
    plain_losses = []
    for _ in range(3):
        state, loss = plain_trainer.step(state, tokens, targets)
        plain_losses.append(float(loss))
    del state, plain_trainer
    gc.collect()
    torch.cuda.empty_cache()

    trainer = trainer_for(None)
    state = trainer.init(0)
    n_params = trainer.param_count
    log(f"  gemma-2b: {n_params} params (fp32 masters, tied head counted "
        f"once), batch {b} x {s}, dense CE")
    if n_params != GEMMA_2B_PARAMS:
        fail(f"gemma-2b has {n_params} params, not {GEMMA_2B_PARAMS}")
    reset_launch_counts()
    attention.reset_impl_counts()
    t0 = time.perf_counter()
    state, loss = trainer.step(state, tokens, targets)
    warm_s = time.perf_counter() - t0
    state, loss2 = trainer.step(state, tokens, targets)
    losses = [float(loss), float(loss2)]
    torch.cuda.reset_peak_memory_stats()
    pending = []
    t0 = time.perf_counter()
    for _ in range(GEMMA_TRAIN_STEPS):
        state, loss = trainer.step(state, tokens, targets)
        pending.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / GEMMA_TRAIN_STEPS
    counts = launch_counts()
    impl = attention.impl_counts()
    losses += [float(x) for x in pending]
    peak = torch.cuda.max_memory_allocated()
    steps = 2 + GEMMA_TRAIN_STEPS
    tok_s = b * s / step_s
    mfu = trainer.step_flops(b, s) / step_s / BF16_FLOPS_S
    log(f"  losses {[round(x, 4) for x in losses]}; plain path's first "
        f"three {[round(x, 4) for x in plain_losses]}")
    log(f"  step (host clock, {GEMMA_TRAIN_STEPS} steps after a warm-up of "
        f"{warm_s:.3f} s and one more step): {step_s * 1e3:.1f} ms, "
        f"{tok_s:.0f} tokens/s, model FLOPs (6 N T) "
        f"{trainer.step_flops(b, s):.4e} per step = {mfu:.1%} of 989 "
        f"TFLOP/s; peak memory {peak / 2**30:.2f} GiB; optimizer state "
        f"{trainer.opt_state_bytes() / 2**30:.2f} GiB")
    log(f"  attention impl counts {impl}; kernel launches {counts} over "
        f"{steps} steps")
    # remat: each block's forward runs twice (forward and recompute)
    expect = {"flash_attention_fwd": 2 * cfg.num_layers * steps,
              "flash_attention_dq": cfg.num_layers * steps,
              "flash_attention_dkv": cfg.num_layers * steps}
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches on gemma-2b's training "
                 f"path, the design implies {n} (remat: forward + "
                 f"recompute)")
    if impl["flash"] == 0 or impl["torch"] != 0:
        fail(f"gemma-2b training did not route every attention call "
             f"through the flash kernels: {impl}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"non-finite gemma-2b loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"gemma-2b loss did not fall: {losses}")
    diff = max(abs(a - p) for a, p in zip(losses, plain_losses))
    log(f"  kernel vs plain path, first three losses: max |diff| "
        f"{diff:.2e}, loss 3 |diff| {abs(losses[2] - plain_losses[2]):.2e} "
        f"(tol {TRAIN_LOSS_TOL})")
    if diff > TRAIN_LOSS_TOL:
        fail("gemma-2b kernel-path losses disagree with the plain path's")

    # one more step under torch.profiler: where a step's time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    _report_profile(prof, prof_s, top=16)
    del state, trainer
    return counts


# -- phase 8 ----------------------------------------------------------------

# the checkpoint goes under build/ (gitignored), inside the checkout
CKPT_DIR = os.path.join(ROOT, "build", "ckpt")
TOKENIZER_VOCAB = 512              # the BPE the port fits on README.md
DOOR_MAX_NEW = 64
DOOR_LENS = PROMPT_LENS * 2        # (b): 8 concurrent streams, 17-300
STOP_AT = 20                       # (c): tokens 20-21 of (a) as the stop
DOOR_TEXT = "Train, save, then serve the checkpoint as text."


def _card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _fit_depth(cfg, free_bytes: int):
    """llama3-1b at full depth when the disk holds its state (fp32
    params and two AdamW moments: 12 bytes a parameter) with a margin,
    else the deepest config that fits: depth is cut, never width."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama

    while cfg.num_layers > 1 and 12 * llama.num_params(cfg) * 1.25 \
            > free_bytes:
        cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
    return cfg


def checkpoint_and_check(torch):
    """Phase 8, training half: two steps of phase 4's trainer, an async
    save, a restore into a fresh Trainer (bit-equal), and one step from
    each state (identical losses). -> (cfg, the saved params on the
    host, the flash kernels' launches, their expected counts)."""
    import shutil

    import numpy as np

    from kubeflow_tpu_torch.data import bpe
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import (
        TrainConfig,
        Trainer,
        chunked_cross_entropy_from_hidden,
    )
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        Checkpointer,
        flatten,
        unflatten,
    )

    dev = torch.device("cuda")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    cfg = _fit_depth(llama.LLAMA3_1B, free)
    log(f"  disk: {free / 2**30:.1f} GiB free under build/; llama3-1b "
        f"state {12 * llama.num_params(llama.LLAMA3_1B) / 2**30:.2f} GiB "
        f"at 12 bytes a parameter; training at {cfg.num_layers} of "
        f"{llama.LLAMA3_1B.num_layers} layers")
    tok_path = os.path.join(ROOT, "build", "ckpt_tokenizer.json")
    with open(os.path.join(ROOT, "README.md")) as f:
        tok = bpe.train([f.read()], vocab_size=TOKENIZER_VOCAB)
    tok.save(tok_path)
    tc = TrainConfig(warmup_steps=10, total_steps=1000)
    b, s = FLASH_B, FLASH_S

    def loss_fn(params, tokens, targets, mask):
        h = llama.hidden(params, cfg, tokens)
        return chunked_cross_entropy_from_hidden(
            h, llama.unembed_matrix(params, cfg), targets, mask,
            num_chunks=16)

    def trainer():
        return Trainer(apply_fn=lambda p, t: llama.apply(p, cfg, t),
                       init_fn=lambda seed: llama.init(cfg, seed, dev,
                                                       train=True),
                       train_config=tc, loss_fn=loss_fn, device=dev)

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    ta = trainer()
    state = ta.init(0)
    reset_launch_counts()
    for _ in range(2):
        state, loss = ta.step(state, tokens, targets)
    log(f"  trained 2 steps (loss {float(loss):.4f}); "
        f"{ta.param_count} params")
    ckpt = Checkpointer(CheckpointConfig(
        CKPT_DIR, save_interval_steps=1, enable_async=True,
        tokenizer_path=tok_path), ta, run_metadata={"model": "llama3-1b"})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not ckpt.save(state):
        fail("the checkpointer did not save step 2")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.wait()
    wait_s = time.perf_counter() - t0
    step_dir = ckpt.step_path(2)
    written = {f: os.path.getsize(os.path.join(step_dir, f))
               for f in sorted(os.listdir(step_dir))}
    total = sum(written.values())
    log(f"  async save (device-to-host copy + thread start) {save_s:.2f} s, "
        f"wait (disk write + commit) {wait_s:.2f} s; {total} bytes "
        f"written ({total / 2**30:.2f} GiB, "
        f"{total / (save_s + wait_s) / 2**30:.2f} GiB/s end to end): "
        f"{written}")
    if "COMMITTED" not in written or ckpt.committed_steps() != [2]:
        fail(f"step 2 not committed: {written}")
    if not os.path.exists(os.path.join(CKPT_DIR, "tokenizer.json")):
        fail("the tokenizer was not carried beside the checkpoint")
    saved = unflatten({n: t.detach().to("cpu", copy=True)
                       for n, t in flatten(state.params).items()})

    tb = trainer()
    t0 = time.perf_counter()
    restored = Checkpointer(CheckpointConfig(CKPT_DIR, enable_async=False),
                            tb).restore(device="cpu")
    restore_s = time.perf_counter() - t0
    pairs = list(zip(flatten(state.params).values(),
                     flatten(restored.params).values(), strict=True))
    for key in ("mu", "nu"):
        pairs += list(zip(state.opt_state[key], restored.opt_state[key],
                          strict=True))
    unequal = sum(not torch.equal(a.detach().cpu(), r.detach())
                  for a, r in pairs)
    log(f"  restore (disk to host) {restore_s:.2f} s: {len(pairs)} tensors, "
        f"{unequal} not bit-equal; step {restored.step}, AdamW count "
        f"{restored.opt_state['count']}")
    if unequal or restored.step != state.step \
            or restored.opt_state["count"] != state.opt_state["count"]:
        fail("the restored state differs from the saved one")
    # one step from each state; the in-memory trainer is freed before the
    # restored state goes to the card (two states would need ~37 GB)
    _, loss_a = ta.step(state, tokens, targets)
    loss_a = float(loss_a)
    del state, ta, pairs, ckpt
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored = tb.state_from(restored.params, restored.opt_state,
                             restored.step)
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    _, loss_b = tb.step(restored, tokens, targets)
    loss_b = float(loss_b)
    counts = launch_counts()
    log(f"  one step from each state: in-memory loss {loss_a!r}, restored "
        f"{loss_b!r} (restored state to the card {to_card_s:.2f} s)")
    if loss_a != loss_b:
        fail("the restored state's step differs from the in-memory one's")
    del restored, tb
    gc.collect()
    torch.cuda.empty_cache()
    layers, steps = cfg.num_layers, 4
    want = {"flash_attention_fwd": 2 * layers * steps,
            "flash_attention_dq": layers * steps,
            "flash_attention_dkv": layers * steps}
    return cfg, saved, {k: counts[k] for k in want}, want


def _quantile(xs, q):
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _parse_metrics(text: str) -> dict:
    """exposition -> {(name, sorted label items): value}"""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^(\w+)(?:\{(.*)\})? (\S+)$", line)
        labels = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


async def door_and_check(torch, cfg, saved):
    """Phase 8, serving half: the CLI's own loader from `--checkpoint
    --tokenizer auto`, served continuously (`--warmup`, depth 2, chunk
    64) over HTTP, checks (a)-(i). -> the kernels' launches over the
    checkpoint app's traffic and over the one-shot app's."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY,
        ENGINES_KEY,
        TOKENIZER_KEY,
        _apply_stop,
        create_serving_app,
    )
    from kubeflow_tpu_torch.train.checkpoint import serving_params

    dev = torch.device("cuda")
    name = "llama3-1b"
    card = _card()
    gen = torch.Generator().manual_seed(8)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    p300 = prompt(300)
    streams = [prompt(n) for n in DOOR_LENS]
    p_h = prompt(300)
    firsts = [p[0] for p in (p300, *streams, p_h)]
    if len(set(firsts)) != len(firsts):
        fail("phase 8's prompts share a first token: reseed them")
    body_a = {"tokens": [p300], "max_new": DOOR_MAX_NEW}

    async def serving(app, port, fn):
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as sess:
                return await fn(sess, f"http://127.0.0.1:{port}")
        finally:
            await runner.cleanup()

    async def post(sess, url, body, headers=None, status=200):
        async with sess.post(url, json=body, headers=headers) as r:
            if r.status != status:
                fail(f"{url} answered {r.status}, not {status}: "
                     f"{await r.text()}")
            return await r.json(), r.headers

    async def stream(sess, url, body, headers=None):
        """-> (tokens, terminal record, event arrival times, sent at,
        response headers)"""
        t0 = time.perf_counter()
        async with sess.post(url, json={**body, "stream": True},
                             headers=headers) as r:
            if r.status != 200 or r.content_type != "text/event-stream":
                fail(f"stream: {r.status} {r.content_type}")
            toks, times, final = [], [], None
            async for line in r.content:
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[6:])
                if "tokens" in ev:
                    toks += ev["tokens"][0]
                    times += [time.perf_counter()] * len(ev["tokens"][0])
                else:
                    final = ev
            return toks, final, times, t0, r.headers

    # the control: an app built from the in-memory params, cold
    t0 = time.perf_counter()
    ctrl = create_serving_app(
        {name: InferenceEngine(serving_params(saved, cfg, dev), cfg,
                               LLAMA_FAMILY, EngineConfig(max_len=MAX_LEN),
                               device=dev)},
        continuous=True, prefill_chunk_tokens=CHUNK)

    async def control(sess, base):
        out, _ = await post(sess, f"{base}/v1/models/{name}:generate",
                            body_a)
        return out["tokens"][0]

    ctrl_tokens = await serving(ctrl, _free_port(), control)
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  control app (in-memory params, cold): {len(ctrl_tokens)} tokens "
        f"in {time.perf_counter() - t0:.1f} s")

    port = _free_port()
    t0 = time.perf_counter()
    app = build_app(parse_args([
        "--model", name, "--checkpoint", CKPT_DIR, "--tokenizer", "auto",
        "--continuous", "--warmup", "--prefill-chunk-tokens", str(CHUNK),
        "--host", "127.0.0.1", "--port", str(port)]))
    if cfg.num_layers != app[ENGINES_KEY][name].cfg.num_layers:
        # a depth cut for the disk: serve the trained depth
        app = create_serving_app(
            {name: InferenceEngine(
                app[ENGINES_KEY][name].params, cfg, LLAMA_FAMILY,
                EngineConfig(max_len=MAX_LEN), device=dev)},
            tokenizer=app[TOKENIZER_KEY], continuous=True, warmup=True,
            prefill_chunk_tokens=CHUNK)
    engine = app[ENGINES_KEY][name]
    batcher = app[BATCHERS_KEY][name]
    tok = app[TOKENIZER_KEY]
    if tok is None or tok.vocab_size != TOKENIZER_VOCAB:
        fail("--tokenizer auto did not load the carried BPE")
    if tok.bos_id in firsts:
        fail("a phase 8 prompt starts with the BPE's BOS: reseed them")
    log(f"  checkpoint app built by the CLI's loader in "
        f"{time.perf_counter() - t0:.1f} s (tokenizer vocab "
        f"{tok.vocab_size}, pipeline depth {batcher.pipeline_depth})")
    gen_url = f"/v1/models/{name}:generate"
    out = {}

    async def traffic(sess, base):
        url = base + gen_url
        reset_launch_counts()
        calls0, slices0 = batcher.calls, batcher.slices
        # (a) stream vs non-stream vs the control
        toks, final, times, _, hdrs = await stream(sess, url, body_a)
        out["a_stream"], out["a_final"] = toks, final
        out["a_rid"] = hdrs.get("X-Request-Id")
        a, _ = await post(sess, url, {**body_a, "logprobs": True})
        out["a"], out["a_lps"] = a["tokens"][0], a["logprobs"][0]
        # (b) 8 concurrent streams
        got = await asyncio.gather(*(stream(
            sess, url, {"tokens": [p], "max_new": DOOR_MAX_NEW})
            for p in streams))
        out["b"] = got
        # (c) stop, alone, so the dropped tokens are its own
        stop = out["a"][STOP_AT:STOP_AT + 2]
        dropped0 = batcher.tokens_dropped
        c, _ = await post(sess, url, {**body_a, "stop": [stop]},
                          headers={"X-Request-Id": "door-stop"})
        out["c"], out["stop"] = c["tokens"][0], stop
        out["c_dropped"] = batcher.tokens_dropped - dropped0
        # (d) text through the BPE, and its encoding sent as tokens
        d, _ = await post(sess, url, {"text": DOOR_TEXT, "max_new": 32})
        out["d"] = d
        out["d_tokens"], _ = await post(sess, url, {
            "tokens": [tok.encode(DOOR_TEXT, bos=True)], "max_new": 32})
        # (e) score the prompt and its greedy continuation
        e, _ = await post(sess, f"{base}/v1/models/{name}:score",
                          {"tokens": [p300 + out["a"]]})
        out["e"] = e
        # (f) (a)'s timeline by its X-Request-Id
        async with sess.get(
                f"{base}/v1/requests/{out['a_rid']}/timeline") as r:
            out["f"] = await r.json() if r.status == 200 else None
        # (i) refusals
        out["i_adapter"], _ = await post(
            sess, url, {**body_a, "adapter": "fr"}, status=400)
        out["i_stream_stop"], _ = await post(
            sess, url, {**body_a, "stream": True, "stop": [stop]},
            status=400)
        # (g) /metrics
        async with sess.get(f"{base}/metrics") as r:
            out["g"] = _parse_metrics(await r.text())
        out["counts"] = launch_counts()
        out["calls"] = batcher.calls - calls0
        out["slices"] = batcher.slices - slices0

    await serving(app, port, traffic)
    L = cfg.num_layers
    counts = out["counts"]
    log(f"  traffic: {out['calls']} decode steps dispatched, "
        f"{out['slices']} prefill slices; kernel launches {counts}")
    want = {"paged_decode_attention": L * out["calls"],
            "paged_prefill_append": L * out["slices"]}
    for k, n in want.items():
        if counts[k] != n or not n:
            fail(f"{k}: {counts[k]} launches over the door's traffic, the "
                 f"design implies {n}")
    # (a)
    if out["a_stream"] != out["a"] or out["a"] != ctrl_tokens \
            or len(out["a"]) != DOOR_MAX_NEW:
        fail(f"(a) stream {out['a_stream'][:8]}..., non-stream "
             f"{out['a'][:8]}..., control {ctrl_tokens[:8]}... differ")
    if out["a_final"] != {"done": True, "total": DOOR_MAX_NEW}:
        fail(f"(a) terminal record {out['a_final']}")
    log(f"  (a) stream == non-stream == control app on the in-memory "
        f"params: {DOOR_MAX_NEW} greedy tokens")
    # (b)
    ttft = [times[0] - t0 for _, _, times, t0, _ in out["b"]]
    itl = [(times[-1] - times[0]) / (len(times) - 1)
           for _, _, times, _, _ in out["b"]]
    if any(len(t) != DOOR_MAX_NEW for t, *_ in out["b"]):
        fail("(b) a stream ended short")
    log(f"  (b) 8 concurrent streams ({DOOR_LENS} prompt tokens, "
        f"{DOOR_MAX_NEW} new), client clock on {card}: TTFT median "
        f"{_quantile(ttft, 0.5) * 1e3:.1f} ms p95 "
        f"{_quantile(ttft, 0.95) * 1e3:.1f} ms; ITL (a stream's span over "
        f"its gaps) median {_quantile(itl, 0.5) * 1e3:.2f} ms p95 "
        f"{_quantile(itl, 0.95) * 1e3:.2f} ms")
    # (c)
    cut = _apply_stop(out["a"], [out["stop"]])
    tl = batcher.timelines.get("door-stop")
    bound = batcher.pipeline_depth * batcher.chunk
    log(f"  (c) stop {out['stop']} at {len(cut)}: {len(out['c'])} tokens "
        f"returned, {len(tl.tokens)} emitted, {out['c_dropped']} decoded "
        f"past the stop and dropped (bound {bound})")
    if out["c"] != cut or len(tl.tokens) != len(cut) + 2 \
            or out["c_dropped"] > bound:
        fail("(c) the stop did not trim or retire its slot as designed")
    # (d)
    d = out["d"]
    if d["text"] != tok.decode(d["tokens"][0]) \
            or d["tokens"] != out["d_tokens"]["tokens"]:
        fail("(d) text is not the tokenizer's encode and decode")
    kept = sum(t < tok.vocab_size for t in d["tokens"][0])
    log(f"  (d) text: {len(tok.encode(DOOR_TEXT, bos=True))} prompt tokens "
        f"(the BPE's encoding, sent as tokens: the same output); "
        f"{len(d['tokens'][0])} tokens, {kept} inside the BPE's vocab, "
        f"decode to {d['text'][:40]!r}")
    # (e) against the teacher-forced plain dense pass and (a)'s logprobs
    seq = p300 + out["a"]
    with torch.inference_mode():
        logp = torch.log_softmax(llama.apply(
            engine.params, cfg, torch.tensor([seq], device=dev))[0, :-1], -1)
        ref = logp[torch.arange(len(seq) - 1, device=dev),
                   torch.tensor(seq[1:], device=dev)].float().cpu()
    got = torch.tensor(out["e"]["logprobs"][0])
    err = float((got - ref).abs().max())
    err_gen = float((got[len(p300) - 1:]
                     - torch.tensor(out["a_lps"])).abs().max())
    log(f"  (e) :score of {len(seq)} tokens: max |diff| {err:.4f} from the "
        f"teacher-forced plain pass, {err_gen:.4f} from :generate's "
        f"logprobs (tol {LOGPROB_TOL})")
    if err > LOGPROB_TOL or err_gen > LOGPROB_TOL \
            or out["e"]["count"] != len(seq) - 1:
        fail("(e) :score disagrees")
    # (f)
    f = out["f"]
    if f is None or f["tokens"] != DOOR_MAX_NEW \
            or not f["ttft_s"] <= f["token_times"][-1]:
        fail(f"(f) timeline of {out['a_rid']}: {f}")
    log(f"  (f) timeline {out['a_rid']}: {f['tokens']} tokens, TTFT "
        f"{f['ttft_s'] * 1e3:.1f} ms, last token {f['token_times'][-1]:.3f}"
        f" s, events {[e['kind'] for e in f['events']]}")
    # (g) against what the requests reckon
    g = out["g"]
    model = (("model", name),)
    answered = 2 + len(streams) + 3      # a twice, b, c, d twice
    # a request hits when an earlier one with its prompt left full
    # blocks below its cache line (prompt + max_new - 1 cells)
    text_prompt = tok.encode(DOOR_TEXT, bos=True)
    served = [(p300, DOOR_MAX_NEW)] * 2 + [
        (p, DOOR_MAX_NEW) for p in streams] + [
        (p300, DOOR_MAX_NEW), (text_prompt, 32), (text_prompt, 32)]
    hits = sum(any(q == p and (len(q) + m - 1) // BS for q, m in served[:i])
               for i, (p, _) in enumerate(served))
    seen = {"ttft": g[("serving_time_to_first_token_seconds_count", model)],
            "itl": g[("serving_itl_seconds_count", model)],
            "hits": g[("serving_prefix_cache_hits_total", model)],
            "tokens_emitted": batcher.tokens_emitted}
    log(f"  (g) /metrics: {seen}; reckoned {answered} answered, {hits} "
        f"hits")
    if seen["ttft"] != answered or seen["itl"] != batcher.tokens_emitted \
            or seen["hits"] != hits:
        fail("(g) /metrics disagrees with the traffic")
    # (i)
    if out["i_adapter"] != {"error": f"model {name!r} has no adapters "
                                     f"loaded"} \
            or out["i_stream_stop"] != {
                "error": "stop does not compose with stream"}:
        fail(f"(i) refusals: {out['i_adapter']} {out['i_stream_stop']}")
    log("  (i) adapter and stream + stop refused with the reference's "
        "400s")
    del app, batcher
    gc.collect()
    torch.cuda.empty_cache()

    # (h) a one-shot app (the window batcher) on the same params streams
    one = create_serving_app({name: engine}, batch_window_ms=WINDOW_MS,
                             max_batch=DENSE_B, warmup=True)

    async def oneshot(sess, base):
        url = base + gen_url
        await post(sess, url, {"tokens": [p_h], "max_new": 2})  # uncounted
        torch.cuda.synchronize()
        reset_launch_counts()
        toks, final, *_ = await stream(
            sess, url, {"tokens": [p_h], "max_new": DOOR_MAX_NEW})
        want = engine.generate([p_h], max_new=DOOR_MAX_NEW)[0].tolist()
        torch.cuda.synchronize()
        return toks, final, want, launch_counts()

    toks, final, want, one_counts = await serving(one, _free_port(), oneshot)
    expect = 2 * L * (DOOR_MAX_NEW - 1)
    log(f"  (h) one-shot stream: {len(toks)} tokens == generate's "
        f"{toks == want}; kernel launches {one_counts} (the design implies "
        f"decode_attention {expect}: {L} x {DOOR_MAX_NEW - 1} for the "
        f"stream and for generate)")
    others = {k: n for k, n in one_counts.items() if k != "decode_attention"}
    if toks != want or final != {"done": True, "total": DOOR_MAX_NEW} \
            or one_counts["decode_attention"] != expect or any(
                others.values()):
        fail("(h) the one-shot stream disagrees")
    del one, engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts, one_counts


# -- phase 9 ----------------------------------------------------------------


SPEC_TOPK = 20                     # the sampled request's top_k
SPEC_TEMPERATURE = 0.8
TOPK_TIE = 0.05                    # logit slack at the top-k boundary
# the self-draft control: llama3-1b with its head scaled by HEAD_SCALE
# drafts for itself. In bf16 it must accept at least this share of its
# proposals: read 211/236 = 0.894 on an H100 80GB HBM3 at 700 W, where a
# verify that commits or reads the wrong draft cell rejects most rounds.
HEAD_SCALE = 50.0
SELF_DRAFT_BF16_FLOOR = 0.8


def _first_divergence_ok(torch, engine, prompt, a, b, scale=1.0):
    """Two greedy sequences of one prompt agree up to their first
    difference, and there the teacher-forced top-2 margin of the plain
    dense model is at most 2 x LOGPROB_TOL x `scale` (a near tie that
    bf16 paths may break either way; `scale` is a factor the model's
    head was multiplied by, which scales its margins with their noise).
    -> (index of the first difference or None, ok)."""
    from kubeflow_tpu_torch.models import llama

    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return None, True
    with torch.inference_mode():
        toks = torch.tensor([prompt + a[:j]], device=engine.device)
        logits = llama.apply(engine.params, engine.cfg, toks)[0, -1]
        top2 = torch.topk(torch.log_softmax(logits.float(), -1), 2).values
    return j, float(top2[0] - top2[1]) <= 2 * LOGPROB_TOL * scale


def _topk_check(torch, engine, prompt, out):
    """Every sampled token lies in the teacher-forced top SPEC_TOPK of
    the plain dense model, a tie at the boundary allowed within
    TOPK_TIE in the logits. -> tokens outside."""
    from kubeflow_tpu_torch.models import llama

    with torch.inference_mode():
        toks = torch.tensor([prompt + out[:-1]], device=engine.device)
        logits = llama.apply(engine.params, engine.cfg,
                             toks)[0, len(prompt) - 1:].float()
        kth = torch.topk(logits, SPEC_TOPK, dim=-1).values[:, -1]
        got = logits[torch.arange(len(out), device=logits.device),
                     torch.tensor(out, device=logits.device)]
        return int((got < kth - TOPK_TIE).sum())


async def serve_spec_and_check(torch):
    """Phase 9: llama3-8b served continuously with a llama3-1b draft
    through the CLI's app (`--spec-decode --draft-model llama3-1b
    --spec-gamma 4 --prefill-chunk-tokens 64 --warmup`, 8 slots,
    max_len 1024)."""
    import aiohttp
    from aiohttp import web
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY,
        ENGINES_KEY,
        OBS_KEY,
    )

    name = "llama3-8b"
    t_phase = time.perf_counter()
    port = _free_port()
    torch.cuda.reset_peak_memory_stats()
    app = build_app(parse_args([
        "--model", name, "--random", "--seed", "0", "--continuous",
        "--warmup", "--prefill-chunk-tokens", str(CHUNK), "--spec-decode",
        "--draft-model", "llama3-1b", "--spec-gamma", str(GAMMA),
        "--host", "127.0.0.1", "--port", str(port)]))
    runner = web.AppRunner(app)
    t0 = time.perf_counter()
    await runner.setup()          # on_startup: the batcher's warmup
    warm_s = time.perf_counter() - t0
    await web.TCPSite(runner, "127.0.0.1", port).start()
    engine = app[ENGINES_KEY][name]
    batcher = app[BATCHERS_KEY][name]
    ce = batcher.cengine
    draft = ce.draft
    graphs = ce.graphs
    captures = graphs.captures
    cfg, L, Ld = engine.cfg, engine.cfg.num_layers, draft.cfg.num_layers
    log(f"  server up in {time.perf_counter() - t_phase:.1f} s ({name}, "
        f"llama3-1b draft at seed 1, gamma {batcher.spec_gamma}, "
        f"{ce.S} slots, max_len {engine.ec.max_len}); warmup {warm_s:.2f} "
        f"s captured {captures} CUDA graphs; draft cache "
        f"{2 * ce.draft_slots().k.numel() * 2 / 2**30:.2f} GiB")
    gen = torch.Generator().manual_seed(9)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    prompts = [prompt(n) for n in DENSE_PROMPTS[:-1]]
    prompts.append(prompts[0])          # the repeated prompt
    edge = prompt(MAX_LEN - DENSE_MAX_NEW)   # prompt + max_new == max_len
    sampled = prompt(40)
    base = f"http://127.0.0.1:{port}"
    url = f"{base}/v1/models/{name}:generate"
    rounds_seen = []
    prof_box = {}
    spec_round = batcher._spec_round

    async def profiled_round():
        # the third round with a live slot under the profiler
        if any(r.prefilling is None for r in batcher._active.values()):
            rounds_seen.append(batcher.spec_rounds)
        if len(rounds_seen) != 3 or "prof" in prof_box:
            return await spec_round()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            await spec_round()
            torch.cuda.synchronize()
            prof_box["wall"] = time.perf_counter() - t
        prof_box["prof"] = prof

    def books():
        return dict(rounds=batcher.spec_rounds, slices=batcher.slices,
                    calls=batcher.calls, proposed=batcher.spec_proposed,
                    accepted=batcher.spec_accepted,
                    emitted=batcher.tokens_emitted,
                    decode_s=batcher.decode_s, hits=batcher.prefix_hits,
                    reused=batcher.tokens_reused)

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    try:
        async with aiohttp.ClientSession() as sess:
            async def post(p, max_new=DENSE_MAX_NEW, **kw):
                async with sess.post(url, json={
                        "tokens": [p], "max_new": max_new,
                        "logprobs": True, **kw}) as r:
                    if r.status != 200:
                        fail(f":generate returned {r.status}: "
                             f"{await r.text()}")
                    return await r.json()

            async def spec_state(body=None):
                if body is None:
                    req = sess.get(f"{base}/v1/spec")
                else:
                    req = sess.post(f"{base}/v1/spec", json=body)
                async with req as r:
                    if r.status != 200:
                        fail(f"/v1/spec returned {r.status}")
                    return await r.json()

            b0 = books()
            reset_launch_counts()
            t0 = time.perf_counter()
            wave1 = await asyncio.gather(*(post(p) for p in prompts))
            wave1_s = time.perf_counter() - t0
            b1 = books()
            wave2 = await asyncio.gather(
                post(edge), post(prompts[6]),
                post(sampled, temperature=SPEC_TEMPERATURE,
                     top_k=SPEC_TOPK))
            torch.cuda.synchronize()
            b2 = books()
            counts = launch_counts()
            spec_captures = graphs.captures - captures

            # one round under the profiler, in a wave that is not timed
            batcher._spec_round = profiled_round
            await asyncio.gather(*(post(prompt(n))
                                   for n in DENSE_PROMPTS[:-1]))
            batcher._spec_round = spec_round
            b_prof = books()

            # the kill switch: the same prompts through plain chunks,
            # from a cold radix cache as wave 1 had
            off = await spec_state({"enabled": False})
            state_off = await spec_state()
            batcher.flush_cache()
            reset_launch_counts()
            t0 = time.perf_counter()
            wave3 = await asyncio.gather(*(post(p) for p in prompts))
            wave3_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            b3 = books()
            off_counts = launch_counts()
            on = await spec_state({"enabled": True})    # drained: safe
            async with sess.get(f"{base}/metrics") as r:
                metrics = await r.text()
    finally:
        batcher._spec_round = spec_round
        await runner.cleanup()
    slo_events = list(app[OBS_KEY].slo._events["serving_spec_acceptance"])
    spec = delta(b0, b2)
    plain = delta(b_prof, b3)
    rounds, slices = spec["rounds"], spec["slices"]
    acceptance = spec["accepted"] / max(spec["proposed"], 1)
    log(f"  spec waves: {rounds} rounds, {slices} prefill slices, "
        f"acceptance {spec['accepted']}/{spec['proposed']} = "
        f"{acceptance:.4f}; kernel launches {counts}; captures in traffic "
        f"{spec_captures}")
    want = {"paged_prefill_append": L * (rounds + slices),
            "decode_attention": Ld * (GAMMA + 1) * rounds,
            "paged_decode_attention": 0}
    for kname, n in want.items():
        if counts[kname] != n:
            fail(f"phase 9 {kname}: {counts[kname]} launches, the design "
                 f"implies {n} ({L} target / {Ld} draft layers, {rounds} "
                 f"rounds, {slices} slices, gamma {GAMMA})")
    others = {k: n for k, n in counts.items() if k not in want and n}
    if others or spec_captures or not rounds:
        fail(f"phase 9: other kernels {others}, {spec_captures} captures "
             f"in traffic, {rounds} rounds")
    reckon = sum(-(-n // CHUNK) for n in [len(p) for p in prompts]
                 + [len(edge), len(sampled), 1])
    if slices != reckon:
        fail(f"phase 9: {slices} slices, the prompts reckon {reckon}")
    hits, reused = delta(b1, b2)["hits"], delta(b1, b2)["reused"]
    if hits != 1 or reused != len(prompts[6]) - 1:
        fail(f"the repeated {len(prompts[6])}-token prompt: {hits} hits, "
             f"{reused} cells reused (want 1 and {len(prompts[6]) - 1})")

    # tokens: the repeats, the teacher-forced plain dense 8B, the edge
    outs = [(p, b["tokens"][0], b["logprobs"][0])
            for p, b in zip(prompts, wave1)]
    outs += [(edge, wave2[0]["tokens"][0], wave2[0]["logprobs"][0]),
             (prompts[6], wave2[1]["tokens"][0], wave2[1]["logprobs"][0])]
    for p, o, lp in outs + [(sampled, wave2[2]["tokens"][0],
                             wave2[2]["logprobs"][0])]:
        if len(o) != DENSE_MAX_NEW or len(lp) != len(o) or not all(
                0 <= t < cfg.vocab_size for t in o):
            fail(f"malformed output {o} / {lp}")
    if outs[0][1] != outs[7][1] or outs[6][1] != outs[9][1]:
        fail("phase 9: a repeated prompt gave different greedy tokens")
    _teacher_check(torch, engine, *zip(*outs), "spec (llama3-8b)")
    outside = _topk_check(torch, engine, sampled, wave2[2]["tokens"][0])
    log(f"  sampled request (temperature {SPEC_TEMPERATURE}, top_k "
        f"{SPEC_TOPK}): {outside} tokens outside the teacher-forced top "
        f"{SPEC_TOPK} (tie slack {TOPK_TIE})")
    if outside:
        fail("phase 9: sampled tokens outside the top-k set")

    # the kill switch's pass
    log(f"  /v1/spec off: {off}; GET {state_off}; back on: {on}")
    if state_off["models"][name] != {"draft": True, "spec_enabled": False} \
            or on["models"][name]["spec_enabled"] is not True \
            or not batcher.spec_enabled:
        fail("phase 9: /v1/spec did not switch speculation")
    pwant = {"paged_decode_attention": L * plain["calls"],
             "paged_prefill_append": L * plain["slices"],
             "decode_attention": 0}
    log(f"  spec off: {plain['calls']} decode steps, {plain['slices']} "
        f"slices, {plain['rounds']} rounds; kernel launches {off_counts}")
    if plain["rounds"] or any(off_counts[k] != n for k, n in pwant.items()) \
            or not plain["calls"]:
        fail(f"phase 9, spec off: launches {off_counts}, the design implies "
             f"{pwant}; rounds {plain['rounds']}")
    off_outs = [b["tokens"][0] for b in wave3]
    _teacher_check(torch, engine, prompts, off_outs,
                   [b["logprobs"][0] for b in wave3], "spec off (llama3-8b)")
    same = 0
    for p, (_, o, _), o2 in zip(prompts, outs, off_outs):
        j, ok = _first_divergence_ok(torch, engine, p, o, o2)
        same += j is None
        if not ok:
            fail(f"phase 9: spec and plain greedy tokens part at {j} where "
                 f"the teacher-forced margin exceeds {2 * LOGPROB_TOL}")
    log(f"  spec vs plain greedy tokens: {same}/{len(prompts)} identical, "
        f"the rest parting at near ties")

    # the acceptance SLO
    series = [ln for ln in metrics.splitlines()
              if 'slo="serving_spec_acceptance"' in ln]
    log(f"  /metrics: {series}; {len(slo_events)} acceptance events")
    if len(series) != 3 or len(slo_events) != batcher.spec_proposed:
        fail(f"phase 9: acceptance SLO series {series}, {len(slo_events)} "
             f"events for {batcher.spec_proposed} proposed draft tokens")

    # host and device time: the two 8-prompt waves from a cold cache,
    # whole (prefill and decode) and their decode alone
    host_ms = spec["decode_s"] / rounds * 1e3
    w1 = delta(b0, b1)
    tok_spec = len(prompts) * DENSE_MAX_NEW / wave1_s
    tok_off = len(prompts) * DENSE_MAX_NEW / wave3_s
    log(f"  (host clock) {host_ms:.2f} ms a round (dispatch + wait), "
        f"{spec['emitted'] / rounds:.2f} tokens a round; spec off "
        f"{plain['decode_s'] / plain['calls'] * 1e3:.2f} ms a decode step "
        f"(dispatch + wait, depth 2); the 8-prompt wave "
        f"{tok_spec:.1f} tokens/s with spec, {tok_off:.1f} tokens/s with "
        f"the switch off; decode alone (tokens emitted / decode s) "
        f"{w1['emitted'] / w1['decode_s']:.1f} tokens/s with spec, "
        f"{plain['emitted'] / plain['decode_s']:.1f} with the switch off")
    if "prof" not in prof_box:
        fail("phase 9: the profile wave ran no round with a live slot")
    _report_profile(prof_box["prof"], prof_box["wall"], top=6)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # self-draft control: llama3-1b, lm_head x HEAD_SCALE, drafting for
    # itself. fp32 (the CUDA-core kernels, P unrounded) must accept every
    # proposal and give the plain batcher's tokens. In bf16 the verify's
    # logits (P rounded to bf16 on the tensor cores) and the draft's or
    # plain decode's may part at the random model's near ties: a
    # sequence may leave the plain batcher's only where the 8B's rule
    # above, scaled with the head, allows it, and acceptance must reach
    # SELF_DRAFT_BF16_FLOOR.
    params = dict(draft.params,
                  lm_head=draft.params["lm_head"] * HEAD_SCALE)
    dcfg, dev = draft.cfg, draft.device
    del app, runner, engine, batcher, ce, graphs, draft
    gc.collect()
    torch.cuda.empty_cache()

    def cast(tree, dtype):
        return {k: cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in tree.items()}

    async def control(conf, with_draft):
        b = ContinuousBatcher(conf, asyncio.Lock(), max_slots=SLOTS,
                              prefill_chunk_tokens=CHUNK, seed=0,
                              draft=conf if with_draft else None,
                              spec_gamma=GAMMA)
        try:
            out = await asyncio.gather(*(b.submit(p, DENSE_MAX_NEW)
                                         for p in prompts))
            return [list(t) for t in out], b
        finally:
            await b.close()

    for dtype in (torch.bfloat16, torch.float32):
        ccfg = dataclasses.replace(dcfg, dtype=dtype)
        conf = InferenceEngine(cast(params, dtype), ccfg, LLAMA_FAMILY,
                               EngineConfig(max_len=MAX_LEN), device=dev)
        self_out, sb = await control(conf, True)
        plain_out, _ = await control(conf, False)
        parts = [_first_divergence_ok(torch, conf, p, a, b, HEAD_SCALE)
                 for p, a, b in zip(prompts, self_out, plain_out)]
        label = str(dtype).replace("torch.", "")
        rate = sb.spec_accepted / max(sb.spec_proposed, 1)
        log(f"  self-draft control (llama3-1b, lm_head x{HEAD_SCALE:g}, "
            f"{label}): acceptance {sb.spec_accepted}/{sb.spec_proposed} "
            f"= {rate:.4f}, {[j for j, _ in parts].count(None)}/"
            f"{len(prompts)} sequences equal to the plain batcher's, the "
            f"first differences at {[j for j, _ in parts if j is not None]}"
            f", each at a near tie: {all(ok for _, ok in parts)}")
        if dtype == torch.float32:
            bad = (sb.spec_accepted != sb.spec_proposed
                   or self_out != plain_out)
        else:
            bad = (rate < SELF_DRAFT_BF16_FLOOR
                   or not all(ok for _, ok in parts))
        if not sb.spec_proposed or bad:
            fail(f"phase 9: the {label} self-draft disagrees with plain "
                 f"continuous decoding")
        del conf, sb
        gc.collect()
        torch.cuda.empty_cache()
    del params
    log(f"  phase 9 wall {time.perf_counter() - t_phase:.1f} s")
    # the verify pass's launches under their own name, the slices' under
    # the kernel's
    verify = L * rounds
    counts["paged_prefill_append"] -= verify
    counts["paged_prefill_append" + VERIFY] = verify
    return counts, off_counts


# -- phase 10 ---------------------------------------------------------------


TENANT_MAX_NEW = 96                 # phase 10's bulk and migrated budgets
LIVE_MAX_NEW = 16
PREEMPT_AFTER = 16                  # bulk tokens out before live arrives
TENANTS = {"tenants": {
    "live": {"priority": "interactive"},
    "bulk": {"priority": "batch"},
    "iso": {"priority": "standard", "prefix_isolation": True},
    "paced": {"requests_per_s": 0.5, "request_burst": 1.0}}}
MIGRATE_LENS = (17, 130, 300, 520, 64)
# how far each of the four admitted streams is read before the export:
# the earliest to decode is read furthest, so none completes first
MIGRATE_READ = (70, 40, 5, 0)
# gemma-2b's pool geometry: a record of it must be refused by a
# llama3-1b pool before anything is allocated
GEMMA_GEOMETRY = {"block_size": BS, "num_kv_heads": 1, "head_dim": 256,
                  "num_layers": 18}


def _tie_rule(torch, engine, label, prompt, want, got):
    """`got` equals the uninterrupted `want` up to their first
    difference, and there the teacher-forced top-2 margin of the plain
    dense model is at most 2 x LOGPROB_TOL (a near tie that the two bf16
    paths, paged decode against a recomputed prefill-append tail, may
    break either way). Fails otherwise; logs the difference and its
    margin. -> True when the two are equal."""
    from kubeflow_tpu_torch.models import llama

    j = next((i for i, (x, y) in enumerate(zip(want, got)) if x != y), None)
    if j is None and len(want) == len(got):
        return True
    if j is None:
        fail(f"{label}: {len(got)} tokens, the uninterrupted run gave "
             f"{len(want)}")
    with torch.inference_mode():
        toks = torch.tensor([prompt + want[:j]], device=engine.device)
        logits = llama.apply(engine.params, engine.cfg, toks)[0, -1]
        top2 = torch.topk(torch.log_softmax(logits.float(), -1), 2).values
    margin = float(top2[0] - top2[1])
    log(f"  {label}: parts from the uninterrupted run at token {j} of "
        f"{len(want)}, teacher-forced top-2 margin {margin:.4f} (tie rule: "
        f"<= {2 * LOGPROB_TOL})")
    if margin > 2 * LOGPROB_TOL:
        fail(f"{label}: parts from the uninterrupted run at {j} where the "
             f"teacher-forced margin {margin:.4f} exceeds "
             f"{2 * LOGPROB_TOL}")
    return False


async def _serve_app(argv):
    """The CLI's app for `argv`, warmed and served on a free local port.
    -> (app, runner, base url)."""
    from aiohttp import web

    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    if "--fleet-router" in argv:
        argv = argv + ["--advertise", base]
    app = build_app(parse_args(argv + ["--host", "127.0.0.1",
                                       "--port", str(port)]))
    runner = web.AppRunner(app)
    await runner.setup()          # on_startup: the batcher's warmup
    await web.TCPSite(runner, "127.0.0.1", port).start()
    return app, runner, base


async def _post_json(sess, url, body, headers=None, status=200):
    async with sess.post(url, json=body, headers=headers) as r:
        if r.status != status:
            fail(f"{url} answered {r.status}, not {status}: "
                 f"{await r.text()}")
        return await r.json(), r.headers


def _wave_slices(timelines, rids):
    """The prefill slices the admissions of `rids` reckon: every admit
    and resume event's computed suffix, in 64-token slices."""
    n = 0
    for rid in rids:
        for ev in timelines.get(rid).to_dict()["events"]:
            if ev["kind"] in ("admit", "resume"):
                n += -(-ev["prefill_computed"] // CHUNK)
    return n


async def tenancy_and_check(torch):
    """Phase 10a: llama3-1b as a multi-tenant replica through the CLI's
    app (`--tenants`, `--max-batch 2`, chunked prefill 64, `--warmup`,
    depth 2): the oracle, contention with preemption, isolation and
    throttling. -> the paged kernels' launches over the four waves."""
    import tempfile

    import aiohttp

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.server import BATCHERS_KEY, ENGINES_KEY

    name = "llama3-1b"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tenants.json")
        with open(path, "w") as f:
            json.dump(TENANTS, f)
        app, runner, base = await _serve_app([
            "--model", name, "--random", "--seed", "0", "--continuous",
            "--warmup", "--prefill-chunk-tokens", str(CHUNK),
            "--max-batch", "2", "--tenants", path])
    engine, batcher = app[ENGINES_KEY][name], app[BATCHERS_KEY][name]
    graphs = batcher.cengine.graphs
    captures = graphs.captures
    L = engine.cfg.num_layers
    log(f"  server up in {time.perf_counter() - t_phase:.1f} s "
        f"({batcher.cengine.S} slots, pipeline depth "
        f"{batcher.pipeline_depth}, tenants {batcher.tenancy.names()}); "
        f"warmup captured {captures} CUDA graphs")
    gen = torch.Generator().manual_seed(10)

    def prompt(n):
        return torch.randint(0, engine.cfg.vocab_size, (n,),
                             generator=gen).tolist()

    bulk = {"bulk-300": prompt(300), "bulk-130": prompt(130)}
    live, paced = prompt(17), prompt(17)
    url = f"{base}/v1/models/{name}:generate"
    emitted = {t: 0 for t in TENANTS["tenants"]}
    counts_all: dict = {}

    def wave_start():
        reset_launch_counts()
        return batcher.calls, batcher.slices

    def wave_end(label, start, rids):
        """Exact launches over the wave: 16 paged decode launches per
        dispatched step, 16 prefill-append launches per slice (admission
        and re-admission tails), slices as the admissions reckon."""
        calls, slices = (batcher.calls - start[0], batcher.slices - start[1])
        counts = launch_counts()
        want = {"paged_decode_attention": L * calls,
                "paged_prefill_append": L * slices}
        reckon = _wave_slices(batcher.timelines, rids)
        log(f"  {label}: {calls} decode steps, {slices} slices; launches "
            f"{counts}")
        if any(counts[k] != n for k, n in want.items()) or slices != reckon:
            fail(f"phase 10a {label}: launches {counts}, the design implies "
                 f"{want}; {slices} slices, the admissions reckon {reckon}")
        for k in want:
            counts_all[k] = counts_all.get(k, 0) + counts[k]

    async def gen_req(sess, rid, tenant, p, max_new=TENANT_MAX_NEW,
                      status=200):
        body, headers = await _post_json(
            sess, url, {"tokens": [p], "max_new": max_new,
                        "logprobs": True},
            {"X-Tenant": tenant, "X-Request-Id": rid}, status=status)
        if status == 200:
            emitted[tenant] += len(body["tokens"][0])
        return body, headers

    try:
        async with aiohttp.ClientSession() as sess:
            # 1. the oracle: each bulk prompt alone, then a cold cache
            start = wave_start()
            oracle = {}
            for rid, p in bulk.items():
                body, _ = await gen_req(sess, f"oracle-{rid}", "bulk", p)
                oracle[rid] = (body["tokens"][0], body["logprobs"][0])
            wave_end("oracle", start, [f"oracle-{r}" for r in bulk])
            batcher.flush_cache()

            # 2. contention: both bulk prompts, then live once both have
            # PREEMPT_AFTER tokens out (read in-process from the batcher)
            start = wave_start()
            pre0, reused0 = batcher.preemptions, batcher.tokens_reused
            tasks = {rid: asyncio.ensure_future(gen_req(sess, rid, "bulk", p))
                     for rid, p in bulk.items()}
            t0 = time.perf_counter()
            while not (len(batcher._active) == 2 and all(
                    len(r.out) >= PREEMPT_AFTER
                    for r in batcher._active.values())):
                if time.perf_counter() - t0 > 60:
                    fail("phase 10a: the bulk requests never both decoded")
                await asyncio.sleep(0.002)
            t_live = time.perf_counter()
            live_body, _ = await gen_req(sess, "live", "live", live,
                                         LIVE_MAX_NEW)
            live_s = time.perf_counter() - t_live
            got = {rid: (await t)[0] for rid, t in tasks.items()}
            contention_s = time.perf_counter() - t0
            wave_end("contention", start, list(bulk) + ["live"])
            preempted = batcher.preemptions - pre0

            # 3. isolation: iso's 300-token prompt misses bulk's cache
            start = wave_start()
            hits0, reused1 = batcher.prefix_hits, batcher.tokens_reused
            iso_body, _ = await gen_req(sess, "iso", "iso", bulk["bulk-300"])
            iso_hits = batcher.prefix_hits - hits0
            iso_reused = batcher.tokens_reused - reused1
            wave_end("isolation", start, ["iso"])

            # 4. throttling: paced's second request, back to back
            start = wave_start()
            await gen_req(sess, "paced-1", "paced", paced, LIVE_MAX_NEW)
            shed, shed_headers = await gen_req(
                sess, "paced-2", "paced", paced, LIVE_MAX_NEW, status=429)
            wave_end("throttling", start, ["paced-1"])
            async with sess.get(f"{base}/metrics") as r:
                metrics = _parse_metrics(await r.text())
        if graphs.captures != captures:
            fail(f"phase 10a: traffic captured {graphs.captures - captures} "
                 f"CUDA graphs after warmup")
        timelines = {rid: batcher.timelines.get(rid).to_dict()
                     for rid in list(bulk) + ["live"]}
        ledger = batcher.cache_anatomy()["ledger"]
        stats = batcher.tenant_stats()
    finally:
        await runner.cleanup()

    # the victim: the younger bulk request, re-admitted from its donated
    # blocks (a full block below its last written cell is a cache hit)
    victims = [rid for rid in bulk
               if any(e["kind"] == "preempt"
                      for e in timelines[rid]["events"])]
    younger = max(bulk, key=lambda r: timelines[r]["enqueue_monotonic_s"])
    log(f"  contention: {preempted} preemption(s) of {victims} (the younger "
        f"bulk request is {younger}); live answered in {live_s:.3f} s, the "
        f"wave in {contention_s:.3f} s")
    if preempted < 1 or victims != [younger]:
        fail(f"phase 10a: {preempted} preemptions of {victims}, want the "
             f"younger bulk request {younger}")
    events = timelines[younger]["events"]
    pre = next(e for e in events if e["kind"] == "preempt")
    res = next(e for e in events if e["kind"] == "resume")
    kv_len = len(bulk[younger]) + pre["emitted"]
    want_reused = BS * ((kv_len - 1) // BS)
    log(f"  the victim: preempted with {pre['emitted']} tokens out, "
        f"re-admitted reusing {res['prefill_reused']} cells (want >= "
        f"{want_reused}) and prefilling {res['prefill_computed']}")
    if res["prefill_reused"] < want_reused:
        fail(f"phase 10a: the re-admission reused {res['prefill_reused']} "
             f"cells, its donated blocks hold {want_reused}")

    # tokens: the tie rule against the oracle, logprobs against the
    # teacher-forced plain model
    prompts, outs, lps = [], [], []
    for rid, p in bulk.items():
        prompts += [p, p]
        outs += [oracle[rid][0], got[rid]["tokens"][0]]
        lps += [oracle[rid][1], got[rid]["logprobs"][0]]
        _tie_rule(torch, engine, f"bulk {rid} under contention", p,
                  oracle[rid][0], got[rid]["tokens"][0])
    prompts += [live, bulk["bulk-300"]]
    outs += [live_body["tokens"][0], iso_body["tokens"][0]]
    lps += [live_body["logprobs"][0], iso_body["logprobs"][0]]
    for o, lp in zip(outs, lps):
        if len(lp) != len(o) or not all(
                0 <= t < engine.cfg.vocab_size for t in o):
            fail(f"phase 10a: malformed output {o} / {lp}")
    _teacher_check(torch, engine, prompts, outs, lps, "tenants")
    _tie_rule(torch, engine, "iso (isolated namespace)", bulk["bulk-300"],
              oracle["bulk-300"][0], iso_body["tokens"][0])
    log(f"  isolation: iso's 300-token prompt {iso_hits} hits, {iso_reused} "
        f"cells reused (bulk cached it)")
    if iso_hits or iso_reused:
        fail("phase 10a: iso's prompt hit another tenant's cache")
    retry = shed_headers.get("Retry-After")
    log(f"  throttling: paced's second request 429 {shed['error']!r}, "
        f"Retry-After {retry}")
    if not retry or int(retry) < 1 or "throttled (rate)" not in shed["error"]:
        fail(f"phase 10a: paced's 429 carried Retry-After {retry}")

    def series(fam, tenant, **kw):
        labels = tuple(sorted({"model": name, "tenant": tenant,
                               **kw}.items()))
        return metrics.get((fam, labels))

    tokens = {t: series("serving_tenant_tokens_total", t) for t in emitted}
    log(f"  /metrics: preemptions {series('serving_tenant_preemptions_total', 'bulk')}, "
        f"tokens {tokens} (emitted {emitted}), rate throttles of paced "
        f"{series('serving_tenant_throttled_total', 'paced', reason='rate')}; "
        f"ledger conserved {ledger['conserved']}")
    if (series("serving_tenant_preemptions_total", "bulk")
            != batcher.preemptions or tokens != emitted
            or series("serving_tenant_throttled_total", "paced",
                      reason="rate") != 1
            or stats["bulk"]["preempted"] != batcher.preemptions):
        fail("phase 10a: the tenant series disagree with the traffic")
    if not ledger["conserved"]:
        fail(f"phase 10a: the block ledger is not conserved: {ledger}")
    log(f"  phase 10a wall {time.perf_counter() - t_phase:.1f} s")
    return counts_all


async def migration_and_check(torch):
    """Phase 10b: two llama3-1b replicas (the CLI's app, 4 slots, chunked
    prefill 64, `--warmup`, depth 2): B's oracle, wave M1 (A's batcher
    exports, B imports and resumes over HTTP), wave M2 (`POST /drain
    {"migrate": true}` from A into B), B's refusals. -> the paged
    kernels' launches over the waves."""
    import aiohttp

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving import migration
    from kubeflow_tpu_torch.serving.server import BATCHERS_KEY, ENGINES_KEY

    name = "llama3-1b"
    t_phase = time.perf_counter()
    argv = ["--model", name, "--random", "--seed", "0", "--continuous",
            "--warmup", "--prefill-chunk-tokens", str(CHUNK),
            "--max-batch", "4"]
    app_a, runner_a, base_a = await _serve_app(argv)
    app_b, runner_b, base_b = await _serve_app(argv)
    a, b = app_a[BATCHERS_KEY][name], app_b[BATCHERS_KEY][name]
    engine = app_b[ENGINES_KEY][name]
    L = engine.cfg.num_layers
    captures = (a.cengine.graphs.captures, b.cengine.graphs.captures)
    log(f"  replicas A and B up in {time.perf_counter() - t_phase:.1f} s "
        f"({a.cengine.S} slots each, pipeline depth {a.pipeline_depth})")
    gen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, engine.cfg.vocab_size, (n,),
                             generator=gen).tolist() for n in MIGRATE_LENS]
    if len({p[0] for p in prompts}) != len(prompts):
        # a shared first token would seed a partial (copy-on-write) match
        # and move the slice counts
        fail("phase 10b's prompts share a first token: reseed them")
    url_b = f"{base_b}/v1/models/{name}:generate"
    counts_all: dict = {}

    def launches(label, start, want_slices):
        calls = a.calls + b.calls - start[0]
        slices = a.slices + b.slices - start[1]
        counts = launch_counts()
        want = {"paged_decode_attention": L * calls,
                "paged_prefill_append": L * slices}
        log(f"  {label}: {calls} decode steps, {slices} slices; launches "
            f"{counts}")
        if any(counts[k] != n for k, n in want.items()) or (
                want_slices is not None and slices != want_slices):
            fail(f"phase 10b {label}: launches {counts}, the design "
                 f"implies {want}; {slices} slices, want {want_slices}")
        for k in want:
            counts_all[k] = counts_all.get(k, 0) + counts[k]

    def wave_start():
        reset_launch_counts()
        return a.calls + b.calls, a.slices + b.slices

    def pool(batcher, ids):
        st = batcher.cengine.slots()
        return st.k[:, ids], st.v[:, ids]

    try:
        async with aiohttp.ClientSession() as sess:
            # B's oracle, one prompt at a time, then a cold cache
            start = wave_start()
            oracle = []
            for p in prompts:
                body, _ = await _post_json(sess, url_b, {
                    "tokens": [p], "max_new": TENANT_MAX_NEW,
                    "logprobs": True})
                oracle.append(body["tokens"][0])
            launches("B's oracle", start,
                     sum(-(-n // CHUNK) for n in MIGRATE_LENS))
            b.flush_cache()

            # wave M1, at batcher level: five streams on A, four admitted
            start = wave_start()
            streams = [a.open_stream(p, TENANT_MAX_NEW) for p in prompts]
            t0 = time.perf_counter()
            for (fut, q), k in zip(streams, MIGRATE_READ):
                for _ in range(k):
                    if await q.get() is None:
                        fail("phase 10b: a stream ended before its migrate "
                             "point")
            if time.perf_counter() - t0 > 60 or any(
                    f.done() for f, _ in streams) or len(a._active) != 4 \
                    or len(a._pending) != 1:
                fail(f"phase 10b M1: {len(a._active)} active, "
                     f"{len(a._pending)} pending, done "
                     f"{[f.done() for f, _ in streams]} at the export")
            tables = {r.meta.request_id: r.table for r in a._active.values()}
            t0 = time.perf_counter()
            records = await a.export_sequences()
            export_s = time.perf_counter() - t0
            launches("M1 on A until the export", start, None)
            for fut, _ in streams:
                try:
                    await fut
                    fail("phase 10b M1: an exported future resolved")
                except Exception as e:  # noqa: BLE001
                    if type(e).__name__ != "MigratedAway":
                        fail(f"phase 10b M1: {e!r}, not MigratedAway")
            n_fulls = [r["kv"]["n_full"] if r["kv"] else 0 for r in records]
            blocks = sum(n_fulls)
            log(f"  M1: exported {len(records)} records (outs "
                f"{[len(r['out']) for r in records]}, full blocks {n_fulls})"
                f" in {export_s * 1e3:.1f} ms = "
                f"{export_s * 1e3 / max(blocks, 1):.3f} ms a block "
                f"(synchronous: the worker's halt, the device-to-host copy, "
                f"float32 base64)")
            if a._active or a.kv_blocks_in_use() != a._radix.cached_blocks \
                    or any(n.refs for n in _nodes(a._radix)):
                fail("phase 10b M1: A still holds blocks after the export")
            import_s, reused0 = 0.0, b.tokens_reused
            for rec in records:
                free0 = b.cengine.pool.num_free
                t0 = time.perf_counter()
                adopted = await b.import_sequence(rec)
                torch.cuda.synchronize()
                import_s += time.perf_counter() - t0
                n = rec["kv"]["n_full"] if rec["kv"] else 0
                if adopted != n or b.cengine.pool.num_free != free0 - n:
                    fail(f"phase 10b M1: B adopted {adopted} of {n} blocks")
                if not n:
                    continue
                # bit-equal: A's blocks, the wire's, B's adopted ones
                nodes, _, _ = b._radix.match(rec["tokens"][:n * BS],
                                             ns=rec["ns"])
                got_k, got_v = pool(b, [nd.block for nd in nodes])
                src_k, src_v = pool(a, [int(x) for x in
                                        tables[rec["request_id"]][:n]])
                wk, wv = (torch.from_numpy(x.copy()).to(
                    got_k.device, got_k.dtype)
                    for x in migration.decode_kv(rec["kv"]))
                if not (torch.equal(got_k, src_k) and torch.equal(got_v, src_v)
                        and torch.equal(got_k, wk) and torch.equal(got_v, wv)):
                    fail(f"phase 10b M1: the imported blocks of "
                         f"{rec['request_id']} differ from the exported ones")
            log(f"  M1: B imported {blocks} blocks in {import_s * 1e3:.1f} ms "
                f"= {import_s * 1e3 / max(blocks, 1):.3f} ms a block "
                f"(synchronous: base64 decode, host-to-device copy); bit-"
                f"equal to A's exported blocks")
            start = wave_start()
            resumed = await asyncio.gather(*(_post_json(sess, url_b, {
                "tokens": [r["tokens"]],
                "max_new": r["max_new"] - len(r["out"]),
                "logprobs": True}) for r in records))
            reused = b.tokens_reused - reused0
            want_slices = sum(
                -(-(len(r["tokens"]) - min(n * BS, len(r["tokens"]) - 1))
                  // CHUNK) for r, n in zip(records, n_fulls))
            launches("M1 resume on B", start, want_slices)
            log(f"  M1: B reused {reused} cells (want >= {blocks * BS})")
            if reused < blocks * BS:
                fail("phase 10b M1: the resumed prefills missed the imported "
                     "blocks")
            full_outs, full_lps, plist = [], [], []
            for rec, (body, _) in zip(records, resumed):
                rid = rec["request_id"]
                p = rec["tokens"][:rec["prompt_len"]]
                if p not in prompts or rec["tokens"] != p + rec["out"]:
                    fail(f"phase 10b M1: {rid}'s record lost its prompt")
                out = rec["out"] + body["tokens"][0]
                full_outs.append(out)
                full_lps.append(rec["lps"] + body["logprobs"][0])
                plist.append(p)
                _tie_rule(torch, engine, f"M1 {rid} ({len(p)}-token prompt, "
                          f"{len(rec['out'])} out at the export)", p,
                          oracle[prompts.index(p)], out)
            _teacher_check(torch, engine, plist, full_outs, full_lps,
                           "M1 migrated (llama3-1b)")

            # wave M2, over HTTP: four streams and a plain request on A,
            # then A drains into B
            a.end_drain()
            a.flush_cache()
            b.flush_cache()
            start = wave_start()
            url_a = f"{base_a}/v1/models/{name}:generate"

            async def sse(p, rid):
                async with sess.post(url_a, json={
                        "tokens": [p], "max_new": TENANT_MAX_NEW,
                        "stream": True},
                        headers={"X-Request-Id": rid}) as r:
                    if r.status != 200:
                        fail(f"phase 10b M2: stream answered {r.status}")
                    events = []
                    async for line in r.content:
                        if line.startswith(b"data: "):
                            events.append(json.loads(line[6:]))
                    return events

            tasks = [asyncio.ensure_future(sse(p, f"m2-{i}"))
                     for i, p in enumerate(prompts[:4])]
            t0 = time.perf_counter()
            while not (len(a._active) == 4 and all(
                    r.prefilling is None and r.out
                    for r in a._active.values())):
                if time.perf_counter() - t0 > 60:
                    fail("phase 10b M2: the streams never all decoded")
                await asyncio.sleep(0.002)
            plain = asyncio.ensure_future(_post_json(
                sess, url_a, {"tokens": [prompts[4]],
                              "max_new": TENANT_MAX_NEW},
                {"X-Request-Id": "m2-plain"}, status=503))
            while len(a._pending) != 1:
                if time.perf_counter() - t0 > 60:
                    fail("phase 10b M2: the plain request never queued")
                await asyncio.sleep(0.002)
            t0 = time.perf_counter()
            drained, _ = await _post_json(sess, f"{base_a}/drain", {
                "migrate": True, "peers": [base_b]})
            drain_s = time.perf_counter() - t0
            events = await asyncio.gather(*tasks)
            plain_body, plain_headers = await plain
            launches("M2 (A until the drain)", start, None)
            async with sess.get(f"{base_a}/healthz") as r:
                health_a = r.status
            metrics_a, metrics_b = [], []
            for base, out in ((base_a, metrics_a), (base_b, metrics_b)):
                async with sess.get(f"{base}/metrics") as r:
                    out.append(_parse_metrics(await r.text()))
            metrics_a, metrics_b = metrics_a[0], metrics_b[0]
            model = (("model", name),)
            blocks_out = metrics_a[("serving_migration_blocks_total",
                                    (("direction", "out"),) + model)]
            blocks_in = metrics_b[("serving_migration_blocks_total",
                                   (("direction", "in"),) + model)]
            in_total = metrics_b[("serving_migration_in_total", model)]
            log(f"  M2: /drain answered {drained} in {drain_s * 1e3:.1f} ms; "
                f"terminal events {[e[-1] for e in events]}; the plain "
                f"request {plain_body}; A's /healthz {health_a}; B's "
                f"migration_in {in_total}, blocks in {blocks_in} (A out "
                f"{blocks_out}, B cached {b._radix.cached_blocks})")
            if (drained["migrated"], drained["failed"]) != (5, 0) \
                    or health_a != 503 or in_total != 5 \
                    or blocks_in != blocks_out \
                    or blocks_in != b._radix.cached_blocks or not blocks_in:
                fail("phase 10b M2: the instant drain did not move every "
                     "sequence")
            for i, ev in enumerate(events):
                toks = [e["tokens"][0][0] for e in ev[:-1]]
                if ev[-1] != {"error": f"MigratedAway: request m2-{i} "
                              "migrated to a peer replica",
                              "total": len(toks)} or not toks:
                    fail(f"phase 10b M2: stream m2-{i} ended with {ev[-1]}")
                _tie_rule(torch, engine, f"M2 stream m2-{i}", prompts[i],
                          oracle[i][:len(toks)], toks)
            if not plain_body.get("migrated") \
                    or plain_headers.get("Retry-After") != "0":
                fail(f"phase 10b M2: the plain request got {plain_body}")

            # refusals on B: a wedged transfer, gemma-2b's geometry, and
            # the block export of a cached prefix
            rec = next(r for r in records if r["kv"])
            free0 = b.cengine.pool.num_free
            wedged, _ = await _post_json(
                sess, f"{base_b}/v1/migrate/in",
                {"model": name, "record": rec, "wedge": True}, status=500)
            foreign, _ = await _post_json(
                sess, f"{base_b}/v1/migrate/in",
                {"model": name, "record": {**rec, "geometry":
                                           GEMMA_GEOMETRY}}, status=400)
            if b.cengine.pool.num_free != free0:
                fail("phase 10b: a refused import leaked pool blocks")
            p300 = prompts[2]
            fetch = migration.prefix_fetch_request(name, p300,
                                                   block_size=BS)
            exported, _ = await _post_json(sess, f"{base_b}/v1/blocks/export",
                                           fetch)
            nodes, _, _ = b._radix.match(p300)
            got_k, got_v = pool(b, [nd.block for nd in nodes])
            wk, wv = (torch.from_numpy(x.copy()).to(got_k.device,
                                                    got_k.dtype)
                      for x in migration.decode_kv(exported["record"]["kv"]))
            uncached, _ = await _post_json(
                sess, f"{base_b}/v1/blocks/export",
                migration.prefix_fetch_request(
                    name, list(range(7, 7 + 2 * BS)), block_size=BS),
                status=404)
            bad_hash, _ = await _post_json(
                sess, f"{base_b}/v1/blocks/export",
                {**fetch, "prefix": "0" * 16}, status=400)
            log(f"  B's refusals: wedged {wedged}; gemma-2b geometry "
                f"{foreign}; /v1/blocks/export of the cached 300-token "
                f"prompt {exported['blocks']} blocks (equal to B's pool: "
                f"{torch.equal(got_k, wk) and torch.equal(got_v, wv)}), "
                f"uncached {uncached}, bad hash {bad_hash}")
            if exported["blocks"] != len(nodes) or len(nodes) != 300 // BS \
                    or not (torch.equal(got_k, wk)
                            and torch.equal(got_v, wv)) \
                    or "geometry mismatch" not in foreign["error"] \
                    or "wedged" not in wedged["error"]:
                fail("phase 10b: B's refusals or block export are wrong")
        for batcher, cap in zip((a, b), captures):
            if batcher.cengine.graphs.captures != cap:
                fail("phase 10b: traffic captured CUDA graphs after warmup")
        for label, batcher in (("A", a), ("B", b)):
            if not batcher.cache_anatomy()["ledger"]["conserved"]:
                fail(f"phase 10b: {label}'s block ledger is not conserved")
    finally:
        await runner_a.cleanup()
        await runner_b.cleanup()
    log(f"  phase 10b wall {time.perf_counter() - t_phase:.1f} s ({_card()})")
    return counts_all

FLEET_LENS = (130, 200, 260, 190)   # 11b: fetched, missed, failed; timed
HEARTBEAT_WITHIN_S = 2.5            # the reference beats every 2 s
HEARTBEAT_KEYS = {"id", "url", "models", "checkpoints", "queue_depth",
                  "active_slots", "max_slots", "kv_blocks_free",
                  "kv_blocks_total", "draining", "pool", "version",
                  "phase_seconds", "cache_digest"}
RELOAD_SEED = 7
DEFECT_S = 1.0


async def _stub_router():
    """A router that only listens: it records every `/fleet/register`,
    `/fleet/heartbeat` and `/fleet/deregister` body with its arrival
    time. -> (runner, url, bodies)."""
    from aiohttp import web

    bodies: list = []

    async def record(request):
        bodies.append((request.path, time.perf_counter(),
                       await request.json()))
        return web.json_response({"ok": True})

    app = web.Application()
    for path in ("/fleet/register", "/fleet/heartbeat", "/fleet/deregister"):
        app.router.add_post(path, record)
    runner = web.AppRunner(app)
    await runner.setup()
    port = _free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    return runner, f"http://127.0.0.1:{port}", bodies


async def fleet_and_check(torch):
    """Phase 11: the fleet plane. Replicas P (`--pool prefill`) and D
    (`--pool decode`, with a host spill tier), llama3-1b from the CLI's
    app (4 slots, chunk 64, `--warmup`, depth 2, `--fleet-router` to a
    stub router, `--model-version v1`): 11a the `:prefill` handoff, 11b
    the peer block fetch, 11c the live reload, 11d the heartbeats. ->
    the paged kernels' launches over the waves."""
    import aiohttp

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving import server
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.train.checkpoint import flatten

    name = "llama3-1b"
    t_phase = time.perf_counter()
    t_quiet = float("inf")
    router, router_url, bodies = await _stub_router()
    argv = ["--model", name, "--random", "--seed", "0", "--continuous",
            "--warmup", "--prefill-chunk-tokens", str(CHUNK),
            "--max-batch", "4", "--fleet-router", router_url,
            "--model-version", "v1"]
    app_p, runner_p, base_p = await _serve_app(argv + ["--pool", "prefill"])
    app_d, runner_d, base_d = await _serve_app(
        argv + ["--pool", "decode", "--kv-spill-bytes", str(1 << 30)])
    p, d = app_p[server.BATCHERS_KEY][name], app_d[server.BATCHERS_KEY][name]
    engine = app_d[server.ENGINES_KEY][name]
    L = engine.cfg.num_layers
    captures = (p.cengine.graphs.captures, d.cengine.graphs.captures)
    log(f"  replicas P and D up in {time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator().manual_seed(14)
    prompts = [torch.randint(0, engine.cfg.vocab_size, (n,),
                             generator=gen).tolist()
               for n in MIGRATE_LENS + FLEET_LENS]
    if len({q[0] for q in prompts}) != len(prompts):
        fail("phase 11's prompts share a first token: reseed them")
    hand, fresh = prompts[:len(MIGRATE_LENS)], prompts[len(MIGRATE_LENS):]
    gen_p = f"{base_p}/v1/models/{name}:generate"
    gen_d = f"{base_d}/v1/models/{name}:generate"
    counts_all: dict = {}

    def wave_start():
        reset_launch_counts()
        return {k: (b.calls, b.slices) for k, b in (("P", p), ("D", d))}

    def launches(label, start, want_slices=None):
        calls = sum(b.calls - start[k][0] for k, b in (("P", p), ("D", d)))
        slices = sum(b.slices - start[k][1] for k, b in (("P", p), ("D", d)))
        counts = launch_counts()
        want = {"paged_decode_attention": L * calls,
                "paged_prefill_append": L * slices}
        log(f"  {label}: {calls} decode steps, {slices} slices; launches "
            f"{counts}")
        if any(counts[k] != n for k, n in want.items()) or (
                want_slices is not None and slices != want_slices):
            fail(f"phase 11 {label}: launches {counts}, the design implies "
                 f"{want}; {slices} slices, want {want_slices}")
        for k in want:
            counts_all[k] = counts_all.get(k, 0) + counts[k]

    def pool(batcher, tokens):
        nodes, _, _ = batcher._radix.match(tokens)
        ids = [nd.block for nd in nodes]
        st = batcher.cengine.slots()
        return len(ids), st.k[:, ids], st.v[:, ids]

    async def generate(sess, url, prompt, headers=None):
        t0 = time.perf_counter()
        body, _ = await _post_json(sess, url, {
            "tokens": [prompt], "max_new": TENANT_MAX_NEW, "logprobs": True},
            headers)
        return body["tokens"][0], body["logprobs"][0], \
            time.perf_counter() - t0

    try:
        async with aiohttp.ClientSession() as sess:
            # 11a: P prefills each prompt and hands its full blocks to D
            start = wave_start()
            prefill0 = p.profiler.totals()["prefill_chunk"]
            handed, handoff_s, nbytes = [], 0.0, 0
            for q in hand:
                body, _ = await _post_json(
                    sess, f"{base_p}/v1/models/{name}:prefill",
                    {"tokens": [q], "peer": base_d})
                n = len(q) // BS
                if body["blocks"] != n or body["handoff"] != (n > 0) \
                        or not body["prefilled"]:
                    fail(f"phase 11a: the {len(q)}-token handoff answered "
                         f"{body}, want {n} blocks")
                handed.append(n)
                handoff_s += body["handoff_s"] if n else 0.0
                nbytes += body["bytes"]
            launches("11a P's prefills", start,
                     sum(-(-len(q) // CHUNK) for q in hand))
            if p.calls != start["P"][0]:
                fail("phase 11a: P ran a decode step for a max_new-1 prompt")
            prefill_s = p.profiler.totals()["prefill_chunk"] - prefill0
            log(f"  11a: handed off {sum(handed)} blocks {handed} "
                f"({nbytes / 2**20:.1f} MiB on the wire) in "
                f"{handoff_s * 1e3:.1f} ms = "
                f"{handoff_s * 1e3 / sum(handed):.3f} ms a block (admission "
                f"and P's prefill slices included: {prefill_s * 1e3:.1f} ms "
                f"of host time in prefill_chunk over all five prompts)")
            for q, n in zip(hand, handed):
                if not n:
                    continue
                got = pool(d, q)
                want = pool(p, q)
                if got[0] != n or want[0] < n or not (
                        torch.equal(got[1], want[1][:, :n])
                        and torch.equal(got[2], want[2][:, :n])):
                    fail(f"phase 11a: D's imported blocks of the {len(q)}-"
                         f"token prompt differ from P's")
            start = wave_start()
            reused0 = d.tokens_reused
            outs_d = [await generate(sess, gen_d, q) for q in hand]
            reused = d.tokens_reused - reused0
            want_reused = sum(min(n * BS, len(q) - 1)
                              for q, n in zip(hand, handed))
            launches("11a D's generations", start,
                     sum(-(-(len(q) - min(n * BS, len(q) - 1)) // CHUNK)
                         for q, n in zip(hand, handed)))
            log(f"  11a: D reused {reused} cells (want {want_reused})")
            if reused != want_reused:
                fail("phase 11a: D's prefills missed the handed-off blocks")
            start = wave_start()
            outs_p = [await generate(sess, gen_p, q) for q in hand]
            launches("11a P's own generations", start)
            for q, (a, _, _), (b, _, _) in zip(hand, outs_p, outs_d):
                _tie_rule(torch, engine, f"11a {len(q)}-token prompt, D "
                          f"against P", q, a, b)
            _teacher_check(torch, engine, hand, [o[0] for o in outs_d],
                           [o[1] for o in outs_d], "11a D (llama3-1b)")

            # 11b: D pulls a prompt P serves, misses one P never saw, and
            # fails on a dead peer; each answers the plain path's tokens
            start = wave_start()
            served_p = await generate(sess, gen_p, fresh[0])
            metrics0 = await _scrape(sess, base_d)
            dead = f"http://127.0.0.1:{_free_port()}"
            hinted = [await generate(sess, gen_d, q, {"X-KV-Peer": peer})
                      for q, peer in zip(fresh[:3], (base_p, base_p, dead))]
            metrics1 = await _scrape(sess, base_d)
            plain = [served_p] + [await generate(sess, gen_p, q)
                                  for q in fresh[1:3]]
            launches("11b", start)
            model = (("model", name),)
            fetched = {o: metrics1[("fleet_peer_fetch_total",
                                    model + (("outcome", o),))]
                       - metrics0[("fleet_peer_fetch_total",
                                   model + (("outcome", o),))]
                       for o in ("ok", "miss", "failed")}
            key = ("serving_prefill_tokens_sum",
                   model + (("source", "peer_fetched"),))
            cells = metrics1[key] - metrics0[key]
            log(f"  11b: fetch outcomes {fetched}, {cells:.0f} cells "
                f"fetched")
            if fetched != {"ok": 1, "miss": 1, "failed": 1} \
                    or cells != BS * (len(fresh[0]) // BS):
                fail("phase 11b: the peer fetch outcomes are wrong")
            for q, (a, _, _), (b, _, _) in zip(fresh, plain, hinted):
                _tie_rule(torch, engine, f"11b {len(q)}-token prompt, "
                          f"hinted D against P", q, a, b)
            _teacher_check(torch, engine, fresh[:3], [o[0] for o in hinted],
                           [o[1] for o in hinted], "11b D (llama3-1b)")
            # the fetch alone, timed: a fourth prompt P serves
            await generate(sess, gen_p, fresh[3])
            n = len(fresh[3]) // BS
            t0 = time.perf_counter()
            await server._peer_fetch_blocks(app_d, name, d, fresh[3], base_p)
            fetch_s = time.perf_counter() - t0
            log(f"  11b: a {n}-block fetch took {fetch_s * 1e3:.1f} ms = "
                f"{fetch_s * 1e3 / n:.3f} ms a block (export on P, HTTP, "
                f"import on D: the wait a hinted request adds to its TTFT)")

            # 11c: D's weights replaced live under its graphs
            ptrs = {k: t.data_ptr()
                    for k, t in flatten(engine.params).items()}
            graphs = d.cengine.graphs
            runners = dict(graphs._runners)
            body, _ = await _post_json(sess, f"{base_d}/v1/reload", {
                "version": "v2", "source": {"seed": RELOAD_SEED}})
            regs = [b for path, _, b in bodies
                    if path == "/fleet/register" and b["pool"] == "decode"]
            log(f"  11c: reload to seed {RELOAD_SEED} in {body['reload_s']} s")
            if {k: t.data_ptr() for k, t in
                    flatten(engine.params).items()} != ptrs \
                    or graphs._runners != runners \
                    or graphs.captures != captures[1]:
                fail("phase 11c: the reload moved a parameter or a graph")
            if d._radix.cached_blocks or d._spill_tier.spilled_blocks \
                    or d._prefix_states or d.kv_blocks_in_use():
                fail("phase 11c: a cache of the old weights survived")
            if not regs or regs[-1]["version"] != "v2":
                fail("phase 11c: no registration with version v2 before "
                     "the reload answered")
            start = wave_start()
            after = [await generate(sess, gen_d, q) for q in hand[1:3]]
            launches("11c D after the reload", start)
            new = InferenceEngine(
                llama.init(engine.cfg, RELOAD_SEED, engine.device),
                engine.cfg, LLAMA_FAMILY,
                EngineConfig(max_len=engine.ec.max_len),
                device=engine.device)
            _teacher_check(torch, new, hand[1:3], [o[0] for o in after],
                           [o[1] for o in after], "11c D at seed 7")
            if any(a[0] == b[0] for a, b in zip(after, outs_d[1:3])):
                fail("phase 11c: the reloaded replica gave seed 0's tokens")
            async with sess.post(f"{base_d}/v1/reload", json={
                    "version": "v3", "source": {}}) as r:
                refused = r.status
            again = await generate(sess, gen_d, hand[1])
            if refused != 400 or app_d[server.DRAIN_KEY]["draining"] \
                    or app_d[server.MODEL_VERSION_KEY] != "v2":
                fail(f"phase 11c: an empty source answered {refused} and "
                     "left the replica changed")
            _tie_rule(torch, new, "11c after the refused reload", hand[1],
                      after[0][0], again[0])
            del new

            async def ttft():
                t0 = time.perf_counter()
                await _post_json(sess, gen_d, {"tokens": [hand[0]],
                                               "max_new": 1})
                return time.perf_counter() - t0

            await _post_json(sess, f"{base_d}/v1/reload", {
                "version": "v3", "source": {"seed": RELOAD_SEED},
                "defect": {"ttft_delay_s": DEFECT_S}})
            slow = await ttft()
            await _post_json(sess, f"{base_d}/v1/reload", {
                "version": "v4", "source": {"seed": RELOAD_SEED}})
            healed = await ttft()
            log(f"  11c: defect ttft_delay_s {DEFECT_S} planted: TTFT "
                f"{slow:.3f} s; healed by the next reload: {healed:.3f} s")
            if slow <= DEFECT_S or healed >= DEFECT_S \
                    or slow - healed < 0.9 * DEFECT_S:
                fail("phase 11c: the defect was not planted or not healed")

            # 11d: a quiet window: each replica must beat within it
            t_quiet = time.perf_counter()
            await asyncio.sleep(HEARTBEAT_WITHIN_S)
        for label, batcher, cap in (("P", p, captures[0]),
                                    ("D", d, captures[1])):
            if batcher.cengine.graphs.captures != cap:
                fail(f"phase 11: traffic captured CUDA graphs on {label}")
            if not batcher.cache_anatomy()["ledger"]["conserved"]:
                fail(f"phase 11: {label}'s block ledger is not conserved")
    finally:
        totals = {k: {ph: round(s, 3) for ph, s in b.profiler.totals().items()
                      if s} for k, b in (("P", p), ("D", d))}
        await runner_p.cleanup()
        await runner_d.cleanup()
        await router.cleanup()
    # 11d: the heartbeats the stub router recorded
    log(f"  11d: phase totals (host seconds) {totals}")
    by_pool: dict = {}
    for path, t, body in bodies:
        by_pool.setdefault(body.get("pool") or body["id"], []).append(
            (path, t, body))
    for pool_name in ("prefill", "decode"):
        seen = by_pool.get(pool_name, [])
        beats = [(t, b) for path, t, b in seen if path == "/fleet/heartbeat"]
        quiet = [b for t, b in beats
                 if t_quiet <= t <= t_quiet + HEARTBEAT_WITHIN_S]
        if not quiet or any(set(b) != HEARTBEAT_KEYS for _, b in beats) \
                or any(b["pool"] != pool_name for _, b in beats):
            fail(f"phase 11d: the {pool_name} replica's heartbeats are "
                 f"missing from a {HEARTBEAT_WITHIN_S} s window or "
                 f"malformed")
        last = beats[-1][1]
        log(f"  11d: {pool_name}: {len(beats)} heartbeats, {len(quiet)} in "
            f"the quiet {HEARTBEAT_WITHIN_S} s; last phase_seconds "
            f"{last['phase_seconds']}, version {last['version']}, "
            f"{len(last['cache_digest'])} digest entries")
        ids = {b["id"] for _, _, b in seen}
        if not any(path == "/fleet/deregister" and b["id"] in ids
                   for path, _, b in bodies):
            fail(f"phase 11d: the {pool_name} replica did not deregister")
    last_p = [b for path, _, b in by_pool["prefill"]
              if path == "/fleet/heartbeat"][-1]
    last_d = [b for path, _, b in by_pool["decode"]
              if path == "/fleet/heartbeat"][-1]
    if not (last_p["phase_seconds"]["prefill"] > 0
            and last_d["phase_seconds"]["decode"] > 0
            and last_p["cache_digest"]):
        fail("phase 11d: the heartbeats carry no phase seconds or digest")
    log(f"  phase 11 wall {time.perf_counter() - t_phase:.1f} s ({_card()})")
    return counts_all


async def _scrape(sess, base):
    async with sess.get(f"{base}/metrics") as r:
        return _parse_metrics(await r.text())



def _nodes(radix):
    """Every node of a radix tree, all namespaces."""
    stack = [n for root in radix._roots.values()
             for n in root.children.values()]
    out = []
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children.values())
    return out


# -- phase 12 ---------------------------------------------------------------

QUANT_REL = 0.05          # int8 vs bf16 logits: the reference's own bound
INT8_PER_LAYER = len(INT8_LAUNCHES)   # int8_proj launches a layer
LORA_NAMES = ("alice", "bob", "carol")
LORA_RANK, LORA_ALPHA = 8, 16.0
# phase 12b's eight concurrent rows: prompt length and adapter ("" base)
LORA_ROWS = ((17, ""), (130, "alice"), (300, "bob"), (45, "carol"),
             (60, ""), (90, "alice"), (200, "bob"), (17, "carol"))
ISOLATION_LEN = 200       # the prompt served as base, alice, alice again
# phase 14's pack on the MoE family: its routed FFN has no dense MLP
ATTN_TARGETS = ("wq", "wk", "wv", "wo")
# phase 3's and phase 5's bf16 numbers, printed beside phase 12's
MEASURED: dict = {}


def _is_int8(engine) -> bool:
    from kubeflow_tpu_torch.serving.quant import QTensor

    return any(isinstance(w, QTensor)
               for w in engine.params["blocks"].values())


def _reckon_param_bytes(cfg) -> int:
    """Device bytes of llama params under --quant int8: each block matrix
    int8 plus a bf16 scale per output channel; norms, embedding and head
    fp32 (the serving storage rule)."""
    L, D, ffn = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    shapes = _proj_shapes(D, cfg.q_dim, cfg.kv_dim, ffn).values()
    blocks = sum(L * (k * n + 2 * n) for k, n in shapes)
    head = 0 if cfg.tie_embeddings else D * cfg.vocab_size * 4
    return blocks + (2 * L * D + D) * 4 + cfg.vocab_size * D * 4 + head


def _profiled_step_ms(torch, engine, prompts, max_new, tries=3):
    """Device ms a decode step of the window batch (the prompts
    left-padded to one row each): profiled calls to 1 and to `max_new`
    tokens, the difference of their device time over max_new - 1. Each
    profile must hold a record of every `int8_proj` launch that the
    wrappers counted in its call (graph replays included): the profiler
    can lose a kernel's record, and a profile that lost one is taken
    again, up to `tries` times. Returns the step's ms and, for the call
    to 1 token (the window's prefill and its first token), the
    `int8_proj` device ms, the wrappers' launches and the busy ms."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    width = max(len(p) for p in prompts)
    arr = torch.zeros(len(prompts), width, dtype=torch.long)
    mask = torch.zeros(len(prompts), width, dtype=torch.bool)
    for r, p in enumerate(prompts):
        arr[r, width - len(p):] = torch.tensor(p)
        mask[r, width - len(p):] = True
    busy, prefill = {}, None
    for n in (1, max_new):
        for attempt in range(1, tries + 1):
            reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                engine.generate(arr, prompt_mask=mask, max_new=n)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            launched = launch_counts()["int8_proj"]
            events = _device_events(prof)
            proj = [e for e in events if "int8_proj" in e.key]
            recorded = sum(e.count for e in proj)
            if recorded == launched:
                break
            log(f"  profile of the call to {n} token(s), try {attempt}: "
                f"{recorded} int8_proj records of {launched} launches "
                f"counted by the wrappers")
        else:
            fail(f"the profiler lost int8_proj records in {tries} profiles "
                 f"of the call to {n} token(s) (last: {recorded} of "
                 f"{launched})")
        busy[n] = sum(_dev_us(e) for e in events)
        if n == 1:
            prefill = (sum(_dev_us(e) for e in proj) / 1e3, launched,
                       busy[1] / 1e3)
    _report_profile(prof, wall, top=6)
    return (busy[max_new] - busy[1]) / (max_new - 1) / 1e3, prefill


async def quant_oneshot_and_check(torch):
    """Phase 12a: llama3-8b under `--quant int8` in the reference's
    default mode, through the CLI's app: the block matrices int8 on the
    card, the prefill logits against the bf16 model's, the window batch
    through `int8_proj` with exact launches and no capture in traffic,
    the served logprobs against a teacher-forced plain pass over the same
    int8 weights, an adapter refused (no pack)."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.quant import (
        BLOCK_MATMUL_WEIGHTS,
        QTensor,
        param_bytes,
    )
    from kubeflow_tpu_torch.serving.server import BATCHERS_KEY, ENGINES_KEY

    name, cfg = "llama3-8b", llama.LLAMA3_8B
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    prompts = [prompt(n) for n in DENSE_PROMPTS[:-1]]
    prompts.append(prompts[0])        # the repeated prompt
    probe = torch.tensor([prompts[6]], device=dev)    # 300 tokens

    def prefill_logits(engine):
        with torch.inference_mode():
            logits, _ = engine._forward_cached(probe, engine.init_state(1),
                                               return_all=True)
        return logits[0]

    t0 = time.perf_counter()
    bf16 = InferenceEngine(llama.init(cfg, 0, dev), cfg, LLAMA_FAMILY,
                           EngineConfig(max_len=MAX_LEN), device=dev)
    bf16_bytes = param_bytes(bf16.params)
    ref = prefill_logits(bf16)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    port = _free_port()
    app = build_app(parse_args([
        "--model", name, "--random", "--seed", "0", "--quant", "int8",
        "--batch-window-ms", str(WINDOW_MS), "--max-batch", str(DENSE_B),
        "--host", "127.0.0.1", "--port", str(port)]))
    engine, batcher = app[ENGINES_KEY][name], app[BATCHERS_KEY][name]
    torch.cuda.synchronize()
    log(f"  bf16 reference logits and the CLI's app (--quant int8) built "
        f"in {time.perf_counter() - t0:.1f} s")
    for k in BLOCK_MATMUL_WEIGHTS:
        w = engine.params["blocks"][k]
        if not (isinstance(w, QTensor) and w.q.dtype == torch.int8
                and w.q.is_cuda and w.scale.dtype == torch.bfloat16):
            fail(f"--quant int8: block matrix {k} is {w!r}, not int8 on "
                 f"the card")
    got_bytes, want_bytes = param_bytes(engine.params), \
        _reckon_param_bytes(cfg)
    log(f"  param bytes {got_bytes} (reckoned {want_bytes}; bf16 "
        f"{bf16_bytes}: {got_bytes / bf16_bytes:.3f}x)")
    if got_bytes != want_bytes:
        fail(f"--quant int8 param bytes {got_bytes}, reckoned {want_bytes}")
    reset_launch_counts()
    logits = prefill_logits(engine)
    torch.cuda.synchronize()
    n_fwd = launch_counts()["int8_proj"]
    err, scale = float((logits - ref).abs().max()), float(ref.abs().max())
    log(f"  prefill logits (300 tokens) vs the bf16 model's: max_abs_err "
        f"{err:.4f}, {err / scale:.4f} of max|l| {scale:.3f} (bound "
        f"{QUANT_REL}); int8_proj {n_fwd} launches a forward")
    if n_fwd != INT8_PER_LAYER * cfg.num_layers:
        fail(f"int8 forward: {n_fwd} int8_proj launches, the design "
             f"implies {INT8_PER_LAYER * cfg.num_layers}")
    if err > QUANT_REL * scale:
        fail(f"int8 prefill logits part from bf16's by {err / scale:.4f} "
             f"of max|l| (bound {QUANT_REL})")
    del ref, logits
    # the CLI refuses --warmup without --continuous, as the reference's
    # does; the decode graphs are warmed here as create_serving_app(
    # warmup=True) warms them: rows 1, 2, 4, 8 x 3 sampling keys
    t0 = time.perf_counter()
    engine.warmup((1, 2, 4, 8))
    log(f"  warmup {time.perf_counter() - t0:.2f} s captured "
        f"{engine.captures} CUDA graphs")
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
    try:
        async with aiohttp.ClientSession() as sess:
            async def post(body, status=200):
                async with sess.post(url, json=body) as r:
                    if r.status != status:
                        fail(f":generate returned {r.status} (want "
                             f"{status}): {await r.text()}")
                    return await r.json()

            await post({"tokens": [prompts[0]], "max_new": 2})   # uncounted
            body = await post({"tokens": [prompts[0]], "max_new": 2,
                               "adapter": "alice"}, 400)
            if "has no adapters loaded" not in body["error"]:
                fail(f"adapter without a pack: {body}")
            calls0 = batcher.calls
            captures, replays0 = engine.captures, engine.replays
            reset_launch_counts()
            t0 = time.perf_counter()
            window = await asyncio.gather(*(post(
                {"tokens": [p], "max_new": DENSE_MAX_NEW, "logprobs": True})
                for p in prompts))
            window_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = launch_counts()
            calls = batcher.calls - calls0
            replays = engine.replays - replays0
    finally:
        await runner.cleanup()
    log(f"  window: {len(prompts)} requests in {window_s:.3f} s as {calls} "
        f"batcher call(s), {replays} graph replays, "
        f"{engine.captures - captures} captures in traffic; kernel "
        f"launches {counts}")
    L, steps = cfg.num_layers, DENSE_MAX_NEW - 1
    want = {"int8_proj": INT8_PER_LAYER * L * (1 + steps) * calls,
            "decode_attention": L * steps * calls}
    for k, n in counts.items():
        if n != want.get(k, 0):
            fail(f"phase 12a {k}: {n} launches, the design implies "
                 f"{want.get(k, 0)} ({INT8_PER_LAYER} x {L} a forward and a "
                 f"decode step, {L} decode attention a step, {steps} steps "
                 f"a call, {calls} calls)")
    if engine.captures != captures or replays != steps * calls:
        fail(f"phase 12a: {engine.captures - captures} captures in "
             f"traffic, {replays} replays (the design implies "
             f"{steps * calls})")
    outs = [b["tokens"][0] for b in window]
    lps = [b["logprobs"][0] for b in window]
    for o, lp in zip(outs, lps):
        if len(o) != DENSE_MAX_NEW or len(lp) != len(o) \
                or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"malformed output {o} / {lp}")
    if outs[0] != outs[-1]:
        fail(f"repeated prompt gave different greedy tokens: {outs[0]} vs "
             f"{outs[-1]}")
    # teacher: llama.apply over the QTensor leaves, each dequantized at
    # its use (q * scale in bf16), with no kernel
    _teacher_check(torch, engine, prompts, outs, lps, "one-shot llama3-8b "
                   "int8 (teacher: the plain pass over the int8 weights)")
    step_ms, (pre_ms, pre_n, pre_busy) = _profiled_step_ms(
        torch, engine, prompts, 9)
    bf16_ms = MEASURED.get("phase5_step_ms")
    log(f"  window prefill (the call to 1 token, its trace): int8_proj "
        f"{pre_ms:.2f} ms of device time in {pre_n} launches (the "
        f"wrappers' count, each recorded by the profiler), of "
        f"{pre_busy:.2f} ms busy")
    if pre_n != INT8_PER_LAYER * L:
        fail(f"phase 12a's traced prefill: {pre_n} int8_proj launches, the "
             f"design implies {INT8_PER_LAYER * L}")
    log(f"  device time a decode step of the window batch (profiled calls "
        f"to 9 and to 1 token): int8 {step_ms:.3f} ms; bf16 (phase 5, "
        f"this run) "
        f"{'not run' if bf16_ms is None else f'{bf16_ms:.3f} ms'}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def _lora_adapters(torch, cfg, dev, seed, targets=None):
    """Three adapter trees in the reference's layout and test recipe: A
    fan-in-scaled truncated normal (init_lora's law), B normal x 0.05
    (non-zero: a fresh B of 0 is the base), fp32 on the card; over
    `targets` (default: all seven block matrices)."""
    from kubeflow_tpu_torch.train.lora import _TARGET_DIMS

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name in LORA_NAMES:
        blocks = {}
        for t in targets or _TARGET_DIMS:
            din, dout = _TARGET_DIMS[t]
            d_in, d_out = getattr(cfg, din), getattr(cfg, dout)
            a = torch.empty(cfg.num_layers, d_in, LORA_RANK, device=dev)
            torch.nn.init.trunc_normal_(a, 0.0, 1.0, -2.0, 2.0, generator=g)
            blocks[t] = {"A": a * d_in**-0.5,
                         "B": torch.randn(cfg.num_layers, LORA_RANK, d_out,
                                          generator=g, device=dev) * 0.05}
        out[name] = {"blocks": blocks}
    return out


def _merged_teacher(torch, engine, adapters, lcfg, name):
    """The teacher of adapter `name`'s rows: a plain dense llama on the
    engine's base (an int8 leaf dequantized in fp32) plus the scaled
    delta, merged in fp32 and rounded to the serving dtype once."""
    import types

    from kubeflow_tpu_torch.serving.quant import QTensor
    from kubeflow_tpu_torch.train.lora import merge_lora

    cfg = engine.cfg
    dense = {k: (w.q.float() * w.scale.float() if isinstance(w, QTensor)
                 else w.float()) for k, w in engine.params["blocks"].items()
             if k in next(iter(adapters.values()))["blocks"]}
    base = {"blocks": dense}
    if name:
        base = merge_lora(base, adapters[name], lcfg)
    blocks = dict(engine.params["blocks"])
    blocks.update({k: w.to(cfg.dtype) for k, w in base["blocks"].items()})
    del dense, base
    return types.SimpleNamespace(params=dict(engine.params, blocks=blocks),
                                 cfg=cfg, family=engine.family,
                                 device=engine.device)


async def adapters_and_check(torch, quant: bool):
    """Phase 12b: llama3-1b continuous (8 slots, chunk 64, warmed, depth
    2) with a pack of three adapters, in bf16 or under int8 weights:
    eight concurrent rows mixing the base and the adapters, exact
    launches, no capture in traffic, every row against the plain dense
    model on its merged weights; the base-then-alice prompt keyed apart;
    the reference's 400s."""
    import aiohttp
    from aiohttp import web
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.multilora import build_pack
    from kubeflow_tpu_torch.serving.quant import quantize_blocks
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY,
        create_serving_app,
    )
    from kubeflow_tpu_torch.train.lora import LoraConfig

    name, cfg = "llama3-1b", llama.LLAMA3_1B
    label = "int8" if quant else "bf16"
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lcfg = LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA)
    adapters = _lora_adapters(torch, cfg, dev, 12)
    params = llama.init(cfg, 0, dev)
    if quant:
        params = quantize_blocks(params)
    pack = build_pack(cfg, lcfg, adapters, device=dev)
    engine = InferenceEngine(params, cfg, LLAMA_FAMILY,
                             EngineConfig(max_len=MAX_LEN), device=dev,
                             adapter_pack=pack)
    app = create_serving_app({name: engine}, continuous=True, warmup=True,
                             max_batch=SLOTS, prefill_chunk_tokens=CHUNK,
                             seed=0)
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()              # on_startup: the batcher's warmup
    await web.TCPSite(runner, "127.0.0.1", port).start()
    batcher = app[BATCHERS_KEY][name]
    graphs = batcher.cengine.graphs
    captures = graphs.captures
    log(f"  {label}: llama3-1b (seed 0) with a {len(LORA_NAMES)}-adapter "
        f"pack (rank {LORA_RANK}, alpha {LORA_ALPHA}, seven targets, "
        f"{pack.nbytes / 2**20:.1f} MiB) up in "
        f"{time.perf_counter() - t0:.1f} s, {captures} graphs captured")
    gen = torch.Generator().manual_seed(12)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    rows = [(prompt(n), a) for n, a in LORA_ROWS]
    iso = prompt(ISOLATION_LEN)
    url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"

    def body(p, a, max_new=MAX_NEW, **kw):
        return {"tokens": [p], "max_new": max_new, "logprobs": True,
                **({"adapter": a} if a else {}), **kw}

    try:
        async with aiohttp.ClientSession() as sess:
            async def post(b, status=200):
                async with sess.post(url, json=b) as r:
                    if r.status != status:
                        fail(f":generate returned {r.status} (want "
                             f"{status}): {await r.text()}")
                    return await r.json()

            batcher.calls = batcher.slices = 0
            batcher.decode_s = 0.0
            reset_launch_counts()
            t1 = time.perf_counter()
            served = await asyncio.gather(*(post(body(p, a))
                                            for p, a in rows))
            serve_s = time.perf_counter() - t1
            torch.cuda.synchronize()
            counts = launch_counts()
            calls, slices, hits = (batcher.calls, batcher.slices,
                                   batcher.prefix_hits)
            step_ms = batcher.decode_s / max(calls, 1) * 1e3
            # the isolation wave, profiled: the prompt under the base,
            # then alice (keyed apart: a miss), then alice again (a hit
            # on her own blocks)
            iso_out = []
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for a in ("", "alice", "alice"):
                    r0 = batcher.tokens_reused
                    iso_out.append((a, await post(body(iso, a)),
                                    batcher.tokens_reused - r0))
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t1
            refusals = [({"adapter": "dave"}, "unknown adapter"),
                        ({"adapter": 7}, "adapter must be a string"),
                        ({"adapter": "bob", "speculative": True},
                         "adapter does not compose with speculative")]
            for extra, text in refusals:
                got = await post({"tokens": [rows[0][0]], "max_new": 2,
                                  **extra}, 400)
                if text not in got["error"]:
                    fail(f"phase 12b: {extra} answered {got}, want {text}")
            new_captures = graphs.captures - captures
    finally:
        await runner.cleanup()
    L = cfg.num_layers
    want = {"paged_decode_attention": L * calls,
            "paged_prefill_append": L * slices,
            "int8_proj": INT8_PER_LAYER * L * (calls + slices) if quant
            else 0}
    log(f"  {label}: {len(rows)} rows in {serve_s:.3f} s: {calls} decode "
        f"steps dispatched, {slices} slices, {hits} prefix hits; host "
        f"{step_ms:.2f} ms a decode step (phase 3, bf16, no pack, this "
        f"run: {MEASURED.get('phase3_step_ms', 'not run')}); kernel "
        f"launches {counts}")
    for k, n in counts.items():
        if n != want.get(k, 0):
            fail(f"phase 12b ({label}) {k}: {n} launches, the design "
                 f"implies {want.get(k, 0)} ({L} layers x {calls} steps / "
                 f"{slices} slices; int8_proj {INT8_PER_LAYER} a layer)")
    if slices != sum(-(-n // CHUNK) for n, _ in LORA_ROWS) or hits:
        fail(f"phase 12b: {slices} slices, {hits} hits for cold prompts "
             f"{[n for n, _ in LORA_ROWS]}")
    if new_captures:
        fail(f"phase 12b: traffic captured {new_captures} CUDA graphs")
    (_, base_b, r_base), (_, a1, r_a1), (_, a2, r_a2) = iso_out
    want_reused = (ISOLATION_LEN + MAX_NEW - 1) // BS * BS
    log(f"  isolation: base reused {r_base} cells, alice after the base "
        f"{r_a1} (keyed apart), alice again {r_a2} (reckoned "
        f"{want_reused}); alice's tokens equal on the repeat: "
        f"{a1['tokens'] == a2['tokens']}; base and alice differ: "
        f"{base_b['tokens'] != a1['tokens']}")
    if (r_base, r_a1, r_a2) != (0, 0, want_reused):
        fail(f"phase 12b isolation: cells reused {r_base}/{r_a1}/{r_a2}, "
             f"the keys reckon 0/0/{want_reused}")
    if a1["tokens"] != a2["tokens"]:
        fail("phase 12b: alice's repeat gave other tokens")
    _report_profile(prof, prof_s)
    groups = {a: [] for a in ("",) + LORA_NAMES}
    for (p, a), b in zip(rows, served):
        groups[a].append((p, b["tokens"][0], b["logprobs"][0]))
    for a, b in (("", base_b), ("alice", a1), ("alice", a2)):
        groups[a].append((iso, b["tokens"][0], b["logprobs"][0]))
    for a, items in groups.items():
        teacher = _merged_teacher(torch, engine, adapters, lcfg, a)
        _teacher_check(torch, teacher, *map(list, zip(*items)),
                       f"{label} {a or 'base'} rows (teacher: merged "
                       f"{'dequantized ' if quant else ''}weights)")
        del teacher
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


# the port's own kernels, as the profiler names them
PORT_KERNELS = ("decode_split_kernel", "decode_combine_kernel",
                "prefill_attention_", "scatter_kernel", "flash_fwd_",
                "flash_dq_", "flash_dkv_", "int8_proj_")


# -- phase 13 ---------------------------------------------------------------

# open-loop traces from the port's scenario engine, at llama3-1b's width
REPLAY_TRACES = (("heavy_tail", {"n": 120, "rps": 8.0, "max_prompt": 900,
                                 "max_new": 32}),
                 ("agent_swarm", {}),
                 ("abandon_retry", {}))
REPLAY_MODEL = "llama3-1b"
REPLICA_ARGV = ["--model", REPLAY_MODEL, "--random", "--seed", "0",
                "--continuous", "--warmup", "--prefill-chunk-tokens",
                str(CHUNK), "--max-batch", str(SLOTS)]
PHASE13_DIR = os.path.join(ROOT, "build", "phase13")


def replica_main(out_path: str, argv: list[str]) -> None:
    """`chip_smoke.py --replica OUT -- <serving CLI args>`: the port's
    serving CLI (its parser and app) in this process, with every launch
    counter set to 0 once the warmup has run and, at shutdown (SIGINT),
    the counts, the batcher's steps and slices, its captures after the
    warmup and now, and its live slots written to OUT as JSON."""
    from aiohttp import web

    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.server import BATCHERS_KEY, ENGINES_KEY

    args = parse_args(argv)
    app = build_app(args)
    state = {}

    async def after_warmup(app_):
        # on_startup hooks run in order: the app's warmup came first
        b = next(iter(app_[BATCHERS_KEY].values()))
        state["captures_warm"] = b.cengine.graphs.captures
        reset_launch_counts()

    async def dump(app_):
        (name, b), = app_[BATCHERS_KEY].items()
        with open(out_path, "w") as f:
            json.dump({"launch": launch_counts(), "calls": b.calls,
                       "slices": b.slices, "prefills": b.prefills,
                       "captures_warm": state["captures_warm"],
                       "captures": b.cengine.graphs.captures,
                       "active": len(b._active),
                       "layers": app_[ENGINES_KEY][name].cfg.num_layers},
                      f)

    app.on_startup.append(after_warmup)
    app.on_shutdown.append(dump)
    web.run_app(app, host=args.host, port=args.port, print=None)


def _http(method, url, body=None, headers=None, timeout=60):
    """-> (status, headers, body bytes), an HTTP error's status included."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers, e.read()


def _get_json(url):
    status, _, raw = _http("GET", url)
    if status != 200:
        fail(f"GET {url} answered {status}: {raw[:300]!r}")
    return json.loads(raw)


def _spans_of(doc, tid):
    return {e["args"]["span_id"]: e for e in doc["traceEvents"]
            if e["ph"] == "X" and e["args"]["trace_id"] == tid}


def _trace_checks(base, gen_url):
    """The tracer doors on the live replica before the replays: a plain
    and a streamed request each under a root whose trace id is the
    `X-Trace-Id` the client got, with `batcher.submit`, the first
    request's `decode.attention` chunks and `stream.continuous` nested
    under them; a valid `X-Trace-Id` / `X-Parent-Span` pair adopted, a
    malformed one a fresh trace; a bad `?limit=` a 400; the counter
    tracks under the model's name."""
    traces = f"{base}/debug/traces"
    status, hdr, _ = _http("POST", gen_url, {"tokens": [[11, 12, 13] * 6],
                                             "max_new": 8},
                           {"X-Request-Id": "probe-plain"})
    tid = hdr.get("X-Trace-Id", "")
    if status != 200 or not tid:
        fail(f"probe: status {status}, X-Trace-Id {tid!r}")
    doc = _get_json(f"{traces}?name=http.request&trace_id={tid}")
    spans = _spans_of(doc, tid)
    roots = [e for e in spans.values() if e["name"] == "http.request"]
    if len(roots) != 1:
        fail(f"/debug/traces: {len(roots)} http.request roots in {tid}")
    root = roots[0]["args"]["span_id"]

    def under(name, top):
        found = [e for e in spans.values() if e["name"] == name]
        for e in found:
            p = e["args"]["parent_id"]
            while p in spans and p != top:
                p = spans[p]["args"]["parent_id"]
            if p != top:
                fail(f"{name} span not under its request's root")
        return len(found)

    n_submit, n_decode = under("batcher.submit", root), under(
        "decode.attention", root)
    if n_submit != 1 or n_decode < 1:
        fail(f"probe trace: {n_submit} batcher.submit, {n_decode} "
             "decode.attention spans")
    impl = {e["args"]["impl"] for e in spans.values()
            if e["name"] == "decode.attention"}
    status, hdr, raw = _http("POST", gen_url, {
        "tokens": [[14, 15, 16] * 6], "max_new": 8, "stream": True},
        {"X-Request-Id": "probe-stream"})
    stid = hdr.get("X-Trace-Id", "")
    if status != 200 or not stid or b'"done": true' not in raw:
        fail(f"streamed probe: status {status}, X-Trace-Id {stid!r}")
    sdoc = _get_json(f"{traces}?trace_id={stid}")
    spans = _spans_of(sdoc, stid)
    sroot = [k for k, e in spans.items() if e["name"] == "http.request"]
    if len(sroot) != 1 or under("stream.continuous", sroot[0]) != 1:
        fail("the streamed probe's stream.continuous span is not under "
             "its root")
    good_tid, good_psid = "5eed" * 8, "0123456789abcdef"
    _, hdr, _ = _http("POST", gen_url, {"tokens": [[17] * 9], "max_new": 4},
                      {"X-Trace-Id": good_tid, "X-Parent-Span": good_psid})
    rdoc = _get_json(f"{traces}?trace_id={good_tid}")
    rroots = [e for e in rdoc["traceEvents"] if e["ph"] == "X"
              and e["name"] == "http.request"]
    if hdr.get("X-Trace-Id") != good_tid or len(rroots) != 1 \
            or rroots[0]["args"]["parent_id"] != good_psid:
        fail("a valid X-Trace-Id / X-Parent-Span pair was not adopted")
    _, hdr, _ = _http("POST", gen_url, {"tokens": [[18] * 9], "max_new": 4},
                      {"X-Trace-Id": "not-hex!", "X-Parent-Span": good_psid})
    fresh = hdr.get("X-Trace-Id", "")
    if fresh in ("", "not-hex!", good_tid) or len(fresh) != 32:
        fail(f"a malformed X-Trace-Id was not replaced: {fresh!r}")
    status, hdr, _ = _http("GET", f"{traces}?limit=x")
    if status != 400 or not hdr.get("X-Trace-Id"):
        fail(f"/debug/traces?limit=x answered {status}")
    tracks = sorted({e["name"] for e in doc["traceEvents"]
                     if e["ph"] == "C"})
    want = sorted(f"{REPLAY_MODEL}.{t}" for t in (
        "kv_blocks", "batch_occupancy", "phase_seconds", "kv_evictions"))
    if tracks != want:
        fail(f"counter tracks {tracks}, want {want}")
    log(f"  traces: probe root {tid[:8]}.. holds batcher.submit and "
        f"{n_decode} decode.attention spans (impl {sorted(impl)}); the "
        f"stream's root holds stream.continuous; propagation adopted "
        f"{good_tid[:8]}.., a malformed pair got {fresh[:8]}..; ?limit=x "
        f"400; counter tracks {tracks}")
    return 4   # requests sent


def _recompiles(base):
    prof = _get_json(f"{base}/debug/profile")["models"][REPLAY_MODEL]
    status, _, raw = _http("GET", f"{base}/metrics")
    metrics = _parse_metrics(raw.decode())
    series = {dict(k[1])["fn"]: v for k, v in metrics.items()
              if k[0] == "serving_recompiles_total"}
    return prof, metrics, series


def start_replica():
    """Phase 13's replica: the serving CLI in a subprocess, started (the
    smoke starts it beside phase 12, whose work it does not touch). ->
    what `replay_and_check` takes."""
    os.makedirs(PHASE13_DIR, exist_ok=True)
    port = _free_port()
    dump = os.path.join(PHASE13_DIR, "replica.json")
    log_path = os.path.join(PHASE13_DIR, "replica.log")
    if os.path.exists(dump):
        os.remove(dump)
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--replica", dump,
             "--", *REPLICA_ARGV, "--host", "127.0.0.1", "--port",
             str(port)], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
    atexit.register(_stop, proc)   # a failure before phase 13 exits
    return proc, port, dump, log_path, time.perf_counter()


def replay_and_check(started) -> dict:
    """Phase 13: llama3-1b from the serving CLI in a subprocess
    (`start_replica`), three open-loop traces replayed through
    `HttpTarget`, then the recompile, ledger, tracer and recorder
    checks. -> the paged kernels' launches over the phase."""
    import signal

    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch import scenarios
    from kubeflow_tpu_torch.scenarios import __main__ as scenarios_cli

    proc, port, dump, log_path, t_start = started
    t_phase = time.perf_counter()
    traces = []
    for shape, params in REPLAY_TRACES:
        tr = scenarios.generate(shape, 0, **params)
        path = os.path.join(PHASE13_DIR, f"{shape}.jsonl")
        scenarios.write_trace(tr, path)
        traces.append(tr)
    base = f"http://127.0.0.1:{port}"
    gen_url = f"{base}/v1/models/{REPLAY_MODEL}:generate"

    def replica_log() -> str:
        with open(log_path) as f:
            return f.read()[-3000:]

    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                fail(f"the replica exited with {proc.returncode}:\n"
                     f"{replica_log()}")
            try:
                if _http("GET", f"{base}/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail(f"the replica did not come up:\n{replica_log()}")
            time.sleep(0.5)
        log(f"  replica up {time.perf_counter() - t_start:.1f} s after "
            f"its start, {time.perf_counter() - t_phase:.1f} s into the "
            f"phase (`python -m kubeflow_tpu_torch.serving "
            f"{' '.join(REPLICA_ARGV)}` in a subprocess, port {port})")
        sent = _trace_checks(base, gen_url)
        prof0, _, series0 = _recompiles(base)
        before = prof0["recompiles"]
        # the metric is zero-seeded for every watched fn name, spec rounds
        # included: /debug/profile lists the fns this batcher watches
        if series0 != {fn: float(before.get(fn, 0)) for fn in series0} \
                or not set(before) <= set(series0):
            fail(f"serving_recompiles_total {series0} != /debug/profile's "
                 f"recompiles {before}")
        summaries = []
        for tr in traces:
            target = scenarios.HttpTarget(base, model=REPLAY_MODEL,
                                          seed=tr.seed)
            records = scenarios.replay(tr, target)
            result = scenarios.summarize(tr, records)
            summaries.append(result)
            sent += len(tr.requests)
            keys = ("offered", "completed", "abandoned", "client_failures",
                    "ttft_p50_s", "ttft_p95_s", "arrival_skew_p95_s",
                    "duration_s")
            log(f"  replay {tr.name}: " + json.dumps(
                {k: result.get(k) for k in keys}))
            failures = scenarios.check_expect(tr.expect, result)
            if failures:
                fail(f"{tr.name} violated its expect block: {failures} "
                     f"(first error {result.get('first_error')})")
        for _ in range(100):   # a hung-up stream's slot frees on the loop
            health = _get_json(f"{base}/healthz")
            if health["models"][REPLAY_MODEL]["active_slots"] == 0:
                break
            time.sleep(0.1)
        else:
            fail(f"slots still held after the replays: {health}")
        prof1, metrics, series1 = _recompiles(base)
        after = prof1["recompiles"]
        if after != before or series1 != series0:
            fail(f"traffic recompiled: /debug/profile {before} -> {after}, "
                 f"/metrics {series0} -> {series1}")
        led = prof1["cache"]["ledger"]
        evictions = {dict(k[1])["cause"]: v for k, v in metrics.items()
                     if k[0] == "serving_kv_evictions_total"}
        if not led["conserved"] or led["frees"]["unattributed"] \
                or sum(evictions.values()) != led["frees_total"] \
                or evictions.get("unattributed", -1) != 0:
            fail(f"ledger {led}; serving_kv_evictions_total {evictions}")
        defers = {dict(k[1])["cause"]: v for k, v in metrics.items()
                  if k[0] == "serving_kv_admission_defers_total"}
        log(f"  recompiles {after} before and after, as /metrics; ledger "
            f"conserved: {led['births']} births, frees {evictions}, "
            f"{led['live_blocks']} live; defers {defers}; reuse distance "
            f"{led['reuse_distance']}; goodput {prof1['goodput']}")
        rec = scenarios.record_from_server(base, name="phase13")
        rec_path = os.path.join(PHASE13_DIR, "recorded.jsonl")
        scenarios.write_trace(rec, rec_path)
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = scenarios_cli.main(["describe", rec_path])
        desc = json.loads(buf.getvalue())
        completed = sum(r["completed"] for r in summaries)
        log(f"  record: {desc['requests']} requests ({desc['abandoning']} "
            f"abandoning) over {desc['duration_s']} s from "
            f"/v1/requests/timelines; {sent} sent, {completed} replayed "
            "requests completed")
        if rc != 0 or desc["requests"] != sent \
                or desc["requests"] - desc["abandoning"] < completed:
            fail(f"the recorded trace reads {desc}, {sent} requests sent")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if not os.path.exists(dump):
        fail(f"the replica wrote no counts:\n{replica_log()}")
    with open(dump) as f:
        rep = json.load(f)
    counts, L = rep["launch"], rep["layers"]
    want = {"paged_decode_attention": L * rep["calls"],
            "paged_prefill_append": L * rep["slices"]}
    log(f"  replica: {rep['calls']} decode steps, {rep['slices']} slices, "
        f"{rep['prefills']} prefill groups; launches {counts}; captures "
        f"{rep['captures_warm']} after warmup, {rep['captures']} at exit")
    for name, n in want.items():
        if counts.get(name) != n:
            fail(f"phase 13 {name}: {counts.get(name)} launches, the "
                 f"design implies {n}")
    if rep["captures"] != rep["captures_warm"]:
        fail(f"traffic captured {rep['captures'] - rep['captures_warm']} "
             "CUDA graphs")
    tracer = MEASURED.get("tracer_ms")
    log(f"  phase 3's host ms a decode step with the tracer attached "
        f"{MEASURED.get('phase3_step_ms', 'not run')}; tracer on / off "
        f"{tracer or 'not run'}; {_card()}")
    log(f"  phase 13 wall {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 14 ---------------------------------------------------------------

# Mixtral-8x7B's widths (models/llama_moe.py's MoELlamaConfig defaults:
# hidden 4096, 32/8 heads of 128, 8 experts, top 2, expert width 14336,
# vocab 32000, bf16) at 16 of its 32 layers: 23.22 B parameters, 46.44 GB
# of bf16 block weights and 1.05 GB of fp32 embedding and head. All 32
# layers (92.9 GB in bf16) exceed the card's 80 GB; only the depth is cut.
MOE_LAYERS = 16
MOE_NAME = "mixtral-8x7b-16l"
MOE_MAX_NEW = 16
# A token's experts are a top-k of router probabilities: where the k-th
# and (k+1)-th lie closer than the bf16 noise between the served path and
# the plain pass, the two may route the token to different experts, a
# jump in its logprob rather than a rounding. The plain pass records each
# position's smallest such gap over the layers; a position under
# MOE_GAP_TOL is excused from the logprob and argmax checks, counted and
# printed, and at most MOE_EXCUSE_MAX of the phase's positions may be.
# On an NVIDIA H100 80GB HBM3 (700 W): 14 of 208 distinct positions fell
# under it, the largest error above it read 0.0693 (at a gap of
# 1.37e-3), and the renormalised-gates control 1.075-1.432.
MOE_GAP_TOL = 2e-4
MOE_EXCUSE_MAX = 0.10
# A position past the logprob limit is tested for a route flip at each
# layer whose router gap there is under MOE_FLIP_GAP (ten MOE_GAP_TOLs;
# the int8 model's positions past 0.1 sat at gaps of 2.4e-4 to 9.8e-4 in
# three card runs, H100 80GB HBM3, 700 W).
MOE_FLIP_GAP = 10 * MOE_GAP_TOL


def _moe_teacher_pass(torch, engine, seqs, renorm=False, swap=None):
    """Each (prompt, served tokens) teacher-forced through the port's plain
    `llama_moe.apply` at capacity E / k (nothing drops, as in serving)
    -> [(log-softmax [n, vocab] at the n served positions, router gaps
    [L, n], the experts each layer chose [L, n, k])]. The probabilities
    are read where a layer takes its top k (`moe._top_k`, wrapped for
    the pass); the gap is the k-th minus the (k+1)-th. `renorm` is the
    control: the gate values renormalised over the k chosen, as public
    Mixtral code has them and the reference does not. `swap` = (j,
    layer): at served position j that layer takes the (k+1)-th expert,
    at its probability, in place of the k-th (a route flip)."""
    from kubeflow_tpu_torch.models import llama_moe
    from kubeflow_tpu_torch.parallel import moe

    cfg = dataclasses.replace(
        engine.cfg, capacity_factor=engine.cfg.num_experts / engine.cfg.top_k)
    top_k, gaps, chosen, out = moe._top_k, [], [], []
    row = None

    def probe(probs, k):
        top = torch.topk(probs, k + 1, dim=-1)
        gaps.append(top.values[:, k - 1] - top.values[:, k])
        vals, idx = top_k(probs, k)
        if swap is not None and len(chosen) == swap[1]:
            vals, idx = vals.clone(), idx.clone()
            vals[row, k - 1] = top.values[row, k]
            idx[row, k - 1] = top.indices[row, k]
        chosen.append(idx)
        if renorm:
            vals = vals / vals.sum(-1, keepdim=True)
        return vals, idx

    moe._top_k = probe
    try:
        with torch.inference_mode():
            for p, o in seqs:
                gaps.clear()
                chosen.clear()
                row = None if swap is None else len(p) - 1 + swap[0]
                toks = torch.tensor([p + o[:-1]], device=engine.device)
                logits, _ = llama_moe.apply(engine.params, cfg, toks)
                at = slice(len(p) - 1, len(p) - 1 + len(o))
                out.append((torch.log_softmax(logits[0, at], -1),
                            torch.stack(gaps)[:, at].cpu(),
                            torch.stack(chosen)[:, at].cpu()))
    finally:
        moe._top_k = top_k
    return out


def _moe_served_routes(torch, engine, p, o):
    """One (prompt, served tokens) through the engine's one-shot served
    path, teacher-forced on the served tokens: the prompt's prefill,
    then one cached forward a token (`_forward_cached`, the path
    `generate` takes, without graphs, so each layer's routing runs on
    the host's call), with `moe._top_k` wrapped. -> (logprobs of the
    served tokens, the experts each layer chose at the n served
    positions [L, n, k]): the prefill's last row, then one row a
    step."""
    from kubeflow_tpu_torch.parallel import moe

    dev = engine.device
    top_k, chosen, lps = moe._top_k, [], []

    def probe(probs, k):
        vals, idx = top_k(probs, k)
        chosen.append(idx)
        return vals, idx

    moe._top_k = probe
    try:
        with torch.inference_mode():
            state = engine.init_state(1)
            feed = [p] + [[t] for t in o[:-1]]
            for toks, nxt in zip(feed, o):
                logits, state = engine._forward_cached(
                    torch.tensor([toks], device=dev), state)
                lps.append(float(torch.log_softmax(logits[0], -1)[nxt]))
    finally:
        moe._top_k = top_k
    L = engine.cfg.num_layers
    if len(chosen) != L * len(o) or chosen[0].shape[0] != len(p):
        fail(f"served routes: {len(chosen)} routing calls for {L} layers "
             f"and {len(o)} tokens (prefill rows {chosen[0].shape[0]})")
    routes = torch.stack([torch.cat([chosen[li][-1:]] + chosen[L + li::L])
                          for li in range(L)])
    return lps, routes.cpu()


def _moe_teacher_check(torch, engine, prompts, outs, lps, label):
    """`_teacher_check` for a MoE engine: logprobs within LOGPROB_TOL of
    the plain pass and the argmax where its top-2 margin exceeds 2 x
    LOGPROB_TOL, at every position whose router gap is at least
    MOE_GAP_TOL. A position past either limit is examined for a route
    flip (when the teacher holds the served engine): the experts each
    layer chose there on the engine's served path, teacher-forced on
    the served tokens (`_moe_served_routes`), are printed beside the
    teacher's, and the teacher is run again with the k-th expert swapped
    for the (k+1)-th at each layer whose gap there is under
    MOE_FLIP_GAP. The position is excused as a route flip where the
    served path chose other experts, or where a swap brings the teacher
    within LOGPROB_TOL of the served logprob; else the check fails. The
    excused ones (by gap or by flip) are printed and pooled (by
    sequence) for the phase's cap. The renormalised-gates control must
    exceed LOGPROB_TOL on the positions not excused."""
    tol = LOGPROB_TOL
    served = getattr(engine, "served",
                     engine if hasattr(engine, "generate") else None)
    seqs = list(zip(prompts, outs))
    plain = _moe_teacher_pass(torch, engine, seqs)
    ctrl = _moe_teacher_pass(torch, engine, seqs, renorm=True)
    pos = []        # one dict a served position
    for i, ((p, o), lp, (logp, gaps, _), (clogp, _, _)) in enumerate(
            zip(seqs, lps, plain, ctrl)):
        at = torch.arange(len(o), device=logp.device)
        tok = torch.tensor(o, device=logp.device)
        ref, cref = logp[at, tok].cpu(), clogp[at, tok].cpu()
        top2 = torch.topk(logp, 2, dim=-1)
        margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
        best = top2.indices[:, 0].cpu()
        gap = gaps.min(0).values
        for j in range(len(o)):
            pos.append(dict(
                i=i, j=j, gap=float(gap[j]), ref=float(ref[j]), flip=False,
                lp=None if lp is None else lp[j],
                err=None if lp is None else abs(lp[j] - float(ref[j])),
                cerr=None if lp is None else abs(lp[j] - float(cref[j])),
                argmax=(None if margin[j] <= 2 * tol
                        else int(best[j]) == o[j])))
    over = [r for r in pos if r["gap"] >= MOE_GAP_TOL and (
        (r["err"] or 0.0) > tol or r["argmax"] is False)]
    routes = {}
    for r in over if served is not None else ():
        i, j = r["i"], r["j"]
        p, o = seqs[i]
        if i not in routes:
            routes[i] = _moe_served_routes(torch, served, p, o)
        rlps, got = routes[i]
        gaps, mine = plain[i][1], plain[i][2]
        flips = [(li, got[li, j].tolist(), mine[li, j].tolist())
                 for li in range(got.shape[0])
                 if set(got[li, j].tolist()) != set(mine[li, j].tolist())]
        swaps = []
        for li in gaps[:, j].argsort().tolist():
            if gaps[li, j] >= MOE_FLIP_GAP:
                break
            (slogp, _, _), = _moe_teacher_pass(torch, engine, [(p, o)],
                                               swap=(j, li))
            swaps.append((li, round(float(gaps[li, j]), 6),
                          round(float(slogp[j, o[j]]), 4)))
        explained = [sw for sw in swaps if r["lp"] is not None
                     and abs(r["lp"] - sw[2]) <= tol]
        r["flip"] = bool(flips) or bool(explained)
        log(f"    past the limit: sequence {i} position {j} (router gap "
            f"{r['gap']:.6f}, served {r['lp'] or 0.0:.4f}, teacher "
            f"{r['ref']:.4f}, "
            f"err {r['err'] or 0.0:.4f}, argmax {r['argmax']}); the served "
            f"path teacher-forced: logprob {rlps[j]:.4f}, layers choosing "
            f"other experts than the teacher (layer, served, teacher) "
            f"{flips}; the teacher with a layer's k-th expert swapped for "
            f"the (k+1)-th (layer, gap, logprob) {swaps}: "
            f"{'a route flip' if r['flip'] else 'no flip'}")
    pooled = MEASURED.setdefault("moe_positions", {})
    for i, (p, o) in enumerate(seqs):
        pooled[tuple(p + o)] = [r["gap"] < MOE_GAP_TOL or r["flip"]
                                for r in pos if r["i"] == i]
    kept = [r for r in pos if r["gap"] >= MOE_GAP_TOL and not r["flip"]]
    worst = max((r["err"] for r in kept if r["err"] is not None),
                default=0.0)
    ctrl_worst = max((r["cerr"] for r in kept if r["cerr"] is not None),
                     default=0.0)
    judged = [r["argmax"] for r in kept if r["argmax"] is not None]
    by_gap = [r for r in pos if r["gap"] < MOE_GAP_TOL]
    by_flip = [r for r in pos if r["flip"]]

    def shown(some):
        return [(round(r["gap"], 6),
                 r["err"] if r["err"] is None else round(r["err"], 4))
                for r in some]

    log(f"  {label}: teacher-forced logprob max_abs_err {worst:.4f} (tol "
        f"{tol}) over {len(kept)} positions; {len(by_gap)}/{len(pos)} "
        f"excused by router gap < {MOE_GAP_TOL} and {len(by_flip)} by a "
        f"route flip ((gap, err)): {shown(by_gap)}, {shown(by_flip)}; "
        f"greedy argmax agrees on {sum(judged)}/{len(judged)} steps with "
        f"margin > {2 * tol}; renormalised-gates control {ctrl_worst:.4f}")
    by_err = sorted((r for r in pos if r["err"] is not None),
                    key=lambda r: -r["err"])[:6]
    log(f"    largest errors (gap, err): {shown(by_err)}; smallest gaps: "
        f"{shown(sorted(pos, key=lambda r: r['gap'])[:6])}")
    if worst > tol or not all(judged):
        fail(f"{label}: served tokens disagree with the plain MoE model")
    if any(lp is not None for lp in lps) and ctrl_worst <= tol:
        fail(f"{label}: the renormalised-gates control is within "
             f"{tol}: the check does not see the gating")


def _dev_total(e):
    """A host op's device time, its kernels' included."""
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))


def _moe_step_split(torch, engine, prompts):
    """Device ms of a one-shot decode step of the window batch (the
    prompts left-padded to one row each), split into the expert products
    (`aten::bmm`'s device time: only the expert FFN runs batched
    products), the decode attention kernel (`decode_split` and
    `decode_combine`) and the rest. Two profiled calls of an eager engine
    on the same weights (graphs off, so each kernel's host op is
    recorded) to 1 and to MOE_MAX_NEW tokens; their difference over
    MOE_MAX_NEW - 1 steps. Also how many of the E experts each layer of
    each decode step routes to. -> (total, experts, attention) ms."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.parallel import moe
    from kubeflow_tpu_torch.serving.engine import InferenceEngine

    eager = InferenceEngine(engine.params, engine.cfg, engine.family,
                            engine.ec, device=engine.device,
                            cuda_graphs=False)
    width = max(len(p) for p in prompts)
    arr = torch.zeros(len(prompts), width, dtype=torch.long)
    mask = torch.zeros(len(prompts), width, dtype=torch.bool)
    for r, p in enumerate(prompts):
        arr[r, width - len(p):] = torch.tensor(p)
        mask[r, width - len(p):] = True
    top_k, hit, parts = moe._top_k, [], {}

    def count(probs, k):
        vals, idx = top_k(probs, k)
        if probs.shape[0] == len(prompts):      # a decode step's layer
            hit.append(idx)
        return vals, idx

    moe._top_k = count
    try:
        for n in (1, MOE_MAX_NEW):
            hit.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                toks = eager.generate(arr, prompt_mask=mask, max_new=n)
                torch.cuda.synchronize()
            events = _device_events(prof)
            parts[n] = (
                sum(_dev_us(e) for e in events),
                sum(_dev_total(e) for e in prof.key_averages()
                    if e.key == "aten::bmm"),
                sum(_dev_us(e) for e in events
                    if "decode_split" in e.key or "decode_combine" in e.key))
    finally:
        moe._top_k = top_k
    # the same window batch through the engine's graphs: the same tokens
    graphed = engine.generate(arr, prompt_mask=mask, max_new=MOE_MAX_NEW)
    log(f"  graph replay against the eager engine, window batch: greedy "
        f"tokens identical {torch.equal(graphed, toks)}")
    if not torch.equal(graphed, toks):
        fail("phase 14: graph replay and eager launches gave different "
             "greedy tokens")
    steps = MOE_MAX_NEW - 1
    total, experts, attn = ((parts[MOE_MAX_NEW][i] - parts[1][i]) / steps
                            / 1e3 for i in range(3))
    distinct = [len(set(idx.flatten().tolist())) for idx in hit]
    E = engine.cfg.num_experts
    hist = {n: distinct.count(n) for n in sorted(set(distinct))}
    log(f"  decode step of the {len(prompts)}-row window batch (eager "
        f"engine, profiled): device {total:.4f} ms = expert products "
        f"{experts:.4f} + decode attention kernel {attn:.4f} + the rest "
        f"{total - experts - attn:.4f}")
    log(f"  experts routed to per layer per decode step ({len(prompts)} "
        f"rows x top {engine.cfg.top_k} over {E}): "
        f"{hist} over {len(distinct)} layer-steps, mean "
        f"{sum(distinct) / max(len(distinct), 1):.2f}; the dense expert "
        f"products compute all {E}")
    return total, experts, attn


async def _release(torch) -> None:
    """Free what a closed server or batcher held. Its cancelled worker and
    the app's cleanup leave callbacks on the event loop that keep the
    engine, and so its weights, alive until the loop runs them: yield to
    the loop once, then collect and return the cached blocks."""
    await asyncio.sleep(0)
    gc.collect()
    torch.cuda.empty_cache()


async def serve_moe_and_check(torch):
    """Phase 14: the MoE family at Mixtral-8x7B's widths and 16 layers
    (random weights, seed 0, drawn a layer at a time) served three ways
    as phase 6 serves gemma-2b: continuous chunked (64-token slices) and
    monolithic through the app the CLI would build (8 slots, warmed,
    depth 2), then one-shot (window batcher at 8 rows, direct path).
    One engine serves all three. -> launch counts."""
    from kubeflow_tpu_torch.models import llama_moe
    from kubeflow_tpu_torch.parallel import moe
    from kubeflow_tpu_torch.serving.engine import (
        MOE_LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama_moe.MIXTRAL_8X7B, num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama_moe.init(cfg, 0, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    blocks = params["blocks"].values()
    n_params = sum(t.numel() for t in blocks) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    block_bytes = sum(t.numel() * t.element_size() for t in blocks)
    bound_ms = block_bytes / HBM_BYTES_S * 1e3
    log(f"  {MOE_NAME} (seed 0): {n_params} params, {block_bytes / 1e9:.2f} "
        f"GB of bf16 block weights, drawn in {load_s:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    engine = InferenceEngine(params, cfg, MOE_LLAMA_FAMILY,
                             EngineConfig(max_len=MAX_LEN), device=dev)
    MEASURED["moe_positions"] = {}
    counts, secs = {}, {"load": load_s}
    for chunked in (True, False):
        way = "chunked" if chunked else "monolithic"
        log(f"  continuous, {way}:")
        t0 = time.perf_counter()
        got = await serve_and_check(torch, chunked, MOE_NAME, engine=engine)
        for name in ("paged_decode_attention", "paged_prefill_append"):
            counts[name] = counts.get(name, 0) + got[name]
        await _release(torch)
        secs[way] = time.perf_counter() - t0
    log("  one-shot (window batcher, direct path):")
    t0 = time.perf_counter()
    got = await serve_dense_and_check(torch, MOE_NAME, spec=False,
                                      engine=engine, max_new=MOE_MAX_NEW)
    counts["decode_attention"] = got["decode_attention"]
    secs["one-shot"] = time.perf_counter() - t0
    _moe_excused("")

    gen = torch.Generator().manual_seed(14)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in DENSE_PROMPTS]
    t0 = time.perf_counter()
    total, experts, attn = _moe_step_split(torch, engine, prompts)
    secs["split"] = time.perf_counter() - t0
    graph_ms = MEASURED[f"oneshot_step_ms@{MOE_NAME}"]
    # one layer's expert products at the decode shape, graph-replayed
    lp = {k: v[0] for k, v in params["blocks"].items()}
    xe = torch.randn(cfg.num_experts, DENSE_B, cfg.hidden_size,
                     device=dev).to(cfg.dtype)
    layer_ms, _ = _time_ms(torch, lambda i: moe._expert_ffn(lp, xe), 10)
    expert_bytes = sum(lp[k].numel() * lp[k].element_size()
                       for k in ("w_gate", "w_up", "w_down"))
    MEASURED["moe"] = dict(load_s=load_s, graph_step_ms=graph_ms,
                           eager_step_ms=total, experts_ms=experts,
                           attention_ms=attn, expert_layer_ms=layer_ms,
                           bound_ms=bound_ms)
    log(f"  decode step (graph replay, phase 5's method): {graph_ms:.4f} "
        f"ms device against the {bound_ms:.2f} ms bound (the "
        f"{block_bytes / 1e9:.2f} GB of block weights at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s) = {bound_ms / graph_ms:.1%}; one "
        f"layer's expert products at [{cfg.num_experts}, {DENSE_B}, "
        f"{cfg.hidden_size}] {layer_ms:.4f} ms graph-replayed "
        f"({expert_bytes / layer_ms / 1e6:.0f} GB/s, x{MOE_LAYERS} = "
        f"{layer_ms * MOE_LAYERS:.3f} ms)")
    del lp, xe
    t0 = time.perf_counter()
    for k, n in (await _moe_adapters_and_check(torch, engine)).items():
        counts[k] = counts.get(k, 0) + n
    secs["adapters"] = time.perf_counter() - t0
    del engine
    await _release(torch)
    t0 = time.perf_counter()
    qparams = _moe_quantize(torch, params, cfg)
    # the bf16 weights (43 GiB) must be gone before the int8 engine
    # serves: beside them its graphs and dequantized stacks overrun 80 GB
    bf16 = weakref.ref(params["blocks"]["w_up"])
    del params, blocks
    await _release(torch)
    log(f"  int8: bf16 weights released {bf16() is None}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before "
        f"int8 serving")
    if bf16() is not None:
        fail("phase 14 int8: the bf16 weights outlived their engines")
    for k, n in (await _serve_moe_int8(torch, qparams, cfg)).items():
        counts[k] = counts.get(k, 0) + n
    secs["int8"] = time.perf_counter() - t0
    del qparams
    log(f"  phase 14 {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    return counts


def _reckon_moe_param_bytes(cfg) -> int:
    """Device bytes of the MoE family's params under --quant int8: the
    four attention matrices and the three expert stacks int8 plus a bf16
    scale per output channel (per expert for the stacks), the router
    bf16, the norms, embedding and head fp32 (the serving storage
    rule)."""
    L, D, E, M = (cfg.num_layers, cfg.hidden_size, cfg.num_experts,
                  cfg.expert_mlp_dim)
    q, kv = cfg.q_dim, cfg.kv_dim
    attn = sum(k * n + 2 * n for k, n in ((D, q), (D, kv), (D, kv),
                                          (q, D)))
    experts = E * (2 * (D * M + 2 * M) + (M * D + 2 * D))
    router = 2 * D * E
    return (L * (attn + experts + router) + (2 * L * D + D) * 4
            + 2 * cfg.vocab_size * D * 4)


def _moe_excused(label: str) -> None:
    """The excused-position cap over what the teacher checks since the
    last call pooled (MEASURED["moe_positions"])."""
    pooled = MEASURED.pop("moe_positions", {})
    n_pos = sum(len(v) for v in pooled.values())
    n_exc = sum(sum(v) for v in pooled.values())
    log(f"  {label + ' ' if label else ''}router gaps: {n_exc}/{n_pos} "
        f"distinct served positions excused (gap < {MOE_GAP_TOL} or a "
        f"route flip; at most {MOE_EXCUSE_MAX:.0%})")
    if n_exc > MOE_EXCUSE_MAX * n_pos:
        fail(f"phase 14{' ' + label if label else ''}: {n_exc} of {n_pos} "
             f"positions excused by their router gap or a route flip, "
             f"above {MOE_EXCUSE_MAX:.0%}")


async def _moe_adapters_and_check(torch, base) -> dict:
    """Phase 14, adapters: the MoE model's bf16 base with a pack of
    attention-only adapters (wq, wk, wv, wo; the routed FFN has no dense
    MLP to adapt), served continuously (8 slots, chunk 64): phase 12b's
    eight rows mixing the base and the adapters, exact paged launches,
    and each row against the plain MoE model on its merged weights."""
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.engine import (
        MOE_LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.multilora import build_pack
    from kubeflow_tpu_torch.train.lora import LoraConfig

    cfg, dev = base.cfg, base.device
    lcfg = LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, targets=ATTN_TARGETS)
    adapters = _lora_adapters(torch, cfg, dev, 14, ATTN_TARGETS)
    pack = build_pack(cfg, lcfg, adapters, device=dev)
    engine = InferenceEngine(base.params, cfg, MOE_LLAMA_FAMILY,
                             EngineConfig(max_len=MAX_LEN), device=dev,
                             adapter_pack=pack)
    batcher = ContinuousBatcher(engine, asyncio.Lock(), max_slots=SLOTS,
                                prefill_chunk_tokens=CHUNK, seed=0)
    gen = torch.Generator().manual_seed(141)
    rows = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(),
             a) for n, a in LORA_ROWS]
    t0 = time.perf_counter()
    try:
        reset_launch_counts()
        served = await asyncio.gather(*(
            batcher.submit(p, MAX_NEW, {"adapter": a} if a else {},
                           with_logprobs=True) for p, a in rows))
        torch.cuda.synchronize()
        counts = launch_counts()
        calls, slices = batcher.calls, batcher.slices
    finally:
        await batcher.close()
    L = cfg.num_layers
    want = {"paged_decode_attention": L * calls,
            "paged_prefill_append": L * slices}
    log(f"  adapters: a {len(LORA_NAMES)}-adapter attention-only pack (rank "
        f"{LORA_RANK}, {pack.nbytes / 2**20:.1f} MiB), {len(rows)} rows in "
        f"{time.perf_counter() - t0:.1f} s: {calls} decode steps, {slices} "
        f"slices; launches {counts}")
    for k, n in want.items():
        if counts[k] != n:
            fail(f"phase 14 adapters {k}: {counts[k]} launches, the design "
                 f"implies {n}")
    groups = {a: [] for a in ("",) + LORA_NAMES}
    for (p, a), (toks, lps) in zip(rows, served):
        groups[a].append((p, list(toks), list(lps)))
    MEASURED["moe_positions"] = {}
    for a, items in groups.items():
        teacher = _merged_teacher(torch, engine, adapters, lcfg, a)
        _teacher_check(torch, teacher, *map(list, zip(*items)),
                       f"MoE {a or 'base'} rows (teacher: merged weights)")
        del teacher
        gc.collect()
        torch.cuda.empty_cache()
    _moe_excused("adapters")
    del engine, pack
    return counts


def _moe_quantize(torch, params, cfg):
    """Phase 14, int8: the same weights under --quant int8 (the expert
    stacks quantized per expert and output channel over D, the router
    kept), param bytes as reckoned. -> the int8 params."""
    from kubeflow_tpu_torch.serving.quant import param_bytes, quantize_blocks

    t0 = time.perf_counter()
    qparams = quantize_blocks(params)
    torch.cuda.synchronize()
    got, want = param_bytes(qparams), _reckon_moe_param_bytes(cfg)
    log(f"  int8: quantized in {time.perf_counter() - t0:.1f} s, param "
        f"bytes {got} (reckoned {want}; bf16 {param_bytes(params)})")
    if got != want:
        fail(f"phase 14 int8: {got} param bytes, reckoned {want}")
    return qparams


class _QdotRhs:
    """`h @ rhs` as the reference's `qdot` forms it, (h @ q) * scale,
    in the int8_proj kernel's arithmetic: accumulated and scaled in fp32,
    rounded once."""

    def __init__(self, w, dtype):
        self.w, self.dtype = w, dtype

    def __rmatmul__(self, h):
        y = h.float() @ self.w.q.float()
        return (y * self.w.scale.float()[..., 0, :]).to(self.dtype)


def _qdot_teacher(engine):
    """The plain MoE model over an int8 engine's weights with the served
    numerics: the four attention products as the reference's `qdot`
    ((h @ q) * scale, in fp32 and rounded once, as int8_proj computes
    it; not a product with the dequantized weight), the expert stacks
    dequantized as the serving FFN dequantizes them. `served` is the
    engine, for the routes of a position past the limit."""
    import types

    from kubeflow_tpu_torch.serving.quant import QTensor

    class QdotLeaf(QTensor):
        def __getitem__(self, idx):
            return QdotLeaf(self.q[idx], self.scale[idx])

        def to(self, dtype):
            return _QdotRhs(self, dtype)

    blocks = {k: QdotLeaf(w.q, w.scale) if k in ATTN_TARGETS else w
              for k, w in engine.params["blocks"].items()}
    return types.SimpleNamespace(params=dict(engine.params, blocks=blocks),
                                 cfg=engine.cfg, family=engine.family,
                                 device=engine.device, served=engine)


async def _serve_moe_int8(torch, qparams, cfg) -> dict:
    """The int8 MoE model served continuously (chunked: a repeated
    prompt, the teacher check against the plain MoE model on the same
    int8 weights with the reference's qdot, the eager control) and
    one-shot. The expert stacks are dequantized each step; the
    attention products run through int8_proj. -> launch counts."""
    from kubeflow_tpu_torch.serving.engine import (
        MOE_LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )

    dev = torch.device("cuda")
    engine = InferenceEngine(qparams, cfg, MOE_LLAMA_FAMILY,
                             EngineConfig(max_len=MAX_LEN), device=dev)
    MEASURED["moe_positions"] = {}
    counts = {}
    log("  int8, continuous, chunked:")
    teacher = _qdot_teacher(engine)
    got = await serve_and_check(torch, True, MOE_NAME, engine=engine,
                                teacher=teacher)
    for name in ("paged_decode_attention", "paged_prefill_append",
                 "int8_proj"):
        counts[name] = counts.get(name, 0) + got[name]
    await _release(torch)
    log("  int8, one-shot (window batcher, direct path):")
    got = await serve_dense_and_check(torch, MOE_NAME, spec=False,
                                      engine=engine, max_new=MOE_MAX_NEW,
                                      teacher=teacher)
    for name in ("decode_attention", "int8_proj"):
        counts[name] = counts.get(name, 0) + got[name]
    _moe_excused("int8")
    if not counts["int8_proj"]:
        fail("phase 14 int8: no int8_proj launch")
    del engine
    return counts


# -- phase 15 ---------------------------------------------------------------

# Mixtral-8x7B's attention (32 query heads over 8 KV heads of 128: a GQA
# group of 4), timed in phase 2 and trained through in phase 15a
MIXTRAL = Geom("mixtral-8x7b", 32, 8, 128, 32)
MIXTRAL_SUFFIX = "@mixtral"
MOE_TRAIN_STEPS = 4                # timed, after RECIPE_STEPS counted steps
# The MoE training state: 16 bytes a parameter (fp32 master, gradient, two
# AdamW moments) and 4 more a block parameter (each layer's gradient waits
# for the others before the unbind's backward stacks them), plus this for
# activations, the fp32 head's logits and the allocator's slack.
MOE_TRAIN_MARGIN = 10 * 2**30
# Kernel path vs plain path at fp32 activations (the fp32 flash kernels,
# the same routing forced on both): worst leaf (per layer for block
# leaves) by relative L2 error. The limit, set before the first card run
# (PERF.md): fp32 sums in other orders through two layers; a control with
# the aux term's gradient detached must exceed it on the router.
MOE_GRAD_TOL = 1e-3
# fp32: a route may differ between the two paths only where the top k + 1
# router probabilities lie closer than this (a near-tie, not a fault)
MOE_ROUTE_GAP_TOL = 1e-5
REMAT_POLICIES = ("full", "mlp", "dots")
# 15b: gradients and loss under "mlp" / "dots" against "full" (bf16, the
# same flash kernels): worst leaf by relative L2 error (PERF.md)
REMAT_GRAD_TOL = 1e-3
ADAFACTOR_STEPS, LORA_STEPS = 4, 8
REMAT_STEPS = 3                    # 15b: timed a policy, after one step
ADAMW_STATE_BYTES_1B = 2 * 4 * 1_235_814_400    # llama3-1b's two moments


def _route_probe(torch, calls, force=None):
    """A stand-in for `moe._top_k` that records each call's natural
    experts [T, k] and each token's smallest adjacent gap among its top
    k + 1 probabilities (a swap of rank 0 and 1 moves capacity priority
    too); with `force` (the experts a previous pass recorded, one entry a
    call) it routes by those instead, the probabilities gathered there."""
    from kubeflow_tpu_torch.parallel import moe

    top_k = moe._top_k

    def probe(probs, k):
        top = torch.topk(probs.detach(), k + 1, dim=-1)
        gap = (top.values[:, :-1] - top.values[:, 1:]).min(-1).values
        calls.append((top.indices[:, :k], gap))
        if force is None:
            return top_k(probs, k)
        idx = force[len(calls) - 1]
        return probs.gather(-1, idx), idx

    return probe


def _moe_train_depth(cfg, free_bytes: int):
    """Mixtral's widths at the deepest depth whose training state fits
    the card's free memory (MOE_TRAIN_MARGIN): depth is cut, never width.
    -> (cfg, block params a layer, embedding + head + final norm)."""
    import math

    from kubeflow_tpu_torch.models import llama_moe

    one = llama_moe.param_shapes(dataclasses.replace(cfg, num_layers=1))
    per_layer = sum(math.prod(s) for s in one["blocks"].values())
    fixed = sum(math.prod(s) for k, s in one.items() if k != "blocks")
    layers = cfg.num_layers
    while layers > 1 and (20 * per_layer * layers + 16 * fixed
                          + MOE_TRAIN_MARGIN) > free_bytes:
        layers -= 1
    return dataclasses.replace(cfg, num_layers=layers), per_layer, fixed


def _moe_step_flops(cfg, b, s):
    """FLOPs one training step runs, by part: the forward's projections,
    router, attention core (causal pairs) and expert products at
    capacity (E x C rows a layer), the fp32 head; the backward (two
    products per forward product; the flash backward's dQ 3 and dK/dV 4
    products against the forward's 2); remat's second forward of every
    block, apart. -> dict of TFLOP."""
    T, D, L = b * s, cfg.hidden_size, cfg.num_layers
    rows = cfg.num_experts * cfg.moe_config().capacity(T)
    proj = 2 * T * D * (2 * cfg.q_dim + 2 * cfg.kv_dim)
    router = 2 * T * D * cfg.num_experts
    unit = 2 * cfg.head_dim * _pairs(s, True, None) * cfg.num_heads * b
    experts = 3 * 2 * rows * D * cfg.expert_mlp_dim
    head = 2 * T * D * cfg.vocab_size
    fwd_block = proj + router + experts + 2 * unit
    parts = {"forward": L * fwd_block + head,
             "backward": L * (2 * (proj + router + experts) + 7 * unit)
             + 2 * head,
             "remat": L * fwd_block}
    return {k: v / 1e12 for k, v in parts.items()}, rows


def moe_train_and_check(torch):
    """Phase 15a: the MoE family trained at Mixtral-8x7B's widths, at the
    depth the card's memory holds. -> (the flash kernels' launches over
    the bf16 training, over the fp32 gradient pass)."""
    from unittest import mock

    import numpy as np

    from kubeflow_tpu_torch.models import llama, llama_moe
    from kubeflow_tpu_torch.ops import attention
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import moe
    from kubeflow_tpu_torch.train import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.trainer import cross_entropy_loss

    dev = torch.device("cuda")
    b, s = FLASH_B, FLASH_S
    free, total = torch.cuda.mem_get_info()
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    cfg, per_layer, fixed = _moe_train_depth(llama_moe.MIXTRAL_8X7B, free)
    L = cfg.num_layers
    log(f"  free {free / 2**30:.2f} of {total / 2**30:.2f} GiB: "
        f"{L} of {llama_moe.MIXTRAL_8X7B.num_layers} layers ({per_layer} "
        f"block params a layer, {fixed} in the embedding, head and final "
        f"norm; {(20 * per_layer * L + 16 * fixed) / 1e9:.1f} GB of state "
        f"and stacked gradients reckoned, {MOE_TRAIN_MARGIN / 2**30:.0f} "
        f"GiB margin)")
    if L < 2:
        fail(f"phase 15a: {free / 2**30:.1f} GiB free holds fewer than two "
             "Mixtral layers' training state")
    rng = np.random.default_rng(15)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(b, s, device=dev)
    batch = (tokens, targets, mask)
    t0 = time.perf_counter()
    params0 = llama_moe.init(cfg, 0, dev, train=True)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params0["blocks"].values()) + sum(
        t.numel() for k, t in params0.items() if k != "blocks")
    log(f"  {n_params} params (fp32 masters) drawn in "
        f"{time.perf_counter() - t0:.1f} s; capacity "
        f"{cfg.moe_config().capacity(b * s)} slots an expert at "
        f"{b * s} tokens (factor {cfg.capacity_factor})")

    # gradients at the initial weights, fp32 activations (the fp32 flash
    # kernels), no remat: the plain path, then the kernel path routed as
    # the plain path routed, then the control
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, remat=False)

    def loss32(detach_aux=False):
        def fn(params, tokens, targets, mask):
            logits, aux = llama_moe.apply(params, cfg32, tokens)
            if detach_aux:
                aux = aux.detach()
            return (cross_entropy_loss(logits, targets, mask)
                    + cfg32.aux_loss_weight * aux)
        return fn

    def plain_attention(*a, **kw):
        return attention.dot_product_attention(
            *a, **{**kw, "contiguous_positions": False})

    assign, drops, hist = moe._assign, [], []

    def counted(*a, **kw):
        out = assign(*a, **kw)
        drops.append(int((~out[3]).sum()))
        hist.append(torch.bincount(out[1].flatten(),
                                   minlength=cfg.num_experts).tolist())
        return out

    plain_calls, kernel_calls, top_k = [], [], moe._top_k
    attention.reset_impl_counts()
    try:
        moe._top_k = _route_probe(torch, plain_calls)
        moe._assign = counted
        with mock.patch.object(llama, "dot_product_attention",
                               plain_attention):
            want_loss, want = _grads(torch, loss32(), params0, *batch)
        moe._assign = assign
        plain_impl = attention.impl_counts()
        attention.reset_impl_counts()
        force = [idx for idx, _ in plain_calls]
        moe._top_k = _route_probe(torch, kernel_calls, force)
        reset_launch_counts()
        got_loss, got = _grads(torch, loss32(), params0, *batch)
        fp32_counts = launch_counts()
        kernel_impl = attention.impl_counts()
        grad_err = _worst_grad_err(torch, got, want)
        del got
        gc.collect()
        ctrl_calls = []
        moe._top_k = _route_probe(torch, ctrl_calls, force)
        _, ctrl = _grads(torch, loss32(detach_aux=True), params0,
                               *batch, only="blocks.router")
        ctrl_err = _worst_grad_err(
            torch, ctrl, {"blocks.router": want["blocks.router"]})
    finally:
        moe._top_k, moe._assign = top_k, assign
    del want, ctrl
    gc.collect()
    torch.cuda.empty_cache()
    differ, gaps = 0, []
    for (p_idx, _), (k_idx, k_gap) in zip(plain_calls, kernel_calls,
                                          strict=True):
        moved = (p_idx != k_idx).any(-1)
        differ += int(moved.sum())
        gaps += k_gap[moved].tolist()
    min_gap = min(float(g.min()) for _, g in plain_calls)
    log(f"  fp32 gradients at the initial weights, kernel path (routed as "
        f"the plain path) vs plain path, worst leaf |diff| / |plain| in L2: "
        f"{grad_err[0]:.3e} ({grad_err[1]}); aux-detached control on the "
        f"router {ctrl_err[0]:.3e} ({ctrl_err[1]}) (tol {MOE_GRAD_TOL}); "
        f"losses {got_loss:.6f} vs {want_loss:.6f}; attention impl counts "
        f"plain pass {plain_impl}, kernel pass {kernel_impl}")
    log(f"  routing choices that differ between the two passes: {differ} "
        f"tokens of {b * s} x {L} layers, at router gaps "
        f"{[round(g, 8) for g in gaps]} (excused under "
        f"{MOE_ROUTE_GAP_TOL}); smallest gap of the plain pass {min_gap:.3e}")
    log(f"  at capacity factor {cfg.capacity_factor}: choices dropped per "
        f"layer {drops} of {b * s * cfg.top_k}; routed-expert histogram "
        f"per layer (choices an expert) {hist}")
    if plain_impl["flash"] or kernel_impl["torch"] or not kernel_impl["flash"]:
        fail(f"phase 15a: the passes did not take their paths: plain "
             f"{plain_impl}, kernel {kernel_impl}")
    # the fp32 kernel pass, no remat: one forward, dQ and dK/dV a layer
    fp32_counts = {k: n for k, n in fp32_counts.items()
                   if k.startswith("flash_attention")}
    if fp32_counts != {k: L for k in fp32_counts} or len(fp32_counts) != 3:
        fail(f"phase 15a: the fp32 kernel pass launched {fp32_counts}, the "
             f"design implies {L} of each flash kernel")
    if any(g >= MOE_ROUTE_GAP_TOL for g in gaps):
        fail(f"phase 15a: routes differ at router gaps {gaps}, not only "
             f"near-ties under {MOE_ROUTE_GAP_TOL}")
    if grad_err[0] > MOE_GRAD_TOL or abs(got_loss - want_loss) > \
            MOE_GRAD_TOL * abs(want_loss):
        fail("phase 15a: kernel-path MoE gradients disagree with the plain "
             "path's")
    if ctrl_err[0] <= MOE_GRAD_TOL:
        fail("phase 15a: the gradient check cannot see the aux loss's "
             "gradient on the router")

    # training: bf16 activations, fp32 masters, AdamW, full remat
    trainer = Trainer(apply_fn=lambda p, t: llama_moe.apply(p, cfg, t)[0],
                      init_fn=lambda seed: llama_moe.init(cfg, seed, dev,
                                                          train=True),
                      train_config=TrainConfig(warmup_steps=2,
                                               total_steps=1000),
                      loss_fn=llama_moe.loss_fn(cfg), device=dev)
    state = trainer.init_from_params(params0)
    del params0
    reset_launch_counts()
    attention.reset_impl_counts()
    train_hist, train_drops = [], []

    def counted_train(*a, **kw):
        out = assign(*a, **kw)
        if len(train_hist) < L:     # the forward's calls, not remat's
            train_drops.append(int((~out[3]).sum()))
            train_hist.append(torch.bincount(
                out[1].flatten(), minlength=cfg.num_experts).tolist())
        return out

    # the counted steps' routes: phase 17g-b forces its ranks onto them
    routes: list = []
    moe._assign, moe._top_k = counted_train, _route_probe(torch, routes)
    try:
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens, targets)
        losses = [float(loss)]
        warm_s = time.perf_counter() - t0
        moe._assign = assign
        for _ in range(RECIPE_STEPS - 1):
            state, loss = trainer.step(state, tokens, targets)
            losses.append(float(loss))
    finally:
        moe._assign, moe._top_k = assign, top_k
    torch.cuda.reset_peak_memory_stats()
    pending = []
    t0 = time.perf_counter()
    for _ in range(MOE_TRAIN_STEPS):
        state, loss = trainer.step(state, tokens, targets)
        pending.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    impl = attention.impl_counts()
    losses += [float(x) for x in pending]
    steps = RECIPE_STEPS + MOE_TRAIN_STEPS
    flops, rows = _moe_step_flops(cfg, b, s)
    run = flops["forward"] + flops["backward"]
    model = trainer.step_flops(b, s) / 1e12
    log(f"  losses {[round(x, 4) for x in losses]}; first step "
        f"{warm_s:.2f} s; choices dropped per layer {train_drops}, "
        f"routed-expert histogram {train_hist} (bf16, first step)")
    log(f"  step (host clock, {MOE_TRAIN_STEPS} steps after "
        f"{RECIPE_STEPS}): "
        f"{step_s * 1e3:.1f} ms, {b * s / step_s:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB, optimizer state "
        f"{trainer.opt_state_bytes() / 2**30:.2f} GiB")
    log(f"  FLOPs the step runs (expert products at capacity, {rows} rows "
        f"a layer): forward {flops['forward']:.2f} + backward "
        f"{flops['backward']:.2f} = {run:.2f} TFLOP, "
        f"{run / step_s / (BF16_FLOPS_S / 1e12):.1%} of 989 TFLOP/s (MFU); "
        f"with remat's second forward ({flops['remat']:.2f} TFLOP) "
        f"{(run + flops['remat']) / step_s / (BF16_FLOPS_S / 1e12):.1%} "
        f"(hardware use). Apart, the reference's 6 N T model FLOPs (all "
        f"{cfg.num_experts} experts of each token): {model:.2f} TFLOP, "
        f"{model / step_s / (BF16_FLOPS_S / 1e12):.1%}")
    log(f"  attention impl counts {impl}; kernel launches {counts} over "
        f"{steps} steps")
    # one more step under torch.profiler: where a MoE step's time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    _report_profile(prof, prof_s, top=12)
    bmm_ms = sum(_dev_total(e) for e in prof.key_averages()
                 if e.key == "aten::bmm") / 1e3
    log(f"  expert products (aten::bmm: forward, remat, backward) "
        f"{bmm_ms:.1f} ms of the profiled step's device time")
    expect = {"flash_attention_fwd": 2 * L * steps,
              "flash_attention_dq": L * steps,
              "flash_attention_dkv": L * steps}
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"phase 15a {name}: {counts[name]} launches, the design "
                 f"implies {n} (remat: forward + recompute, {L} layers x "
                 f"{steps} steps)")
    if impl["torch"] != 0:
        fail(f"phase 15a: attention left the flash kernels: {impl}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"phase 15a: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 15a: loss did not fall: {losses}")
    MEASURED["moe_train"] = dict(
        step_ms=step_s * 1e3, peak=peak, run=run, layers=L,
        losses=losses[:RECIPE_STEPS],
        routes=[idx.cpu() for idx, _ in routes])
    del state, trainer
    return {k: v for k, v in counts.items() if k in expect}, fp32_counts


def _chunked_loss(cfg):
    """Phase 4's loss: chunked CE over llama.hidden."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import chunked_cross_entropy_from_hidden

    def fn(params, tokens, targets, mask):
        h = llama.hidden(params, cfg, tokens)
        return chunked_cross_entropy_from_hidden(
            h, llama.unembed_matrix(params, cfg), targets, mask,
            num_chunks=16)
    return fn


def _llama1b_batch(torch, dev, seed):
    import numpy as np

    from kubeflow_tpu_torch.models import llama

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, llama.LLAMA3_1B.vocab_size, (FLASH_B, FLASH_S))).to(dev)
    return tokens, torch.roll(tokens, -1, dims=1)


# cuBLAS's GEMM kernels as the profiler names them on an H100
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def _gemm_kernels(prof) -> tuple[int, float]:
    """(GEMM kernel launches, their device ms) in a profile. Device events
    only: under selective checkpointing each op is dispatched through a
    mode that calls it again, so a host op such as `aten::mm` is
    recorded twice where its kernel runs once."""
    ev = [e for e in _device_events(prof)
          if any(k in e.key.lower() for k in GEMM_KERNELS)]
    return sum(e.count for e in ev), sum(_dev_us(e) for e in ev) / 1e3


def _mm_counter():
    """A dispatch mode counting the `aten.mm` calls that run (a product a
    selective checkpoint serves from its cache is not called)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "mm":
                self.n += 1
            return func(*args, **(kwargs or {}))

    return Count()


def remat_policies_and_check(torch):
    """Phase 15b: llama3-1b at phase 4's configuration under each remat
    policy: loss and gradients at the initial weights against "full",
    the `aten.mm` calls of the forward and of the backward (a dispatch
    mode) and the GEMM kernels of each (profiler), the memory the forward
    leaves saved for the backward and each half's peak, then trainer
    steps (REMAT_STEPS timed after one; the first splits the step's peak
    between the gradient pass and the optimizer update). -> flash
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    tokens, targets = _llama1b_batch(torch, dev, 0)
    mask = torch.ones(FLASH_B, FLASH_S, device=dev)
    params0 = llama.init(llama.LLAMA3_1B, 0, dev, train=True)
    counts, rows, full = {}, {}, None
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(llama.LLAMA3_1B, remat_policy=policy)
        live = {k: ({n: x.detach().requires_grad_(True)
                     for n, x in v.items()} if isinstance(v, dict)
                    else v.detach().requires_grad_(True))
                for k, v in params0.items()}
        named = {**{f"blocks.{n}": x for n, x in live["blocks"].items()},
                 **{k: v for k, v in live.items() if k != "blocks"}}
        reset_launch_counts()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        # bytes above what was allocated before the forward: `saved`, what
        # the forward leaves for the backward; `fwd_top` / `bwd_top`, each
        # half's peak; `grads`, what the backward leaves (the gradients)
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile(activities=acts) as pf, _mm_counter() as mf:
            loss = _chunked_loss(cfg)(live, tokens, targets, mask)
            torch.cuda.synchronize()
        mem = dict(saved=torch.cuda.memory_allocated() - m0,
                   fwd_top=torch.cuda.max_memory_allocated() - m0)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=acts) as pb, _mm_counter() as mb:
            grads = dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))
            torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        mem.update(bwd_top=torch.cuda.max_memory_allocated() - m0,
                   grads=torch.cuda.memory_allocated() - m0)
        busy_s = sum(_dev_us(e) for p in (pf, pb)
                     for e in _device_events(p)) / 1e6
        grad_counts = launch_counts()
        loss = float(loss.detach())
        del live, named
        if full is None:
            full, err = (loss, grads), (0.0, "")
        else:
            err = _worst_grad_err(torch, grads, full[1])
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(apply_fn=None, init_fn=None,
                          train_config=TrainConfig(warmup_steps=10,
                                                   total_steps=1000),
                          loss_fn=_chunked_loss(cfg), device=dev)
        state = trainer.init_from_params(
            {k: ({n: x.clone() for n, x in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params0.items()})
        reset_launch_counts()
        # the first step's peak, split at the optimizer update: the
        # gradient pass's, then the update's (above the resident state)
        update = trainer.optimizer.update

        def split_update(*args):
            mem["step_grad_top"] = torch.cuda.max_memory_allocated() - m0
            torch.cuda.reset_peak_memory_stats()
            update(*args)

        trainer.optimizer.update = split_update
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        mem["resident"] = m0
        torch.cuda.reset_peak_memory_stats()
        state, _ = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        mem["step_update_top"] = torch.cuda.max_memory_allocated() - m0
        del trainer.optimizer.update
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REMAT_STEPS):
            state, _ = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / REMAT_STEPS
        peak = torch.cuda.max_memory_allocated()
        got = launch_counts()
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        for k, n in got.items():
            if k.startswith("flash"):
                counts[k] = counts.get(k, 0) + n
        rows[policy] = dict(fwd_mm=(mf.n, *_gemm_kernels(pf)),
                            bwd_mm=(mb.n, *_gemm_kernels(pb)),
                            step_ms=step_ms, peak=peak, mem=mem,
                            loss=loss, err=err,
                            pass_s=pass_s, busy_s=busy_s,
                            grad_fwd=grad_counts["flash_attention_fwd"],
                            step_fwd=got["flash_attention_fwd"]
                            // (1 + REMAT_STEPS))
    base = rows["dots"]["bwd_mm"][0]
    L = llama.LLAMA3_1B.num_layers
    for policy, r in rows.items():
        log(f"  {policy}: loss {r['loss']:.6f}, gradients vs full worst "
            f"{r['err'][0]:.3e} {r['err'][1]} (tol {REMAT_GRAD_TOL}); "
            f"aten.mm forward {r['fwd_mm'][0]}, backward {r['bwd_mm'][0]} "
            f"({r['bwd_mm'][0] - base} more than dots' = "
            f"{(r['bwd_mm'][0] - base) / L:.1f} recomputed a layer); GEMM "
            f"kernels (profiler) forward {r['fwd_mm'][1]} "
            f"({r['fwd_mm'][2]:.2f} ms), backward {r['bwd_mm'][1]} "
            f"({r['bwd_mm'][2]:.2f} ms); the profiled pass {r['pass_s']:.3f}"
            f" s wall, device busy {r['busy_s']:.3f} s; step "
            f"{r['step_ms']:.1f} ms, peak memory {r['peak'] / 2**30:.2f} GiB;"
            f" flash forwards {r['grad_fwd']} in the gradient pass, "
            f"{r['step_fwd']} a trainer step")
        m = {k: v / 2**30 for k, v in r["mem"].items()}
        where = ("the gradient pass" if m["step_grad_top"]
                 >= m["step_update_top"] else "the optimizer update")
        log(f"  {policy} memory (GiB): the forward saved {m['saved']:.3f} "
            f"for the backward (forward peak {m['fwd_top']:.3f}, backward "
            f"peak {m['bwd_top']:.3f}, gradients {m['grads']:.3f}, above "
            f"the params); a trainer step above its resident "
            f"{m['resident']:.3f} (params, moments): gradient pass peak "
            f"{m['step_grad_top']:.3f}, update peak "
            f"{m['step_update_top']:.3f}: the step's peak falls in "
            f"{where}")
        if r["err"][0] > REMAT_GRAD_TOL or abs(r["loss"] - full[0]) > \
                REMAT_GRAD_TOL * abs(full[0]):
            fail(f"phase 15b: {policy} disagrees with full remat")
        if r["grad_fwd"] != 2 * L or r["step_fwd"] != 2 * L:
            fail(f"phase 15b: {policy} launched {r['grad_fwd']} / "
                 f"{r['step_fwd']} flash forwards a step, the design "
                 f"implies {2 * L} (the recompute reruns the kernel)")
    recomputed = {p: (r["bwd_mm"][0] - base) / L for p, r in rows.items()}
    if recomputed != {"full": 6.0, "mlp": 4.0, "dots": 0.0}:
        fail(f"phase 15b: products recomputed a layer {recomputed}, the "
             "policies imply full 6 (w_down's output is dead in the "
             "backward), mlp 4, dots 0")
    del full, params0
    gc.collect()
    torch.cuda.empty_cache()
    MEASURED["remat"] = rows
    return counts


async def _serve_trained_adapters(torch, cfg, base, adapters, lcfg):
    """15c's serving half: the trained adapters as a one-adapter pack on
    the base (rounded to its serving dtypes) through the continuous
    engine the CLI's app builds, greedy tokens and logprobs against the
    merged model (`_merged_teacher`). -> launch counts."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.engine import (
        LLAMA_FAMILY,
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.multilora import build_pack
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY,
        create_serving_app,
    )

    dev = torch.device("cuda")
    name = "llama3-1b"
    params = {k: ({n: w.detach().to(llama.leaf_dtype(cfg, n))
                   for n, w in v.items()} if k == "blocks"
                  else v.detach().to(llama.leaf_dtype(cfg, k)))
              for k, v in base.items()}
    pack = build_pack(cfg, lcfg, {"tuned": adapters}, device=dev)
    engine = InferenceEngine(params, cfg, LLAMA_FAMILY,
                             EngineConfig(max_len=MAX_LEN), device=dev,
                             adapter_pack=pack)
    app = create_serving_app({name: engine}, continuous=True, warmup=True,
                             max_batch=SLOTS, prefill_chunk_tokens=CHUNK,
                             seed=0)
    port = _free_port()
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    batcher = app[BATCHERS_KEY][name]
    gen = torch.Generator().manual_seed(151)
    rows = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(),
             a) for n, a in ((40, "tuned"), (130, ""), (300, "tuned"),
                             (17, "tuned"))]
    url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
    try:
        async with aiohttp.ClientSession() as sess:
            async def post(p, a):
                body = {"tokens": [p], "max_new": MAX_NEW, "logprobs": True,
                        **({"adapter": a} if a else {})}
                async with sess.post(url, json=body) as r:
                    if r.status != 200:
                        fail(f"phase 15c :generate {r.status}: "
                             f"{await r.text()}")
                    return await r.json()

            batcher.calls = batcher.slices = 0
            reset_launch_counts()
            served = await asyncio.gather(*(post(p, a) for p, a in rows))
            torch.cuda.synchronize()
            counts = launch_counts()
            calls, slices = batcher.calls, batcher.slices
    finally:
        await runner.cleanup()
    L = cfg.num_layers
    want = {"paged_decode_attention": L * calls,
            "paged_prefill_append": L * slices}
    log(f"  the trained adapters served as a pack (rows "
        f"{[(len(p), a or 'base') for p, a in rows]}): {calls} decode steps"
        f", {slices} slices; kernel launches {counts}")
    for k, n in want.items():
        if counts.get(k, 0) != n:
            fail(f"phase 15c serving {k}: {counts.get(k, 0)} launches, the "
                 f"design implies {n}")
    groups = {"": [], "tuned": []}
    for (p, a), b in zip(rows, served):
        groups[a].append((p, b["tokens"][0], b["logprobs"][0]))
    for a, items in groups.items():
        teacher = _merged_teacher(torch, engine, {"tuned": adapters}, lcfg,
                                  a)
        _teacher_check(torch, teacher, *map(list, zip(*items)),
                       f"trained {'adapter' if a else 'base'} rows "
                       f"(teacher: merged weights)")
        del teacher
    del engine, pack, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: n for k, n in counts.items() if k in want}


def adafactor_lora_and_check(torch):
    """Phase 15c: llama3-1b at full width and depth trained by Adafactor
    (loss falling, state bytes, a bit-equal resume through the
    checkpointer) and by LoRA over a frozen base (loss falling, the base
    bitwise unchanged, adapter-only state), the trained adapters then
    served. -> flash and paged launches."""
    import shutil

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import (
        LoraConfig,
        TrainConfig,
        Trainer,
        init_lora,
        lora_freeze_labels,
        lora_loss_fn,
        lora_train_tree,
    )
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        Checkpointer,
    )
    from kubeflow_tpu_torch.train.trainer import _leaves

    dev = torch.device("cuda")
    cfg = llama.LLAMA3_1B
    tokens, targets = _llama1b_batch(torch, dev, 1)
    counts = {}

    def add(got):
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n

    # Adafactor
    t0 = time.perf_counter()
    trainer = Trainer(apply_fn=None,
                      init_fn=lambda seed: llama.init(cfg, seed, dev,
                                                      train=True),
                      train_config=TrainConfig(
                          optimizer="adafactor", learning_rate=1e-2,
                          warmup_steps=1, total_steps=100,
                          weight_decay=0.0),
                      loss_fn=_chunked_loss(cfg), device=dev)
    reset_launch_counts()
    state = trainer.init(0)
    losses = []
    for _ in range(ADAFACTOR_STEPS):
        state, loss = trainer.step(state, tokens, targets)
        losses.append(float(loss))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ckpt = Checkpointer(CheckpointConfig(CKPT_DIR, enable_async=False),
                        trainer, registry=Registry())
    ckpt.save(state, force=True)
    restored = ckpt.restore()
    same_state = all(
        torch.equal(a, b) for slot in trainer.optimizer.slots
        for a, b in zip(state.opt_state[slot], restored.opt_state[slot],
                        strict=True)) and all(
        torch.equal(a, b) for a, b in zip(_leaves(state.params),
                                          _leaves(restored.params)))
    state, l1 = trainer.step(state, tokens, targets)
    restored, l2 = trainer.step(restored, tokens, targets)
    resumed = float(l1) == float(l2) and all(
        torch.equal(a, b) for a, b in zip(_leaves(state.params),
                                          _leaves(restored.params)))
    add(launch_counts())
    ada_bytes = trainer.opt_state_bytes()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del state, restored, trainer, ckpt
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  adafactor: losses {[round(x, 4) for x in losses]}; optimizer "
        f"state {ada_bytes / 2**20:.1f} MiB against AdamW's "
        f"{ADAMW_STATE_BYTES_1B / 1e9:.1f} GB ({ADAMW_STATE_BYTES_1B / ada_bytes:.0f}x); "
        f"checkpoint restore bit-equal {same_state}; the next step after "
        f"the restore equals the uninterrupted one {resumed} (loss "
        f"{float(l1):.6f}); {time.perf_counter() - t0:.1f} s")
    if not losses[-1] < losses[0]:
        fail(f"phase 15c: Adafactor's loss did not fall: {losses}")
    if not (same_state and resumed):
        fail("phase 15c: Adafactor's checkpoint did not resume bit-equal")

    # LoRA over a frozen base
    t0 = time.perf_counter()
    lcfg = LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA)
    tree = lora_train_tree(llama.init(cfg, 0, dev, train=True),
                           init_lora(cfg, lcfg, 1, dev))
    base_copy = [t.clone() for t in _leaves(tree["base"])]
    trainer = Trainer(apply_fn=None, init_fn=None,
                      train_config=TrainConfig(learning_rate=3e-3,
                                               warmup_steps=1,
                                               total_steps=100),
                      loss_fn=lora_loss_fn(_chunked_loss(cfg), lcfg),
                      device=dev, freeze_labels=lora_freeze_labels(tree))
    reset_launch_counts()
    state = trainer.init_from_params(tree)
    del tree
    losses = []
    for _ in range(LORA_STEPS):
        state, loss = trainer.step(state, tokens, targets)
        losses.append(float(loss))
    torch.cuda.synchronize()
    add(launch_counts())
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(_leaves(state.params["base"]), base_copy))
    n_adapter = sum(t.numel() for t in _leaves(state.params["lora"]))
    lora_bytes = trainer.opt_state_bytes()
    slots_ok = all(len(state.opt_state[s]) ==
                   len(_leaves(state.params["lora"])) for s in ("mu", "nu"))
    log(f"  lora (rank {LORA_RANK}, alpha {LORA_ALPHA}, seven targets, "
        f"{n_adapter} adapter params): losses "
        f"{[round(x, 4) for x in losses]}; base bitwise unchanged "
        f"{unchanged}; optimizer state {lora_bytes / 2**20:.1f} MiB "
        f"(adapters' moments only: {slots_ok}); "
        f"{time.perf_counter() - t0:.1f} s")
    del base_copy
    if not losses[-1] < losses[0]:
        fail(f"phase 15c: LoRA's loss did not fall: {losses}")
    if not unchanged or not slots_ok or lora_bytes != 8 * n_adapter:
        fail("phase 15c: LoRA moved the base or kept state beyond the "
             "adapters")
    adapters = {"blocks": {n: {k: v.detach() for k, v in ab.items()}
                           for n, ab in state.params["lora"]["blocks"]
                           .items()}}
    base = state.params["base"]
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    add(asyncio.run(_serve_trained_adapters(torch, cfg, base, adapters,
                                            lcfg)))
    MEASURED["adafactor_bytes"] = ada_bytes
    return counts


# -- phase 16: the data story, ViT-B/16, MNIST and a local HPO sweep ---------

DATA_DIR = os.path.join(ROOT, "build", "phase16")
DATA_VOCAB = 1024                  # the BPE fitted on CORPUS_FILES
DATA_SHARD_TOKENS = 65536
DATA_STEPS = 8                     # counted, from the native loader
DATA_PY_STEPS = 4                  # then from PyTokenLoader at its ticket
LOADER_BATCHES = 16                # compared native against Python
RESUME_AT = 8
# ViT-B/16 on the card against the CPU at fp32, batch 4, after one step
# so the head is not zero: loss relative error, and each gradient leaf's
# relative L2 error (fp32 cuBLAS with TF32 off against the CPU's fp32
# GEMMs: other summation orders over up to 3072 terms, ~1e-6 relative;
# the limits sit well above that and far below any wrong term). The key
# bias's exact gradient is 0 (softmax over keys is blind to it): both
# sides give rounding noise, held under VIT_BK_TOL of the query bias's.
VIT_CHECK_B = 4
VIT_LOSS_TOL = 1e-4
VIT_GRAD_TOL = 1e-3
VIT_BK_TOL = 1e-3
VIT_B, VIT_WARM, VIT_STEPS = 64, 2, 10     # bench.py's vit-b16 cell
MNIST_ACC_GATE = 0.90              # bench.py's gate on the smoke
MNIST_BENCH_STEPS, MNIST_BENCH_B = 200, 256
HPO_TRIALS, HPO_SMOKE_STEPS = 8, 30


# Phase 16a's corpus: markdown of the repository that its work does not
# rewrite (the project's documents and the survey of the system it was
# modelled on), so every run tokenizes, shards and trains on the same
# text. 12 files, 244,554 bytes; the log prints their sha256.
CORPUS_FILES = ("BASELINE.md", "PAPER.md", "PAPERS.md", "SNIPPETS.md",
                "SURVEY.md", "docs/architecture.md", "docs/compute-guide.md",
                "docs/migration.md", "docs/observability.md",
                "docs/operator-guide.md", "docs/perf-notes.md",
                "docs/user-guide.md")


def _corpus_paths():
    return [os.path.join(ROOT, f) for f in CORPUS_FILES]


def data_story_and_check(torch):
    """Phase 16a: prepare_data on CORPUS_FILES (BPE at vocab 1024,
    KTSH shards, the last held out), the native word encoder against the
    Python loop over every word of the corpus, the native loader against
    PyTokenLoader and a resume ticket, llama3-1b at phase 4's
    configuration trained from the shards (8 steps native, then 4 from
    PyTokenLoader at its ticket), and eval_ppl's function on the held-out
    shard at seq 2048 for the trained and the initial weights.
    -> flash launches."""
    import shutil

    import numpy as np

    from kubeflow_tpu_torch.data import bpe
    from kubeflow_tpu_torch.data import loader as dl
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.ops import attention
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.tools import eval_ppl, prepare_data
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    if not dl.native_available():
        fail(f"phase 16a: the native loader did not build: "
             f"{dl.native_error()}")
    if bpe._load_bpe_lib() is None:
        fail(f"phase 16a: the native BPE encoder did not build: "
             f"{bpe.native_error()}")
    import hashlib

    paths = _corpus_paths()
    digest = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            digest.update(f.read())
    n_bytes = sum(os.path.getsize(p) for p in paths)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    summary = prepare_data.prepare(paths, DATA_DIR, vocab_size=DATA_VOCAB,
                                   shard_tokens=DATA_SHARD_TOKENS)
    prep_s = time.perf_counter() - t0
    shards = summary["shard_paths"]
    sizes = [(os.path.getsize(p) - 16) // 4 for p in shards]
    log(f"  prepare_data: {len(paths)} files, {n_bytes} bytes (sha256 "
        f"{digest.hexdigest()[:16]}) -> "
        f"{summary['tokens']} tokens at vocab {summary['vocab_size']}, "
        f"shards of {sizes} tokens, {prep_s:.1f} s (tokenizer training "
        f"and encoding, host)")
    # the last shard held out, with the one before it when the last
    # holds fewer than two evaluation batches of windows
    n_val = 1 if (sizes[-1] - 1) // FLASH_S >= 2 * FLASH_B else 2
    val, train = shards[-n_val:], shards[:-n_val]
    if not train:
        fail(f"phase 16a: {len(shards)} shards leave none to train on")

    # the two word encoders over every word of the corpus, no cache:
    # equal ids, and those of the shards, which encode() wrote
    tok = bpe.Tokenizer.load(summary["tokenizer"])
    if not tok.warm_native():
        fail(f"phase 16a: encode does not take the native encoder: "
             f"{bpe.native_error()}")
    words = []
    for p in paths:
        with open(p, encoding="utf-8", errors="replace") as f:
            words.append([bpe._to_word_bytes(w)
                          for w in bpe._split_words(f.read())])
    encoders = {"Python": lambda w: bpe._encode_word_py(tok._ranks, w),
                "native": tok._ranks_id.native.encode}
    ids, rate = {}, {}
    for name, encode_word in encoders.items():
        t0 = time.perf_counter()
        out = []
        for ws in words:
            for w in ws:
                out.extend(encode_word(w))
            out.append(tok.eos_id)
        rate[name] = len(out) / (time.perf_counter() - t0)
        ids[name] = out
    stored = np.concatenate([np.fromfile(p, np.int32, offset=16)
                             for p in shards])
    same_ids = ids["native"] == ids["Python"]
    log(f"  encode, word by word without the cache (host): Python "
        f"{rate['Python']:.0f} tokens/s, native {rate['native']:.0f} "
        f"tokens/s ({rate['native'] / rate['Python']:.2f}x); ids equal "
        f"{same_ids} ({len(ids['native'])} tokens); the shards hold them "
        f"{np.array_equal(stored, ids['native'])}")
    if not same_ids or not np.array_equal(stored, ids["native"]):
        fail("phase 16a: the native encoder's ids differ from the Python "
             "encoder's or from the shards'")

    # the loaders: the same stream, and a resume ticket continues it
    kw = dict(batch=FLASH_B, seq=FLASH_S, seed=0)

    def timed_batches(loader):
        out, secs = [], []
        for i in range(LOADER_BATCHES):
            if i == RESUME_AT:
                saved = loader.state_dict()   # what a checkpoint keeps
            t0 = time.perf_counter()
            out.append(loader.next_batch())
            secs.append(time.perf_counter() - t0)
        return out, secs, saved

    with dl.open_loader(train, **kw) as nat:
        if type(nat) is not dl.TokenShardLoader:
            fail(f"phase 16a: open_loader gave {type(nat).__name__}")
        stream, nat_s, saved = timed_batches(nat)
        py_stream, py_s, _ = timed_batches(dl.PyTokenLoader(train, **kw))
        same = all(np.array_equal(a, b) for a, b in zip(stream, py_stream))
        windows = nat.n_windows
    with dl.TokenShardLoader(train, start_ticket=saved["ticket"],
                             **kw) as nat:
        resumed = all(np.array_equal(nat.next_batch(), b)
                      for b in stream[RESUME_AT:])
    log(f"  loaders over {len(train)} training shards ({windows} windows "
        f"of {FLASH_S + 1}): the first {LOADER_BATCHES} batches native == "
        f"Python {same}; reopened at the saved ticket {saved['ticket']}, "
        f"the stream continues {resumed}; next_batch (host) native first "
        f"{nat_s[0] * 1e3:.3f} ms, then median "
        f"{np.median(nat_s[1:]) * 1e3:.4f} ms; Python first "
        f"{py_s[0] * 1e3:.3f} ms, then median "
        f"{np.median(py_s[1:]) * 1e3:.4f} ms")
    if not (same and resumed):
        fail("phase 16a: the native loader's stream differs from "
             "PyTokenLoader's, or its resume ticket does not continue it")

    # llama3-1b at phase 4's configuration, from the shards
    cfg = llama.LLAMA3_1B
    trainer = Trainer(apply_fn=lambda p, t: llama.apply(p, cfg, t),
                      init_fn=lambda seed: llama.init(cfg, seed, dev,
                                                      train=True),
                      train_config=TrainConfig(warmup_steps=10,
                                               total_steps=1000),
                      loss_fn=_chunked_loss(cfg), device=dev,
                      registry=Registry())
    state = trainer.init(0)
    nat = dl.open_loader(train, **kw)
    py = dl.PyTokenLoader(train, start_ticket=DATA_STEPS, **kw)
    reset_launch_counts()
    attention.reset_impl_counts()
    losses = []
    steps = DATA_STEPS + DATA_PY_STEPS
    pin_s = []
    for i in range(steps):
        t_pin = time.perf_counter()
        batch = (nat if i < DATA_STEPS else py).next_batch_on(dev)
        pin_s.append(time.perf_counter() - t_pin)
        state, loss = trainer.step(state, batch[:, :-1], batch[:, 1:])
        losses.append(loss)
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        elif i == DATA_STEPS - 1:
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / (DATA_STEPS - 1)
    torch.cuda.synchronize()
    nat.close()
    counts, impl = launch_counts(), attention.impl_counts()
    # the batches the steps took, read again on the host (the native
    # stream equals PyTokenLoader's, checked above), so that no copy
    # back from the card synchronizes the steps
    with dl.PyTokenLoader(train, **kw) as again:
        seen = {again.next_batch().tobytes() for _ in range(steps)}
    # next_batch_on alone, the card idle: the input pipeline's own host
    # cost, apart from any wait on a launch queue the steps filled
    idle_s = []
    with dl.open_loader(train, **kw) as ld:
        for _ in range(LOADER_BATCHES):
            t_pin = time.perf_counter()
            ld.next_batch_on(dev)
            idle_s.append(time.perf_counter() - t_pin)
            torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    # host_gap sample k is the gap before step k + 2; the gaps before
    # steps 2 and DATA_STEPS + 1 hold the timing's synchronize
    gaps = trainer.profiler.samples("host_gap")
    gap_native, gap_py = gaps[1:DATA_STEPS - 1], gaps[DATA_STEPS:]
    log(f"  train from the shards: losses "
        f"{[round(x, 4) for x in losses]} (steps 1-{DATA_STEPS} native, "
        f"then {DATA_PY_STEPS} from PyTokenLoader at ticket {DATA_STEPS}); "
        f"{len(seen)} distinct batches")
    log(f"  step (host clock, native steps 2-{DATA_STEPS}, to a "
        f"synchronize): {step_s * 1e3:.1f} ms, {FLASH_B * FLASH_S / step_s:.0f} "
        f"tokens/s; host_gap (the gaps no synchronize falls in) native "
        f"median {np.median(gap_native) * 1e3:.3f} ms, max "
        f"{max(gap_native) * 1e3:.3f} over {len(gap_native)}; PyTokenLoader "
        f"median {np.median(gap_py) * 1e3:.3f} ms, max "
        f"{max(gap_py) * 1e3:.3f} over {len(gap_py)}; of which "
        f"next_batch_on (the loader's batch, pinned, its copy queued): "
        f"median {np.median(pin_s) * 1e3:.3f} ms; next_batch_on alone "
        f"with the card idle: first {idle_s[0] * 1e3:.3f} ms, then median "
        f"{np.median(idle_s[1:]) * 1e3:.3f} ms")
    log(f"  attention impl counts {impl}; kernel launches {counts} over "
        f"{steps} steps")
    per_step = {"flash_attention_fwd": 2 * cfg.num_layers,
                "flash_attention_dq": cfg.num_layers,
                "flash_attention_dkv": cfg.num_layers}
    for name, n in per_step.items():
        if counts[name] != n * steps:
            fail(f"phase 16a: {name}: {counts[name]} launches in {steps} "
                 f"steps, the design implies {n * steps}")
    if impl["torch"] != 0:
        fail(f"phase 16a: attention left the flash kernels: {impl}")
    if len(seen) != steps:
        fail("phase 16a: a batch repeated within the first epoch")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 16a: the loss did not fall: {losses}")
    counts = {k: counts[k] for k in per_step}

    # eval_ppl's function on the held-out shards at seq 2048
    apply = eval_ppl.model_apply("llama", cfg)
    ppl = {}
    for label in ("trained", "initial"):
        if label == "initial":
            del state, trainer
            gc.collect()
            torch.cuda.empty_cache()
            params = llama.init(cfg, 0, dev, train=True)
        else:
            params = state.params
        reset_launch_counts()
        t0 = time.perf_counter()
        out = eval_ppl.evaluate(apply, params, val, batch=FLASH_B,
                                seq=FLASH_S, device=dev)
        eval_s = time.perf_counter() - t0
        got = launch_counts()
        ppl[label] = out["ppl"]
        counts = {k: counts[k] + got[k] for k in per_step}
        log(f"  eval_ppl, {label} weights: loss {out['loss']:.4f}, ppl "
            f"{out['ppl']:.2f} over {out['tokens']} tokens "
            f"({out['batches']} batches of {FLASH_B} x {FLASH_S}, "
            f"{out['loader']}), {eval_s:.2f} s; launches {got}")
        if out["loader"] != "TokenShardLoader":
            fail(f"phase 16a: eval ran {out['loader']}")
        if (got["flash_attention_fwd"] != cfg.num_layers * out["batches"]
                or got["flash_attention_dq"] or got["flash_attention_dkv"]):
            fail(f"phase 16a: eval launches {got}, the design implies "
                 f"{cfg.num_layers} forwards a batch and no backward")
        del params
    if not ppl["trained"] < ppl["initial"]:
        fail(f"phase 16a: trained perplexity {ppl['trained']} is not "
             f"below the initial {ppl['initial']}")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    return counts


def _vit_loss(torch, vit, cfg, params, x, y):
    logits = vit.apply(params, cfg, x)
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (logz - gold).mean()


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _vit_grads(torch, vit, cfg, params, x, y):
    leaves = dict(_named(params))
    for t in leaves.values():
        t.requires_grad_(True)
    loss = _vit_loss(torch, vit, cfg, params, x, y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, grads))


def _synthetic_images(np, n, size, seed=0):
    """Class 0: bright top half; class 1: bright bottom half."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.int32)
    x = rng.normal(scale=0.1, size=(n, size, size, 3)).astype(np.float32)
    x[y == 0, :size // 2] += 1.0
    x[y == 1, size // 2:] += 1.0
    return x, y


def vit_and_check(torch):
    """Phase 16b: ViT-B/16 at full width and depth. The card against the
    CPU at fp32 after one step (loss and every gradient leaf), then the
    bf16 fine-tune through the port's Trainer at batch 64 (bench.py's
    cell): images/s, StepTimer, MFU, peak memory, time to the first
    step, the loss falling on a fixed synthetic batch, and no kernel
    launched (197 tokens at head dim 64 take the plain attention)."""
    import dataclasses

    import numpy as np

    from kubeflow_tpu_torch.models import vit
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.ops import attention
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import TrainConfig, Trainer
    from kubeflow_tpu_torch.utils.profiling import (
        POD_START_ENV,
        StepTimer,
        time_to_first_compile,
    )

    dev = torch.device("cuda")
    base = vit.VIT_B16
    reset_launch_counts()
    attention.reset_impl_counts()

    # the card against the CPU, fp32, after one plain SGD step
    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 16b: TF32 matmuls are on; the fp32 check needs them off")
    cfg32 = dataclasses.replace(base, dtype=torch.float32)
    t0 = time.perf_counter()
    x, y = _synthetic_images(np, VIT_CHECK_B, base.image_size, seed=1)
    y = (y * 7 + 3).astype(np.int32)        # two of the 1000 classes
    xc, yc = torch.from_numpy(x), torch.from_numpy(y)
    params = {k: ({n: t.cpu() for n, t in v.items()}
                  if isinstance(v, dict) else v.cpu())
              for k, v in vit.init(cfg32, 0, dev).items()}
    _, g0 = _vit_grads(torch, vit, cfg32, params, xc, yc)
    with torch.no_grad():
        for name, t in _named(params):
            t.sub_(0.05 * g0[name])
    del g0
    if not float(params["head_w"].abs().max()) > 0:
        fail("phase 16b: the head is still zero after one step")
    want_loss, want = _vit_grads(torch, vit, cfg32, params, xc, yc)
    cpu_s = time.perf_counter() - t0
    params_c = {k: ({n: t.to(dev) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(dev))
                for k, v in params.items()}
    got_loss, got = _vit_grads(torch, vit, cfg32, params_c, xc.to(dev),
                               yc.to(dev))
    loss_err = abs(got_loss - want_loss) / abs(want_loss)
    errs = {}
    for name, w in want.items():
        if name == "blocks.bk":
            continue
        errs[name] = float((got[name].cpu() - w).norm() / w.norm())
    worst = max(errs, key=errs.get)
    bk = max(float(got["blocks.bk"].abs().max()),
             float(want["blocks.bk"].abs().max()))
    bq = float(want["blocks.bq"].abs().max())
    log(f"  card vs CPU at fp32 (batch {VIT_CHECK_B}, after one step; the "
        f"CPU side {cpu_s:.1f} s): loss {got_loss:.6f} vs {want_loss:.6f} "
        f"(relative {loss_err:.2e}, tol {VIT_LOSS_TOL}); worst gradient "
        f"leaf {worst} {errs[worst]:.2e} (tol {VIT_GRAD_TOL}); key bias "
        f"|grad| {bk:.2e} against the query bias's {bq:.2e}")
    if loss_err > VIT_LOSS_TOL or errs[worst] > VIT_GRAD_TOL \
            or bk > VIT_BK_TOL * bq:
        fail("phase 16b: ViT-B/16 on the card disagrees with the CPU")
    del params, params_c, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # the bf16 fine-tune, bench.py's cell
    cfg = base
    trainer = Trainer(apply_fn=vit.apply_fn(cfg),
                      init_fn=lambda seed: vit.init(cfg, seed, dev),
                      train_config=TrainConfig(warmup_steps=10,
                                               total_steps=1000),
                      device=dev, registry=Registry())
    x, y = _synthetic_images(np, VIT_B, cfg.image_size)
    imgs = torch.from_numpy(x).to(dev)
    tgt = torch.from_numpy(y[:, None]).to(dev)
    mask = torch.ones((VIT_B, 1), device=dev)  # the default takes [b, H, W, C]
    # the "pod" starts here: time_to_first_compile is then the init and
    # the first step, synchronized
    os.environ[POD_START_ENV] = str(time.time())
    state = trainer.init(0)
    ttfc, (state, loss) = time_to_first_compile(trainer.step, state, imgs,
                                                tgt, mask)
    del os.environ[POD_START_ENV]
    losses = [float(loss)]
    for _ in range(VIT_WARM - 1):
        state, loss = trainer.step(state, imgs, tgt, mask)
        losses.append(float(loss))
    timer = StepTimer()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(VIT_STEPS):
        with timer.step():
            state, loss = trainer.step(state, imgs, tgt, mask)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    summ = timer.summary()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = trainer.step(state, imgs, tgt, mask)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    losses.append(float(loss))
    img_s = VIT_B * VIT_STEPS / sum(timer.durations)
    # bench.py's accounting: 6 N a token, plus attention, x seq tokens
    n_params = vit.num_params(cfg)
    seq = cfg.seq_len
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq
    mfu = img_s * (6 * n_params + attn) * seq / BF16_FLOPS_S
    counts, impl = launch_counts(), attention.impl_counts()
    log(f"  ViT-B/16 fine-tune, bf16, batch {VIT_B}, {n_params} params: "
        f"{img_s:.1f} images/s over {VIT_STEPS} steps after {VIT_WARM}; "
        f"StepTimer " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" if k.endswith("_s") else f"{k} {v}"
            for k, v in summ.items()))
    log(f"  MFU {mfu:.1%} of 989 TFLOP/s (bench.py's (6 N + attention) x "
        f"seq a image); peak memory {peak / 2**30:.2f} GiB; "
        f"time_to_first_compile {ttfc:.2f} s (the trainer's init and its "
        f"first step, synchronized)")
    log(f"  losses on the fixed synthetic batch "
        f"{[round(v, 4) for v in losses]}; attention impl counts {impl}; "
        f"kernel launches {counts}")
    _report_profile(prof, prof_s, top=12)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 16b: the loss did not fall: {losses}")
    if any(counts.values()) or impl["flash"] or impl["decode"]:
        fail(f"phase 16b: a kernel launched ({counts}, {impl}); ViT's "
             "attention takes the plain path")
    return {}


def mnist_hpo_and_check(torch):
    """Phase 16c: the MNIST MLP smoke on the card against bench.py's
    accuracy gate, its images/s at bench_mnist's 200 steps x 256, and a
    TPE sweep of the learning rate over shortened smokes."""
    from kubeflow_tpu_torch import hpo
    from kubeflow_tpu_torch.models import mnist
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    reset_launch_counts()
    t0 = time.perf_counter()
    smoke = mnist.train_smoke(device=dev)
    log(f"  train_smoke (100 steps, batch 128, lr 0.1): "
        + ", ".join(f"{k} {v:.4f}" for k, v in smoke.items())
        + f"; {time.perf_counter() - t0:.2f} s")
    if not smoke["test_accuracy"] >= MNIST_ACC_GATE:
        fail(f"phase 16c: test accuracy {smoke['test_accuracy']} below "
             f"{MNIST_ACC_GATE}")

    x_tr, y_tr, x_te, y_te = mnist.load_dataset()
    params = mnist.init(0, device=dev)
    stream = mnist.batch_stream(x_tr, y_tr, MNIST_BENCH_B, dev)
    mnist.sgd_step(params, *next(stream), 0.1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MNIST_BENCH_STEPS):
        loss = mnist.sgd_step(params, *next(stream), 0.1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _, acc = mnist.loss_and_accuracy(params, torch.from_numpy(x_te).to(dev),
                                     torch.from_numpy(y_te).to(dev))
    log(f"  bench_mnist's loop: {MNIST_BENCH_STEPS * MNIST_BENCH_B / dt:.0f}"
        f" images/s ({MNIST_BENCH_STEPS} steps x {MNIST_BENCH_B}, host clock "
        f"to a synchronize, batches from the host each step); loss "
        f"{float(loss):.4f}, test accuracy {float(acc):.4f}")

    t0 = time.perf_counter()
    sweep = hpo.run_sweep(
        lambda a: mnist.train_smoke(steps=HPO_SMOKE_STEPS, lr=a["lr"],
                                    device=dev)["test_loss"],
        hpo.SearchSpace((hpo.Double("lr", 1e-3, 1.0, log=True),)),
        n_trials=HPO_TRIALS, goal="minimize", algorithm="tpe", seed=0)
    wall = time.perf_counter() - t0
    done = [t for t in sweep.trials if t.value is not None]
    log(f"  TPE sweep of lr over {HPO_TRIALS} smokes of {HPO_SMOKE_STEPS} "
        f"steps: best lr {sweep.best_assignment['lr']:.4g}, test loss "
        f"{sweep.best_value:.4f}; {len(done)} completed; {wall:.2f} s; "
        f"trials " + ", ".join(f"{t.assignment['lr']:.3g}:{t.value:.3f}"
                               for t in done))
    if len(done) != HPO_TRIALS:
        fail(f"phase 16c: {HPO_TRIALS - len(done)} sweep trials failed: "
             + "; ".join(t.error for t in sweep.trials if t.error))
    if any(launch_counts().values()):
        fail(f"phase 16c: a kernel launched: {launch_counts()}")
    return {}


# -- phase 17 ---------------------------------------------------------------

# The distributed set on one card. Worker processes (`--dist-worker`)
# all use cuda:0 in a gloo group over a file:// store: NCCL refuses two
# ranks of one device, so parallel/comm.py stages their collectives
# through host memory (the cost of gloo on one card, logged apart, not a
# number for the port's collectives). One rank also forms an NCCL group.
DIST_DIR = os.path.join(ROOT, "build", "phase17")
DIST_TIMEOUT = 600
RING_RANKS = 4
RING_S = 8192                 # 17a/17b: the global sequence, 2048 a rank
# 17a: bf16 o within phase 2's flash bound with c = 2^-8 (the blocks'
# bf16 outputs are merged in fp32 and rounded again): |err| <= 2^-8
# max|ref| + 2^-7 |ref|; gradients by relative L2 within TRAIN_GRAD_TOL
RING_C = 2**-8
FSDP_STEPS = 3
# 17c/18c/the NCCL rank: llama3-1b at full width, depth cut from 16 to 2
# for the phases' time: at 16 layers, 93.5 s of 3 steps' 106.6 s went to
# the host-staged gloo collectives (119.85 GiB through the host; H100
# 80GB HBM3, 700 W, the phase's first card run), a cost of one card, not
# of FSDP; 4 layers until phase 18 joined the smoke
FSDP_LAYERS = 2
PP_MICRO = 4                  # 17d: microbatches of one row
TP_GEMMA_STEPS = 3            # 17f: gemma-2b's widths at tensor 2
LLAMA_1B_VOCAB = 128256       # models/llama.py LLAMA3_1B.vocab_size
EP_TOKENS = 1024              # 17e: tokens a rank (b 1 x s 1024)
# 17e: EP against moe_mlp on each rank's block, bf16: relative L2 of the
# output and of every gradient (the expert products run over other slot
# counts, the a2a-returned rows in another order)
EP_OUT_TOL = 1e-2
EP_GRAD_TOL = TRAIN_GRAD_TOL
# 17g: the mesh trainer's recipes at tensor 2: (a) llama3-1b at 17c's
# depth under Adafactor against one device, losses within 1e-4 relative
# (17f's llama3-1b runs came within 9.64e-05), then AdamW at grad_accum
# 2 (micro-batches of one row) within 1e-4 of 17f's full-batch run on
# the same mesh, as the reference holds grad_accum N to its acc-1 step
# (against one device it keeps 17f's TRAIN_LOSS_TOL: AdamW's first
# update turns rounding-level gradient differences into up to a
# learning rate: 1.14e-04 at step 3 on an H100 80GB HBM3 at 700 W);
# (b) Mixtral-8x7B's widths at the depth the card holds for both ranks
# (as 15a cuts it), 15a's batch, seed and config, on the one-device
# run's routes (bf16 rounding of the router's input routes a near-tie
# elsewhere on one side, and a dropped choice moves every later slot of
# its expert: unforced, 1.42e-03 at step 3 on the same card; at the
# initial weights 276 of the ranks' 32768 token routings chose other
# experts, at top-3 gaps up to 2.9e-3, so a share above MOE_EXCUSE_MAX
# fails; after an update the weights differ by the step's rounding),
# within the training checks' TRAIN_LOSS_TOL; (c) ViT-B/16 at batch
# VIT_TP_B
RECIPE_STEPS, RECIPE_ACC = 3, 2
RECIPE_LOSS_TOL = 1e-4
VIT_TP_B = 16
# 17g-b's one-device depth and routes, written by the parent for the ranks
MOE_YARDSTICK = os.path.join(DIST_DIR, "moe_yardstick.pt")


def _rel_l2(torch, got, want) -> float:
    d = (got.float() - want.float())
    return float(torch.linalg.vector_norm(d)
                 / torch.linalg.vector_norm(want.float()))


def _ring_qkv(torch, dev, s=RING_S, seed=17):
    """llama3-1b's attention at the ring's global sequence, bf16, from a
    seed: q, k, v and the output gradient, alike on every rank."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(n):
        return torch.randn(1, s, n, HD, generator=g, device=dev).to(
            torch.bfloat16)

    return draw(N_Q), draw(N_KV), draw(N_KV), draw(N_Q)


def _dist_seq(torch, rank, world):
    """17a and 17b on every rank of a 4-rank ring: ring flash attention
    (causal and bidirectional, forward and backward), the plain ring on
    the same blocks, and Ulysses with impl "flash"."""
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import MeshSpec, comm, create_mesh, ring

    dev = torch.device("cuda")
    mesh = create_mesh(MeshSpec(data=1, fsdp=world), device_type="cuda")
    g = mesh.axis_group("fsdp")
    q, k, v, do = _ring_qkv(torch, dev)

    def blk(t):
        return t.chunk(world, 1)[g.index].contiguous()

    out = {"backend": g.backend, "index": g.index}
    for impl in ("ring", "ulysses"):
        for causal in (True, False):
            qb, kb, vb = (blk(t).requires_grad_() for t in (q, k, v))
            comm.reset_staged()
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if impl == "ring":
                o = ring.ring_flash_attention(qb, kb, vb, group=g,
                                              causal=causal)
            else:
                o = ring.ulysses_attention(qb, kb, vb, group=g,
                                           causal=causal, impl="flash")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(o, (qb, kb, vb), blk(do))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = {"o": o.detach().cpu(), "counts": launch_counts(),
                   "fwd_s": t1 - t0, "bwd_s": t2 - t1,
                   "staged": dict(comm.staged)}
            res.update(zip(("dq", "dk", "dv"), (t.cpu() for t in grads)))
            if impl == "ring":
                with torch.no_grad():
                    res["plain"] = ring.ring_attention(
                        blk(q), blk(k), blk(v), group=g,
                        causal=causal).cpu()
            out[(impl, causal)] = res
    return out


def _fsdp_cfg(torch):
    from kubeflow_tpu_torch.models import llama

    return dataclasses.replace(llama.LLAMA3_1B, num_layers=FSDP_LAYERS)


def _dist_tc():
    from kubeflow_tpu_torch.train import TrainConfig

    return TrainConfig(warmup_steps=1, total_steps=100)


def _fsdp_residue(torch, trainer, state, cfg, toks) -> dict:
    """17c's forward residue on a rank: the device bytes a forward on the
    rank's rows leaves for its backward, through the trainer's mesh view
    and through the plain model on the full params (gathered), and the
    bytes of the leaves the view gathers once and of one gathered layer.
    The view's extra should be the once-gathered leaves: a layer's
    gathered weights live only while its checkpointed block runs."""
    import math

    from kubeflow_tpu_torch.models import llama

    lay = trainer.layout
    rows = lay.local_rows(toks)
    full = {k: ({n: t.requires_grad_() for n, t in v.items()}
                if isinstance(v, dict) else v.requires_grad_())
            for k, v in trainer.gather_params(state).items()}

    def held(params_fn):
        torch.cuda.synchronize()
        m = torch.cuda.memory_allocated()
        logits = llama.apply(params_fn(), cfg, rows)
        torch.cuda.synchronize()
        n = torch.cuda.memory_allocated() - m
        del logits
        return n

    plain = held(lambda: full)
    view = held(lambda: lay.model_view(state.params))
    del full
    once = sum(math.prod(leaf.shape) * 4 for leaf in lay.leaves.values()
               if leaf.gathers and not leaf.per_layer)
    layer = sum(math.prod(leaf.shape[1:]) * 4
                for leaf in lay.leaves.values() if leaf.per_layer)
    return {"plain": plain, "view": view, "once": once, "layer": layer}


def _dist_train(torch, rank, world):
    """17c to 17g on each of 2 ranks: llama3-1b under FSDP on (data 1,
    fsdp 2), the tensor-parallel runs and recipes (`_dist_tensor`,
    `_dist_recipes`), llama3-1b pipelined over 2 stages, and one MoE
    layer at Mixtral-8x7B's widths with 4 experts a rank."""
    import numpy as np

    from kubeflow_tpu_torch.models import llama, llama_moe, llama_pp
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import (
        Mesh,
        MeshSpec,
        comm,
        create_mesh,
        moe,
    )
    from kubeflow_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    out = {}
    cfg = _fsdp_cfg(torch)
    mesh = create_mesh(MeshSpec(data=1, fsdp=world), device_type="cuda")
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(lambda p, t: llama.apply(p, cfg, t),
                      lambda s: llama.init(cfg, s, dev, train=True),
                      _dist_tc(), device=dev, mesh=mesh,
                      logical_axes=llama.param_logical_axes(cfg))
    state = trainer.init(0)
    toks, tgts = _llama1b_batch(torch, dev, 17)
    comm.reset_staged()
    reset_launch_counts()
    losses, step_s = [], []
    for _ in range(FSDP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    out["fsdp"] = {"losses": losses, "step_s": step_s,
                   "staged": dict(comm.staged), "counts": launch_counts(),
                   "opt_bytes": trainer.opt_state_bytes(),
                   "wq": tuple(state.params["blocks"]["wq"].shape),
                   "peak": torch.cuda.max_memory_allocated() - m0,
                   "residue": _fsdp_residue(torch, trainer, state, cfg,
                                            toks)}
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    out.update(_dist_tensor(torch, world))
    out.update(_dist_recipes(torch, world))

    cfg = llama.LLAMA3_1B
    pmesh = Mesh(np.arange(world).reshape(world, 1), ("stage", "data"),
                 "cuda")
    pt = llama_pp.PipelineTrainer(cfg, pmesh, num_microbatches=PP_MICRO,
                                  train_config=_dist_tc(), device=dev)
    state = pt.init(0)
    ptoks, ptgts = _pp_batch(torch, dev)
    comm.reset_staged()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = pt.step(state, ptoks, ptgts)
    torch.cuda.synchronize()
    out["pp"] = {"loss": float(loss), "step_s": time.perf_counter() - t0,
                 "staged": dict(comm.staged), "counts": launch_counts(),
                 "wq": tuple(state.params["blocks"]["wq"].shape)}
    del pt, state
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = llama_moe.MIXTRAL_8X7B.moe_config()
    emesh = Mesh(np.arange(world), ("expert",), "cuda")
    g = emesh.axis_group("expert")
    full = moe.init_moe(mcfg, 17, dev)
    gen = torch.Generator(device=dev).manual_seed(170 + rank)
    x = torch.randn(1, EP_TOKENS, mcfg.embed_dim, generator=gen,
                    device=dev).to(mcfg.dtype)
    local = {k: (v.chunk(world, 0)[g.index] if k != "router" else v)
             .clone().requires_grad_() for k, v in full.items()}
    xe = x.clone().requires_grad_()
    comm.reset_staged()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = moe.moe_mlp_expert_parallel(local, xe, mcfg, group=g,
                                         token_groups=(g,))
    names = ("router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad((y.float() ** 2).sum(),
                                [xe] + [local[k] for k in names])
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0
    staged = dict(comm.staged)
    dense = {k: v.clone().requires_grad_() for k, v in full.items()}
    xd = x.clone().requires_grad_()
    yd, _ = moe.moe_mlp(dense, xd, mcfg)
    dgrads = torch.autograd.grad((yd.float() ** 2).sum(),
                                 [xd] + [dense[k] for k in names])
    errs = {"y": _rel_l2(torch, y, yd), "x": _rel_l2(torch, grads[0],
                                                     dgrads[0]),
            "router": _rel_l2(torch, grads[1], dgrads[1])}
    for name, got, want in zip(names[1:], grads[2:], dgrads[2:]):
        # each rank's experts get every rank's tokens' gradient: the
        # other rank's dense gradient of this rank's experts, summed
        parts = comm._all_to_all(want.contiguous(), 0, 0, g)
        errs[name] = _rel_l2(torch, got, sum(parts.chunk(world, 0)))
    logits = x.reshape(-1, mcfg.embed_dim).float() @ full["router"].float()
    *_, frac, mean_prob = moe._assign(logits, mcfg, mcfg.capacity(
        EP_TOKENS))
    aux_ref = moe._aux_loss(comm._psum(frac, g) / world,
                            comm._psum(mean_prob, g) / world)
    out["ep"] = {"errs": errs, "aux": float(aux), "aux_ref": float(aux_ref),
                 "s": ep_s, "staged": staged, "counts": launch_counts(),
                 "experts": tuple(local["w_gate"].shape)}
    return out


def _gemma_tp_cfg(torch):
    from kubeflow_tpu_torch.models import gemma

    return dataclasses.replace(gemma.GEMMA_2B, num_layers=FSDP_LAYERS)


def _dist_tensor(torch, world):
    """17f on each rank of (tensor world): llama3-1b at full width
    (FSDP_LAYERS layers, 3 steps, (c)'s weights and batch) and gemma-2b's
    widths (FSDP_LAYERS layers, TP_GEMMA_STEPS steps) trained
    tensor-parallel; each run's losses, step seconds, host-staged
    collectives, launches, per-rank peak and the bytes of its
    tensor-cut leaves' params and moments."""
    import math

    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import MeshSpec, comm, create_mesh
    from kubeflow_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    mesh = create_mesh(MeshSpec(data=1, fsdp=1, tensor=world),
                       device_type="cuda")
    toks, tgts = _llama1b_batch(torch, dev, 17)
    out = {}
    for key, mod, cfg, steps in (
            ("tp", llama, _fsdp_cfg(torch), FSDP_STEPS),
            ("tp_gemma", gemma, _gemma_tp_cfg(torch), TP_GEMMA_STEPS)):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(lambda p, t, mod=mod, cfg=cfg: mod.apply(p, cfg, t),
                          lambda s, mod=mod, cfg=cfg: mod.init(
                              cfg, s, dev, train=True),
                          _dist_tc(), device=dev, mesh=mesh,
                          logical_axes=mod.param_logical_axes(cfg),
                          model_config=cfg)
        state = trainer.init(0)
        comm.reset_staged()
        reset_launch_counts()
        losses, step_s = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = trainer.step(state, toks, tgts)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
        cut = sum(3 * 4 * math.prod(lay.shape)
                  for lay in trainer.layout.leaves.values()
                  if "tensor" in lay.norm_axes)
        out[key] = {"losses": losses, "step_s": step_s,
                    "staged": dict(comm.staged), "counts": launch_counts(),
                    "wq": tuple(state.params["blocks"]["wq"].shape),
                    "wk": tuple(state.params["blocks"]["wk"].shape),
                    "peak": torch.cuda.max_memory_allocated() - m0,
                    "cut_bytes": cut}
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ada_tc():
    from kubeflow_tpu_torch.train import TrainConfig

    return TrainConfig(warmup_steps=1, total_steps=100,
                       optimizer="adafactor")


def _moe_batch(torch, dev, vocab):
    """15a's batch: FLASH_B x FLASH_S tokens from seed 15."""
    import numpy as np

    rng = np.random.default_rng(15)
    tokens = torch.from_numpy(rng.integers(0, vocab, (FLASH_B, FLASH_S)))
    return tokens.to(dev), torch.roll(tokens.to(dev), -1, dims=1)


def _moe_tc():
    from kubeflow_tpu_torch.train import TrainConfig

    return TrainConfig(warmup_steps=2, total_steps=1000)   # 15a's


def _vit_tp_batch(torch, dev):
    import numpy as np

    x, y = _synthetic_images(np, VIT_TP_B, 224)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(y[:, None]).to(dev),
            torch.ones((VIT_TP_B, 1), device=dev))


def _timed_steps(torch, trainer, state, batch, steps):
    """`steps` steps -> (state, losses, step seconds, staged collectives,
    launches)."""
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import comm

    comm.reset_staged()
    reset_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.step(state, *batch)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    return state, {"losses": losses, "step_s": step_s,
                   "staged": dict(comm.staged), "counts": launch_counts()}


def _dist_recipes(torch, world):
    """17g on each rank of (tensor world): (a) llama3-1b at full width,
    FSDP_LAYERS layers, under Adafactor, then AdamW at grad_accum
    RECIPE_ACC; (b) Mixtral-8x7B's widths at the depth and on the routes
    of the parent's one-device yardstick (MOE_YARDSTICK; 15a's batch,
    seed and config), with the choices the ranks would have made apart
    and their router gaps; (c) ViT-B/16 at full width and depth;
    RECIPE_STEPS steps each."""
    from kubeflow_tpu_torch.models import llama, llama_moe, vit
    from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh, moe
    from kubeflow_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    mesh = create_mesh(MeshSpec(data=1, fsdp=1, tensor=world),
                       device_type="cuda")
    out = {}

    def tidy():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = _fsdp_cfg(torch)
    batch = _llama1b_batch(torch, dev, 17)
    for key, tc in (("g_ada", _ada_tc()),
                    ("g_acc", dataclasses.replace(_dist_tc(),
                                                  grad_accum=RECIPE_ACC))):
        trainer = Trainer(lambda p, t: llama.apply(p, cfg, t),
                          lambda s: llama.init(cfg, s, dev, train=True), tc,
                          device=dev, mesh=mesh,
                          logical_axes=llama.param_logical_axes(cfg),
                          model_config=cfg)
        state, res = _timed_steps(torch, trainer, trainer.init(0), batch,
                                  RECIPE_STEPS)
        if key == "g_ada":
            names = [n for n, _ in trainer.optimizer.trained(state.params)]
            opt = trainer.gather_opt_state(state)
            res["v_row"] = tuple(opt["v_row"][names.index("blocks.wq")]
                                 .shape)
            res["opt_bytes"] = trainer.opt_state_bytes()
        out[key] = res
        del trainer, state
        tidy()

    yard = torch.load(MOE_YARDSTICK, weights_only=False)
    mcfg = dataclasses.replace(llama_moe.MIXTRAL_8X7B,
                               num_layers=yard["layers"])
    trainer = Trainer(lambda p, t: llama_moe.apply(p, mcfg, t)[0], None,
                      _moe_tc(), loss_fn=llama_moe.loss_fn(mcfg), device=dev,
                      mesh=mesh, logical_axes=llama_moe.param_logical_axes(
                          mcfg), model_config=mcfg)
    t0 = time.perf_counter()
    # drawn on the card a layer at a time, as 15a draws them, held on the
    # host until each rank keeps its experts
    state = trainer.init_from_params(llama_moe.init(mcfg, 0, dev, train=True,
                                                    store="cpu"))
    init_s = time.perf_counter() - t0
    router = state.params["blocks"]["router"].detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls, top_k = [], moe._top_k
    moe._top_k = _route_probe(torch, calls,
                              [r.to(dev) for r in yard["routes"]])
    try:
        state, res = _timed_steps(torch, trainer, state, _moe_batch(
            torch, dev, mcfg.vocab_size), RECIPE_STEPS)
    finally:
        moe._top_k = top_k
    # each step's natural choices that differ from the forced ones, by
    # router gap (2 L routings a step: the forward and remat's rerun)
    gaps = [[] for _ in range(RECIPE_STEPS)]
    for i, ((idx, gap), forced) in enumerate(zip(calls, yard["routes"],
                                                 strict=True)):
        moved = (idx.cpu() != forced).any(-1)
        gaps[i // (2 * mcfg.num_layers)] += gap[moved.to(dev)].tolist()
    res.update(peak=torch.cuda.max_memory_allocated(), layers=mcfg.num_layers,
               flip_gaps=gaps, calls=len(calls), init_s=init_s,
               w_gate=tuple(state.params["blocks"]["w_gate"].shape),
               router_moved=float((state.params["blocks"]["router"]
                                   - router).abs().max()))
    out["g_moe"] = res
    del trainer, state, router
    tidy()

    vcfg = vit.VIT_B16
    trainer = Trainer(vit.apply_fn(vcfg), lambda s: vit.init(vcfg, s, dev),
                      _dist_tc(), device=dev, mesh=mesh,
                      logical_axes=vit.param_logical_axes(vcfg),
                      model_config=vcfg)
    state, res = _timed_steps(torch, trainer, trainer.init(0),
                              _vit_tp_batch(torch, dev), RECIPE_STEPS)
    res.update(wq=tuple(state.params["blocks"]["wq"].shape),
               head=tuple(state.params["head_w"].shape))
    out["g_vit"] = res
    del trainer, state
    tidy()
    return out


def _pp_batch(torch, dev):
    """17d's batch: PP_MICRO rows of llama3-1b tokens at s 2048."""
    import numpy as np

    rng = np.random.default_rng(171)
    toks = torch.from_numpy(rng.integers(
        0, LLAMA_1B_VOCAB, (PP_MICRO, FLASH_S))).to(dev)
    return toks, torch.roll(toks, -1, dims=1)


def _dist_nccl(torch, rank, world):
    """A one-rank NCCL group: the ring (one causal block, so one launch
    of each kernel) and one FSDP trainer step."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh, ring
    from kubeflow_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    mesh = create_mesh(MeshSpec(data=1, fsdp=1), device_type="cuda")
    g = mesh.axis_group("fsdp")
    q, k, v, do = _ring_qkv(torch, dev, s=FLASH_S)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    reset_launch_counts()
    o = ring.ring_flash_attention(qb, kb, vb, group=g, causal=True)
    dq, dk, dv = torch.autograd.grad(o, (qb, kb, vb), do)
    torch.cuda.synchronize()
    counts = launch_counts()
    ref = fa.flash_attention(q, k, v, causal=True)
    cfg = _fsdp_cfg(torch)
    trainer = Trainer(lambda p, t: llama.apply(p, cfg, t),
                      lambda s: llama.init(cfg, s, dev, train=True),
                      _dist_tc(), device=dev, mesh=mesh,
                      logical_axes=llama.param_logical_axes(cfg))
    state = trainer.init(0)
    toks, tgts = _llama1b_batch(torch, dev, 17)
    _, loss = trainer.step(state, toks, tgts)
    return {"backend": dist.get_backend(), "counts": counts,
            "ring_equal": bool(torch.equal(o, ref)),
            "loss": float(loss)}


# -- phase 19: tensor-parallel serving ----------------------------------------
# Two ranks on cuda:0 in a gloo group (`--dist-worker serving`), each one
# process holding its rank's cut of the weights (`bridge.
# tensor_rank_params`), stepped in lockstep by serving/gang.py: rank 0
# runs the HTTP app and the batcher, rank 1 follows. Eager throughout:
# the engines refuse CUDA graphs at tensor > 1 (a gloo collective stages
# through host memory). (a) llama3-1b continuous, 8 slots, chunked prefill
# (phase 3's requests, then the 130-token prompt again, which must hit the
# radix cache), then a monolithic wave through a second batcher; a
# control in which the follower drops layer 0's attention exit sum
# during a one-shot generate of the same prompts; (b) gemma-2b one-shot,
# a direct 2-row request through the app (its one KV head held whole, its
# 256,000-token vocabulary cut on "tensor").
TP_RANKS = 2
TP_GANG_TIMEOUT_S = 120.0
TP_GEMMA_ROWS, TP_GEMMA_LEN = 2, 45  # 19b's direct batch (one width)
TP_MEASURE_STEPS = 8               # decode steps timed alone after 19a
# a rank's peak in 19a and 19b over one device's for the same part, at
# most: a rank holds half the weights and half the KV cells but the
# whole gathered logits (0.56-0.57 of one device's on an H100 80GB); a
# rank that still holds its 19a engine at 19b reads 0.76
TP_PEAK_SHARE = 0.7


def _tp_prompts(torch, vocab):
    """Phase 3's prompts (17, 130, 300 tokens, the first again)."""
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in PROMPT_LENS[:3]]
    return prompts + [prompts[0]]


def _tp_gemma_rows(torch, vocab):
    """19b's direct batch: TP_GEMMA_ROWS prompts of TP_GEMMA_LEN tokens
    (a client's batch has one width)."""
    gen = torch.Generator().manual_seed(4)
    return torch.randint(0, vocab, (TP_GEMMA_ROWS, TP_GEMMA_LEN),
                         generator=gen).tolist()


def _tp_rank_engine(torch, mod, cfg, gang):
    """This rank's engine: the full weights drawn on the card from seed 0
    into host memory, leaf by leaf, cut for the rank, the cut moved to
    the card."""
    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.serving.engine import (
        GEMMA_FAMILY, LLAMA_FAMILY, EngineConfig, InferenceEngine,
    )

    dev = torch.device("cuda")
    full = mod.init(cfg, 0, dev, store="cpu")
    local = bridge.tensor_rank_params(full, cfg, gang.group.index,
                                      gang.group.size)
    local = {k: ({n: t.to(dev) for n, t in v.items()} if k == "blocks"
                 else v.to(dev)) for k, v in local.items()}
    del full
    fam = GEMMA_FAMILY if mod.__name__.endswith("gemma") else LLAMA_FAMILY
    return InferenceEngine(local, cfg, fam, EngineConfig(max_len=MAX_LEN),
                           device=dev, cuda_graphs=False, group=gang.group)


def _tp_token_log(torch):
    """Every rank logs the tokens its engines compute (decode steps,
    prefill slices and groups, one-shot generates), so the parent can
    hold each rank's to rank 0's."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine
    from kubeflow_tpu_torch.serving.engine import InferenceEngine

    got = []

    def logged(cls, name, pick):
        fn = getattr(cls, name)

        def run(self, *a, **kw):
            out = fn(self, *a, **kw)
            got.append((name, pick(out).detach().cpu()))
            return out

        setattr(cls, name, run)

    logged(ContinuousEngine, "decode", lambda out: out[0])
    logged(ContinuousEngine, "prefill_slice", lambda out: out[0])
    logged(ContinuousEngine, "prefill_batch", lambda out: out[1])
    logged(InferenceEngine, "generate",
           lambda out: out[0] if isinstance(out, tuple) else out)
    return got


def _tp_serve_llama(torch, eng, prompts, calls_log):
    """19a on the leading rank: the app's chunked waves, the radix
    repeat, the staged cost of a decode step and of a prefill slice, a
    monolithic wave; -> what the parent checks."""
    import aiohttp
    import numpy as np
    from aiohttp import web

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import comm
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.server import (
        BATCHERS_KEY, create_serving_app,
    )

    name = "llama3-1b"

    async def session():
        out = {}
        app = create_serving_app({name: eng}, max_batch=SLOTS,
                                 continuous=True, prefill_chunk_tokens=CHUNK,
                                 seed=0)
        runner = web.AppRunner(app)
        await runner.setup()
        port = _free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        batcher = app[BATCHERS_KEY][name]
        url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
        try:
            async with aiohttp.ClientSession() as sess:
                async def post(p):
                    async with sess.post(url, json={
                            "tokens": [p], "max_new": MAX_NEW,
                            "logprobs": True}) as r:
                        if r.status != 200:
                            raise RuntimeError(f":generate {r.status}: "
                                               f"{await r.text()}")
                        return await r.json()

                reset_launch_counts()
                comm.reset_staged()
                t0 = time.perf_counter()
                bodies = await asyncio.gather(*(post(p) for p in prompts))
                out["wave_s"] = time.perf_counter() - t0
                out["counts"] = launch_counts()
                out["logged_steps"] = sum(int(t.shape[1]) for n, t in
                                          calls_log if n == "decode")
                out["staged_wave"] = dict(comm.staged)
                out.update(calls=batcher.calls, slices=batcher.slices,
                           decode_ms=batcher.decode_s
                           / max(batcher.calls, 1) * 1e3)
                hits0 = batcher.prefix_hits
                again = await post(prompts[1])
                out["hits"] = batcher.prefix_hits - hits0
                out["chunked"] = [(b["tokens"][0], b["logprobs"][0])
                                  for b in bodies]
                out["repeat"] = (again["tokens"][0], again["logprobs"][0])
                if not await batcher.drain(timeout=60):
                    raise RuntimeError("19a: the batcher did not drain")
                ce = batcher.cengine
                sp = ce.sampling(np.zeros(SLOTS, np.float32),
                                 np.zeros(SLOTS, np.int64),
                                 np.ones(SLOTS, np.float32))
                ce.reset_slots(ce.slots(), list(range(SLOTS)))
                steps = []
                for i in range(TP_MEASURE_STEPS + 1):
                    comm.reset_staged()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ce.decode(sp, 1)
                    torch.cuda.synchronize()
                    if i:    # the first step is not timed
                        steps.append((time.perf_counter() - t0,
                                      dict(comm.staged)))
                out["step"] = steps
                comm.reset_staged()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ce.prefill_slice(sp, 0, np.zeros((1, CHUNK), np.int64),
                                 CHUNK, False)
                torch.cuda.synchronize()
                out["slice"] = (time.perf_counter() - t0, dict(comm.staged))
                ce.reset_slots(ce.slots(), list(range(SLOTS)))
        finally:
            await runner.cleanup()
        out["kv_block_bytes"] = eng.kv_cache_bytes(1, BS)
        mono = ContinuousBatcher(eng, asyncio.Lock(), max_slots=SLOTS,
                                 seed=0)
        try:
            out["mono"] = [tuple(r) for r in await asyncio.gather(*(
                mono.submit(p, MAX_NEW, with_logprobs=True)
                for p in prompts))]
        finally:
            await mono.close()
        return out

    return asyncio.run(session())


def _tp_serve_gemma(torch, eng):
    """19b on the leading rank: one direct 2-row request through the
    one-shot app (window 0)."""
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import comm
    from kubeflow_tpu_torch.serving.server import create_serving_app

    name = "gemma-2b"
    rows = _tp_gemma_rows(torch, eng.cfg.vocab_size)

    async def session():
        app = create_serving_app({name: eng})
        runner = web.AppRunner(app)
        await runner.setup()
        port = _free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
        try:
            async with aiohttp.ClientSession() as sess:
                reset_launch_counts()
                comm.reset_staged()
                t0 = time.perf_counter()
                async with sess.post(url, json={
                        "tokens": rows, "max_new": MAX_NEW,
                        "logprobs": True}) as r:
                    if r.status != 200:
                        raise RuntimeError(f":generate {r.status}: "
                                           f"{await r.text()}")
                    body = await r.json()
                return {"s": time.perf_counter() - t0,
                        "counts": launch_counts(),
                        "staged": dict(comm.staged),
                        "tokens": body["tokens"],
                        "logprobs": body["logprobs"]}
        finally:
            await runner.cleanup()

    return asyncio.run(session())


def _tp_follow_faulty(g, eng, layers) -> int:
    """Follow the gang; the control: during a one-shot generate (the
    continuous waves run none) this rank drops layer 0's attention exit
    sum (the collective still runs, its result is thrown away). -> the
    forwards it dropped the sum in."""
    from kubeflow_tpu_torch.parallel import tensor

    real_exit, fault = tensor.exit, {"on": False, "n": 0}

    def exit_(x):
        if fault["on"]:
            fault["n"] += 1
            if fault["n"] % (2 * layers) == 1:
                real_exit(x)
                return x
        return real_exit(x)

    generate = eng.generate

    def faulty(*a, **kw):
        fault["on"] = True
        try:
            return generate(*a, **kw)
        finally:
            fault["on"] = False

    tensor.exit, eng.generate = exit_, faulty
    try:
        g.follow(eng)
    finally:
        tensor.exit = real_exit
        del eng.generate
    return fault["n"] // (2 * layers)


def _dist_serving(torch, rank, world):
    """Phase 19 on each rank of the serving gang: (a) llama3-1b, its
    control, (b) gemma-2b. -> per part: the leader's served tokens and
    logprobs, every rank's token log, launches, peak memory, KV bytes,
    captured graphs, staged collectives."""
    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving import gang as gang_lib
    from kubeflow_tpu_torch.serving import graphs

    gangs = {k: gang_lib.form(list(range(world)),
                              timeout_s=TP_GANG_TIMEOUT_S)
             for k in ("llama", "gemma")}
    log_ = _tp_token_log(torch)
    out = {"rank": rank}

    # (a) llama3-1b
    g = gangs["llama"]
    torch.cuda.reset_peak_memory_stats()
    eng = _tp_rank_engine(torch, llama, llama.LLAMA3_1B, g)
    prompts = _tp_prompts(torch, eng.cfg.vocab_size)
    width = max(len(p) for p in prompts)
    arr = [[0] * (width - len(p)) + p for p in prompts]
    mask = [[False] * (width - len(p)) + [True] * len(p) for p in prompts]
    layers = eng.cfg.num_layers
    reset_launch_counts()
    if g.leader:
        g.lead(eng)
        part = _tp_serve_llama(torch, eng, prompts, log_)
        toks, lps = eng.generate(arr, max_new=MAX_NEW, prompt_mask=mask,
                                 return_logprobs=True)
        part["control"] = (toks.tolist(), lps.tolist())
        g.stop()
    else:
        part = {"dropped": _tp_follow_faulty(g, eng, layers)}
    part.update(session=launch_counts(),
                peak=torch.cuda.max_memory_allocated(),
                kv_heads=eng.kv_heads, gang_calls=g.calls,
                log=[(n, t) for n, t in log_ if n != "generate"])
    out["llama"] = part
    log_.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) gemma-2b
    g = gangs["gemma"]
    torch.cuda.reset_peak_memory_stats()
    eng = _tp_rank_engine(torch, gemma, gemma.GEMMA_2B, g)
    if g.leader:
        g.lead(eng)
        part = _tp_serve_gemma(torch, eng)
        g.stop()
    else:
        reset_launch_counts()
        g.follow(eng)
        part = {"counts": launch_counts()}
    part.update(peak=torch.cuda.max_memory_allocated(),
                kv_heads=eng.kv_heads, gang_calls=g.calls, log=list(log_),
                kv_cache_bytes=eng.kv_cache_bytes(1))
    out["gemma"] = part
    out["graphs"] = graphs.captured["graphs"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


DIST_CASES = {"seq": _dist_seq, "train": _dist_train, "nccl": _dist_nccl,
              "resize": lambda torch, rank, world: _dist_resize(torch, rank,
                                                                world),
              "serving": _dist_serving}


def dist_worker_main(argv: list[str]) -> None:
    """`chip_smoke.py --dist-worker CASE RANK WORLD STORE OUT BACKEND`:
    one rank of phase 17's gang on cuda:0; what CASE returns (CPU
    tensors and numbers) is saved to OUT."""
    import torch
    import torch.distributed as dist

    case, rank, world, store, out, backend = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    result = DIST_CASES[case](torch, rank, world)
    torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


def _start_gang(case: str, world: int, backend: str = "gloo"):
    """Start `world` worker processes of `case` on cuda:0; -> what
    `_wait_gang` takes."""
    os.makedirs(DIST_DIR, exist_ok=True)
    store = os.path.join(DIST_DIR, f"{case}.store")
    outs = [os.path.join(DIST_DIR, f"{case}.{r}.pt") for r in range(world)]
    for path in (store, *outs):
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", case,
         str(r), str(world), store, outs[r], backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    for p in procs:     # a failure elsewhere exits the smoke: stop them
        atexit.register(_stop, p)
    return case, procs, outs, t0


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _wait_gang(torch, started):
    """Wait for a started gang. A rank that fails or outlives
    DIST_TIMEOUT fails the phase. -> ([per-rank results], seconds)."""
    case, procs, outs, t0 = started
    world = len(procs)
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=DIST_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        fail(f"gang {case}: a rank outlived {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"gang {case}: rank {r} of {world} exited "
                 f"{p.returncode}:\n{text[-4000:]}")
    res = [torch.load(o, weights_only=False) for o in outs]
    return res, time.perf_counter() - t0


def _spawn_gang(torch, case: str, world: int, backend: str = "gloo"):
    """Start `world` worker processes of `case` on cuda:0 and wait for
    them all (`_start_gang`, `_wait_gang`)."""
    return _wait_gang(torch, _start_gang(case, world, backend))


def _sum_counts(results, key=None) -> dict:
    total: dict = {}
    for r in results:
        got = r["counts"] if key is None else r[key]["counts"]
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
    return total


def _tp_teacher(torch, mod, eng, prompts, outs):
    """Each one-device sequence teacher-forced through the plain dense
    model: per row, per position (the logprob of the one-device token,
    the top-2 margin, the argmax), and the whole log-softmax [n, V] on
    the host (a served token that parts from the one-device run is held
    to it)."""
    rows, dists = [], []
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            toks = torch.tensor([p + o[:-1]], device=eng.device)
            logp = torch.log_softmax(
                mod.apply(eng.params, eng.cfg, toks)[0, len(p) - 1:].float(),
                -1)
            top2 = torch.topk(logp, 2, dim=-1)
            got = logp[torch.arange(len(o), device=eng.device),
                       torch.tensor(o, device=eng.device)]
            rows.append(list(zip(got.tolist(),
                                 (top2.values[:, 0] - top2.values[:, 1])
                                 .tolist(), top2.indices[:, 0].tolist())))
            dists.append(logp.cpu())
    return rows, dists


def _tp_one_device(torch, key):
    """Phase 19's one-device yardstick of part `key` ("llama": 19a's
    prompts one at a time; "gemma": 19b's two rows): greedy tokens, the
    teacher-forced pass along them, peak memory and KV bytes; the card
    is freed after."""
    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.serving.engine import (
        GEMMA_FAMILY, LLAMA_FAMILY, EngineConfig, InferenceEngine,
    )

    mod, cfg, fam = ((llama, llama.LLAMA3_1B, LLAMA_FAMILY) if key == "llama"
                     else (gemma, gemma.GEMMA_2B, GEMMA_FAMILY))
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(mod.init(cfg, 0, dev), cfg, fam,
                          EngineConfig(max_len=MAX_LEN), device=dev,
                          cuda_graphs=False)
    if key == "llama":
        prompts = _tp_prompts(torch, cfg.vocab_size)
        outs = [eng.generate([p], max_new=MAX_NEW)[0].tolist()
                for p in prompts]
    else:
        prompts = _tp_gemma_rows(torch, cfg.vocab_size)
        outs = eng.generate(prompts, max_new=MAX_NEW).tolist()
    peak = torch.cuda.max_memory_allocated() - m0
    teacher, dists = _tp_teacher(torch, mod, eng, prompts, outs)
    for i, (o, t) in enumerate(zip(outs, teacher)):
        for j, (tok, (_, margin, top)) in enumerate(zip(o, t)):
            if margin > 2 * LOGPROB_TOL and top != tok:
                fail(f"phase 19 one-device {key}: row {i} token {j} is "
                     f"{tok}, the plain model's argmax {top} (margin "
                     f"{margin:.3f})")
            if top != tok:
                break
    ref = {"prompts": prompts, "tokens": outs, "teacher": teacher,
           "dists": dists, "peak": peak,
           "kv_block_bytes": eng.kv_cache_bytes(1, BS),
           "kv_cache_bytes": eng.kv_cache_bytes(1)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _tp_hold(ref, outs, lps, label) -> bool:
    """Served sequences against the one-device yardstick: each token's
    logprob within LOGPROB_TOL of the teacher-forced pass's, up to and
    including the first token that differs from the one-device run's
    (the same prefix, so the teacher's distribution there holds the
    served token too), which must sit at a top-2 margin of at most 2 x
    LOGPROB_TOL (a near tie that the bf16 exit sums, rounded once per
    rank, may break either way); the rest of that row follows another
    path and is not compared. -> ok."""
    worst, n, excused, bad = 0.0, 0, 0, []
    for i, (o, lp) in enumerate(zip(outs, lps)):
        for j, (tok, got) in enumerate(zip(o, lp)):
            _, margin, _ = ref["teacher"][i][j]
            worst = max(worst, abs(got - float(ref["dists"][i][j, tok])))
            n += 1
            if tok != ref["tokens"][i][j]:
                if margin > 2 * LOGPROB_TOL:
                    bad.append((i, j, round(margin, 3)))
                else:
                    excused += 1
                break
    ok = worst <= LOGPROB_TOL and not bad
    log(f"  {label}: {n} tokens held to the teacher-forced pass, logprob "
        f"max_abs_err {worst:.4f} (tol {LOGPROB_TOL}); {excused} rows part "
        f"from the one-device run at a near tie (margin <= "
        f"{2 * LOGPROB_TOL}); parted above it: {bad}")
    return ok


def _tp_same_logs(results, key):
    """Every rank's logged tokens are rank 0's. -> entries compared."""
    base = results[0][key]["log"]
    for r in results[1:]:
        got = r[key]["log"]
        if len(got) != len(base) or any(
                a[0] != b[0] or not _tensors_equal(a[1], b[1])
                for a, b in zip(got, base)):
            fail(f"phase 19 {key}: rank {r['rank']}'s tokens are not rank "
                 f"0's ({len(got)} vs {len(base)} logged calls)")
    return len(base)


def _tensors_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _tp_staged(st) -> str:
    return (f"{st['calls']} staged calls, {st['bytes'] / 2**20:.3f} MiB, "
            f"{st['seconds'] * 1e3:.2f} ms")


def serving_tp_and_check(torch) -> dict:
    """Phase 19: tensor-parallel serving, two ranks on cuda:0 stepped in
    lockstep by a gang behind the HTTP app (`--dist-worker serving`),
    held to one device's yardstick. -> the serving kernels' launches
    over the ranks, under the `@...-tp2` names."""
    t_phase = time.perf_counter()
    card = _card()
    refs = {key: _tp_one_device(torch, key) for key in ("llama", "gemma")}
    log(f"  one-device yardsticks in {time.perf_counter() - t_phase:.1f} s; "
        f"ranks: {TP_RANKS} worker processes on cuda:0 in a gloo group "
        f"(host-staged collectives), eager (graphs refused at tensor > 1)")
    res, gang_s = _spawn_gang(torch, "serving", TP_RANKS)
    lead, layers = res[0], LAYERS
    log(f"  gang {gang_s:.1f} s ({card})")

    # (a) llama3-1b
    a = lead["llama"]
    counts = a["counts"]
    bad = []
    for r in res:
        lg = r["llama"]["log"]
        steps = sum(int(t.shape[1]) for n, t in lg if n == "decode")
        slices = sum(1 for n, _ in lg if n == "prefill_slice")
        got = r["llama"]["session"]
        log(f"  19a rank {r['rank']}: {steps} decode steps and {slices} "
            f"slices logged over the session, launches {got}")
        if (got.get("paged_decode_attention", 0) != layers * steps
                or got.get("paged_prefill_append", 0) != layers * slices):
            bad.append(f"rank {r['rank']}: launches {got}, its {steps} "
                       f"decode steps and {slices} slices imply {layers} "
                       f"each")
    want = {"paged_decode_attention": layers * a["calls"],
            "paged_prefill_append": layers * a["slices"]}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            bad.append(f"{name} {counts.get(name, 0)} launches in the wave "
                       f"on rank 0, its {a['calls']} steps ({a['logged_steps']}"
                       f" logged) and {a['slices']} slices imply {n}")
    if a["slices"] != sum(-(-n // CHUNK) for n in PROMPT_LENS):
        bad.append(f"{a['slices']} prefill slices for {PROMPT_LENS}")
    if a["logged_steps"] != a["calls"]:
        bad.append(f"{a['calls']} decode steps dispatched in the wave, "
                   f"{a['logged_steps']} run")
    for key in ("llama", "gemma"):
        calls = {r[key]["gang_calls"] for r in res}
        if len(calls) != 1:
            bad.append(f"{key}: the ranks made {calls} calls of the gang")
    if bad:
        fail("phase 19: " + "; ".join(bad))
    n_log = _tp_same_logs(res, "llama")
    log(f"  19a llama3-1b at tensor 2 (n_q 8, n_kv {a['kv_heads']} a rank), "
        f"8 slots, chunked prefill: {len(PROMPT_LENS)} requests in "
        f"{a['wave_s']:.3f} s, {a['calls']} decode steps, {a['slices']} "
        f"slices; launches a rank {counts} ({layers} a step / slice); "
        f"{n_log} calls' tokens identical on every rank; staged in the wave "
        f"{_tp_staged(a['staged_wave'])}")
    outs = [o for o, _ in a["chunked"]]
    ok = _tp_hold(refs["llama"], outs, [lp for _, lp in a["chunked"]],
                  "19a chunked")
    if outs[0] != outs[3]:
        fail(f"19a: the repeated 17-token prompt gave {outs[3]}, first "
             f"{outs[0]}")
    if a["hits"] < 1 or a["repeat"][0] != outs[1]:
        fail(f"19a: the 130-token prompt again: {a['hits']} radix hits, "
             f"tokens {a['repeat'][0]} vs {outs[1]}")
    mono = [list(t) for t, _ in a["mono"]]
    ok &= _tp_hold(refs["llama"], mono, [lp for _, lp in a["mono"]],
                   "19a monolithic wave")
    if not ok:
        fail("19a: the served tokens disagree with one device's")
    ctl_ok = _tp_hold(refs["llama"], *a["control"], "19a control")
    log(f"  19a control (rank 1 drops layer 0's attention exit sum in "
        f"{res[1]['llama']['dropped']} forwards of a one-shot generate): "
        f"{'PASSED the check: fault' if ctl_ok else 'fails the check'}")
    if ctl_ok or not res[1]["llama"]["dropped"]:
        fail("19a: the control with a dropped exit sum passed the check")
    steps = a["step"]
    mean = {k: sum(st[k] for _, st in steps) / len(steps)
            for k in ("calls", "bytes", "seconds")}
    host_ms = sum(t for t, _ in steps) / len(steps) * 1e3
    sl_s, sl = a["slice"]
    phase3 = MEASURED.get("phase3_step_ms")
    log(f"  19a a decode step (8 slots, {len(steps)} timed alone, rank 0): "
        f"host {host_ms:.2f} ms, {_tp_staged(mean)} staged; the wave's "
        f"batcher {a['decode_ms']:.2f} ms a step (dispatch + wait; phase 3's "
        f"graph replays: "
        f"{'not run' if phase3 is None else f'{phase3} ms'}); a {CHUNK}-token "
        f"prefill slice {sl_s * 1e3:.2f} ms, {_tp_staged(sl)} staged: gloo on "
        f"one card, not a number for NCCL ({card})")
    kv1 = refs["llama"]["kv_block_bytes"]
    if a["kv_block_bytes"] * 2 != kv1:
        fail(f"19a: a rank's KV block {a['kv_block_bytes']} B, one "
             f"device's {kv1} B (half the KV heads)")
    log(f"  19a memory: peak {res[0]['llama']['peak'] / 2**30:.2f} / "
        f"{res[1]['llama']['peak'] / 2**30:.2f} GiB on ranks 0 / 1 (weights "
        f"cut in two, paged pools of two batchers, eager activations) "
        f"against one device's {refs['llama']['peak'] / 2**30:.2f} GiB "
        f"(all the weights, its batch-1 generates); KV block "
        f"{a['kv_block_bytes']} B a rank against {kv1} B")

    # (b) gemma-2b
    b = lead["gemma"]
    n_log = _tp_same_logs(res, "gemma")
    steps = MAX_NEW - 1
    for r in res:
        got = r["gemma"]["counts"].get("decode_attention", 0)
        if got != 18 * steps:
            fail(f"19b rank {r['rank']}: decode_attention {got} launches, "
                 f"18 layers x {steps} steps imply {18 * steps}")
    if not _tp_hold(refs["gemma"], b["tokens"], b["logprobs"],
                    "19b gemma-2b direct"):
        fail("19b: the served tokens disagree with one device's")
    if b["kv_cache_bytes"] != refs["gemma"]["kv_cache_bytes"]:
        fail(f"19b: a rank's dense cache {b['kv_cache_bytes']} B, one "
             f"device's {refs['gemma']['kv_cache_bytes']} B (its one KV "
             f"head held whole)")
    log(f"  19b gemma-2b at tensor 2 (n_q 4 over its one KV head held whole, "
        f"vocab 256000 cut in two), a direct request of {TP_GEMMA_ROWS} x "
        f"{TP_GEMMA_LEN} tokens: {b['s']:.3f} s, decode_attention 18 x {steps} a "
        f"rank, {n_log} calls' tokens identical on every rank; staged "
        f"{_tp_staged(b['staged'])}; peak {res[0]['gemma']['peak'] / 2**30:.2f}"
        f" / {res[1]['gemma']['peak'] / 2**30:.2f} GiB against one device's "
        f"{refs['gemma']['peak'] / 2**30:.2f} GiB")
    shares = {}
    for key, part in (("llama", "19a"), ("gemma", "19b")):
        one = refs[key]["peak"]
        shares[part] = [r[key]["peak"] / one for r in res]
        for r, share in zip(res, shares[part]):
            if share > TP_PEAK_SHARE:
                fail(f"{part} rank {r['rank']}: peak {r[key]['peak']} B is "
                     f"{share:.3f} of one device's {one} B (at most "
                     f"{TP_PEAK_SHARE})")
    log("  a rank's peak over one device's (ranks 0 / 1, at most "
        f"{TP_PEAK_SHARE}): " + "; ".join(
            f"{part} " + " / ".join(f"{x:.3f}" for x in xs)
            for part, xs in shares.items()))
    graphs = [r["graphs"] for r in res]
    if any(graphs):
        fail(f"phase 19: CUDA graphs captured at tensor 2: {graphs}")
    took = time.perf_counter() - t_phase
    log(f"  no graph captured on either rank; phase 19 {took:.1f} s "
        f"(budget 75 s)")
    total = _sum_counts([{"counts": r["llama"]["session"]} for r in res])
    gcount = _sum_counts([{"counts": r["gemma"]["counts"]} for r in res])
    return {"paged_decode_attention" + TP2: total["paged_decode_attention"],
            "paged_prefill_append" + TP2: total["paged_prefill_append"],
            "decode_attention" + GEMMA_TP2: gcount["decode_attention"]}


def _ring_checks(torch, dev, seq) -> dict:
    """17a and 17b against one-device flash attention over the whole
    sequence (the same kernels at s 8192). -> launch counts."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v, do = _ring_qkv(torch, dev)
    counts: dict = {}
    for impl in ("ring", "ulysses"):
        for causal in (True, False):
            label = f"17{'a' if impl == 'ring' else 'b'} {impl} " \
                f"{'causal' if causal else 'bidirectional'}"
            parts = [r[(impl, causal)] for r in seq]
            cat = {name: torch.cat([p[name] for p in parts], 1).to(dev)
                   for name in ("o", "dq", "dk", "dv")}
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            ref = fa.flash_attention(qr, kr, vr, causal=causal)
            rgrads = torch.autograd.grad(ref, (qr, kr, vr), do)
            ref = ref.detach().float()
            bound = RING_C * ref.abs().max() + 2**-7 * ref.abs()
            o_err = float(((cat["o"].float() - ref).abs() - bound).max())
            gerr = {n: _rel_l2(torch, cat[n], w)
                    for n, w in zip(("dq", "dk", "dv"), rgrads)}
            total = _sum_counts(parts)
            n_blocks = (RING_RANKS * (RING_RANKS + 1) // 2 if causal
                        else RING_RANKS * RING_RANKS)
            want = n_blocks if impl == "ring" else RING_RANKS
            flash = {n: total[f"flash_attention_{n}"]
                     for n in ("fwd", "dq", "dkv")}
            fwd_s = max(p["fwd_s"] for p in parts)
            bwd_s = max(p["bwd_s"] for p in parts)
            st = max(p["staged"]["seconds"] for p in parts)
            mib = sum(p["staged"]["bytes"] for p in parts) / 2**20
            extra = ""
            if impl == "ring":
                plain = torch.cat([p["plain"] for p in parts], 1).to(dev)
                p_err = float(((cat["o"].float() - plain.float()).abs()
                               - bound).max())
                extra = f"; ring flash vs plain ring: excess {p_err:.2e}"
                if p_err > 0:
                    fail(f"{label}: ring flash and the plain ring disagree "
                         f"beyond the bf16 bound")
            log(f"  {label}: o excess over the bound {o_err:.2e} (<= 0: "
                f"within 2^-8 max|ref| + 2^-7 |ref|), gradient rel L2 "
                + ", ".join(f"{n} {e:.2e}" for n, e in gerr.items())
                + f" (tol {TRAIN_GRAD_TOL}){extra}; launches over the "
                f"ranks {flash} (design {want} each; per rank "
                f"{[p['counts']['flash_attention_fwd'] for p in parts]}); "
                f"forward {fwd_s * 1e3:.1f} ms, backward {bwd_s * 1e3:.1f} "
                f"ms (slowest rank), of which host-staged collectives "
                f"{st * 1e3:.1f} ms on the slowest rank ({mib:.1f} MiB "
                f"through the host over the ranks)")
            if o_err > 0:
                fail(f"{label}: o outside the bf16 bound")
            if max(gerr.values()) > TRAIN_GRAD_TOL:
                fail(f"{label}: gradients {gerr} beyond {TRAIN_GRAD_TOL}")
            if any(n != want for n in flash.values()):
                fail(f"{label}: flash launches {flash}, the design "
                     f"implies {want} each")
            for name, n in total.items():
                counts[name] = counts.get(name, 0) + n
    return counts


def _tensor_checks(train, one_losses, one_peak, gemma_losses) -> None:
    """17f: the tensor-parallel runs against their one-device ones."""
    for key, label, want_losses, layers_of in (
            ("tp", "llama3-1b at full width", one_losses, 16),
            ("tp_gemma", "gemma-2b's widths", gemma_losses, 18)):
        t = train[0][key]
        steps = len(t["losses"])
        errs = [abs(a - b) / abs(b) for a, b in zip(t["losses"],
                                                   want_losses)]
        per_step = [max(r[key]["step_s"][i] for r in train)
                    for i in range(steps)]
        st = max(r[key]["staged"]["seconds"] for r in train)
        gib = sum(r[key]["staged"]["bytes"] for r in train) / 2**30
        got = _sum_counts(train, key)
        want = {"flash_attention_fwd": 2 * FSDP_LAYERS * 2 * steps,
                "flash_attention_dq": 2 * FSDP_LAYERS * steps,
                "flash_attention_dkv": 2 * FSDP_LAYERS * steps}
        peak = max(r[key]["peak"] for r in train)
        share = (1 - 1 / 2) * t["cut_bytes"]
        log(f"  17f tensor parallelism: {label}, {FSDP_LAYERS} of "
            f"{layers_of} layers, mesh (data 1, fsdp 1, tensor 2), global "
            f"batch {FLASH_B} x {FLASH_S}, {steps} steps: losses "
            f"{t['losses']} vs one device {want_losses[:steps]} (rel err "
            f"{max(errs):.2e}, tol {TRAIN_LOSS_TOL}); wq held as {t['wq']}, "
            f"wk as {t['wk']}; step {[round(x, 3) for x in per_step]} s "
            f"(slowest rank), of which host-staged collectives {st:.3f} s "
            f"over the {steps} steps on the slowest rank ({gib:.2f} GiB "
            f"through the host); peak {peak / 2**30:.3f} GiB a rank; "
            f"launches {got} (design {want})")
        if max(errs) > TRAIN_LOSS_TOL:
            fail(f"17f {label}: tensor-parallel losses differ from the "
                 f"one-device run")
        if any(got.get(k) != n for k, n in want.items()):
            fail(f"17f {label}: flash launches {got}, the design implies "
                 f"{want}")
        if key == "tp":
            log(f"  17f memory: peak {peak / 2**30:.3f} GiB a rank vs the "
                f"one device's {one_peak / 2**30:.3f} GiB, which less half "
                f"the tensor-cut leaves' params and moments "
                f"({share / 2**30:.3f} GiB) bounds it at "
                f"{(one_peak - share) / 2**30:.3f} GiB")
            if t["wq"] != (FSDP_LAYERS, 2048, 1024):
                fail(f"17f: wq held as {t['wq']}, not [2, 2048, 1024]")
            if peak > one_peak - share:
                fail(f"17f: a rank's peak {peak} B is not below the one "
                     f"device's {one_peak} B by half the tensor-cut "
                     f"leaves' params and moments ({share:.0f} B)")
        elif t["wk"] != (FSDP_LAYERS, 2048, 256):
            fail(f"17f: gemma-2b's one KV head held as {t['wk']}, not "
                 "whole")


def _one_device_recipes(torch, dev) -> dict:
    """17g's one-device yardsticks, before the gang: llama3-1b at 17c's
    depth under Adafactor (wq's v_row shape, its losses) and ViT-B/16
    (losses), RECIPE_STEPS steps on the ranks' batches and seeds."""
    from kubeflow_tpu_torch.models import llama, vit
    from kubeflow_tpu_torch.train import Trainer

    cfg = _fsdp_cfg(torch)
    one = Trainer(lambda p, t: llama.apply(p, cfg, t),
                  lambda s: llama.init(cfg, s, dev, train=True), _ada_tc(),
                  device=dev)
    state = one.init(0)
    batch = _llama1b_batch(torch, dev, 17)
    ada = [float(one.step(state, *batch)[1]) for _ in range(RECIPE_STEPS)]
    names = [n for n, _ in one.optimizer.trained(state.params)]
    v_row = tuple(state.opt_state["v_row"][names.index("blocks.wq")].shape)
    del one, state
    vcfg = vit.VIT_B16
    one = Trainer(vit.apply_fn(vcfg), lambda s: vit.init(vcfg, s, dev),
                  _dist_tc(), device=dev)
    state = one.init(0)
    batch = _vit_tp_batch(torch, dev)
    vit_losses = [float(one.step(state, *batch)[1])
                  for _ in range(RECIPE_STEPS)]
    del one, state, batch
    gc.collect()
    return {"ada": ada, "v_row": v_row, "vit": vit_losses}


def _mixtral_yardstick(torch) -> dict:
    """17g-b's one-device yardstick, before the gang, at the depth the
    card's free memory holds for the two ranks together (as 15a reckons
    one device): 15a's run where it ran at that depth, else 15a's
    training run (batch, seed, config) at that depth here. Its first
    RECIPE_STEPS losses, its peak over them and its routes, which it
    writes to MOE_YARDSTICK with the depth for the ranks to force (a bf16
    near-tie may route a token elsewhere on one side: a jump, not a
    rounding)."""
    from kubeflow_tpu_torch.models import llama_moe
    from kubeflow_tpu_torch.parallel import moe
    from kubeflow_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    free = torch.cuda.mem_get_info()[0]
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    cfg, _, _ = _moe_train_depth(llama_moe.MIXTRAL_8X7B, free)
    seen = MEASURED.get("moe_train")
    if seen and seen["layers"] == cfg.num_layers:
        want = {"losses": seen["losses"], "peak": seen["peak"],
                "routes": seen["routes"], "source": "phase 15a's run"}
    else:
        trainer = Trainer(lambda p, t: llama_moe.apply(p, cfg, t)[0], None,
                          _moe_tc(), loss_fn=llama_moe.loss_fn(cfg),
                          device=dev)
        state = trainer.init_from_params(llama_moe.init(cfg, 0, dev,
                                                        train=True))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch = _moe_batch(torch, dev, cfg.vocab_size)
        calls, top_k = [], moe._top_k
        moe._top_k = _route_probe(torch, calls)
        try:
            losses = [float(trainer.step(state, *batch)[1])
                      for _ in range(RECIPE_STEPS)]
        finally:
            moe._top_k = top_k
        want = {"losses": losses, "peak": torch.cuda.max_memory_allocated(),
                "routes": [idx.cpu() for idx, _ in calls],
                "source": "a one-device run in this phase"}
        del trainer, state, batch, calls
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(DIST_DIR, exist_ok=True)
    torch.save({"layers": cfg.num_layers, "routes": want["routes"]},
               MOE_YARDSTICK)
    return dict(want, layers=cfg.num_layers, free=free)


def _recipe_checks(torch, train, one_losses, one) -> dict:
    """17g: the recipes at tensor 2 against their one-device runs (the
    accumulation against 17f's full-batch run too), and their launches
    against the design. -> the flash launches (Mixtral's under its
    suffix)."""
    L = FSDP_LAYERS
    ranks = len(train)

    def design(layers, micro):
        return {"flash_attention_fwd": ranks * micro * layers * 2
                * RECIPE_STEPS,
                "flash_attention_dq": ranks * micro * layers * RECIPE_STEPS,
                "flash_attention_dkv": ranks * micro * layers * RECIPE_STEPS}

    def report(key, label, want_losses, tol, want_counts):
        t = train[0][key]
        errs = [abs(a - b) / abs(b) for a, b in zip(t["losses"],
                                                   want_losses)]
        per_step = [max(r[key]["step_s"][i] for r in train)
                    for i in range(RECIPE_STEPS)]
        st = max(r[key]["staged"]["seconds"] for r in train)
        gib = sum(r[key]["staged"]["bytes"] for r in train) / 2**30
        got = {k: n for k, n in _sum_counts(train, key).items()
               if k.startswith("flash")}
        log(f"  17g {label}, mesh (data 1, fsdp 1, tensor 2), "
            f"{RECIPE_STEPS} steps: losses {t['losses']} vs one device "
            f"{want_losses} (rel err {max(errs):.2e}, tol {tol}); step "
            f"{[round(x, 3) for x in per_step]} s (slowest rank), of which "
            f"host-staged collectives {st:.3f} s over the steps on the "
            f"slowest rank ({gib:.2f} GiB through the host); flash launches "
            f"{got} (design {want_counts})")
        if max(errs) > tol or any(x != x for x in t["losses"]):
            fail(f"17g {label}: tensor-parallel losses differ from one "
                 "device's")
        if {k: n for k, n in got.items() if n} != {
                k: n for k, n in want_counts.items() if n}:
            fail(f"17g {label}: flash launches {got}, the design implies "
                 f"{want_counts}")
        return got

    counts: dict = {}
    ada = train[0]["g_ada"]
    got = report("g_ada", f"(a) llama3-1b at full width, {L} of 16 layers, "
                 "Adafactor", one["ada"], RECIPE_LOSS_TOL, design(L, 1))
    log(f"  17g (a) Adafactor: wq's gathered v_row {ada['v_row']} vs one "
        f"device's {one['v_row']}; optimizer state a rank "
        f"{ada['opt_bytes']} B")
    if ada["v_row"] != one["v_row"]:
        fail(f"17g (a): wq's v_row gathered as {ada['v_row']}, one device "
             f"holds {one['v_row']}")
    for k, n in got.items():
        counts[k] = counts.get(k, 0) + n
    label = (f"(a) llama3-1b, AdamW at grad_accum {RECIPE_ACC} "
             f"(micro-batches of 1 x {FLASH_S})")
    got = report("g_acc", label + ", against 17f's full-batch steps on the "
                 "same mesh", train[0]["tp"]["losses"][:RECIPE_STEPS],
                 RECIPE_LOSS_TOL, design(L, RECIPE_ACC))
    acc = train[0]["g_acc"]["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(acc, one_losses))
    log(f"  17g {label} against one device {one_losses[:RECIPE_STEPS]}: "
        f"rel err {err:.2e} (tol {TRAIN_LOSS_TOL}, 17f's)")
    if err > TRAIN_LOSS_TOL:
        fail(f"17g {label}: losses differ from one device's")
    for k, n in got.items():
        counts[k] = counts.get(k, 0) + n

    m = train[0]["g_moe"]
    want = one["moe"]
    layers = want["layers"]
    peak = max(r["g_moe"]["peak"] for r in train)
    got = report("g_moe", f"(b) Mixtral-8x7B's widths, {layers} of 32 layers "
                 f"(the depth the card's {want['free'] / 2**30:.1f} GiB free "
                 f"holds for both ranks), on the routes of the yardstick, "
                 f"{want['source']}", want["losses"], TRAIN_LOSS_TOL,
                 design(layers, 1))
    steps = [[g for r in train for g in r["g_moe"]["flip_gaps"][i]]
             for i in range(RECIPE_STEPS)]
    # a token's routing at a layer, each rank, the forward and remat's rerun
    moved = len(steps[0]) / (ranks * 2 * layers * FLASH_B * FLASH_S)
    log(f"  17g (b) w_gate held as {m['w_gate']}; the router moved by "
        f"{m['router_moved']:.3e}; peak {peak / 2**30:.3f} GiB a rank vs "
        f"one device's {want['peak'] / 2**30:.3f} GiB; the init drew and "
        f"cut the params in {m['init_s']:.1f} s; choices the ranks would "
        f"have routed elsewhere, a step (2 x {layers} routings of "
        f"{FLASH_B * FLASH_S} tokens a rank): {[len(g) for g in steps]} at "
        f"router gaps up to {[round(max(g, default=0.0), 6) for g in steps]}"
        f" (at the initial weights a share {moved:.2e} of the routings, "
        f"at most MOE_EXCUSE_MAX {MOE_EXCUSE_MAX}; later the weights "
        f"differ by the steps' rounding)")
    if moved > MOE_EXCUSE_MAX:
        fail(f"17g (b): at the initial weights the ranks route a share "
             f"{moved:.2e} of the tokens elsewhere than one device, more "
             f"than rounding moves (MOE_EXCUSE_MAX {MOE_EXCUSE_MAX})")
    if m["calls"] != 2 * layers * RECIPE_STEPS:
        fail(f"17g (b): {m['calls']} routings, the design implies "
             f"{2 * layers * RECIPE_STEPS} (forward and remat a layer)")
    if m["w_gate"] != (layers, 4, 4096, 14336):
        fail(f"17g (b): w_gate held as {m['w_gate']}")
    if not m["router_moved"] > 0:
        fail("17g (b): the router did not move")
    if peak >= want["peak"]:
        fail(f"17g (b): a rank's peak {peak} B is not below one device's "
             f"{want['peak']} B")
    for k, n in got.items():
        counts[k + MIXTRAL_SUFFIX] = counts.get(k + MIXTRAL_SUFFIX, 0) + n

    v = train[0]["g_vit"]
    report("g_vit", f"(c) ViT-B/16, batch {VIT_TP_B}, 6 heads and 500 "
           "classes a rank (the plain attention at hd 64)", one["vit"],
           TRAIN_LOSS_TOL, {})
    log(f"  17g (c) wq held as {v['wq']}, the head as {v['head']}")
    if v["wq"] != (12, 768, 384) or v["head"] != (768, 500):
        fail(f"17g (c): wq held as {v['wq']}, the head as {v['head']}")
    return counts


def distributed_and_check(torch) -> dict:
    """Phase 17: the distributed set on the card, in gangs of worker
    processes on cuda:0. -> the flash kernels' launches over the
    ranks."""
    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.train import Trainer
    from kubeflow_tpu_torch.train.trainer import _leaves

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    log(f"  ranks: worker processes on cuda:0 in a gloo group over a "
        f"file:// store; their collectives stage through host memory "
        f"(NCCL refuses two ranks of one device); one rank also forms an "
        f"NCCL group")
    # the one NCCL rank runs beside the ring gang (the smoke's time)
    nccl_started = _start_gang("nccl", 1, backend="nccl")
    seq, seq_s = _spawn_gang(torch, "seq", RING_RANKS)
    if {r["backend"] for r in seq} != {"gloo"}:
        fail(f"phase 17: ring ranks on {[r['backend'] for r in seq]}")
    log(f"  17a/17b: {RING_RANKS} ranks, llama3-1b attention (n_q {N_Q}, "
        f"n_kv {N_KV}, hd {HD}), bf16, b 1, s {RING_S} "
        f"({RING_S // RING_RANKS} a rank), gang {seq_s:.1f} s")
    counts = _ring_checks(torch, dev, seq)

    cfg = _fsdp_cfg(torch)
    toks, tgts = _llama1b_batch(torch, dev, 17)
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = Trainer(lambda p, t: llama.apply(p, cfg, t),
                  lambda s: llama.init(cfg, s, dev, train=True),
                  _dist_tc(), device=dev)
    state = one.init(0)
    one_losses = []
    for _ in range(FSDP_STEPS):
        state, loss = one.step(state, toks, tgts)
        one_losses.append(float(loss))
    one_peak = torch.cuda.max_memory_allocated() - m0
    one_bytes = one.opt_state_bytes()
    one_params = sum(p.numel() * p.element_size()
                     for p in _leaves(state.params))
    del one, state
    # 17f's yardstick at gemma-2b's widths: the same run on one device
    gcfg = _gemma_tp_cfg(torch)
    gone = Trainer(lambda p, t: gemma.apply(p, gcfg, t),
                   lambda s: gemma.init(gcfg, s, dev, train=True),
                   _dist_tc(), device=dev)
    state = gone.init(0)
    gemma_losses = [float(gone.step(state, toks, tgts)[1])
                    for _ in range(TP_GEMMA_STEPS)]
    del gone, state
    gc.collect()
    one_recipes = _one_device_recipes(torch, dev)
    # the NCCL rank's memory is back before 17g-b reckons its depth from
    # the card's free memory
    nccl, nccl_s = _wait_gang(torch, nccl_started)
    one_recipes["moe"] = _mixtral_yardstick(torch)
    fsdp_cfg, cfg = cfg, llama.LLAMA3_1B
    params = llama.init(cfg, 0, dev, train=True)
    ptoks, ptgts = _pp_batch(torch, dev)
    with torch.no_grad():
        from kubeflow_tpu_torch.train.trainer import cross_entropy_loss

        dense_loss = float(cross_entropy_loss(
            llama.apply(params, cfg, ptoks), ptgts))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    train, train_s = _spawn_gang(torch, "train", 2)
    f = train[0]["fsdp"]
    errs = [abs(a - b) / abs(b) for a, b in zip(f["losses"], one_losses)]
    step_s = [max(r["fsdp"]["step_s"][i] for r in train)
              for i in range(FSDP_STEPS)]
    st = max(r["fsdp"]["staged"]["seconds"] for r in train)
    fl = _sum_counts(train, "fsdp")
    want = {"flash_attention_fwd": 2 * FSDP_LAYERS * 2 * FSDP_STEPS,
            "flash_attention_dq": 2 * FSDP_LAYERS * FSDP_STEPS,
            "flash_attention_dkv": 2 * FSDP_LAYERS * FSDP_STEPS}
    half = one_bytes / 2
    gib = sum(r["fsdp"]["staged"]["bytes"] for r in train) / 2**30
    log(f"  17c FSDP: llama3-1b at full width, {fsdp_cfg.num_layers} of 16 "
        f"layers (depth cut for the phase's time: FSDP_LAYERS), "
        f"mesh (data 1, fsdp 2), global batch {FLASH_B} x {FLASH_S}, "
        f"{FSDP_STEPS} steps: losses {f['losses']} vs one device "
        f"{one_losses} (rel err {max(errs):.2e}, tol {TRAIN_LOSS_TOL}); "
        f"wq held as {f['wq']}; optimizer state a rank "
        f"{f['opt_bytes']} B vs half the one-device run's {half:.0f} B; "
        f"step {[round(s, 3) for s in step_s]} s (slowest rank), of which "
        f"host-staged collectives {st:.3f} s over the {FSDP_STEPS} steps "
        f"on the slowest rank ({gib:.2f} GiB through the host); launches "
        f"{fl} (design {want})")
    # memory: each rank holds 1/2 of the params and moments the one
    # device holds, so its peak sits at least that far below the one
    # device's; and a forward through the mesh view leaves for the
    # backward only the once-gathered leaves more than the plain model's
    # forward on the same rows (one gathered layer's bytes of slack)
    peak = max(r["fsdp"]["peak"] for r in train)
    share = (1 - 1 / 2) * (one_params + one_bytes)
    res = [r["fsdp"]["residue"] for r in train]
    extra = max(x["view"] - x["plain"] for x in res)
    bound = res[0]["once"] + res[0]["layer"]
    log(f"  17c memory: peak {peak / 2**30:.3f} GiB a rank (above its "
        f"start) vs the one device's {one_peak / 2**30:.3f} GiB, which "
        f"less half its params and moments ({share / 2**30:.3f} GiB) "
        f"bounds it at {(one_peak - share) / 2**30:.3f} GiB; a forward "
        f"on a rank's rows leaves "
        f"{[round(x['view'] / 2**30, 3) for x in res]} GiB for the "
        f"backward through the mesh view vs "
        f"{[round(x['plain'] / 2**30, 3) for x in res]} GiB through the "
        f"plain model: {extra / 2**30:.3f} GiB more, bound "
        f"{bound / 2**30:.3f} GiB (the once-gathered leaves "
        f"{res[0]['once'] / 2**30:.3f} + one layer "
        f"{res[0]['layer'] / 2**30:.3f})")
    if max(errs) > TRAIN_LOSS_TOL:
        fail("17c: FSDP losses differ from the one-device run")
    if peak > one_peak - share:
        fail(f"17c: a rank's peak {peak} B is not below the one device's "
             f"{one_peak} B by half its params and moments ({share:.0f} B)")
    if extra > bound:
        fail(f"17c: the mesh view's forward leaves {extra} B more than the "
             f"plain forward, above the once-gathered leaves and one "
             f"layer ({bound} B): gathered layers outlive their blocks")
    if abs(f["opt_bytes"] - half) > 8 + 2 * len(llama.param_shapes(
            fsdp_cfg)):
        fail(f"17c: {f['opt_bytes']} B of optimizer state a rank, not "
             f"half of {one_bytes}")
    if any(fl.get(k) != n for k, n in want.items()):
        fail(f"17c: flash launches {fl}, the design implies {want}")
    _tensor_checks(train, one_losses, one_peak, gemma_losses)
    recipe_counts = _recipe_checks(torch, train, one_losses, one_recipes)
    p = train[0]["pp"]
    per = cfg.num_layers // 2
    ticks = PP_MICRO + 2 - 1
    pwant = {"flash_attention_fwd": 2 * (ticks + PP_MICRO) * per,
             "flash_attention_dq": 2 * PP_MICRO * per,
             "flash_attention_dkv": 2 * PP_MICRO * per}
    pl = _sum_counts(train, "pp")
    perr = abs(p["loss"] - dense_loss) / abs(dense_loss)
    log(f"  17d pipeline: llama3-1b over 2 stages ({per} layers a rank, "
        f"wq held as {p['wq']}), {PP_MICRO} microbatches of 1 x {FLASH_S}: "
        f"loss {p['loss']:.6f} vs the dense forward's {dense_loss:.6f} "
        f"(rel err {perr:.2e}, tol {TRAIN_LOSS_TOL}); step "
        f"{max(r['pp']['step_s'] for r in train):.3f} s, host-staged "
        f"{max(r['pp']['staged']['seconds'] for r in train):.3f} s; "
        f"launches {pl} (design {pwant}: {ticks} ticks x {per} forward, "
        f"{PP_MICRO} x {per} recomputed and {PP_MICRO} x {per} dQ, dK/dV, "
        f"a rank)")
    if perr > TRAIN_LOSS_TOL:
        fail("17d: the pipelined loss differs from the dense loss")
    if any(pl.get(k) != n for k, n in pwant.items()):
        fail(f"17d: flash launches {pl}, the design implies {pwant}")
    for r in train:
        e = r["ep"]
        log(f"  17e EP rank: experts held {e['experts']}, {EP_TOKENS} "
            f"tokens; rel L2 vs moe_mlp on its block {e['errs']} (y tol "
            f"{EP_OUT_TOL}, gradients {EP_GRAD_TOL}); aux {e['aux']:.6f} "
            f"vs {e['aux_ref']:.6f}; forward+backward {e['s'] * 1e3:.1f} "
            f"ms, host-staged {e['staged']['seconds'] * 1e3:.1f} ms")
        errs = dict(e["errs"])
        if errs.pop("y") > EP_OUT_TOL or max(errs.values()) > EP_GRAD_TOL:
            fail(f"17e: expert parallelism disagrees with moe_mlp on the "
                 f"rank's block: {e['errs']}")
        if abs(e["aux"] - e["aux_ref"]) > 1e-3 * abs(e["aux_ref"]):
            fail("17e: the aux loss is not the global batch's")
    for name, suffix in (("fsdp", ""), ("pp", ""), ("tp", ""),
                         ("tp_gemma", GEMMA)):
        for k, n in _sum_counts(train, name).items():
            counts[k + suffix] = counts.get(k + suffix, 0) + n
    for k, n in recipe_counts.items():
        counts[k] = counts.get(k, 0) + n

    n = nccl[0]
    nerr = abs(n["loss"] - one_losses[0]) / abs(one_losses[0])
    log(f"  one-rank NCCL group ({n['backend']}): ring flash launches "
        f"{n['counts']}, equal to flash_attention {n['ring_equal']}; an "
        f"FSDP step's loss {n['loss']:.6f} vs one device "
        f"{one_losses[0]:.6f} (rel err {nerr:.2e}); gang {nccl_s:.1f} s")
    if n["backend"] != "nccl" or not n["ring_equal"] or nerr > \
            TRAIN_LOSS_TOL:
        fail("phase 17: the one-rank NCCL group disagrees")
    for k, c in n["counts"].items():
        counts[k] = counts.get(k, 0) + c
    log(f"  phase 17 {time.perf_counter() - t_phase:.1f} s (ring gang "
        f"{seq_s:.1f}, train gang {train_s:.1f}, nccl {nccl_s:.1f})")
    return counts


# -- phase 18 ----------------------------------------------------------------

ELASTIC_DIR = os.path.join(ROOT, "build", "phase18")
FP32_LAYERS, FP32_B, FP32_STEPS = 2, 1, 3   # 18a: 2 of gemma-2b's 18
ELASTIC_STEPS, ELASTIC_SAVE_AT = 4, 2       # 18b
# 18b at full width, 4 of llama3-1b's 16 layers: the depth is cut for the
# smoke's time (a 16-layer state is an 18.4 GB checkpoint: 36.7 s of save
# and wait and an 11.0 s restore in a whole run on an NVIDIA H100 80GB
# HBM3 at 700 W on a slow host)
ELASTIC_LAYERS = 4
RESIZE_STEPS, RESIZE_MORE = 3, 2            # 18c
GANG_WORKERS, GANG_STEPS, GANG_SAVE_EVERY = 3, 16, 4   # 18d
# the chief is killed in its first save at or past GANG_KILL_AT (step 8
# unless a busy host makes the poll miss that save's window)
GANG_KILL_AT, GANG_SLOW_SAVE_S = 8, 1.0
GANG_TIMEOUT = 240
# Replayed and restarted losses against the first run's on the card:
# bit-equal in every card run so far (the flash kernels, cuBLAS at fixed
# shapes and the sorted accumulation of the embedding's gradient are
# deterministic on one card; NVIDIA H100 80GB HBM3, 700 W). The check
# holds them to the training checks' TRAIN_LOSS_TOL and logs the largest
# |diff| and how many were bit-equal, so a card or library whose step is
# not bit-deterministic fails only past the training bound.
ELASTIC_LOSS_TOL = TRAIN_LOSS_TOL
GOODPUT_TOL = 0.01                 # the ledger's causes vs its wall


def fp32_gemma_and_check(torch):
    """18a: gemma-2b's widths trained in fp32 (`dtype=float32`: fp32
    activations, so the attention takes the fp32 CUDA-core flash kernels
    at head dim 256), 2 of its 18 layers, batch 1 x 2048, 3 steps, against
    the plain attention path from the same weights; exact launches."""
    import math

    from kubeflow_tpu_torch.models import gemma
    from kubeflow_tpu_torch.ops import attention
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    import numpy as np

    dev = torch.device("cuda")
    cfg = dataclasses.replace(gemma.GEMMA_2B, num_layers=FP32_LAYERS,
                              dtype=torch.float32)
    b, s = FP32_B, FLASH_S
    rng = np.random.default_rng(18)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    plain_positions = torch.arange(s, device=dev).expand(b, s)

    def run(positions):
        trainer = Trainer(
            apply_fn=lambda p, t: gemma.apply(p, cfg, t, positions=positions),
            init_fn=lambda seed: gemma.init(cfg, seed, dev, train=True),
            train_config=TrainConfig(warmup_steps=1, total_steps=100),
            device=dev)
        state = trainer.init(0)
        losses = []
        t0 = time.perf_counter()
        for _ in range(FP32_STEPS):
            state, loss = trainer.step(state, tokens, targets)
            losses.append(float(loss))
        return losses, time.perf_counter() - t0

    plain, plain_s = run(plain_positions)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    attention.reset_impl_counts()
    losses, kernel_s = run(None)
    counts = launch_counts()
    impl = attention.impl_counts()
    gc.collect()
    torch.cuda.empty_cache()
    diff = max(abs(a - p) for a, p in zip(losses, plain))
    log(f"  gemma-2b widths, {FP32_LAYERS} layers, fp32, batch {b} x {s}: "
        f"losses {[round(x, 5) for x in losses]}, plain path "
        f"{[round(x, 5) for x in plain]}, max |diff| {diff:.2e} (tol "
        f"{TRAIN_LOSS_TOL}); {FP32_STEPS} steps {kernel_s:.2f} s through "
        f"the kernels, {plain_s:.2f} s plain (host clock, first steps "
        f"included)")
    log(f"  attention impl counts {impl}; kernel launches {counts}")
    steps = FP32_STEPS
    expect = {"flash_attention_fwd": 2 * cfg.num_layers * steps,
              "flash_attention_dq": cfg.num_layers * steps,
              "flash_attention_dkv": cfg.num_layers * steps}
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"18a {name}: {counts[name]} launches, the design implies "
                 f"{n} (remat: forward + recompute)")
    if impl["flash"] == 0 or impl["torch"] != 0:
        fail(f"18a did not route every attention call through the fp32 "
             f"flash kernels: {impl}")
    if not all(math.isfinite(x) for x in losses) or diff > TRAIN_LOSS_TOL:
        fail(f"18a fp32 kernel-path losses {losses} against the plain "
             f"path's {plain}")
    return {name: n for name, n in counts.items() if name in expect}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _loss_match(got, want) -> tuple[float, int]:
    """(max |diff|, how many bit-equal) of two loss lists."""
    return (max(abs(a - b) for a, b in zip(got, want)),
            sum(a == b for a, b in zip(got, want)))


def elastic_trainer_and_check(torch):
    """18b: the elastic worker's trainer (`elastic._build_trainer(1, ...)`)
    at llama3-1b's full width (phase 4's 2 x 2048, full remat) under a
    GoodputLedger and the Checkpointer, as a worker and its restarted
    incarnation run it: 4 steps with a save at step 2, then a rebuild,
    `restore_or_init` and steps 3-4 again."""
    import shutil

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.obs.tracing import Tracer
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.train import elastic
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        Checkpointer,
    )
    from kubeflow_tpu_torch.train.goodput import GoodputLedger

    dev = torch.device("cuda")
    ckdir = os.path.join(ELASTIC_DIR, "trainer")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    cfg = _fit_depth(dataclasses.replace(llama.LLAMA3_1B,
                                         num_layers=ELASTIC_LAYERS),
                     shutil.disk_usage(ckdir).free)
    b, s = FLASH_B, FLASH_S
    ledger = GoodputLedger(peak_flops_per_s=BF16_FLOPS_S)
    reg = Registry()
    times = {}

    def build():
        with ledger.book("compile"):
            trainer = elastic._build_trainer(1, cfg, registry=reg,
                                             tracer=Tracer(), device=dev)
        ckpt = Checkpointer(CheckpointConfig(
            ckdir, save_interval_steps=ELASTIC_SAVE_AT, enable_async=True),
            trainer, run_metadata={"replica": "smoke"}, registry=reg)
        with ledger.book("checkpoint_restore"):
            t0 = time.perf_counter()
            state = ckpt.restore_or_init(0)
            torch.cuda.synchronize()
            times.setdefault("restore_s", []).append(time.perf_counter() - t0)
        ledger.note_restore(int(state.step))
        return trainer, ckpt, state

    def steps(trainer, ckpt, state, until):
        losses = []
        while state.step < until:
            step = state.step
            toks, tgts = elastic._deterministic_batch(cfg.vocab_size, b, s,
                                                      0, step)
            compiling = not trainer._stepped
            t0 = time.perf_counter()
            state, loss = trainer.step(state, torch.as_tensor(toks),
                                       torch.as_tensor(tgts))
            losses.append(float(loss))
            ledger.note_step(step, time.perf_counter() - t0,
                             tokens=b * s, flops=trainer.step_flops(b, s),
                             compiling=compiling)
            if state.step == ELASTIC_SAVE_AT and "save_s" not in times:
                with ledger.book("checkpoint_save"):
                    t0 = time.perf_counter()
                    ckpt.save(state, force=True)
                    times["save_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    ckpt.wait()        # the write, fsync and commit
                    times["wait_s"] = time.perf_counter() - t0
        return state, losses

    reset_launch_counts()
    trainer, ckpt, state = build()
    state, first = steps(trainer, ckpt, state, ELASTIC_STEPS)
    ckpt.close()
    saved = _dir_bytes(ckpt.step_path(ELASTIC_SAVE_AT))
    del trainer, ckpt, state
    gc.collect()
    torch.cuda.empty_cache()
    trainer, ckpt, state = build()     # the restarted incarnation
    if state.step != ELASTIC_SAVE_AT:
        fail(f"18b restored step {state.step}, not {ELASTIC_SAVE_AT}")
    state, replay = steps(trainer, ckpt, state, ELASTIC_STEPS)
    ckpt.close()
    counts = launch_counts()
    snap = ledger.snapshot()
    del trainer, ckpt, state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)
    diff, same = _loss_match(replay, first[ELASTIC_SAVE_AT:])
    booked = sum(snap["seconds"].values())
    log(f"  llama3-1b ({cfg.num_layers} layers), batch {b} x {s}: losses "
        f"{[round(x, 5) for x in first]}; replayed steps "
        f"{ELASTIC_SAVE_AT + 1}-{ELASTIC_STEPS} "
        f"{[round(x, 5) for x in replay]}: max |diff| {diff:.2e}, "
        f"{same} of {len(replay)} bit-equal (tol {ELASTIC_LOSS_TOL})")
    log(f"  checkpoint of step {ELASTIC_SAVE_AT}: {saved} bytes written; "
        f"save {times['save_s']:.2f} s (device-to-host copy and dispatch), "
        f"write + commit wait {times['wait_s']:.2f} s, restores "
        + ", ".join(f"{x:.2f}" for x in times["restore_s"]) + " s")
    log("  goodput ledger: " + ", ".join(
        f"{c} {v:.3f}" for c, v in snap["seconds"].items())
        + f" s; wall {snap['wall_seconds']:.3f} s, booked {booked:.3f} s, "
        f"goodput fraction {snap['goodput_fraction']:.4f}, "
        f"{snap['productive_steps']} productive and {snap['replay_steps']} "
        f"replayed steps, {snap['tokens_per_second']:.0f} tokens/s, MFU "
        f"{snap['mfu']:.1%} (host clock)")
    per_step = {"flash_attention_fwd": 2, "flash_attention_dq": 1,
                "flash_attention_dkv": 1}
    n = ELASTIC_STEPS + (ELASTIC_STEPS - ELASTIC_SAVE_AT)
    want = {k: v * cfg.num_layers * n for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    log(f"  flash launches {got} over {n} steps")
    if got != want:
        fail(f"18b flash launches {got}, the design implies {want}")
    if diff > ELASTIC_LOSS_TOL:
        fail(f"18b replayed losses {replay} against {first}")
    # the rebuilt trainer's first step books to compile (a fresh
    # trainer's first step), the rest of the re-run to replay
    if snap["replay_steps"] != ELASTIC_STEPS - ELASTIC_SAVE_AT - 1 \
            or not snap["seconds"]["replay"] > 0:
        fail(f"18b: the replayed steps were not booked to replay: {snap}")
    if abs(booked - snap["wall_seconds"]) > GOODPUT_TOL * \
            snap["wall_seconds"] or not snap["conserved"]:
        fail(f"18b: the ledger's causes do not sum to its wall: {snap}")
    return got


def _dist_resize(torch, rank, world):
    """18c on each of 2 ranks on cuda:0: llama3-1b at full width and
    FSDP_LAYERS layers on (data 2, fsdp 1) with ZeRO moments, 3 steps and
    a save, then RESIZE_MORE steps on the mesh (the uninterrupted run);
    rank 0 then restores the checkpoint into a one-device trainer, holds
    its moments against the mesh's gathered ones bit for bit and steps
    it RESIZE_MORE times."""
    import logging

    import torch.distributed as dist

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh
    from kubeflow_tpu_torch.train import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        Checkpointer,
    )

    dev = torch.device("cuda")
    lines = []

    class Catch(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    ckpt_log = logging.getLogger("kubeflow_tpu_torch.train.checkpoint")
    ckpt_log.addHandler(Catch())
    ckpt_log.setLevel(logging.INFO)
    cfg = _fsdp_cfg(torch)
    tc = TrainConfig(warmup_steps=1, total_steps=100, zero_optimizer=True)
    mesh = create_mesh(MeshSpec(data=world, fsdp=1), device_type="cuda")

    def trainer_on(m):
        return Trainer(lambda p, t: llama.apply(p, cfg, t),
                       lambda seed: llama.init(cfg, seed, dev, train=True),
                       tc, device=dev, mesh=m,
                       logical_axes=llama.param_logical_axes(cfg))

    trainer = trainer_on(mesh)
    state = trainer.init(0)
    toks, tgts = _llama1b_batch(torch, dev, 18)
    reset_launch_counts()
    losses = []
    for _ in range(RESIZE_STEPS):
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
    ckdir = os.path.join(ELASTIC_DIR, "resize")
    # async: the disk write overlaps the gather below and the two steps;
    # close() commits it
    ckpt = Checkpointer(CheckpointConfig(ckdir, enable_async=True),
                        trainer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(state, force=True)
    save_s = time.perf_counter() - t0
    # on the host: the card is shared with 18b and 18d meanwhile
    saved = {slot: [t.to("cpu") for t in v] if isinstance(v, list) else v
             for slot, v in trainer.gather_opt_state(state).items()}
    local_mu = tuple(state.opt_state["mu"][0].shape)
    for _ in range(RESIZE_MORE):
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
    t0 = time.perf_counter()
    ckpt.close()
    out = {"losses": losses, "save_s": save_s, "local_mu": local_mu,
           "close_s": time.perf_counter() - t0,
           "bytes": _dir_bytes(ckpt.step_path(RESIZE_STEPS))
           if rank == 0 else 0}
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        one = trainer_on(None)
        ck1 = Checkpointer(CheckpointConfig(ckdir), one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ck1.restore()
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["stamp"] = (ck1.restore_metadata()["virtual_replicas"],
                        ck1.virtual_replicas)
        out["moments_equal"] = all(
            torch.equal(a.to("cpu"), b) for slot in one.optimizer.slots
            for a, b in zip(restored.opt_state[slot], saved[slot]))
        out["count"] = (restored.opt_state["count"], saved["count"])
        del saved
        out["one_device"] = []
        for _ in range(RESIZE_MORE):
            restored, loss = one.step(restored, toks, tgts)
            out["one_device"].append(float(loss))
        del one, restored
        ck1.close()
    out["log"] = lines
    out["counts"] = launch_counts()
    dist.barrier()
    if rank == 0:
        import shutil

        shutil.rmtree(ckdir, ignore_errors=True)
    return out


def start_resize():
    """18c's gang, started: its two ranks are processes, host-bound on
    the staged collectives, so the phase runs 18a, 18b and 18d
    meanwhile."""
    import shutil

    shutil.rmtree(os.path.join(ELASTIC_DIR, "resize"), ignore_errors=True)
    return _start_gang("resize", 2)


def resize_and_check(torch, started) -> dict:
    """18c: resize-on-restore at full width: a 2-rank gloo gang's ZeRO
    checkpoint restored into one device."""
    res, wall_s = _wait_gang(torch, started)
    r0 = res[0]
    cfg = _fsdp_cfg(torch)
    got, want = r0["one_device"], r0["losses"][RESIZE_STEPS:]
    diff, same = _loss_match(got, want)
    log(f"  gang (data 2, ZeRO) at {cfg.num_layers} layers: losses "
        f"{[round(x, 5) for x in r0['losses']]}; rank 0's moment of the "
        f"embedding {r0['local_mu']}; save {r0['save_s']:.2f} s "
        f"({r0['bytes']} bytes: the gather from the ranks and the "
        f"device-to-host copy), close {r0['close_s']:.2f} s (the rest of "
        f"the write, after 2 steps, and the commit); {wall_s:.1f} s for "
        f"the gang")
    log(f"  one device restored the checkpoint in {r0['restore_s']:.2f} s: "
        f"stamp saved {r0['stamp'][0]}, restored {r0['stamp'][1]}; "
        f"moments bit-equal {r0['moments_equal']}, count {r0['count']}; "
        f"then {[round(x, 5) for x in got]} against the gang's "
        f"{[round(x, 5) for x in want]}: max |diff| {diff:.2e}, {same} "
        f"bit-equal (tol {TRAIN_LOSS_TOL})")
    resize_lines = [x for x in r0["log"] if "resize-on-restore" in x]
    log(f"  resize log: {resize_lines}")
    if not r0["moments_equal"] or r0["count"][0] != r0["count"][1]:
        fail("18c: the restored moments differ from the saved ones")
    if r0["stamp"] != (2, 1) or not any(
            "saved at 2 virtual replicas, restored at 1" in x
            for x in resize_lines):
        fail(f"18c: stamp {r0['stamp']}, log {resize_lines}")
    if r0["local_mu"][0] * 2 != LLAMA_1B_VOCAB:
        fail(f"18c: rank 0's embedding moment {r0['local_mu']} is not a "
             "ZeRO half")
    if diff > TRAIN_LOSS_TOL:
        fail(f"18c: one-device losses {got} against the gang's {want}")
    counts = _sum_counts(res)
    n_mesh = 2 * (RESIZE_STEPS + RESIZE_MORE) + RESIZE_MORE
    want_counts = {"flash_attention_fwd": 2 * cfg.num_layers * n_mesh,
                   "flash_attention_dq": cfg.num_layers * n_mesh,
                   "flash_attention_dkv": cfg.num_layers * n_mesh}
    got_counts = {k: counts[k] for k in want_counts}
    if got_counts != want_counts:
        fail(f"18c flash launches {got_counts}, the design implies "
             f"{want_counts}")
    return got_counts


def _http_json(url: str, body=None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None
                                 else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        text = r.read().decode()
    return json.loads(text) if url.split("/")[-1] != "metrics" else text


def elastic_gang_and_check(torch):
    """18d: the coordinator CLI (--min-replicas 2) and GANG_WORKERS
    worker CLIs on cuda:0 at the reference's defaults (llama-tiny, batch
    12, seq 16, 16 steps, a save every 4); the chief is SIGKILLed while
    /elastic/world shows it saving at step GANG_KILL_AT or later."""
    import shutil
    import signal

    from kubeflow_tpu_torch import obs

    gdir = os.path.join(ELASTIC_DIR, "gang")
    shutil.rmtree(gdir, ignore_errors=True)
    os.makedirs(gdir)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    mod = [sys.executable, "-m", "kubeflow_tpu_torch.train.elastic"]
    # every process logs to a file of its own (a pipe nobody reads would
    # fill and block the writer: the coordinator logs each request)
    logs = {}

    def start(name, args, stdout=subprocess.DEVNULL):
        logs[name] = open(os.path.join(gdir, f"{name}.log"), "w")
        procs[name] = subprocess.Popen(mod + args, env=env, stdout=stdout,
                                       stderr=logs[name], text=True)

    def tail(name):
        logs[name].flush()
        with open(logs[name].name) as f:
            return f.read()[-3000:]

    procs = {}
    start("coordinator", ["coordinator", "--port", str(port),
                          "--min-replicas", "2"])
    rids = [f"tr{i}" for i in range(GANG_WORKERS)]
    t0 = time.perf_counter()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                _http_json(url + "/elastic/world")
                break
            except OSError:
                if time.monotonic() > deadline:
                    fail(f"18d: the coordinator never answered: "
                         f"{tail('coordinator')}")
                time.sleep(0.1)
        for rid in rids:
            start(rid, ["worker", "--coordinator", url, "--replica-id", rid,
                        "--ckpt-dir", os.path.join(gdir, "ckpt"),
                        "--steps", str(GANG_STEPS),
                        "--save-every", str(GANG_SAVE_EVERY),
                        "--slow-save-s", str(GANG_SLOW_SAVE_S),
                        "--loss-log", os.path.join(gdir, f"{rid}.jsonl")],
                  stdout=subprocess.PIPE)
        want = _gang_oracle(torch)
        deadline = time.monotonic() + GANG_TIMEOUT
        while True:
            w = _http_json(url + "/elastic/world")
            if w["phases"].get("tr0") == "saving" and \
                    (w["steps"].get("tr0") or 0) >= GANG_KILL_AT:
                break
            if procs["tr0"].poll() is not None or \
                    time.monotonic() > deadline:
                fail(f"18d: tr0 never saved at step {GANG_KILL_AT} or "
                     f"later: {w}; {tail('tr0')}")
            time.sleep(0.01)
        gen_at_kill, kill_step = w["generation"], w["steps"]["tr0"]
        procs["tr0"].send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        survivors = rids[1:]
        fed = traces = None
        while fed is None:
            w = _http_json(url + "/elastic/world")
            live = (w["generation"] > gen_at_kill
                    and w["members"] == survivors
                    and all((w["steps"].get(r) or 0) > kill_step
                            for r in survivors))
            if live:
                fed = _http_json(url + "/elastic/metrics")
                traces = _http_json(url + "/elastic/traces")
                # while the survivors are members: once they finish and
                # stop beating, their departure is one more change
                metrics = _http_json(url + "/metrics")
                world = w
            elif any(procs[r].poll() is not None for r in survivors) or \
                    time.monotonic() > deadline:
                fail(f"18d: the survivors never resumed past step "
                     f"{kill_step}: {w}")
            time.sleep(0.02)
        results = {}
        for rid in survivors:
            out, _ = procs[rid].communicate(timeout=GANG_TIMEOUT)
            if procs[rid].returncode != 0:
                fail(f"18d: {rid} exited {procs[rid].returncode}: "
                     f"{tail(rid)}")
            results[rid] = json.loads(out.strip().splitlines()[-1])
        resume_s = time.perf_counter() - t_kill
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()
        for f in logs.values():
            f.close()
    wall_s = time.perf_counter() - t0
    fams = obs.parse_exposition(metrics)
    restarts = fams["train_restarts_total"]["samples"][
        ("train_restarts_total", ())]
    fed_fams = obs.parse_exposition(fed)
    up = {dict(k[1])["replica"]: v
          for k, v in fed_fams["fleet_federation_up"]["samples"].items()}
    booked = sum(fed_fams["train_goodput_seconds_total"]["samples"].values())
    tracks = {e["args"]["name"] for e in traces["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "process_name"}
    lines = {rid: [json.loads(x) for x in open(
        os.path.join(gdir, f"{rid}.jsonl"))] for rid in rids}
    diffs = [abs(x["loss"] - want[x["step"] - 1])
             for ls in lines.values() for x in ls]
    equal = sum(d == 0 for d in diffs)
    log(f"  coordinator and {GANG_WORKERS} workers on cuda:0: tr0 killed "
        f"while saving step {kill_step} (generation {gen_at_kill} -> "
        f"{world['generation']}); survivors resumed and finished "
        f"{resume_s:.1f} s after the kill; {wall_s:.1f} s in all")
    log(f"  train_restarts_total {restarts}; /elastic/metrics: "
        f"fleet_federation_up {up}, goodput seconds booked {booked:.3f}; "
        f"/elastic/traces tracks {sorted(tracks)}")
    log(f"  {len(diffs)} loss lines against a one-worker uninterrupted run: "
        f"max |diff| {max(diffs):.2e}, {equal} bit-equal (tol "
        f"{ELASTIC_LOSS_TOL})")
    for rid, res in results.items():
        book = res["goodput"]
        log(f"  {rid}: restores {res['restores']}, generation "
            f"{res['generation']}, goodput fraction "
            f"{book['goodput_fraction']:.4f}, seconds " + ", ".join(
                f"{c} {v:.3f}" for c, v in book["seconds"].items())
            + f"; {book['productive_steps']} productive, "
            f"{book['replay_steps']} replayed steps")
    shutil.rmtree(gdir, ignore_errors=True)
    if restarts != 1 or world["generation"] <= gen_at_kill:
        fail(f"18d: restarts {restarts}, generation {world['generation']}")
    # a worker restores once at its start, again for each generation it
    # sees move (a member joining after the world formed, the kill)
    if any(res["final_step"] != GANG_STEPS or res["restores"] < 2
           or res["generation"] != world["generation"]
           for res in results.values()):
        fail(f"18d: survivors' results {results}")
    if {x["step"] for r in survivors for x in lines[r]} != \
            set(range(1, GANG_STEPS + 1)):
        fail("18d: the survivors' loss lines do not cover every step")
    if max(diffs) > ELASTIC_LOSS_TOL:
        fail(f"18d: loss lines off the uninterrupted run by {max(diffs)}")
    if up.get("tr1") != 1.0 or up.get("tr2") != 1.0 or not booked > 0:
        fail(f"18d: /elastic/metrics did not federate the workers: {up}")
    if tracks != set(survivors):
        fail(f"18d: /elastic/traces merged {tracks}")
    if any(not res["goodput"]["conserved"] for res in results.values()):
        fail("18d: a survivor's goodput ledger does not conserve")


def _gang_oracle(torch):
    """One worker's uninterrupted losses on the card: the worker's
    trainer and batches, in this process."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.train import elastic

    cfg = llama.LLAMA_TINY
    trainer = elastic._build_trainer(1, cfg, registry=Registry(),
                                     device=torch.device("cuda:0"))
    state = trainer.init(0)
    losses = []
    for step in range(GANG_STEPS):
        toks, tgts = elastic._deterministic_batch(cfg.vocab_size, 12, 16, 0,
                                                  step)
        state, loss = trainer.step(state, torch.as_tensor(toks),
                                   torch.as_tensor(tgts))
        losses.append(float(loss))
    return losses


def planner_and_check(torch):
    """18e: the planner's estimate for phase 4's run beside phase 4's
    measured peak (a finding: the planner's budget is a TPU chip's)."""
    from kubeflow_tpu_torch.tools import memplan

    got = memplan.plan("llama3-1b", {"data": 1, "fsdp": 1, "tensor": 1},
                       FLASH_B, FLASH_S, "v5p")
    gb = got["per_chip_gb"]
    peak = MEASURED.get("phase4_peak")
    if peak is None:
        log(f"  plan per chip (GB): {gb}; phase 4 did not run: no measured "
            f"peak to set beside it")
        return
    log(f"  plan per chip (GB): {gb}; phase 4's measured peak "
        f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated): "
        f"estimate / measured {gb['total'] * 1e9 / peak:.3f}")


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _device_events(prof):
    """The profile's device events. Only these count: a host op (aten::mm,
    an autograd node) may also carry the device time of the kernels it
    launched, which would count them twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def _report_profile(prof, wall_s: float, top: int = 8) -> None:
    """Device busy share, the kernels that take the device time, and the
    port's own kernels below those."""
    events = _device_events(prof)
    total_us = sum(_dev_us(e) for e in events)
    if not events:
        log("  profile: no device time recorded (not measured)")
        return
    log(f"  profile (profiler on): wall {wall_s:.3f} s, device busy "
        f"{total_us / 1e6:.3f} s = {total_us / 1e6 / wall_s:.1%}")
    ranked = sorted(events, key=_dev_us, reverse=True)
    for i, e in enumerate(ranked):
        if i < top or any(k in e.key for k in PORT_KERNELS):
            log(f"    {_dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def _phases(argv) -> set[str]:
    """`--phases 1,8` runs those phases only (a debugging call: no
    result line); no arguments run them all."""
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--phases", default="",
                   help="comma-separated phases to run (default: all; a "
                        "partial run prints no result line)")
    args = p.parse_args(argv)
    return set(args.phases.split(",")) if args.phases else set()


def main() -> None:
    import shutil

    import torch

    if sys.argv[1:2] == ["--replica"]:
        # phase 13's replica process: `--replica OUT -- <CLI args>`
        replica_main(sys.argv[2], sys.argv[4:])
        return
    if sys.argv[1:2] == ["--dist-worker"]:
        # one rank of phase 17's gang
        dist_worker_main(sys.argv[2:])
        return
    only = _phases(sys.argv[1:])

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs the card")
    sys.path.insert(0, ROOT)
    try:
        from kubeflow_tpu_torch.ops.cuda import _build
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    def run(phase: str) -> bool:
        go = not only or phase in only
        if go:
            log(f"[{time.perf_counter() - t_all:.1f} s] phase {phase}")
        return go

    log("phase 1: build")
    build_s = _build.build_all()
    log(f"  nvcc built {len(_build.KERNELS)} kernels in {build_s:.1f} s")
    for name, report in _build.ptxas_reports.items():
        # registers and spills of every instantiation (ptxas -v)
        log(f"  ptxas {name}: " + "; ".join(sorted(
            {ln.strip() for ln in report.splitlines()
             if "Used" in ln or "spill" in ln})))

    stats, counts = {}, {}
    if run("2"):
        log("phase 2: kernels against their plain versions (llama3-1b "
            "shapes)")
        stats = {"paged_decode_attention": check_decode(torch, dev),
                 "paged_prefill_append": check_prefill(torch, dev)[0],
                 **check_flash(torch, dev),
                 "decode_attention": check_dense_decode(torch, dev)[0]}
        log("phase 2, verify: prefill-append at the speculative verify "
            "pass's shape (llama3-8b heads)")
        stats[f"paged_prefill_append{VERIFY}"] = check_verify(torch, dev)
        log("phase 2, gemma-2b: the kernels at head dim 256, group 8")
        stats.update({
            f"paged_decode_attention{GEMMA}": check_decode(torch, dev,
                                                           GEMMA_2B),
            f"paged_prefill_append{GEMMA}": check_prefill(torch, dev,
                                                          GEMMA_2B)[0],
            **{name if name.endswith(FP32_256) else name + GEMMA: st
               for name, st in check_flash(torch, dev, GEMMA_2B).items()},
            f"decode_attention{GEMMA}": check_dense_decode(
                torch, dev, GEMMA_2B, GEMMA_2B)[0]})
        log("phase 2, gemma-2b verify: the verify pass's shape at head dim "
            "256, group 8")
        check_verify(torch, dev, GEMMA_2B)
        log("phase 2, mixtral: the flash kernels at Mixtral-8x7B's "
            "attention (n_q 32, n_kv 8, hd 128: group 4)")
        stats.update({name + MIXTRAL_SUFFIX: st for name, st in
                      check_flash(torch, dev, MIXTRAL).items()})
        log("phase 2, tensor 2: the flash kernels at a rank's heads under "
            "tensor parallelism (phases 17f's and 17g's shapes)")
        check_flash_tp(torch, dev)
        log("phase 2, tensor 2 serving: paged decode, prefill-append and "
            "dense decode at a rank's heads (phase 19's shapes)")
        stats.update(check_serving_tp(torch, dev))
        log("phase 2, int8_proj: the int8-weight projection at llama3-8b's "
            "and llama3-1b's projection shapes")
        stats["int8_proj"] = check_int8_proj(torch, dev)

    def add(got: dict, suffix: str = "", prefix: str = "") -> None:
        for name, n in got.items():
            if name.startswith(prefix):
                counts[name + suffix] = counts.get(name + suffix, 0) + n

    def tidy() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    if run("3"):
        log("phase 3: serve llama3-1b through the kernels (chunked "
            "prefill)")
        add(asyncio.run(serve_and_check(torch, chunked=True)))
        tidy()
        log("phase 3b: serve llama3-1b with monolithic admission")
        add(asyncio.run(serve_and_check(torch, chunked=False)),
            prefix="paged_decode")
        tidy()
        log("phase 3c: prefix reuse (radix cache, copy-on-write, spill "
            "tier)")
        for chunked in (True, False):
            add(asyncio.run(prefix_reuse_and_check(torch, chunked)),
                prefix="paged")
            tidy()

    if run("4"):
        log("phase 4: train llama3-1b through the flash kernels")
        add(train_and_check(torch), prefix="flash")
        tidy()

    if run("5"):
        log("phase 5: serve llama3-8b one-shot and speculatively")
        add(asyncio.run(serve_dense_and_check(torch)),
            prefix="decode_attention")
        tidy()

    if run("6"):
        log("phase 6: serve gemma-2b (chunked, monolithic, one-shot)")
        for chunked in (True, False):
            log(f"  continuous, {'chunked' if chunked else 'monolithic'}:")
            add(asyncio.run(serve_and_check(torch, chunked, "gemma-2b")),
                GEMMA, prefix="paged")
            tidy()
        log("  one-shot (window batcher, direct path):")
        add(asyncio.run(serve_dense_and_check(torch, "gemma-2b",
                                              spec=False)),
            GEMMA, prefix="decode_attention")
        tidy()

    if run("7"):
        log("phase 7: train gemma-2b through the flash kernels at head "
            "dim 256")
        add(train_gemma_and_check(torch), GEMMA, prefix="flash")
        tidy()

    if run("8"):
        log("phase 8: checkpoint llama3-1b from the trainer, then serve "
            "it through the door (stop, SSE, text, :score, timelines, "
            "/metrics)")
        cfg8, saved, train_counts, train_want = checkpoint_and_check(torch)
        if train_counts != train_want:
            fail(f"phase 8 training: flash launches {train_counts}, the "
                 f"design implies {train_want} (4 steps)")
        add(train_counts)
        door, one = asyncio.run(door_and_check(torch, cfg8, saved))
        add(door, prefix="paged")
        add(one, prefix="decode_attention")
        del saved
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        os.remove(os.path.join(ROOT, "build", "ckpt_tokenizer.json"))
        tidy()

    if run("9"):
        log("phase 9: serve llama3-8b with continuous speculative decoding "
            "(llama3-1b draft, gamma 4) through the CLI's app")
        spec_counts, off_counts = asyncio.run(serve_spec_and_check(torch))
        add(spec_counts)
        add(off_counts, prefix="paged")
        tidy()

    if run("10"):
        log("phase 10a: llama3-1b as a multi-tenant replica (fair share, "
            "batch-class preemption, namespaced radix, rate limits)")
        add(asyncio.run(tenancy_and_check(torch)))
        tidy()
        log("phase 10b: instant drain, live KV-block migration from replica "
            "A to replica B")
        add(asyncio.run(migration_and_check(torch)))
        tidy()

    if run("11"):
        log("phase 11: the fleet plane (prefill handoff, peer block fetch, "
            "live reload under CUDA graphs, heartbeats)")
        add(asyncio.run(fleet_and_check(torch)))
        tidy()

    # phase 13's replica comes up beside phase 12
    replica = start_replica() if (not only or "13" in only) else None
    if run("12"):
        t12 = time.perf_counter()
        log("phase 12a: llama3-8b one-shot under --quant int8 (the "
            "int8_proj kernel)")
        add(asyncio.run(quant_oneshot_and_check(torch)), prefix="int8")
        tidy()
        for quant in (False, True):
            log(f"phase 12b: llama3-1b continuous with a LoRA adapter pack "
                f"({'int8' if quant else 'bf16'} weights)")
            add(asyncio.run(adapters_and_check(torch, quant)),
                prefix="int8")
            tidy()
        log(f"phase 12 {time.perf_counter() - t12:.1f} s")

    if run("13"):
        log("phase 13: replay open-loop traces from the scenario engine "
            "against llama3-1b served by the CLI in a subprocess")
        add(replay_and_check(replica), prefix="paged")

    if run("14"):
        tidy()
        log("phase 14: serve the MoE family at Mixtral-8x7B's widths, 16 "
            "layers (chunked, monolithic, one-shot)")
        add(asyncio.run(serve_moe_and_check(torch)))
        tidy()

    if run("15"):
        tidy()
        t15 = time.perf_counter()
        log("phase 15a: train the MoE family at Mixtral-8x7B's widths "
            "through the flash kernels (group 4)")
        train_counts, fp32_counts = moe_train_and_check(torch)
        add(train_counts, MIXTRAL_SUFFIX)
        add(fp32_counts, FP32_128)
        tidy()
        log("phase 15b: llama3-1b under the remat policies full, mlp and "
            "dots")
        add(remat_policies_and_check(torch))
        tidy()
        log("phase 15c: llama3-1b trained by Adafactor and by LoRA over a "
            "frozen base; the trained adapters served")
        add(adafactor_lora_and_check(torch))
        tidy()
        log(f"phase 15 {time.perf_counter() - t15:.1f} s")

    if run("16"):
        tidy()
        t16 = time.perf_counter()
        log("phase 16a: the data story at llama3-1b (prepare_data, the "
            "native encoder and loader, training from shards, eval_ppl)")
        add(data_story_and_check(torch), prefix="flash")
        tidy()
        log("phase 16b: ViT-B/16 fine-tune (card against CPU, bench.py's "
            "cell)")
        add(vit_and_check(torch))
        tidy()
        log("phase 16c: the MNIST MLP smoke and a local HPO sweep")
        add(mnist_hpo_and_check(torch))
        tidy()
        log(f"phase 16 {time.perf_counter() - t16:.1f} s")

    if run("17"):
        tidy()
        log("phase 17: the distributed set (ring and Ulysses over the "
            "flash kernels, FSDP, the pipeline, expert parallelism, "
            "tensor parallelism and the mesh trainer's recipes)")
        add(distributed_and_check(torch))
        tidy()

    if run("18"):
        tidy()
        t18 = time.perf_counter()
        sub = []

        def lap(name):
            sub.append(f"{name} {time.perf_counter() - t18:.1f}")

        resize = start_resize()
        log("phase 18a: gemma-2b's widths trained in fp32 through the fp32 "
            "flash kernels at head dim 256 (18c's gang runs meanwhile)")
        add(fp32_gemma_and_check(torch), FP32_256)
        tidy()
        lap("18a")
        log("phase 18b: the elastic worker's trainer at llama3-1b's full "
            "width under the goodput ledger, saved, restarted, replayed "
            "(18c's gang runs meanwhile)")
        add(elastic_trainer_and_check(torch))
        tidy()
        lap("18b")
        log("phase 18d: the elastic gang (coordinator and 3 workers on "
            "cuda:0, the chief killed mid-save; 18c's gang runs "
            "meanwhile)")
        elastic_gang_and_check(torch)
        tidy()
        lap("18d")
        log("phase 18c: resize-on-restore at full width (a 2-rank ZeRO "
            "gang's checkpoint into one device; started before 18a)")
        add(resize_and_check(torch, resize))
        tidy()
        lap("18c")
        log("phase 18e: the memory-fit planner beside phase 4's peak")
        planner_and_check(torch)
        log(f"phase 18 {time.perf_counter() - t18:.1f} s (at the end of "
            f"{', '.join(sub)} s)")

    if run("19"):
        tidy()
        log("phase 19: tensor-parallel serving, two ranks on cuda:0 stepped "
            "in lockstep by a gang behind the HTTP app (llama3-1b "
            "continuous, gemma-2b one-shot)")
        add(serving_tp_and_check(torch))
        tidy()

    log(f"total {time.perf_counter() - t_all:.1f} s")
    if only:
        log(f"partial run (phases {sorted(only)}): no result line")
        return
    flash = "kubeflow_tpu/ops/pallas/flash_attention.py"
    meta = {
        "paged_decode_attention": (
            "kubeflow_tpu_torch/csrc/paged_decode_attention.cu",
            "kubeflow_tpu/ops/pallas/paged_attention.py:123"),
        "paged_prefill_append": (
            "kubeflow_tpu_torch/csrc/paged_prefill_append.cu",
            "kubeflow_tpu/ops/pallas/prefill_append.py:173"),
        "flash_attention_fwd": (
            "kubeflow_tpu_torch/csrc/flash_attention_fwd.cu", f"{flash}:78"),
        "flash_attention_dq": (
            "kubeflow_tpu_torch/csrc/flash_attention_dq.cu", f"{flash}:186"),
        "flash_attention_dkv": (
            "kubeflow_tpu_torch/csrc/flash_attention_dkv.cu", f"{flash}:228"),
        "decode_attention": (
            "kubeflow_tpu_torch/csrc/decode_attention.cu",
            "kubeflow_tpu/ops/pallas/decode_attention.py:115"),
    }
    for name in ("paged_decode_attention", "paged_prefill_append",
                 "flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "decode_attention"):
        meta[name + GEMMA] = meta[name]
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        meta[name + MIXTRAL_SUFFIX] = meta[name]
        meta[name + FP32_256] = meta[name]
        meta[name + FP32_128] = meta[name]
    meta["paged_prefill_append" + VERIFY] = meta["paged_prefill_append"]
    for name in ("paged_decode_attention", "paged_prefill_append"):
        meta[name + TP2] = meta[name]
    meta["decode_attention" + GEMMA_TP2] = meta["decode_attention"]
    # no Pallas kernel: the card's counterpart of the reference's qdot
    meta["int8_proj"] = ("kubeflow_tpu_torch/csrc/int8_proj.cu",
                         "kubeflow_tpu/serving/quant.py:77")
    kernels = []
    for name, (source, replaces) in meta.items():
        s = stats[name]
        if not counts.get(name):
            fail(f"{name} was launched no time on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
        if name == "int8_proj":
            kernels[-1]["functions"] = list(INT8_FUNCTIONS)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
