#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubeflow_tpu_torch) on one
NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
1. build   — nvcc builds every kernel of the serving path from csrc/.
2. kernels — each CUDA kernel against its plain PyTorch version at
             llama3-1b shapes (n_q 16, n_kv 8, hd 128, block 64, bf16,
             max_len 1024, 8 slots): ragged cursors, a sliding window,
             copy-on-write-shared table prefixes, ragged q_lens with 0,
             and the path's own prefill shape (one row, 64-token slices
             at a 300-token prompt's cursors); then times kernel, plain
             version and one library call
             (SDPA over the gathered K/V, a yardstick the port never
             calls) and computes the card's bound for the same work.
3. serve   — boots the port's HTTP server in-process (the CLI's
             `--model llama3-1b --random --seed 0
             --prefill-chunk-tokens 64`), POSTs 4 `:generate` requests
             (prompts of 17, 130, 300 and again 17 tokens, max_new 16),
             with every kernel launch counter set to 0 just before and
             read just after; checks both kernels ran, the repeated
             prompt's greedy tokens are identical, and every served
             token's logprob matches a teacher-forced pass of the plain
             dense model at the same weights. Prints the batcher's
             iterations and its host time per decode step and slice.
Then prints the `kernels` JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.

Exits non-zero without a result when CUDA is unavailable or the port's
package is not beside this script.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# llama3-1b serving geometry (models/llama.py, serving defaults)
N_Q, N_KV, HD, BS, MAX_LEN, SLOTS, CHUNK = 16, 8, 128, 64, 1024, 8, 64
NB = MAX_LEN // BS                 # blocks per slot
NUM_BLOCKS = 1 + SLOTS * NB        # trash + every slot at max_len
LAYERS = 16
HBM_BYTES_S = 3.35e12              # H100 SXM device memory rate
BF16_FLOPS_S = 989e12              # H100 SXM dense bf16 tensor rate
# Kernel vs plain version, bf16: both accumulate in fp32 and round the
# result once, so they differ by at most one bf16 ulp of it (<= 2**-7 of
# its value); the absolute floor covers fp32 summation order near 0. A
# cell dropped or added on a 1000-cell row (an error of ~|v|/1000, up to
# ~3e-3) exceeds it.
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 2**-7
TOL_TEXT = f"tol {KERNEL_ATOL} + 2^-7 |ref|"
LOGPROB_TOL = 0.1                  # served vs teacher-forced, bf16 model
PROMPT_LENS = (17, 130, 300, 17)
MAX_NEW = 16


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


def _summary(kind, worst, kernel, plain, library_ms, bytes_moved, flops):
    """Log one kernel's timings and return its `kernels`-line numbers.
    The bound is the larger of bytes over the memory rate and flops over
    the bf16 tensor rate, for this run's inputs."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOPS_S * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    log(f"  {kind}: device {kernel[0]:.4f} ms (eager call {kernel[1]:.4f} "
        f"ms), plain {plain[0]:.4f} ms (eager {plain[1]:.4f}), SDPA "
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


def check_decode(torch, dev):
    from kubeflow_tpu_torch.ops.cuda.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    kind = "decode"
    gen = torch.Generator().manual_seed(1)
    dt = torch.bfloat16
    shape = (LAYERS, NUM_BLOCKS, BS, N_KV, HD)
    kp = torch.randn(shape, generator=gen).to(dev, dt)
    vp = torch.randn(shape, generator=gen).to(dev, dt)
    q = torch.randn(SLOTS, 1, N_Q, HD, generator=gen).to(dev, dt)
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
        log(f"  decode {name}: max_abs_err {err:.3e}, err/tol max "
            f"{ratio:.3f} ({TOL_TEXT})")
        if not torch.isfinite(got).all() or ratio > 1:
            fail(f"paged_decode_attention {name}: err {err} over {TOL_TEXT}")
        worst = max(worst, err)

    # timing on the ragged case, cycling the 16 layers' pools as a decode
    # step does (working set > L2)
    table = _tables(gen, torch, SLOTS, (pos + 1).tolist()).to(dev)
    mask = torch.ones(SLOTS, NB * BS, dtype=torch.bool, device=dev)
    mask[:, 5] = False
    posd = pos.to(dev)
    ms, eager = _time_ms(torch, lambda i: paged_decode_attention(
        q, kp[i % LAYERS], vp[i % LAYERS], table, posd, mask), 320)
    plain_ms, plain_eager = _time_ms(
        torch, lambda i: paged_decode_attention_plain(
            q, kp[i % LAYERS], vp[i % LAYERS], table, posd, mask), 32)
    # library yardstick: SDPA over K/V gathered beforehand (the gather is
    # not timed), boolean mask = causal & kv_mask
    kg = kp[0][table.long()].reshape(SLOTS, NB * BS, N_KV, HD)
    vg = vp[0][table.long()].reshape(SLOTS, NB * BS, N_KV, HD)
    cells = torch.arange(NB * BS, device=dev)
    amask = (mask & (cells[None] <= posd[:, None]))[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, _ = _time_ms(torch, lambda i: sdpa(
        qt, kt, vt, attn_mask=amask, enable_gqa=True), 320)
    # bound: each live K/V cell read once per kv head, q read, out written
    live = [int(p) + 1 for p in pos]
    vis = [_visible(int(p), mask[r])
           for r, p in enumerate(pos)]
    bytes_moved = (sum(live) * N_KV * HD * 2 * 2           # K and V
                   + 2 * SLOTS * N_Q * HD * 2             # q in, out
                   + sum(live)                             # mask cells
                   + sum(-(-c // BS) for c in live) * 4 + SLOTS * 4)
    flops = sum(vis) * N_Q * HD * 4                        # QK and PV
    return _summary(kind, worst, (ms, eager), (plain_ms, plain_eager),
                    library_ms, bytes_moved, flops)


def _prefill_need(starts, lens, mask):
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
    bytes_moved = (new * (N_Q * 2 + N_KV * 2) * HD * 2      # q, out, new
                   + new * N_KV * HD * 2 * 2                # cells written
                   + prefix * N_KV * HD * 2 * 2             # prefix read
                   + (prefix + new) + len(starts) * (NB * 4 + 8))
    return bytes_moved, vis * N_Q * HD * 4


def _time_prefill(torch, kind, worst, calls, kp, vp, n):
    """Time kernel, plain version and SDPA over `calls`, a list of
    (q, k_new, v_new, table, starts, lens, mask) on the card, cycled
    together with the 16 layers' pools; the bound is the mean over the
    calls of what each needs."""
    from kubeflow_tpu_torch.ops.cuda.prefill_append import (
        paged_prefill_append,
        paged_prefill_append_plain,
    )

    k = len(calls)

    def run(fn):
        return lambda i: fn(*calls[i % k][:3], kp[i % LAYERS],
                            vp[i % LAYERS], *calls[i % k][3:])

    ms = _time_ms(torch, run(paged_prefill_append), n)
    plain = _time_ms(torch, run(paged_prefill_append_plain), n // 8)
    # library yardstick: SDPA over K/V gathered beforehand (the gather is
    # not timed), boolean mask = causal & kv_mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_args = []
    for q, _, _, table, starts, _, mask in calls:
        b, dev = q.shape[0], q.device
        kg = kp[0][table.long()].reshape(b, NB * BS, N_KV, HD)
        vg = vp[0][table.long()].reshape(b, NB * BS, N_KV, HD)
        cells = torch.arange(NB * BS, device=dev)
        qpos = starts[:, None] + torch.arange(CHUNK, device=dev)[None]
        amask = (mask[:, None, :] & (cells[None, None] <= qpos[:, :, None])
                 )[:, None]
        lib_args.append((q.transpose(1, 2), kg.transpose(1, 2),
                         vg.transpose(1, 2), amask))
    library_ms, _ = _time_ms(torch, lambda i: sdpa(
        *lib_args[i % k][:3], attn_mask=lib_args[i % k][3],
        enable_gqa=True), n)
    need = [_prefill_need(c[4], c[5], c[6]) for c in calls]
    return _summary(kind, worst, ms, plain, library_ms,
                    sum(b for b, _ in need) / k, sum(f for _, f in need) / k)


def check_prefill(torch, dev):
    from kubeflow_tpu_torch.ops.cuda.prefill_append import (
        paged_prefill_append,
        paged_prefill_append_plain,
    )

    gen = torch.Generator().manual_seed(2)
    dt = torch.bfloat16
    shape = (LAYERS, NUM_BLOCKS, BS, N_KV, HD)
    kp = torch.randn(shape, generator=gen).to(dev, dt)
    vp = torch.randn(shape, generator=gen).to(dev, dt)

    def fresh(b):
        return tuple(torch.randn(b, CHUNK, n, HD, generator=gen).to(dev, dt)
                     for n in (N_Q, N_KV, N_KV))

    def compare(calls, window=None):
        """Run the calls in order on the plain version and on the kernel,
        each on its own copy of layer 0's pools; -> (max abs error over
        valid tokens, max err/tol, pools equal outside block 0)."""
        want = [kp[0].clone(), vp[0].clone()]
        got = [kp[0].clone(), vp[0].clone()]
        err = ratio = 0.0
        for c in calls:
            wo, *want = paged_prefill_append_plain(
                *c[:3], *want, *c[3:], window=window)
            go, *got = paged_prefill_append(
                *c[:3], *got, *c[3:], window=window)
            torch.cuda.synchronize()
            if not torch.isfinite(go).all():
                fail("paged_prefill_append: non-finite output")
            lens = c[5].tolist()
            e, r = _err(torch.cat([go[i, :n] for i, n in enumerate(lens)]),
                        torch.cat([wo[i, :n] for i, n in enumerate(lens)]))
            err, ratio = max(err, e), max(ratio, r)
        equal = all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))
        return err, ratio, equal

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

    worst = 0.0
    for name, (_, (err, ratio, equal)) in results.items():
        log(f"  prefill {name}: max_abs_err {err:.3e}, err/tol max "
            f"{ratio:.3f} ({TOL_TEXT}), pools equal outside block 0: "
            f"{equal}")
        if ratio > 1 or not equal:
            fail(f"paged_prefill_append {name}: err {err}, pools equal "
                 f"{equal}")
        worst = max(worst, err)

    _time_prefill(torch, "prefill, 4-row batch (ragged_lens)", worst,
                  [results["ragged_lens"][0]], kp, vp, 160)
    return _time_prefill(
        torch, f"prefill, 1-row slices of a {prompt}-token prompt (the "
        f"main path's shape; mean per slice)", worst, slices, kp, vp, 160)


# -- phase 3 ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def serve_and_check(torch):
    import aiohttp
    from aiohttp import web

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from kubeflow_tpu_torch.serving.__main__ import build_app, parse_args
    from kubeflow_tpu_torch.serving.server import BATCHERS_KEY, ENGINES_KEY

    port = _free_port()
    t0 = time.perf_counter()
    app = build_app(parse_args([
        "--model", "llama3-1b", "--random", "--seed", "0",
        "--prefill-chunk-tokens", str(CHUNK), "--host", "127.0.0.1",
        "--port", str(port)]))
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    engine = app[ENGINES_KEY]["llama3-1b"]
    batcher = app[BATCHERS_KEY]["llama3-1b"]
    cfg = engine.cfg
    log(f"  server up in {time.perf_counter() - t0:.1f} s "
        f"(llama3-1b random weights, seed 0, port {port})")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in PROMPT_LENS[:3]]
    prompts.append(prompts[0])        # the repeated prompt
    url = f"http://127.0.0.1:{port}/v1/models/llama3-1b:generate"
    try:
        async with aiohttp.ClientSession() as sess:
            batcher.calls = batcher.iterations = 0
            batcher.decode_s = batcher.prefill_s = 0.0
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
            async with sess.get(f"http://127.0.0.1:{port}/healthz") as r:
                if r.status != 200:
                    fail(f"/healthz returned {r.status}")
            steps = counts["paged_decode_attention"] // cfg.num_layers
            slices = counts["paged_prefill_append"] // cfg.num_layers
            log(f"  served {len(prompts)} requests in {serve_s:.3f} s: "
                f"{steps} decode steps, {slices} prefill slices; kernel "
                f"launches {counts}")
            its = max(batcher.iterations, 1)
            log(f"  batcher (host clock): {batcher.iterations} worker "
                f"iterations, {serve_s / its * 1e3:.2f} ms each; decode "
                f"{batcher.decode_s:.3f} s over {batcher.calls} steps = "
                f"{batcher.decode_s / max(batcher.calls, 1) * 1e3:.2f} ms "
                f"per step; prefill {batcher.prefill_s:.3f} s over "
                f"{slices} slices = "
                f"{batcher.prefill_s / max(slices, 1) * 1e3:.2f} ms per "
                f"slice")
            # the same requests again under torch.profiler: where the
            # time goes (host clock inflated by the profiler itself)
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                await asyncio.gather(*(post(p) for p in prompts))
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
    finally:
        await runner.cleanup()
    _report_profile(prof, prof_s)
    for name, n in counts.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    outs = [b["tokens"][0] for b in bodies]
    lps = [b["logprobs"][0] for b in bodies]
    for o, lp in zip(outs, lps):
        if len(o) != MAX_NEW or len(lp) != MAX_NEW or not all(
                0 <= t < cfg.vocab_size for t in o):
            fail(f"malformed output {o} / {lp}")
    if outs[0] != outs[3]:
        fail(f"repeated prompt gave different greedy tokens: {outs[0]} vs "
             f"{outs[3]}")
    # teacher-force each served sequence through the plain dense model
    worst, argmax_ok, argmax_n = 0.0, 0, 0
    with torch.inference_mode():
        for p, o, lp in zip(prompts, outs, lps):
            toks = torch.tensor([p + o[:-1]], device=engine.device)
            logp = torch.log_softmax(
                llama.apply(engine.params, cfg, toks)[0, len(p) - 1:], -1)
            ref = logp[torch.arange(MAX_NEW, device=engine.device),
                       torch.tensor(o, device=engine.device)].cpu()
            worst = max(worst, float((ref - torch.tensor(lp)).abs().max()))
            top2 = torch.topk(logp, 2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
            for j in range(MAX_NEW):
                if margin[j] > 2 * LOGPROB_TOL:
                    argmax_n += 1
                    argmax_ok += int(top2.indices[j, 0]) == o[j]
    log(f"  teacher-forced logprob max_abs_err {worst:.4f} "
        f"(tol {LOGPROB_TOL}); greedy argmax agrees on {argmax_ok}/"
        f"{argmax_n} steps with margin > {2 * LOGPROB_TOL}")
    if worst > LOGPROB_TOL or argmax_ok != argmax_n:
        fail("served tokens disagree with the plain dense model")
    return counts


def _report_profile(prof, wall_s: float) -> None:
    """Device busy share and the kernels that take the device time."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in events)
    if not events:
        log("  profile: no device time recorded (not measured)")
        return
    log(f"  profile (profiler on): wall {wall_s:.3f} s, device busy "
        f"{total_us / 1e6:.3f} s = {total_us / 1e6 / wall_s:.1%}")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs the card")
    sys.path.insert(0, ROOT)
    try:
        from kubeflow_tpu_torch.ops.cuda import _build
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    log("phase 1: build")
    build_s = _build.build_all()
    log(f"  nvcc built {len(_build.KERNELS)} kernels in {build_s:.1f} s")
    for name, report in _build.ptxas_reports.items():
        # registers and spills of every instantiation (ptxas -v)
        log(f"  ptxas {name}: " + "; ".join(sorted(
            {ln.strip() for ln in report.splitlines()
             if "Used" in ln or "spill" in ln})))

    log("phase 2: kernels against their plain versions (llama3-1b shapes)")
    stats = {"paged_decode_attention": check_decode(torch, dev),
             "paged_prefill_append": check_prefill(torch, dev)}

    log("phase 3: serve llama3-1b through the kernels")
    counts = asyncio.run(serve_and_check(torch))

    meta = {
        "paged_decode_attention": (
            "kubeflow_tpu_torch/csrc/paged_decode_attention.cu",
            "kubeflow_tpu/ops/pallas/paged_attention.py:123"),
        "paged_prefill_append": (
            "kubeflow_tpu_torch/csrc/paged_prefill_append.cu",
            "kubeflow_tpu/ops/pallas/prefill_append.py:173"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
