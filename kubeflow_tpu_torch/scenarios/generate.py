"""Deterministic scenario generators: the shapes that break schedulers.

Every generator takes an explicit integer seed and returns a `Trace`;
the same (generator, seed, params) tuple produces a byte-identical
trace file on every machine, forever — no wall-clock anywhere. That is
what makes a scenario a shareable artifact: "`flash-crowd` seed 7"
names the exact same arrival sequence in a bug report, a CI gate, and
a bench run.

The catalog (NotebookOS motivates the bursty interactive shapes,
Podracer the sustained swarm floods):

- `diurnal`       — sinusoidal load waves (the 24h cycle compressed),
- `flash_crowd`   — a quiet baseline, then everyone arrives at once
                    for the SAME content (shared prefix group),
- `heavy_tail`    — lognormal/Pareto prompt lengths: the p99 prompt
                    is the one that wrecks batch occupancy,
- `agent_swarm`   — N agents each re-querying with a growing shared
                    prefix (radix-cache reuse structure),
- `abandon_retry` — impatient clients that hang up and retry, the
                    storm that doubles offered load exactly when the
                    system is slowest,
- `tenant_flood`  — the `--mode tenants` noisy-neighbor arrival shape
                    (sustained bulk flood + periodic interactive
                    probes) expressed as a scenario file.

Arrival processes are Poisson (exponential gaps) unless the shape
says otherwise; nonhomogeneous rates use thinning so the draw count
per unit time stays seed-stable under parameter tweaks.
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable

from kubeflow_tpu_torch.scenarios.trace import Trace, TraceRequest


def _clip(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


def _poisson_arrivals(rand: random.Random, rate: float,
                      duration_s: float) -> list[float]:
    """Homogeneous Poisson arrival offsets in [0, duration_s)."""
    out, t = [], 0.0
    while True:
        t += rand.expovariate(rate)
        if t >= duration_s:
            return out
        out.append(t)


def _thinned_arrivals(rand: random.Random, rate_fn: Callable[[float], float],
                      max_rate: float, duration_s: float) -> list[float]:
    """Nonhomogeneous Poisson via thinning: draw at max_rate, keep
    each arrival with probability rate(t)/max_rate."""
    out, t = [], 0.0
    while True:
        t += rand.expovariate(max_rate)
        if t >= duration_s:
            return out
        if rand.random() * max_rate < rate_fn(t):
            out.append(t)


def gen_diurnal(seed: int, *, duration_s: float = 20.0,
                base_rps: float = 2.0, peak_rps: float = 8.0,
                waves: int = 2, prompt_tokens: int = 24,
                max_new: int = 16) -> Trace:
    """Sinusoidal waves between base and peak rps — the 24h cycle an
    autoscaler must ride without thrashing, compressed to seconds."""
    rand = random.Random(f"diurnal:{seed}")
    mid = (base_rps + peak_rps) / 2.0
    amp = (peak_rps - base_rps) / 2.0

    def rate(t: float) -> float:
        return mid + amp * math.sin(2 * math.pi * waves * t / duration_s)

    reqs = [
        TraceRequest(id=f"r-{i:06d}", at=at,
                     prompt_tokens=_clip(
                         round(rand.gauss(prompt_tokens,
                                          prompt_tokens / 4)),
                         4, 4 * prompt_tokens),
                     max_new=max_new)
        for i, at in enumerate(_thinned_arrivals(
            rand, rate, peak_rps, duration_s))
    ]
    return Trace(
        name=f"diurnal-s{seed}", requests=reqs, seed=seed,
        generator="diurnal",
        expect={"client_failures": {"max": 0},
                "completed_frac": {"min": 1.0}},
        meta={"duration_s": duration_s, "base_rps": base_rps,
              "peak_rps": peak_rps, "waves": waves})


def gen_flash_crowd(seed: int, *, duration_s: float = 12.0,
                    base_rps: float = 1.0, burst_at_frac: float = 0.4,
                    burst_len_s: float = 2.0, burst_rps: float = 15.0,
                    prompt_tokens: int = 24, prefix_tokens: int = 16,
                    max_new: int = 8) -> Trace:
    """Quiet baseline, then a burst window where arrivals spike an
    order of magnitude — and the crowd all wants the SAME thing, so
    burst requests share one prefix group (the radix cache either
    absorbs the stampede or every request re-prefills the same
    tokens)."""
    rand = random.Random(f"flash_crowd:{seed}")
    burst_t0 = burst_at_frac * duration_s
    base = _poisson_arrivals(rand, base_rps, duration_s)
    burst = [burst_t0 + t for t in
             _poisson_arrivals(rand, burst_rps, burst_len_s)]
    reqs = [TraceRequest(id=f"b-{i:06d}", at=at,
                         prompt_tokens=prompt_tokens, max_new=max_new)
            for i, at in enumerate(base)]
    reqs += [TraceRequest(id=f"c-{i:06d}", at=at,
                          prompt_tokens=prompt_tokens,
                          max_new=max_new,
                          prefix_group="crowd",
                          prefix_tokens=prefix_tokens)
             for i, at in enumerate(burst)]
    return Trace(
        name=f"flash-crowd-s{seed}", requests=reqs, seed=seed,
        generator="flash_crowd",
        expect={"client_failures": {"max": 0},
                "completed_frac": {"min": 1.0}},
        meta={"duration_s": duration_s, "base_rps": base_rps,
              "burst_t0_s": round(burst_t0, 6),
              "burst_len_s": burst_len_s, "burst_rps": burst_rps})


def gen_heavy_tail(seed: int, *, n: int = 60, rps: float = 4.0,
                   dist: str = "pareto", alpha: float = 1.2,
                   scale: float = 8.0, max_prompt: int = 96,
                   max_new: int = 8) -> Trace:
    """Heavy-tailed prompt lengths (Pareto or lognormal): most
    prompts are short, but the tail mass is where chunked prefill and
    batch-occupancy policies earn their keep."""
    if dist not in ("pareto", "lognormal"):
        raise ValueError(f"unknown dist {dist!r}")
    rand = random.Random(f"heavy_tail:{dist}:{seed}")
    arrivals = []
    t = 0.0
    for _ in range(n):
        t += rand.expovariate(rps)
        arrivals.append(t)
    reqs = []
    for i, at in enumerate(arrivals):
        if dist == "pareto":
            ln = scale * rand.paretovariate(alpha)
        else:
            ln = rand.lognormvariate(math.log(scale), 0.9)
        reqs.append(TraceRequest(
            id=f"r-{i:06d}", at=at,
            prompt_tokens=_clip(round(ln), 2, max_prompt),
            max_new=max_new))
    return Trace(
        name=f"heavy-tail-{dist}-s{seed}", requests=reqs, seed=seed,
        generator="heavy_tail",
        expect={"client_failures": {"max": 0},
                "completed_frac": {"min": 1.0}},
        meta={"n": n, "rps": rps, "dist": dist, "alpha": alpha,
              "scale": scale, "max_prompt": max_prompt})


def gen_agent_swarm(seed: int, *, agents: int = 8,
                    steps_per_agent: int = 6, think_s: float = 0.8,
                    prefix_tokens: int = 24, step_tokens: int = 6,
                    max_new: int = 8, stagger_s: float = 0.3) -> Trace:
    """N agents, each looping generate -> think -> generate with a
    growing conversation: step k of agent a shares the agent's prefix
    group with prefix length prefix_tokens (the system prompt) and a
    prompt that grows by step_tokens per turn. Prefix-skew is the
    point — a router that ignores it re-prefills every turn."""
    rand = random.Random(f"agent_swarm:{seed}")
    reqs = []
    for a in range(agents):
        t = a * stagger_s * rand.uniform(0.5, 1.5)
        for k in range(steps_per_agent):
            reqs.append(TraceRequest(
                id=f"a{a:03d}-k{k:02d}", at=t,
                prompt_tokens=prefix_tokens + (k + 1) * step_tokens,
                max_new=max_new,
                tenant="swarm", priority="batch",
                prefix_group=f"agent-{a}",
                prefix_tokens=prefix_tokens))
            t += think_s * rand.uniform(0.6, 1.4)
    return Trace(
        name=f"agent-swarm-s{seed}", requests=reqs, seed=seed,
        generator="agent_swarm",
        expect={"client_failures": {"max": 0},
                "completed_frac": {"min": 1.0}},
        meta={"agents": agents, "steps_per_agent": steps_per_agent,
              "prefix_tokens": prefix_tokens,
              "step_tokens": step_tokens})


def gen_abandon_retry(seed: int, *, n: int = 24, rps: float = 3.0,
                      abandon_frac: float = 0.4,
                      patience_s: float = 0.06,
                      retry_delay_s: float = 0.5,
                      max_retries: int = 2,
                      prompt_tokens: int = 20,
                      max_new: int = 24,
                      abandon_max_new: int = 96) -> Trace:
    """Impatient clients: a fraction abandons after `patience_s` and
    retries the SAME ask (same prefix group) a moment later —
    retries arrive exactly when the system is already slow, and an
    engine that doesn't cancel abandoned work decodes into dead
    sockets while live clients queue.

    Like every shape here, time is compressed: abandoning attempts
    ask for `abandon_max_new` tokens against a `patience_s` far below
    any possible completion time, so EVERY scheduled hang-up fires
    regardless of server speed and the expect block can pin the exact
    abandoned count (a patience the server can outrun would make the
    count a race)."""
    if not (0 <= abandon_frac <= 1):
        raise ValueError("abandon_frac must be in [0, 1]")
    rand = random.Random(f"abandon_retry:{seed}")
    reqs = []
    t = 0.0
    for i in range(n):
        t += rand.expovariate(rps)
        impatient = rand.random() < abandon_frac
        retries = rand.randint(1, max_retries) if impatient else 0
        at = t
        for attempt in range(retries + 1):
            last = attempt == retries
            abandon_at = None if last else \
                at + patience_s * rand.uniform(0.8, 1.2)
            reqs.append(TraceRequest(
                id=f"r-{i:06d}-t{attempt}", at=at,
                prompt_tokens=prompt_tokens,
                max_new=max_new if last else abandon_max_new,
                prefix_group=f"ask-{i}",
                prefix_tokens=prompt_tokens // 2,
                abandon_at=abandon_at))
            if not last:
                at = abandon_at + retry_delay_s * rand.uniform(0.8, 1.2)
    n_abandon = sum(1 for r in reqs if r.abandon_at is not None)
    return Trace(
        name=f"abandon-retry-s{seed}", requests=reqs, seed=seed,
        generator="abandon_retry",
        expect={"client_failures": {"max": 0},
                "abandoned": {"min": n_abandon, "max": n_abandon},
                "completed": {"min": len(reqs) - n_abandon}},
        meta={"n": n, "rps": rps, "abandon_frac": abandon_frac,
              "patience_s": patience_s,
              "retry_delay_s": retry_delay_s})


def gen_tenant_flood(seed: int, *, duration_s: float = 8.0,
                     bulk_rps: float = 16.0, bulk_prompt: int = 12,
                     bulk_max_new: int = 96,
                     live_period_s: float = 0.5,
                     live_prompt: int = 4,
                     live_max_new: int = 8) -> Trace:
    """The `--mode tenants` noisy-neighbor arrival shape as a
    scenario: a batch-class bulk flood (Poisson, long generations)
    with an interactive probe streaming through the backlog at a
    fixed cadence. This is the loadtest's tenants flood expressed as
    data instead of harness code.

    Defaults are sized to genuinely saturate the loadtest's tiny CPU
    engine (offered decode work slightly above capacity), so TTFT is
    set by queue structure — which a faithful record/replay
    round-trip reproduces — rather than by scheduler noise. That is
    what makes this the fidelity arm's reference shape."""
    rand = random.Random(f"tenant_flood:{seed}")
    reqs = [TraceRequest(
        id=f"bulk-{i:06d}", at=at,
        prompt_tokens=_clip(round(rand.gauss(bulk_prompt,
                                             bulk_prompt / 4)),
                            2, 4 * bulk_prompt),
        max_new=bulk_max_new, tenant="bulk", priority="batch")
        for i, at in enumerate(_poisson_arrivals(
            rand, bulk_rps, duration_s))]
    n_live = int(duration_s / live_period_s)
    # first probe after one period: the flood needs a backlog to be
    # noisy about
    reqs += [TraceRequest(
        id=f"live-{i:06d}", at=(i + 1) * live_period_s,
        prompt_tokens=live_prompt, max_new=live_max_new,
        tenant="live", priority="interactive")
        for i in range(n_live - 1)]
    return Trace(
        name=f"tenant-flood-s{seed}", requests=reqs, seed=seed,
        generator="tenant_flood",
        expect={"client_failures": {"max": 0},
                "completed_frac": {"min": 1.0}},
        meta={"duration_s": duration_s, "bulk_rps": bulk_rps,
              "bulk_max_new": bulk_max_new,
              "live_period_s": live_period_s})


GENERATORS: dict[str, Callable[..., Trace]] = {
    "diurnal": gen_diurnal,
    "flash_crowd": gen_flash_crowd,
    "heavy_tail": gen_heavy_tail,
    "agent_swarm": gen_agent_swarm,
    "abandon_retry": gen_abandon_retry,
    "tenant_flood": gen_tenant_flood,
}


def generate(shape: str, seed: int, **params: Any) -> Trace:
    """Look up a generator by name (`-` and `_` interchangeable) and
    run it. Unknown shapes and unknown params fail loudly — a typo'd
    scenario must not silently become the default one."""
    key = shape.replace("-", "_")
    fn = GENERATORS.get(key)
    if fn is None:
        raise ValueError(
            f"unknown scenario shape {shape!r}; known: "
            f"{sorted(GENERATORS)}")
    return fn(seed, **params)
