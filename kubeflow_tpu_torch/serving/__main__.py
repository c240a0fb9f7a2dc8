"""Serving CLI: `python -m kubeflow_tpu_torch.serving` (counterpart:
kubeflow_tpu/serving/__main__.py).

    python -m kubeflow_tpu_torch.serving --model llama3-8b --random \\
        --batch-window-ms 20
    python -m kubeflow_tpu_torch.serving --model llama3-1b --random \\
        --continuous --warmup
    python -m kubeflow_tpu_torch.serving --model gemma-2b --random \\
        --continuous --warmup
    python -m kubeflow_tpu_torch.serving --model llama3-1b \\
        --checkpoint /ckpt/run7 --tokenizer auto --continuous --warmup
    python -m kubeflow_tpu_torch.serving --model llama3-1b \\
        --checkpoint /ckpt/run7 --continuous --warmup --quant int8
    python -m kubeflow_tpu_torch.serving --model llama3-8b --random \\
        --continuous --warmup --prefill-chunk-tokens 64 --spec-decode \\
        --draft-model llama3-1b --spec-gamma 4
    python -m kubeflow_tpu_torch.serving --model llama3-1b --random \\
        --continuous --warmup --prefill-chunk-tokens 64 \\
        --tenants tenants.json
    python -m kubeflow_tpu_torch.serving --model llama3-1b --random \\
        --continuous --warmup --prefill-chunk-tokens 64 --pool prefill \\
        --fleet-router http://router:8080 --model-version v1 --port 8001

Serves one model on the CUDA card (`--cpu` runs the plain PyTorch path
on the CPU instead; the head dim 32 of `gemma-tiny` and `mixtral-tiny`
has no kernel, so they are served with `--cpu` only: on the card the
kernels refuse it at the first request). `mixtral-tiny` is the MoE
family (`llama-moe`: routed experts, dropless at serving); under
`--quant int8` its expert stacks are dequantized each step, as the
reference's. Without `--continuous`, the reference's default
mode: the one-shot engine on a dense KV cache, single prompts coalesced
by a `--batch-window-ms` window when it is above 0, else each request
generated directly. With `--continuous`, continuous batching on the
paged KV pool: monolithic admission (one prefill per bucket group,
`--prefill-chunk` slicing long prompts) unless `--prefill-chunk-tokens`
sets a chunked-prefill budget; decode chunks dispatched
`--pipeline-depth` ahead; `--warmup` captures every serving graph
before the port opens; `--kv-spill-bytes` gives the radix prefix cache
a host-memory tier that eviction demotes to; `--spec-decode` decodes
every request speculatively, `--spec-gamma` tokens of `--draft-model`
(random from `--seed` + 1, or `--draft-checkpoint`) verified a round
(`POST /v1/spec {"enabled": false}` switches it off); `--tenants FILE`
(a tenancy JSON: `{"tenants": {name: {"priority", "weight",
"requests_per_s", "request_burst", "tokens_per_s", "token_burst",
"kv_block_share", "prefix_isolation"}}}`) makes the replica
multi-tenant, each request's tenant named by its `X-Tenant` header.
Shutdown, and `POST /drain`, wait up to `--drain-grace-s` for the
generations in flight. The fleet plane: `--pool prefill|decode` (with
`--continuous`) is the replica's disaggregation role (`mixed`, both
phases, by default); `--fleet-router URL` registers the replica with a
fleet router and heartbeats its stats there, `--advertise URL` (default
`http://HOST:PORT`) is where the router reaches it; `--model-version`
labels the boot weights, which `POST /v1/reload` replaces live from
`{"checkpoint": dir, "step": n}` or `{"seed": n}`. `--name` is the served
model name (the route's model segment and `/v1/models`; default
`--model`). `--paged-attention-impl` (continuous only) is the
reference's knob: `auto` and `pallas` run the CUDA paged kernels, `xla`
(the plain gathered path) is taken with `--cpu` only. `--quant int8` serves
the seven block matrices as int8 with a bf16 scale per output channel
(serving/quant.py), quantized after the load and again after every
reload; their products run through the `int8_proj` kernel on the card.
The draft model is not quantized.

Weights: `--checkpoint DIR` (a train/checkpoint.py `Checkpointer`
directory: the newest committed step's params, the optimizer's moments
left on disk) or `--random` (from `--seed`). `--tokenizer PATH` serves
the "text" field through a data/bpe.py tokenizer file; `auto` takes
`tokenizer.json` beside `--checkpoint` when there is one, else the
byte-level fallback.
"""

from __future__ import annotations

import argparse
import sys


def model_registry():
    """name -> (config, init, family), as the reference's registry;
    `init(cfg, seed, device)` gives the model's random serving params."""
    from kubeflow_tpu_torch.models import gemma, llama, llama_moe
    from kubeflow_tpu_torch.serving.engine import (
        GEMMA_FAMILY,
        LLAMA_FAMILY,
        MOE_LLAMA_FAMILY,
    )

    return {
        "llama-tiny": (llama.LLAMA_TINY, llama.init, LLAMA_FAMILY),
        "llama3-1b": (llama.LLAMA3_1B, llama.init, LLAMA_FAMILY),
        "llama3-8b": (llama.LLAMA3_8B, llama.init, LLAMA_FAMILY),
        "gemma-tiny": (gemma.GEMMA_TINY, gemma.init, GEMMA_FAMILY),
        "gemma-2b": (gemma.GEMMA_2B, gemma.init, GEMMA_FAMILY),
        "mixtral-tiny": (llama_moe.MIXTRAL_TINY, llama_moe.init,
                         MOE_LLAMA_FAMILY),
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.serving")
    names = tuple(model_registry())
    p.add_argument("--model", default="llama-tiny", choices=names)
    p.add_argument("--name", default="",
                   help="served model name: the route's model segment and "
                        "/v1/models' entry (default: --model)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--checkpoint", default="",
                     help="train.checkpoint.Checkpointer directory")
    src.add_argument("--random", action="store_true",
                     help="fresh random params from --seed (smoke/dev)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--eos", type=int, default=None)
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching on the paged KV pool "
                        "(default: one-shot generation on a dense cache)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="rows of a window batch, or decode slots of the "
                        "continuous batcher")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce single-prompt requests arriving within "
                        "this window into one batch (0: each request "
                        "generates alone)")
    p.add_argument("--warmup", action="store_true",
                   help="run every serving shape (CUDA graphs captured) "
                        "before taking traffic (continuous only)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="monolithic admission prefills prompts longer "
                        "than this in slices of this many tokens (0: one "
                        "pass)")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="chunked prefill token budget (continuous only): "
                        "each worker iteration feeds at most this many "
                        "prompt tokens, interleaved with decode chunks. "
                        "0 = monolithic admission prefill")
    p.add_argument("--kv-spill-bytes", type=int, default=0,
                   help="host-memory KV spill tier budget in bytes "
                        "(continuous only): radix eviction demotes block "
                        "contents to host memory instead of discarding "
                        "them, and a returning prefix restores them with "
                        "a host-to-device copy instead of prefilling "
                        "again. 0 = off")
    p.add_argument("--spec-decode", action="store_true",
                   help="speculative decoding on the paged KV pool "
                        "(continuous only): every request drafts "
                        "--spec-gamma tokens with --draft-model and "
                        "verifies them in one batched pass; the target's "
                        "output law is unchanged")
    p.add_argument("--draft-model", default="", choices=("",) + names,
                   help="draft model for --spec-decode (must share the "
                        "target's vocab)")
    p.add_argument("--draft-checkpoint", default="",
                   help="train.checkpoint.Checkpointer directory of the "
                        "draft's params (default: random from --seed + 1)")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   help="decode dispatch-ahead depth (0 = the backend's "
                        "default: 2 on CUDA, 1 on the CPU)")
    p.add_argument("--paged-attention-impl", default="auto",
                   choices=("auto", "xla", "pallas"),
                   help="decode attention over the paged KV pool "
                        "(continuous only): auto and pallas run the CUDA "
                        "kernels on the card; xla is the plain gathered "
                        "path, taken with --cpu only")
    p.add_argument("--tokenizer", default="",
                   help="data.bpe tokenizer file (text mode); 'auto' uses "
                        "tokenizer.json beside --checkpoint when present, "
                        "byte fallback otherwise")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch path, no kernels)")
    p.add_argument("--drain-grace-s", type=float, default=30.0,
                   help="shutdown waits this long for in-flight "
                        "generations before closing")
    p.add_argument("--tenants", default="",
                   help="tenancy config JSON file (continuous only): "
                        "per-tenant weights, priorities, rate limits, "
                        "KV shares, prefix isolation. Requests select a "
                        "tenant with the X-Tenant header; absent/unknown "
                        "maps to 'default'")
    p.add_argument("--pool", default="mixed",
                   choices=("mixed", "prefill", "decode"),
                   help="disaggregation role (continuous only for "
                        "prefill/decode): 'prefill' replicas serve "
                        ":prefill handoffs and ship KV blocks to the "
                        "decode pool; 'decode' replicas receive them; "
                        "'mixed' serves both phases (default)")
    p.add_argument("--fleet-router", default="",
                   help="fleet router base URL; the replica registers "
                        "and heartbeats there")
    p.add_argument("--advertise", default="",
                   help="URL the fleet router should reach this replica "
                        "at (default http://HOST:PORT)")
    p.add_argument("--quant", choices=("", "int8"), default="",
                   help="weight-only quantization of the block matrices "
                        "after the load (int8: symmetric, per output "
                        "channel); the draft model stays as loaded")
    p.add_argument("--model-version", default="",
                   help="version label of the boot weights (rides in "
                        "fleet heartbeats; POST /v1/reload replaces it)")
    args = p.parse_args(argv)
    if not args.checkpoint and not args.random:
        p.error("pass --checkpoint DIR or --random")
    if args.warmup and not args.continuous:
        p.error("--warmup requires --continuous")
    if args.paged_attention_impl != "auto" and not args.continuous:
        p.error("--paged-attention-impl requires --continuous")
    if args.paged_attention_impl == "xla" and not args.cpu:
        # the port's paged path on the card is the kernel: never run the
        # plain gathered version there quietly
        p.error("--paged-attention-impl xla is the plain gathered path, "
                "which the port runs with --cpu only: on the card the "
                "paged path is the CUDA kernel (auto or pallas)")
    for flag in ("prefill_chunk", "prefill_chunk_tokens", "pipeline_depth",
                 "kv_spill_bytes"):
        name = "--" + flag.replace("_", "-")
        if getattr(args, flag) < 0:
            p.error(f"{name} must be >= 0")
        if getattr(args, flag) and not args.continuous:
            p.error(f"{name} requires --continuous")
    if args.spec_decode and not args.continuous:
        p.error("--spec-decode requires --continuous")
    if args.spec_decode and not args.draft_model:
        p.error("--spec-decode requires --draft-model")
    if args.draft_model and not args.spec_decode:
        p.error("--draft-model requires --spec-decode")
    if args.tenants and not args.continuous:
        # the QoS scheduler replaces the continuous batcher's queue;
        # ignoring the file would serve without the configured quotas
        p.error("--tenants requires --continuous")
    if args.advertise and not args.fleet_router:
        p.error("--advertise requires --fleet-router")
    if args.pool != "mixed" and not args.continuous:
        # the handoff ships paged KV blocks: the continuous engine's
        p.error("--pool prefill/decode requires --continuous")
    return args


def _load_params(checkpoint: str, seed: int, cfg, init, device):
    """Serving params: the checkpoint's newest committed step (params
    only), or random ones from the seed when there is no checkpoint."""
    if not checkpoint:
        return init(cfg, seed, device)
    from kubeflow_tpu_torch.train.checkpoint import load_serving_params

    try:
        return load_serving_params(checkpoint, cfg, device)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None


def _quantized(params, quant: str):
    """The boot and reload weights under `--quant`."""
    if quant == "int8":
        from kubeflow_tpu_torch.serving.quant import quantize_blocks

        return quantize_blocks(params)
    return params


def _make_reloader(init, cfg, device, quant: str = ""):
    """`/v1/reload`'s weight materializer for this process: `{"seed":
    n}` draws the model's random params on `device` from torch's
    generator (seed n gives other values than the reference's JAX draw:
    the same law), `{"checkpoint": dir, "step": n}` loads through the
    boot loader. Either way the params are staged on the host, leaf by
    leaf, and the server copies them into the live tensors: the card
    never holds a second copy of the weights. Under `--quant` they are
    quantized as boot quantizes them (on the host), so a reload never
    de-quantizes the server."""

    def reload(name, engine, source):
        return _quantized(_load(source), quant)

    def _load(source):
        if "seed" in source:
            return init(cfg, int(source["seed"]), device, store="cpu")
        checkpoint = source.get("checkpoint", "")
        if not checkpoint:
            raise ValueError("reload source needs 'checkpoint' or 'seed'")
        from kubeflow_tpu_torch.train.checkpoint import load_serving_params

        step = source.get("step")
        try:
            return load_serving_params(
                checkpoint, cfg, "cpu",
                step=step if isinstance(step, int) else None)
        except FileNotFoundError as e:
            raise ValueError(str(e)) from None

    return reload


def load_tokenizer(args: argparse.Namespace):
    """The `--tokenizer` file's tokenizer, or None (byte fallback)."""
    import os

    ref = args.tokenizer
    if ref == "auto":
        # the train -> serve loop carries its tokenizer beside the
        # checkpoint (CheckpointConfig.tokenizer_path)
        ref = ""
        if args.checkpoint:
            cand = os.path.join(args.checkpoint, "tokenizer.json")
            if os.path.exists(cand):
                ref = cand
    if not ref:
        return None
    from kubeflow_tpu_torch.data.bpe import Tokenizer

    return Tokenizer.load(ref)


def build_app(args: argparse.Namespace):
    """The serving app for parsed CLI args: the checkpoint's or random
    weights on the chosen device, in the mode the args choose,
    registered with `--fleet-router` when one is named."""
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.serving.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.server import (
        create_serving_app,
        enable_fleet_registration,
    )

    device = resolve_device("cpu" if args.cpu else None)
    cfg, init, family = model_registry()[args.model]
    name = args.name or args.model
    ec = EngineConfig(max_len=args.max_len, eos_token=args.eos)
    params = _quantized(
        _load_params(args.checkpoint, args.seed, cfg, init, device),
        args.quant)
    engine = InferenceEngine(params, cfg, family, ec, device=device)
    drafts = None
    if args.spec_decode:
        # a random draft proposes junk (acceptance near 0), but the
        # plumbing, and the output law, are production's; its cache
        # covers the target's whole sequence space
        dcfg, dinit, dfamily = model_registry()[args.draft_model]
        dparams = _load_params(args.draft_checkpoint, args.seed + 1, dcfg,
                               dinit, device)
        drafts = {name: InferenceEngine(dparams, dcfg, dfamily, ec,
                                        device=device)}
    tenancy = None
    if args.tenants:
        from kubeflow_tpu_torch.tenancy import load_config

        tenancy = load_config(args.tenants)
    app = create_serving_app(
        {name: engine}, tokenizer=load_tokenizer(args),
        max_batch=args.max_batch,
        continuous=args.continuous, batch_window_ms=args.batch_window_ms,
        warmup=args.warmup, prefill_chunk=args.prefill_chunk or None,
        prefill_chunk_tokens=args.prefill_chunk_tokens or None,
        pipeline_depth=args.pipeline_depth or None,
        kv_spill_bytes=args.kv_spill_bytes or None,
        paged_attention_impl=args.paged_attention_impl, drafts=drafts,
        spec_decode=args.spec_decode, spec_gamma=args.spec_gamma,
        seed=args.seed, tenancy=tenancy, drain_grace_s=args.drain_grace_s,
        pool=args.pool, model_version=args.model_version,
        reloader=_make_reloader(init, cfg, device, args.quant))
    if args.fleet_router:
        enable_fleet_registration(
            app, args.fleet_router,
            args.advertise or f"http://{args.host}:{args.port}")
    return app


def main(argv=None) -> int:
    from aiohttp import web

    args = parse_args(argv)
    app = build_app(args)
    source = f"random, seed {args.seed}" if args.random else args.checkpoint
    print(f"serving {args.model} as {args.name or args.model} ({source}) "
          f"on {args.host}:{args.port} "
          f"device={'cpu' if args.cpu else 'cuda'} "
          f"tokenizer={args.tokenizer or 'byte'}", flush=True)
    web.run_app(app, host=args.host, port=args.port, print=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
