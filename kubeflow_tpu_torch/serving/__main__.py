"""Serving CLI: `python -m kubeflow_tpu_torch.serving` (counterpart:
kubeflow_tpu/serving/__main__.py).

    python -m kubeflow_tpu_torch.serving --model llama3-1b --random \\
        --prefill-chunk-tokens 64

Serves one model with continuous batching on the paged KV pool, on the
CUDA card (`--cpu` runs the plain PyTorch path on the CPU instead).
Weights are random from `--seed`; loading a checkpoint is not ported
yet, so `--random` is required.
"""

from __future__ import annotations

import argparse
import sys


def model_registry():
    """name -> (config, family)."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.engine import LLAMA_FAMILY

    return {
        "llama-tiny": (llama.LLAMA_TINY, LLAMA_FAMILY),
        "llama3-1b": (llama.LLAMA3_1B, LLAMA_FAMILY),
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.serving")
    p.add_argument("--model", default="llama-tiny",
                   choices=tuple(model_registry()))
    p.add_argument("--random", action="store_true",
                   help="random params from --seed (required: checkpoint "
                        "loading is not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--eos", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=8,
                   help="decode slots of the continuous batcher")
    p.add_argument("--prefill-chunk-tokens", type=int, default=64,
                   help="chunked prefill token budget: each worker "
                        "iteration feeds at most this many prompt tokens, "
                        "interleaved with decode chunks")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch path, no kernels)")
    args = p.parse_args(argv)
    if not args.random:
        p.error("pass --random (checkpoint loading is not ported yet)")
    return args


def build_app(args: argparse.Namespace):
    """The serving app for parsed CLI args: random weights from the seed
    on the chosen device, one continuous batcher."""
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.server import create_serving_app

    device = resolve_device("cpu" if args.cpu else None)
    cfg, family = model_registry()[args.model]
    params = llama.init(cfg, args.seed, device)
    engine = InferenceEngine(
        params, cfg, family,
        EngineConfig(max_len=args.max_len, eos_token=args.eos),
        device=device)
    return create_serving_app(
        {args.model: engine}, max_batch=args.max_batch,
        prefill_chunk_tokens=args.prefill_chunk_tokens, seed=args.seed)


def main(argv=None) -> int:
    from aiohttp import web

    args = parse_args(argv)
    app = build_app(args)
    print(f"serving {args.model} (random, seed {args.seed}) "
          f"on {args.host}:{args.port} device="
          f"{'cpu' if args.cpu else 'cuda'}", flush=True)
    web.run_app(app, host=args.host, port=args.port, print=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
