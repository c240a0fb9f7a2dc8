"""Offline perplexity evaluation: KTSH shards -> loss / ppl, one JSON
line (counterpart: tools/eval_ppl.py, the same flags and keys;
`"backend"` is the torch device).

Streams windows through `open_loader` (native, else the Python loader),
teacher-forces them through the model under `torch.inference_mode()`
and reports the token-weighted mean NLL and perplexity. The model comes
from the serving CLI's registry, its weights from `--checkpoint` (a
`train.checkpoint.Checkpointer` directory, the newest committed step)
or `--random`:

    python -m kubeflow_tpu_torch.tools.eval_ppl --shards val.ktsh \\
        --model llama3-1b --checkpoint /ckpt/run7 --batch 8 --seq 512
    python -m kubeflow_tpu_torch.tools.eval_ppl --shards val.ktsh \\
        --model llama-tiny --random --cpu   # plumbing: ppl ~ vocab size

It runs on the card unless `--cpu` is given. On the card llama's
attention takes the flash forward at `--seq` 1024 and above (a multiple
of 512), the plain path below, as the reference takes XLA there.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Sequence

import numpy as np
import torch


def model_apply(family_name: str, cfg) -> Callable:
    """`(params, tokens) -> logits` of a registry family."""
    from kubeflow_tpu_torch.models import gemma, llama, llama_moe

    if family_name == "gemma":
        return lambda p, t: gemma.apply(p, cfg, t)
    if family_name == "llama-moe":
        return lambda p, t: llama_moe.apply(p, cfg, t)[0]
    return lambda p, t: llama.apply(p, cfg, t)


def evaluate(apply: Callable, params, shards: Sequence[str], *,
             batch: int, seq: int, seed: int = 0, max_batches: int = 0,
             device: torch.device | str | None = None) -> dict:
    """Token-weighted NLL of `apply` over the shards' windows: one epoch
    (or `max_batches`) of `open_loader(shards, batch, seq, seed)`.
    Returns `{"loss", "ppl", "tokens", "batches", "loader"}` (`loader`:
    the type of loader that ran)."""
    from kubeflow_tpu_torch.data import loader as dl
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.train.trainer import cross_entropy_loss

    dev = resolve_device(device)
    total, weight, batches = 0.0, 0.0, 0
    with dl.open_loader(list(shards), batch=batch, seq=seq,
                        seed=seed) as loader, torch.inference_mode():
        kind = type(loader).__name__
        per_epoch = loader.n_windows // batch
        n = max_batches or per_epoch
        for _ in range(min(n, per_epoch)):
            arr = loader.next_batch_on(dev)
            mask = torch.ones(arr[:, 1:].shape, dtype=torch.float32,
                              device=dev)
            # token-weighted sums, so a ragged set of batches averages
            # correctly
            loss = cross_entropy_loss(apply(params, arr[:, :-1]),
                                      arr[:, 1:], mask)
            w = mask.sum()
            total += float(loss * w)
            weight += float(w)
            batches += 1
    if weight == 0:
        return {"loss": None, "ppl": None, "tokens": 0, "batches": 0,
                "loader": kind}
    loss = total / weight
    return {"loss": loss, "ppl": float(np.exp(loss)), "tokens": int(weight),
            "batches": batches, "loader": kind}


def main(argv=None) -> int:
    from kubeflow_tpu_torch.serving.__main__ import (
        _load_params,
        model_registry,
    )

    names = tuple(model_registry())
    p = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.tools.eval_ppl")
    p.add_argument("--shards", required=True, nargs="+")
    p.add_argument("--model", default="llama-tiny", choices=names)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--checkpoint", default="")
    src.add_argument("--random", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--max-batches", type=int, default=0,
                   help="0 = one full epoch")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    if not args.checkpoint and not args.random:
        p.error("pass --checkpoint DIR or --random")

    from kubeflow_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    cfg, init, family = model_registry()[args.model]
    params = _load_params(args.checkpoint, args.seed, cfg, init, dev)
    out = evaluate(model_apply(family.name, cfg), params, args.shards,
                   batch=args.batch, seq=args.seq, seed=args.seed,
                   max_batches=args.max_batches, device=dev)
    if not out["tokens"]:
        print("no tokens evaluated", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "eval_perplexity",
        "model": args.model,
        "source": args.checkpoint or "random",
        "loss": round(out["loss"], 6),
        "ppl": round(out["ppl"], 4),
        "tokens": out["tokens"],
        "batches": out["batches"],
        "backend": str(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
