"""Prepare training data: text files -> BPE tokenizer -> KTSH shards
(counterpart: tools/prepare_data.py, the same flags and the same JSON
summary line).

The front door of the data story (prepare -> train -> evaluate ->
serve): its outputs feed `data.loader.open_loader` (training),
`kubeflow_tpu_torch.tools.eval_ppl` (evaluation) and the server's text
mode (the saved tokenizer):

    python -m kubeflow_tpu_torch.tools.prepare_data --input corpus/*.txt \\
        --out /data/run7 --vocab-size 32000 --shard-tokens 50000000

Emits `<out>/tokenizer.json`, `<out>/shard-NNNNN.ktsh` and one JSON
summary line. `--tokenizer` reuses an existing tokenizer instead of
training one (so validation shards share the training vocabulary).
A shard is cut after the document that fills it, so shards hold at
least `--shard-tokens` tokens each, bar the last.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from kubeflow_tpu_torch.data import bpe
from kubeflow_tpu_torch.data import loader as dl


def _iter_texts(paths: list[str]):
    for p in paths:
        with open(p, encoding="utf-8", errors="replace") as f:
            yield f.read()


def prepare(paths: list[str], out: str, *, vocab_size: int = 32000,
            tokenizer: str = "", shard_tokens: int = 50_000_000,
            eos_between_docs: bool = True) -> dict:
    """Tokenize `paths` (in the order given) into shards under `out`;
    returns the summary (also `"shard_paths"`, the shards written)."""
    os.makedirs(out, exist_ok=True)
    if tokenizer:
        tok = bpe.Tokenizer.load(tokenizer)
        tok_src = tokenizer
    else:
        tok = bpe.train(_iter_texts(paths), vocab_size=vocab_size)
        tok_src = os.path.join(out, "tokenizer.json")
        tok.save(tok_src)

    shards: list[str] = []
    buf: list[int] = []
    total = 0

    def flush():
        if not buf:
            return
        path = os.path.join(out, f"shard-{len(shards):05d}.ktsh")
        dl.write_shard(path, np.asarray(buf, np.int32))
        shards.append(path)
        buf.clear()

    for text in _iter_texts(paths):
        ids = tok.encode(text, eos=eos_between_docs)
        buf.extend(ids)
        total += len(ids)
        if len(buf) >= shard_tokens:
            flush()
    flush()
    return {
        "metric": "prepare_data",
        "files": len(paths),
        "tokens": total,
        "shards": len(shards),
        "vocab_size": tok.vocab_size,
        "tokenizer": tok_src,
        "out": out,
        "shard_paths": shards,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.tools.prepare_data")
    p.add_argument("--input", required=True, nargs="+",
                   help="text files (globs ok)")
    p.add_argument("--out", required=True)
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--tokenizer", default="",
                   help="reuse an existing tokenizer.json instead of "
                        "training one (val/test shards MUST share the "
                        "train vocabulary)")
    p.add_argument("--shard-tokens", type=int, default=50_000_000,
                   help="tokens per KTSH shard")
    p.add_argument("--eos-between-docs",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="append EOS after each document "
                        "(--no-eos-between-docs disables)")
    args = p.parse_args(argv)

    paths: list[str] = []
    for pat in args.input:
        matched = glob.glob(pat)
        if not matched:
            # a typo'd pattern must not silently shrink the dataset
            print(f"no input files match {pat!r}", file=sys.stderr)
            return 1
        paths.extend(matched)
    # a file matched by two patterns is tokenized once
    paths = sorted(set(paths))
    summary = prepare(paths, args.out, vocab_size=args.vocab_size,
                      tokenizer=args.tokenizer,
                      shard_tokens=args.shard_tokens,
                      eos_between_docs=args.eos_between_docs)
    summary.pop("shard_paths")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
