"""CLI for the scenario engine.

    # generate a seeded scenario file
    python -m kubeflow_tpu_torch.scenarios generate flash-crowd \
        --seed 7 --out flash.jsonl --param burst_rps=20

    # replay it against any live serving endpoint (replica or router)
    python -m kubeflow_tpu_torch.scenarios replay flash.jsonl \
        --target http://127.0.0.1:8000 --model tiny --assert-expect

    # capture a live run into a replayable trace
    python -m kubeflow_tpu_torch.scenarios record \
        --target http://127.0.0.1:8000 --out captured.jsonl

    # inspect a trace without replaying it
    python -m kubeflow_tpu_torch.scenarios describe flash.jsonl

`replay` prints one JSON result line (the same dict the `expect`
block is judged against); `--assert-expect` exits nonzero on a
violated bound. The target may be the port's replica (`python -m
kubeflow_tpu_torch.serving ... --continuous`) or any server with the
same `:generate` SSE surface; `--model` is the served name.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.scenarios.generate import GENERATORS
from kubeflow_tpu_torch.scenarios.generate import generate as generate_trace
from kubeflow_tpu_torch.scenarios.record import record_from_server
from kubeflow_tpu_torch.scenarios.replay import (
    HttpTarget,
    check_expect,
    replay,
    summarize,
)
from kubeflow_tpu_torch.scenarios.trace import read_trace, write_trace


def _parse_params(pairs: list[str]) -> dict:
    """--param k=v with JSON-typed values (bare words stay strings)."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--param needs k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="kubeflow_tpu_torch.scenarios")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a seeded scenario file")
    g.add_argument("shape", choices=sorted(GENERATORS),
                   type=lambda s: s.replace("-", "_"))
    g.add_argument("--seed", type=int, required=True,
                   help="explicit seed — same seed, byte-identical "
                        "file, no wall-clock defaults")
    g.add_argument("--out", required=True)
    g.add_argument("--param", action="append", default=[],
                   help="generator kwarg override, k=v (JSON values)")

    r = sub.add_parser("replay", help="drive a live target with a trace")
    r.add_argument("trace")
    r.add_argument("--target", required=True,
                   help="base URL of a serving replica or fleet router")
    r.add_argument("--model", default="tiny")
    r.add_argument("--speed", type=float, default=1.0,
                   help="time-scale: 2.0 fires arrivals twice as fast")
    r.add_argument("--assert-expect", action="store_true",
                   help="exit 1 if the trace's expect block is violated")

    c = sub.add_parser("record", help="capture a live run into a trace")
    c.add_argument("--target", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--name", default="recorded")
    c.add_argument("--ids-file", default="",
                   help="newline-separated request ids to capture "
                        "(default: enumerate /v1/requests/timelines)")

    d = sub.add_parser("describe", help="summarize a trace file")
    d.add_argument("trace")

    args = p.parse_args(argv)

    if args.cmd == "generate":
        tr = generate_trace(args.shape, args.seed,
                              **_parse_params(args.param))
        write_trace(tr, args.out)
        print(json.dumps({"written": args.out, "name": tr.name,
                          "requests": len(tr.requests),
                          "duration_s": round(tr.duration_s, 3)}))
        return 0

    if args.cmd == "replay":
        tr = read_trace(args.trace)
        target = HttpTarget(args.target, model=args.model,
                                    seed=tr.seed, speed=args.speed)
        records = replay(tr, target, speed=args.speed)
        result = summarize(tr, records, speed=args.speed)
        failures = check_expect(tr.expect, result)
        result["expect_failures"] = failures
        print(json.dumps(result))
        if args.assert_expect and failures:
            for f in failures:
                print(f"expect FAIL: {f}", file=sys.stderr)
            return 1
        return 0

    if args.cmd == "record":
        ids = None
        if args.ids_file:
            with open(args.ids_file) as f:
                ids = [ln.strip() for ln in f if ln.strip()]
        tr = record_from_server(args.target, ids=ids,
                                        name=args.name)
        write_trace(tr, args.out)
        print(json.dumps({"written": args.out,
                          "requests": len(tr.requests),
                          "duration_s": round(tr.duration_s, 3)}))
        return 0

    if args.cmd == "describe":
        tr = read_trace(args.trace)
        by_tenant: dict[str, int] = {}
        groups: set[str] = set()
        for req in tr.requests:
            by_tenant[req.tenant or "-"] = \
                by_tenant.get(req.tenant or "-", 0) + 1
            if req.prefix_group:
                groups.add(req.prefix_group)
        print(json.dumps({
            "name": tr.name, "version": tr.version, "seed": tr.seed,
            "generator": tr.generator,
            "requests": len(tr.requests),
            "duration_s": round(tr.duration_s, 3),
            "prompt_tokens_total": sum(
                r.prompt_tokens for r in tr.requests),
            "max_new_total": sum(r.max_new for r in tr.requests),
            "abandoning": sum(1 for r in tr.requests
                              if r.abandon_at is not None),
            "prefix_groups": len(groups),
            "by_tenant": by_tenant,
            "expect": tr.expect,
        }))
        return 0

    return 2  # unreachable


if __name__ == "__main__":
    sys.exit(main())
