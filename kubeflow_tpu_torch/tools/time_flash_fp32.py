"""Time the fp32 flash kernels (forward, dQ, dK/dV) of a checkout of
this repository on one NVIDIA card, at the causal training shapes of
llama3-1b (b 2, s 2048, n_q 16, n_kv 8, hd 128) and gemma-2b (n_q 8,
n_kv 1, hd 256), with fp32 SDPA (K/V repeated over the group) beside
them. For comparing two trees on one card in one call:

    python3 kubeflow_tpu_torch/tools/time_flash_fp32.py --root OLD
    python3 kubeflow_tpu_torch/tools/time_flash_fp32.py --root .

`--root` is the checkout whose `kubeflow_tpu_torch` is imported (and
whose kernels are built into its own `build/kernels/`). Device ms per
call: `--calls` calls captured in one CUDA graph and replayed between
two CUDA events, as `chip_smoke.py` phase 2 times them. Prints one JSON
line: the card, and per shape each kernel's ms (dK/dV at the tree's
default split) and SDPA's forward and forward + backward ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"llama3-1b": (2, 2048, 16, 8, 128), "gemma-2b": (2, 2048, 8, 1, 256)}


def _graph_ms(torch, fn, calls):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True,
                   help="checkout whose kubeflow_tpu_torch is timed")
    p.add_argument("--calls", type=int, default=10)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_flash_fp32: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    out = {"root": os.path.abspath(args.root), "card": card}
    gen = torch.Generator().manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for model, (b, s, n_q, n_kv, hd) in SHAPES.items():
        q, do = (torch.randn(b, s, n_q, hd, generator=gen).to(dev)
                 for _ in range(2))
        k, v = (torch.randn(b, s, n_kv, hd, generator=gen).to(dev)
                for _ in range(2))
        o, lse = fa.flash_fwd_plain(q, k, v)
        grads = (q, k, v, do, lse, fa.flash_delta(o, do))
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (x.repeat_interleave(n_q // n_kv, dim=2).transpose(1, 2)
                  .detach().requires_grad_(True) for x in (k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                return sdpa(qt, kt, vt, is_causal=True)

        out[model] = {
            "fwd": _graph_ms(torch, lambda: fa.flash_block_fwd(
                q, k, v, causal=True), args.calls),
            "dq": _graph_ms(torch, lambda: fa.flash_dq(*grads), args.calls),
            "dkv": _graph_ms(torch, lambda: fa.flash_dkv(*grads),
                             args.calls),
            "sdpa_fwd": _graph_ms(torch, sdpa_fwd, args.calls),
            "sdpa_fwd_bwd": _graph_ms(torch, lambda: torch.autograd.grad(
                sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot),
                args.calls)}
        del q, k, v, do, o, lse, grads, qt, kt, vt, dot
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
