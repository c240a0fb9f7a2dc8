"""Memory-fit planner: does model x mesh x batch fit per-chip memory?
(counterpart: the repository's tools/memplan.py; the port imports
nothing of the JAX package).

    python -m kubeflow_tpu_torch.tools.memplan --model llama3-8b \
        --topology v5e-16 --mesh data=1,fsdp=16,tensor=1 --batch 16 \
        --seq 2048

Prints a per-chip budget table on stderr and one JSON line on stdout;
exits 1 when the plan exceeds the chip's memory, 2 on a usage error
(argparse). The reference sizes the params with `jax.eval_shape`; the
port draws them on the "meta" device from its models' own `init`
(shapes and dtypes, no storage), resolves each leaf's logical axes
(`param_logical_axes`) through `LLAMA_RULES`, and keeps the reference's
accounting, its slice table (`parallel.mesh.SLICE_TOPOLOGIES`), its
`HBM_BYTES` per TPU generation and its 0.92 budget: the planner answers
for TPU slices, as the reference's does, so its numbers are a TPU
chip's budget, not a card's.

Accounting (the reference's):
- params: each leaf's size x dtype, over its shard factor (the product
  of the mesh-axis sizes its spec names);
- adam moments: 2 x params, sharded like the params;
- gradients: 1 x params (live during the update step);
- activations: with full remat, the residual stream saved once per
  layer boundary (batch x seq x hidden x act dtype) over the batch axes
  (data x fsdp), one attention working set for the layer being
  recomputed, and the chunked-CE logits chunk (vocab / the trainer's
  default chunk count) — an estimate, on the conservative side.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import math
import sys

import torch

HBM_BYTES = {"v5e": 16e9, "v5p": 96e9, "v4": 32e9, "v6e": 32e9}


def model_registry():
    """Built from the models' own CONFIGS dicts; gemma's keys are
    prefixed where they would collide with llama's ("tiny")."""
    from kubeflow_tpu_torch.models import gemma, llama

    out = {name: ("llama", cfg) for name, cfg in llama.CONFIGS.items()}
    for name, cfg in gemma.CONFIGS.items():
        key = name if name.startswith("gemma") else f"gemma-{name}"
        out[key] = ("gemma", cfg)
    return out


def _leaves(tree, prefix=()):
    """(path, leaf) in sorted key order (the reference's tree order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@functools.lru_cache(maxsize=None)
def param_shapes(family: str, cfg):
    """-> ([(path, meta tensor)], {path: logical axes}): the trained
    params' shapes and dtypes, drawn on the meta device (once a
    config)."""
    from kubeflow_tpu_torch.models import gemma, llama

    mod = {"llama": llama, "gemma": gemma}[family]
    params = mod.init(cfg, 0, "meta", train=True)
    axes = dict(_leaves(mod.param_logical_axes(cfg)))
    return list(_leaves(params)), axes


def shard_factor(spec_entry, mesh_sizes: dict[str, int]) -> int:
    if spec_entry is None:
        return 1
    if isinstance(spec_entry, (tuple, list)):
        f = 1
        for a in spec_entry:
            f *= mesh_sizes.get(a, 1)
        return f
    return mesh_sizes.get(spec_entry, 1)


def _factor(spec, mesh_sizes) -> int:
    factor = 1
    for entry in spec:
        factor *= shard_factor(entry, mesh_sizes)
    return factor


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def plan(model: str, mesh_sizes: dict[str, int], batch: int, seq: int,
         generation: str) -> dict:
    from kubeflow_tpu_torch.parallel.sharding import LLAMA_RULES
    from kubeflow_tpu_torch.train.trainer import (
        chunked_cross_entropy_from_hidden,
    )

    family, cfg = model_registry()[model]
    leaves, axes = param_shapes(family, cfg)
    n_params = 0
    param_bytes_per_chip = 0.0
    for path, leaf in leaves:
        factor = _factor(LLAMA_RULES.resolve(axes[path]), mesh_sizes)
        size = math.prod(leaf.shape)
        n_params += size
        param_bytes_per_chip += size * leaf.element_size() / factor

    opt_bytes = 2 * param_bytes_per_chip          # adam mu + nu
    grad_bytes = param_bytes_per_chip
    batch_shards = mesh_sizes.get("data", 1) * mesh_sizes.get("fsdp", 1)
    act_itemsize = _itemsize(cfg.dtype)
    residuals = (batch * seq * cfg.hidden_size * act_itemsize
                 * cfg.num_layers / batch_shards)
    attn_work = (batch * seq * cfg.num_heads * cfg.head_dim
                 * act_itemsize * 4 / batch_shards
                 / max(mesh_sizes.get("tensor", 1), 1))
    # the chunked-CE logits chunk at the trainer's default chunk count
    num_chunks = inspect.signature(
        chunked_cross_entropy_from_hidden).parameters["num_chunks"].default
    ce_chunk = (batch * seq * cfg.vocab_size / num_chunks * 4
                / batch_shards / max(mesh_sizes.get("tensor", 1), 1))
    act_bytes = residuals + attn_work + ce_chunk

    total = param_bytes_per_chip + opt_bytes + grad_bytes + act_bytes
    hbm = HBM_BYTES[generation]
    budget = hbm * 0.92  # scratch/fragmentation headroom reserve
    return {
        "model": model,
        "params": n_params,
        "mesh": dict(mesh_sizes),
        "batch": batch, "seq": seq, "generation": generation,
        "per_chip_gb": {
            "params": round(param_bytes_per_chip / 1e9, 3),
            "adam_moments": round(opt_bytes / 1e9, 3),
            "gradients": round(grad_bytes / 1e9, 3),
            "activations_est": round(act_bytes / 1e9, 3),
            "total": round(total / 1e9, 3),
            "hbm": round(hbm / 1e9, 1),
        },
        "fits": bool(total <= budget),
        # headroom against the same 0.92 budget the verdict uses: the
        # two never disagree in sign
        "headroom_gb": round((budget - total) / 1e9, 3),
    }


def plan_serving(model: str, mesh_sizes: dict[str, int], slots: int,
                 max_len: int, generation: str, quant: str) -> dict:
    """Serving-side fit: bf16 (or int8) weights + the continuous
    batcher's slot KV cache ([L, S, max_len, kv, hd] x2) + a prefill
    working set. Decode has no optimizer state and no gradients."""
    from kubeflow_tpu_torch.parallel.sharding import LLAMA_RULES

    family, cfg = model_registry()[model]
    leaves, axes = param_shapes(family, cfg)
    weight_bytes = 0.0
    itemsize = 1 if quant == "int8" else 2  # int8 vs bf16 serving
    for path, leaf in leaves:
        factor = _factor(LLAMA_RULES.resolve(axes[path]), mesh_sizes)
        weight_bytes += math.prod(leaf.shape) * itemsize / factor
    # kv heads shard on tensor, never more ways than heads exist (one kv
    # head cannot shard at all)
    kv_shards = max(min(mesh_sizes.get("tensor", 1),
                        cfg.num_kv_heads), 1)
    kv_bytes = (2 * cfg.num_layers * slots * max_len
                * cfg.num_kv_heads * cfg.head_dim * 2 / kv_shards)
    # prefill working set: one bucket of residuals, sharded over the
    # tensor axis through the hidden dim
    t = max(mesh_sizes.get("tensor", 1), 1)
    prefill_bytes = slots * max_len * cfg.hidden_size * 2 * 2 / t
    total = weight_bytes + kv_bytes + prefill_bytes
    hbm = HBM_BYTES[generation]
    budget = hbm * 0.92
    return {
        "model": model, "mode": "serving", "mesh": dict(mesh_sizes),
        "slots": slots, "max_len": max_len, "quant": quant or "bf16",
        "generation": generation,
        "per_chip_gb": {
            "weights": round(weight_bytes / 1e9, 3),
            "kv_cache": round(kv_bytes / 1e9, 3),
            "prefill_est": round(prefill_bytes / 1e9, 3),
            "total": round(total / 1e9, 3),
            "hbm": round(hbm / 1e9, 1),
        },
        "fits": bool(total <= budget),
        "headroom_gb": round((budget - total) / 1e9, 3),
        # the knob with the most leverage when it doesn't fit
        "max_slots_that_fit": int(
            max(0, (budget - weight_bytes)
                // ((kv_bytes + prefill_bytes) / slots))) if slots else 0,
    }


def main(argv: list[str] | None = None) -> int:
    from kubeflow_tpu_torch.parallel.mesh import (
        HYBRID_MESH_AXES,
        SLICE_TOPOLOGIES,
    )

    p = argparse.ArgumentParser(prog="python -m "
                                "kubeflow_tpu_torch.tools.memplan")
    p.add_argument("--model", default="llama3-8b",
                   choices=sorted(model_registry()))
    p.add_argument("--topology", default="v5e-16",
                   help="slice name (sets chip count + generation)")
    p.add_argument("--mesh", default="",
                   help="data=1,fsdp=16,tensor=1 (default: pure FSDP "
                        "over the whole slice)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--serve", action="store_true",
                   help="plan a SERVING deployment instead of training "
                        "(weights + continuous-batcher slot KV cache)")
    p.add_argument("--slots", type=int, default=8,
                   help="continuous batcher slots (--serve)")
    p.add_argument("--max-len", type=int, default=2048,
                   help="cache bucket (--serve)")
    p.add_argument("--quant", choices=("", "int8"), default="",
                   help="int8 weight-only serving (--serve)")
    args = p.parse_args(argv)

    topo = SLICE_TOPOLOGIES.get(args.topology)
    if topo is None:
        p.error(f"unknown topology {args.topology!r}; known: "
                f"{sorted(SLICE_TOPOLOGIES)}")
    generation = args.topology.split("-")[0]
    if args.mesh:
        mesh_sizes = {}
        for part in args.mesh.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in HYBRID_MESH_AXES:
                p.error(f"unknown mesh axis {k!r}; known: "
                        f"{list(HYBRID_MESH_AXES)} (a typo here would "
                        "silently plan an unsharded model)")
            try:
                mesh_sizes[k] = int(v)
            except ValueError:
                p.error(f"mesh axis {k}={v!r} is not an integer")
    else:
        mesh_sizes = {"data": 1, "fsdp": topo.chips, "tensor": 1}
    n_mesh = math.prod(mesh_sizes.values())
    if n_mesh != topo.chips:
        p.error(f"mesh {mesh_sizes} has {n_mesh} devices; topology "
                f"{args.topology} has {topo.chips} chips")

    if args.serve:
        result = plan_serving(args.model, mesh_sizes, args.slots,
                              args.max_len, generation, args.quant)
        gb = result["per_chip_gb"]
        print(f"# serve {args.model} on {args.topology} "
              f"mesh={mesh_sizes} slots={args.slots} "
              f"max_len={args.max_len} quant={result['quant']}",
              file=sys.stderr)
        for k in ("weights", "kv_cache", "prefill_est", "total", "hbm"):
            print(f"#   {k:>16}: {gb[k]:8.3f} GB", file=sys.stderr)
        print(f"#   {'fits':>16}: {result['fits']} "
              f"(headroom {result['headroom_gb']} GB; up to "
              f"{result['max_slots_that_fit']} slots fit)",
              file=sys.stderr)
        print(json.dumps(result))
        return 0 if result["fits"] else 1  # same gate as training mode
    result = plan(args.model, mesh_sizes, args.batch, args.seq,
                  generation)
    gb = result["per_chip_gb"]
    print(f"# {args.model} on {args.topology} mesh={mesh_sizes} "
          f"batch={args.batch} seq={args.seq}", file=sys.stderr)
    for k in ("params", "adam_moments", "gradients", "activations_est",
              "total", "hbm"):
        print(f"#   {k:>16}: {gb[k]:8.3f} GB", file=sys.stderr)
    print(f"#   {'fits':>16}: {result['fits']} "
          f"(headroom {result['headroom_gb']} GB)", file=sys.stderr)
    print(json.dumps(result))
    return 0 if result["fits"] else 1


if __name__ == "__main__":
    sys.exit(main())
