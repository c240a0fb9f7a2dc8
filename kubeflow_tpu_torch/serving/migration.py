"""Versioned wire format for live KV-block migration (a copy of
kubeflow_tpu/serving/migration.py: a record packed by either framework
unpacks and imports in the other).

One record describes one in-flight generation completely enough for a
peer replica to resume it token-identically under greedy sampling:

- `tokens` — the full replay prompt: the original prompt (including
  any registered-prefix expansion) plus every token emitted so far.
  This is the batcher's `kv_toks` log, the same sequence the paged
  blocks' canonical form is keyed by.
- `out` / `lps` — what the source already emitted (and its chosen-token
  logprobs), so the resumed stream starts exactly where the source
  stopped: `max_new - len(out)` tokens remain.
- `kv` — base64 payloads of the guaranteed-written FULL blocks (cells
  `[0, n_full * block_size)` of `tokens`), exported straight from the
  pool in canonical form. Tokens past the full-block line re-prefill on
  the destination; records for pending (never-admitted) requests carry
  `kv: null` and cost the peer one ordinary prefill.
- `geometry` — the exporter's pool layout. The importer validates it
  against its own pool BEFORE allocating anything: scattering a
  payload with a different block size / head count / head dim would
  silently corrupt every sequence that later seeds from those blocks.

Payloads travel as float32 (lossless for the bf16/f32 pools this
engine runs) and are cast to the destination pool dtype on import.
bf16 has no numpy dtype: `encode_kv` widens a torch tensor to float32
before it leaves torch (`export_blocks` returns the pool's dtype), and
`import_blocks` narrows the decoded float32 back through `upload`, so
bf16 -> fp32 -> bf16 returns the exported bits. Pure host-side Python.
"""

from __future__ import annotations

import base64

import numpy as np

from kubeflow_tpu_torch.obs.cachestats import prefix_hash

__all__ = [
    "MIGRATION_WIRE_VERSION",
    "pool_geometry",
    "validate_geometry",
    "encode_kv",
    "decode_kv",
    "pack_record",
    "unpack_record",
    "prefix_fetch_request",
    "validate_fetch_request",
]

MIGRATION_WIRE_VERSION = 1

_GEOMETRY_KEYS = ("block_size", "num_kv_heads", "head_dim",
                  "num_layers")


def pool_geometry(cengine) -> dict:
    """The geometry tuple a `ContinuousEngine`'s pool is laid out in —
    what `validate_geometry` compares wire records against."""
    cfg = cengine.engine.cfg
    return {
        "block_size": int(cengine.block_size),
        "num_kv_heads": int(cfg.num_kv_heads),
        "head_dim": int(cfg.head_dim),
        "num_layers": int(cfg.num_layers),
    }


def validate_geometry(geom: dict, cengine) -> None:
    """Raise ValueError when a record's geometry disagrees with the
    local pool — checked before any block is allocated, so a foreign
    payload can never corrupt the pool."""
    if not isinstance(geom, dict):
        raise ValueError(
            f"migration geometry must be a dict, got {type(geom).__name__}")
    local = pool_geometry(cengine)
    for key in _GEOMETRY_KEYS:
        got = geom.get(key)
        if got != local[key]:
            raise ValueError(
                f"migration geometry mismatch: {key}={got!r} (wire) vs "
                f"{local[key]} (local pool) — importing this payload "
                "would corrupt the destination KV pool")


def _host_f32(x) -> np.ndarray:
    """A payload as a contiguous float32 numpy array: torch tensors
    (a bf16 one has no numpy dtype) widen to float32 first."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def encode_kv(k, v) -> dict:
    """Pack block payloads (`[L, n, block_size, n_kv, hd]` each: numpy
    arrays or torch tensors of any float dtype) into a JSON-safe dict.
    float32 on the wire: lossless for bf16/f32 pools, and a plain dtype
    every peer can decode."""
    k32, v32 = _host_f32(k), _host_f32(v)
    if k32.shape != v32.shape or k32.ndim != 5:
        raise ValueError(
            f"encode_kv: k {k32.shape} / v {v32.shape} must be equal "
            "5-d [L, n, block_size, n_kv, hd] payloads")
    return {
        "n_full": int(k32.shape[1]),
        "shape": [int(d) for d in k32.shape],
        "k": base64.b64encode(k32.tobytes()).decode("ascii"),
        "v": base64.b64encode(v32.tobytes()).decode("ascii"),
    }


def decode_kv(kv: dict) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of `encode_kv`. Raises ValueError when the byte count
    disagrees with the declared shape (truncated/corrupt transfer)."""
    try:
        shape = tuple(int(d) for d in kv["shape"])
        k_raw = base64.b64decode(kv["k"])
        v_raw = base64.b64decode(kv["v"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed migration kv payload: {e}") from e
    want = int(np.prod(shape)) * 4
    if len(k_raw) != want or len(v_raw) != want:
        raise ValueError(
            f"migration kv payload truncated: shape {shape} needs "
            f"{want} bytes, got k={len(k_raw)} v={len(v_raw)}")
    k = np.frombuffer(k_raw, np.float32).reshape(shape)
    v = np.frombuffer(v_raw, np.float32).reshape(shape)
    return k, v


def pack_record(*, request_id: str, tenant: str, ns: str,
                tokens: list[int], out: list[int], lps: list[float],
                max_new: int, sampling: dict, geometry: dict,
                kv=None) -> dict:
    """Build one wire record. `kv` is an `(k, v)` array pair (encoded
    here) or None for tokens-only records."""
    return {
        "version": MIGRATION_WIRE_VERSION,
        "request_id": str(request_id),
        "tenant": str(tenant),
        "ns": str(ns),
        "tokens": [int(t) for t in tokens],
        "prompt_len": len(tokens) - len(out),
        "out": [int(t) for t in out],
        "lps": [float(x) for x in lps],
        "max_new": int(max_new),
        "sampling": dict(sampling),
        "geometry": dict(geometry),
        "kv": encode_kv(*kv) if kv is not None else None,
    }


def prefix_fetch_request(model: str, tokens, *, ns: str = "",
                         block_size: int) -> dict:
    """Body for a peer-side `POST /v1/blocks/export` (the fleet cache
    tier's pull path): the requesting replica asks a peer —
    named by the router's `X-KV-Peer` heat hint — for the cached KV
    blocks covering `tokens`. `prefix` is the 16-hex hash of the
    FIRST full block (the same `prefix_hash` the heat digests and the
    router's affinity key use), so the peer can cheaply verify the
    request names the prefix its digest advertised."""
    toks = [int(t) for t in tokens]
    if len(toks) < block_size:
        raise ValueError(
            f"prefix fetch needs >= one full block ({block_size} "
            f"tokens), got {len(toks)}")
    return {
        "model": str(model),
        "tokens": toks,
        "ns": str(ns),
        "prefix": prefix_hash(toks[:block_size], ns),
    }


def validate_fetch_request(body: dict, *,
                           block_size: int) -> tuple[str, list[int], str]:
    """Peer-side validation of a `/v1/blocks/export` body: shape-check
    the fields and recompute the first-block prefix hash — a mismatch
    means the requester and this pool disagree on block size or the
    body was mangled, and exporting would ship blocks the requester
    can't place. Returns `(model, tokens, ns)`; raises ValueError."""
    if not isinstance(body, dict):
        raise ValueError(
            f"fetch request must be a dict, got {type(body).__name__}")
    tokens = body.get("tokens")
    if (not isinstance(tokens, list) or not tokens
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in tokens)):
        raise ValueError("fetch request needs a non-empty integer "
                         "token list")
    ns = body.get("ns", "")
    if not isinstance(ns, str):
        raise ValueError("fetch request ns must be a string")
    if len(tokens) < block_size:
        raise ValueError(
            f"fetch request covers no full block: {len(tokens)} "
            f"tokens < block_size {block_size}")
    want = prefix_hash(tokens[:block_size], ns)
    if body.get("prefix") != want:
        raise ValueError(
            "fetch request prefix hash does not match its own tokens "
            "— block-size disagreement or mangled body")
    return str(body.get("model", "")), [int(t) for t in tokens], ns


def unpack_record(record: dict) -> dict:
    """Validate a wire record's envelope (version, required fields,
    basic types) and return it normalized. KV payloads stay encoded —
    `decode_kv` is the importer's call, after geometry validation."""
    if not isinstance(record, dict):
        raise ValueError(
            f"migration record must be a dict, got {type(record).__name__}")
    ver = record.get("version")
    if ver != MIGRATION_WIRE_VERSION:
        raise ValueError(
            f"unsupported migration wire version {ver!r} "
            f"(this replica speaks {MIGRATION_WIRE_VERSION})")
    for key in ("request_id", "tokens", "out", "max_new", "sampling",
                "geometry"):
        if key not in record:
            raise ValueError(f"migration record missing field {key!r}")
    tokens = record["tokens"]
    out = record["out"]
    if not isinstance(tokens, list) or not isinstance(out, list):
        raise ValueError("migration record tokens/out must be lists")
    if len(out) > len(tokens):
        raise ValueError(
            f"migration record: {len(out)} emitted tokens cannot "
            f"exceed the {len(tokens)}-token replay prompt")
    if len(out) >= int(record["max_new"]) and len(out) > 0:
        raise ValueError(
            "migration record: generation already complete "
            f"({len(out)}/{record['max_new']} tokens) — nothing to "
            "migrate")
    return {
        "request_id": str(record["request_id"]),
        "tenant": str(record.get("tenant", "")),
        "ns": str(record.get("ns", "")),
        "tokens": [int(t) for t in tokens],
        "prompt_len": int(record.get("prompt_len",
                                     len(tokens) - len(out))),
        "out": [int(t) for t in out],
        "lps": [float(x) for x in record.get("lps", [])],
        "max_new": int(record["max_new"]),
        "sampling": dict(record["sampling"]),
        "geometry": dict(record["geometry"]),
        "kv": record.get("kv"),
    }
