"""Versioned, replayable traffic traces: the scenario interchange format.

One trace = one JSONL file. The FIRST line is the header object
(`{"trace": {...}}`) carrying the format version, the scenario name,
the seed that generated it (0 for recordings), free-form `meta`, and a
declarative `expect` block — the SLO outcomes a replay of this trace
must satisfy (see `kubeflow_tpu_torch.scenarios.replay.check_expect`). Every
following line is one request:

    {"id": "r-000007", "at": 1.25, "prompt_tokens": 24, "max_new": 16,
     "tenant": "bulk", "priority": "batch", "prefix_group": "agent-3",
     "prefix_tokens": 16, "abandon_at": null}

- `at`            — arrival offset in seconds from trace start
                    (open-loop: the replayer fires at `at/speed`
                    regardless of how the target is coping),
- `prompt_tokens` — prompt LENGTH; actual token ids are derived
                    deterministically from (trace seed, prefix_group,
                    id) at replay time, so traces stay compact and a
                    recorded trace never ships user content,
- `prefix_group`  — requests sharing a group share their first
                    `prefix_tokens` prompt tokens, reproducing the
                    radix-cache reuse structure of agent swarms,
- `abandon_at`    — offset from trace start at which the client hangs
                    up (null = patient client); the replayer closes
                    the stream there, exercising the slot-release
                    cancellation path.

The writer is canonical — fixed key order, floats rounded at
construction — so write -> read -> write is byte-identical and traces
diff cleanly in review. Version gates reading: a major bump means the
field semantics changed and old readers must refuse, not guess.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any

TRACE_VERSION = 1

# Canonical per-request key order (the writer emits exactly these, in
# this order; the reader tolerates unknown EXTRA keys for forward
# compat within a major version).
REQUEST_FIELDS = ("id", "at", "prompt_tokens", "max_new", "tenant",
                  "priority", "prefix_group", "prefix_tokens",
                  "abandon_at")

_TIME_DECIMALS = 6  # microsecond resolution; rounds at construction


def _t(v: float) -> float:
    """Canonical time value: rounded once, so the float that lives in
    the dataclass is the float JSON round-trips."""
    return round(float(v), _TIME_DECIMALS)


@dataclasses.dataclass
class TraceRequest:
    """One arrival. Frozen-by-convention: normalize in __post_init__,
    then treat as immutable."""

    id: str
    at: float
    prompt_tokens: int
    max_new: int
    tenant: str = ""
    priority: str = "standard"
    prefix_group: str = ""
    prefix_tokens: int = 0
    abandon_at: float | None = None

    def __post_init__(self) -> None:
        self.at = _t(self.at)
        if self.abandon_at is not None:
            self.abandon_at = _t(self.abandon_at)
        if self.at < 0:
            raise ValueError(f"request {self.id!r}: at {self.at} < 0")
        if self.prompt_tokens < 1:
            raise ValueError(
                f"request {self.id!r}: prompt_tokens must be >= 1")
        if self.max_new < 1:
            raise ValueError(
                f"request {self.id!r}: max_new must be >= 1")
        if not (0 <= self.prefix_tokens <= self.prompt_tokens):
            raise ValueError(
                f"request {self.id!r}: prefix_tokens "
                f"{self.prefix_tokens} outside [0, prompt_tokens]")
        if self.prefix_tokens and not self.prefix_group:
            raise ValueError(
                f"request {self.id!r}: prefix_tokens without a "
                "prefix_group")
        if self.abandon_at is not None and self.abandon_at < self.at:
            raise ValueError(
                f"request {self.id!r}: abandon_at {self.abandon_at} "
                f"before arrival {self.at}")

    def to_json(self) -> str:
        d = {k: getattr(self, k) for k in REQUEST_FIELDS}
        return json.dumps(d, separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TraceRequest":
        missing = [k for k in ("id", "at", "prompt_tokens", "max_new")
                   if k not in d]
        if missing:
            raise ValueError(f"trace request missing {missing}: {d}")
        return cls(**{k: d[k] for k in REQUEST_FIELDS if k in d})


@dataclasses.dataclass
class Trace:
    """Header + arrivals, sorted by (at, id) at construction so two
    traces with the same content serialize identically regardless of
    generation order."""

    name: str
    requests: list[TraceRequest]
    seed: int = 0
    generator: str = ""
    expect: dict[str, dict[str, float]] = dataclasses.field(
        default_factory=dict)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = TRACE_VERSION

    def __post_init__(self) -> None:
        if self.version != TRACE_VERSION:
            raise ValueError(
                f"trace version {self.version} unsupported (this "
                f"reader speaks version {TRACE_VERSION}); regenerate "
                "or upgrade")
        for k, bounds in self.expect.items():
            if not isinstance(bounds, dict):
                raise ValueError(
                    f"expect[{k!r}] must be a dict of bounds")
            bad = set(bounds) - {"min", "max"}
            if bad:
                raise ValueError(
                    f"expect[{k!r}] has unknown bound ops {sorted(bad)}"
                    " (only min/max)")
        self.requests = sorted(self.requests,
                               key=lambda r: (r.at, r.id))
        seen: set[str] = set()
        for r in self.requests:
            if r.id in seen:
                raise ValueError(f"duplicate request id {r.id!r}")
            seen.add(r.id)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].at if self.requests else 0.0

    def header_json(self) -> str:
        return json.dumps({"trace": {
            "version": self.version,
            "name": self.name,
            "seed": self.seed,
            "generator": self.generator,
            "expect": self.expect,
            "meta": self.meta,
        }}, separators=(",", ":"), sort_keys=False)

    def dumps(self) -> str:
        buf = io.StringIO()
        buf.write(self.header_json() + "\n")
        for r in self.requests:
            buf.write(r.to_json() + "\n")
        return buf.getvalue()

    @classmethod
    def loads(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace file")
        try:
            head = json.loads(lines[0])
        except json.JSONDecodeError as e:
            raise ValueError(f"trace header is not JSON: {e}") from None
        if not isinstance(head, dict) or "trace" not in head:
            raise ValueError(
                "first line must be the header object "
                '{"trace": {...}} — is this a scenario trace file?')
        h = head["trace"]
        version = h.get("version")
        if version != TRACE_VERSION:
            raise ValueError(
                f"trace version {version!r} unsupported (reader "
                f"speaks {TRACE_VERSION})")
        reqs = []
        for i, ln in enumerate(lines[1:], start=2):
            try:
                reqs.append(TraceRequest.from_dict(json.loads(ln)))
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                raise ValueError(f"trace line {i}: {e}") from None
        return cls(name=h.get("name", ""), requests=reqs,
                   seed=int(h.get("seed", 0)),
                   generator=h.get("generator", ""),
                   expect=h.get("expect", {}) or {},
                   meta=h.get("meta", {}) or {},
                   version=version)


def write_trace(trace: Trace, path: str) -> None:
    with open(path, "w") as f:
        f.write(trace.dumps())


def read_trace(path: str) -> Trace:
    with open(path) as f:
        return Trace.loads(f.read())
