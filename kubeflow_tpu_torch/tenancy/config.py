"""Tenant specs and where they come from.

A `TenantSpec` is the QoS contract for one tenant: its fair-share
weight, priority class, rate limits, and KV-pool share. A
`TenancyConfig` is the full tenant table plus the safe `default`
tenant every unlabeled (or unknown) request resolves to — resolving
to `default` instead of minting a spec per unknown name is what keeps
queue/metric cardinality bounded by CONFIG, not by traffic.

Specs load from a JSON file (`load_config`). (A copy of
kubeflow_tpu/tenancy/config.py: the port imports nothing of the JAX
package. The reference's bridge from control-plane Profile annotations,
`tenant_from_profile` and `config_from_profiles`, belongs to the control
plane, which the port does not carry.)
"""

from __future__ import annotations

import dataclasses
import json

# Strict priority classes, highest first: the scheduler serves a lower
# class only when every higher class is empty (or rate-paced).
PRIORITIES = ("interactive", "standard", "batch")

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """QoS contract for one tenant. Rates <= 0 mean unlimited; a burst
    of 0 defaults to max(1, rate). `kv_block_share` bounds the fraction
    of the KV pool this tenant's CONCURRENT requests may hold (1.0 =
    uncapped); `prefix_isolation` salts the radix prefix cache with the
    tenant id so cross-tenant prompts can never share (or time) cache
    entries."""

    name: str
    weight: float = 1.0
    priority: str = "standard"
    requests_per_s: float = 0.0
    request_burst: float = 0.0
    tokens_per_s: float = 0.0
    token_burst: float = 0.0
    kv_block_share: float = 1.0
    prefix_isolation: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"tenant {self.name!r}: priority {self.priority!r} "
                f"not in {PRIORITIES}")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight}")
        if not 0 < self.kv_block_share <= 1:
            raise ValueError(
                f"tenant {self.name!r}: kv_block_share must be in "
                f"(0, 1], got {self.kv_block_share}")


_SPEC_FIELDS = {f.name for f in dataclasses.fields(TenantSpec)} - {"name"}


def spec_from_dict(name: str, data: dict) -> TenantSpec:
    unknown = set(data) - _SPEC_FIELDS
    if unknown:
        raise ValueError(
            f"tenant {name!r}: unknown spec field(s) {sorted(unknown)}; "
            f"valid: {sorted(_SPEC_FIELDS)}")
    return TenantSpec(name=name, **data)


class TenancyConfig:
    """The tenant table. Always contains a `default` tenant; `resolve`
    maps any request identity (including "" and names nobody
    configured) onto a configured spec."""

    def __init__(self, tenants=(), default: TenantSpec | None = None):
        self.tenants: dict[str, TenantSpec] = {}
        for spec in tenants:
            if spec.name in self.tenants:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self.tenants[spec.name] = spec
        if default is not None:
            if default.name != DEFAULT_TENANT:
                raise ValueError(
                    f"default tenant must be named {DEFAULT_TENANT!r}, "
                    f"got {default.name!r}")
            self.tenants[DEFAULT_TENANT] = default
        self.tenants.setdefault(
            DEFAULT_TENANT, TenantSpec(name=DEFAULT_TENANT))

    @property
    def default(self) -> TenantSpec:
        return self.tenants[DEFAULT_TENANT]

    def resolve(self, name: str) -> TenantSpec:
        """Spec for a request identity. Unlabeled and UNKNOWN names both
        land on `default` — an unrecognized `X-Tenant` must not mint
        per-value queues or metric series (unbounded cardinality is a
        DoS vector all by itself)."""
        return self.tenants.get(name or DEFAULT_TENANT, self.default)

    def names(self) -> list[str]:
        return sorted(self.tenants)


def config_from_dict(data: dict) -> TenancyConfig:
    """`{"tenants": {name: {spec fields}}, "default": {spec fields}}` —
    the on-disk shape `--tenants file.json` loads."""
    tenants = [spec_from_dict(name, dict(fields or {}))
               for name, fields in (data.get("tenants") or {}).items()
               if name != DEFAULT_TENANT]
    default = None
    merged = dict(data.get("tenants") or {}).get(DEFAULT_TENANT)
    if data.get("default") is not None:
        merged = data["default"]
    if merged is not None:
        default = spec_from_dict(DEFAULT_TENANT, dict(merged))
    return TenancyConfig(tenants, default=default)


def load_config(path) -> TenancyConfig:
    with open(path, encoding="utf-8") as f:
        return config_from_dict(json.load(f))
