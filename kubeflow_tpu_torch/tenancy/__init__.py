"""Multi-tenant QoS for the serving data plane (counterpart:
kubeflow_tpu/tenancy/, copied: the port imports nothing of the JAX
package).

Per-tenant rate limits and KV shares (`ledger`), a priority + weighted
fair-share admission queue with preemption (`scheduler`), and tenant
specs loadable from a file (`config`). The reference's Profile-annotation
bridge belongs to the control plane, which the port does not carry.

Pure host-side Python, unit-testable with a fake clock.
"""

from __future__ import annotations

from kubeflow_tpu_torch.tenancy.config import (
    DEFAULT_TENANT,
    PRIORITIES,
    TenancyConfig,
    TenantSpec,
    config_from_dict,
    load_config,
)
from kubeflow_tpu_torch.tenancy.ledger import (
    THROTTLE_REASONS,
    TenantLedger,
    Throttled,
    TokenBucket,
)
from kubeflow_tpu_torch.tenancy.scheduler import FairShareQueue, ReqMeta

__all__ = [
    "DEFAULT_TENANT",
    "PRIORITIES",
    "THROTTLE_REASONS",
    "FairShareQueue",
    "ReqMeta",
    "TenancyConfig",
    "TenantLedger",
    "TenantSpec",
    "Throttled",
    "TokenBucket",
    "config_from_dict",
    "load_config",
]
