"""Multi-tenant staging gateway (DESIGN.md §12).

One address fronting a pool of staging servers: consistent-hash
placement (:mod:`~repro_torch.gateway.ring`), tenancy + admission
(:mod:`~repro_torch.gateway.tenancy`), redirect/proxy wire front
(:mod:`~repro_torch.gateway.server`), scatter-gather analytical routing
(:mod:`~repro_torch.gateway.router`), and the :class:`StagingPool` harness.
"""
from repro_torch.gateway.client import GatewayClient
from repro_torch.gateway.pool import StagingPool
from repro_torch.gateway.ring import DEFAULT_VNODES, HashRing, RingNode
from repro_torch.gateway.router import (MultiSubscription, RouterSession,
                                  gather_aggregate, gather_select,
                                  merge_histograms, route_query)
from repro_torch.gateway.server import Backend, GatewayServer
from repro_torch.gateway.tenancy import (AuthError, QuotaExceededError, Tenant,
                                   TenantRegistry, error_from_reply,
                                   error_reply)

__all__ = [
    "AuthError", "Backend", "DEFAULT_VNODES", "GatewayClient",
    "GatewayServer", "HashRing", "MultiSubscription", "QuotaExceededError",
    "RingNode", "RouterSession", "StagingPool", "Tenant", "TenantRegistry",
    "error_from_reply", "error_reply", "gather_aggregate", "gather_select",
    "merge_histograms", "route_query",
]
