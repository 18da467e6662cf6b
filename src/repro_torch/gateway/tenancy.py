"""Tenancy: token auth, byte/dataset quotas, usage accounting.

A multi-tenant gateway must answer three questions before any byte is
admitted: *who is this* (token -> :class:`Tenant`), *may they write
this* (:meth:`TenantRegistry.charge` against byte/dataset quotas), and
*what have they used* (:meth:`TenantRegistry.snapshot`).  The registry
is the single synchronized authority for all three; the gateway calls it
on every admission path (``admit``/``admit_batch`` for redirect-capable
clients, proxied ``write_req``/``stripe_open``/``batch_open`` for
legacy ones).

Quota rejections are *typed* on the wire: the error reply carries a
``code`` field (``quota_exceeded`` / ``auth_failed``) that clients map
back to :class:`QuotaExceededError` / :class:`AuthError`, so a tenant
over budget gets a catchable, actionable exception instead of a generic
``RuntimeError`` — and other tenants' traffic is untouched.

Usage counts *admitted ingress* (cumulative bytes/datasets accepted),
not live staging occupancy: occupancy is the credit machinery's job
(see ``server.py``); quotas are the billing-shaped budget knob.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Optional, Union

DEFAULT_TENANT = "default"

CODE_QUOTA = "quota_exceeded"
CODE_AUTH = "auth_failed"


class QuotaExceededError(RuntimeError):
    """Typed rejection: the write would take the tenant over quota."""

    code = CODE_QUOTA

    def __init__(self, message: str, tenant: str = ""):
        super().__init__(message)
        self.tenant = tenant


class AuthError(RuntimeError):
    """Typed rejection: unknown/missing token on an authenticated pool."""

    code = CODE_AUTH


def error_reply(exc: BaseException) -> dict:
    """Wire form of a (possibly typed) rejection.  Untyped exceptions
    still get a ``code`` ("error") so every error reply is taggable."""
    code = getattr(exc, "code", None) or "error"
    return {"ok": False, "error": str(exc), "code": code}


def error_from_reply(h: dict, prefix: str = "staging error") -> Exception:
    """Client side: rebuild the typed exception from an error reply."""
    msg = f"{prefix}: {h.get('error')}"
    code = h.get("code")
    if code == CODE_QUOTA:
        return QuotaExceededError(msg, tenant=h.get("tenant", ""))
    if code == CODE_AUTH:
        return AuthError(msg)
    return RuntimeError(msg)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One tenant: identity, credential, budget (None = unlimited)."""

    name: str
    token: Optional[str] = None
    quota_bytes: Optional[int] = None
    quota_datasets: Optional[int] = None


class TenantRegistry:
    """Synchronized auth + quota + usage authority for one gateway.

    ``require_auth=False`` (the default) keeps single-tenant deployments
    zero-config: requests without a token run as the ``default`` tenant
    (optionally budgeted via ``default_quota_bytes``). With
    ``require_auth=True`` a missing/unknown token is an
    :class:`AuthError` — the hardened multi-tenant posture.
    """

    _GUARDED_BY = {
        "_tenants": "_lock",
        "_by_token": "_lock",
        "_usage": "_lock",
    }

    def __init__(self, tenants: Iterable[Tenant] = (), *,
                 default_quota_bytes: Optional[int] = None,
                 require_auth: bool = False):
        self.require_auth = require_auth
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._by_token: dict[str, Tenant] = {}
        self._usage: dict[str, dict] = {}
        if not require_auth:
            self.register(Tenant(DEFAULT_TENANT,
                                 quota_bytes=default_quota_bytes))
        for t in tenants:
            self.register(t)

    def register(self, tenant: Tenant) -> Tenant:
        with self._lock:
            self._tenants[tenant.name] = tenant
            if tenant.token:
                self._by_token[tenant.token] = tenant
            self._usage.setdefault(tenant.name,
                                   {"bytes": 0, "datasets": 0, "rejects": 0})
        return tenant

    def authenticate(self, token: Optional[str]) -> Tenant:
        """Token -> tenant. Bare tenant *names* are also accepted when
        the tenant has no token (convenience for trusted pools)."""
        with self._lock:
            if token:
                t = self._by_token.get(token)
                if t is None:
                    t = self._tenants.get(token)
                    if t is not None and t.token:
                        t = None      # named tenant requires its token
                if t is None:
                    raise AuthError(f"unknown tenant token {token!r}")
                return t
            if self.require_auth:
                raise AuthError("this gateway requires a tenant token")
            return self._tenants[DEFAULT_TENANT]

    def charge(self, tenant: Union[Tenant, str], nbytes: int,
               datasets: int = 1) -> None:
        """Admit ``datasets`` totalling ``nbytes`` against the tenant's
        budget — all-or-nothing, so a multi-item batch never lands half
        inside quota."""
        name = tenant.name if isinstance(tenant, Tenant) else tenant
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                raise AuthError(f"unknown tenant {name!r}")
            u = self._usage[name]
            if t.quota_bytes is not None and \
                    u["bytes"] + nbytes > t.quota_bytes:
                u["rejects"] += 1
                raise QuotaExceededError(
                    f"tenant {name!r} byte quota exceeded: "
                    f"{u['bytes']} + {nbytes} > {t.quota_bytes}",
                    tenant=name)
            if t.quota_datasets is not None and \
                    u["datasets"] + datasets > t.quota_datasets:
                u["rejects"] += 1
                raise QuotaExceededError(
                    f"tenant {name!r} dataset quota exceeded: "
                    f"{u['datasets']} + {datasets} > {t.quota_datasets}",
                    tenant=name)
            u["bytes"] += nbytes
            u["datasets"] += datasets

    def usage(self, name: str) -> dict:
        with self._lock:
            return dict(self._usage[name])

    def snapshot(self) -> dict:
        """Per-tenant usage + budget, JSON-safe (the gateway ``stats``
        surface and the launcher's accounting printout)."""
        with self._lock:
            out = {}
            for name, t in self._tenants.items():
                u = self._usage[name]
                out[name] = {**u, "quota_bytes": t.quota_bytes,
                             "quota_datasets": t.quota_datasets}
            return out
