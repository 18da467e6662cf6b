"""Tenancy's typed wire errors: the port's copy of the error half of the
reference's ``gateway/tenancy.py`` (the tenant registry, quotas and the
gateway itself come with a later slice).

The reference module's own description follows.

Tenancy: token auth, byte/dataset quotas, usage accounting.

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
