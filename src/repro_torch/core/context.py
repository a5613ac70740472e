"""Scoped TCEC precision-policy resolution — the switchboard for which
policy each matmul *site* runs, without threading policy strings through
call signatures.  A copy of ``repro.core.context`` (pure Python).

Three tiers, lowest to highest precedence:

1. **Global default** (``set_global_default``, ships as ``bf16x1`` —
   standard mixed precision).
2. **Config defaults** (``policy_defaults({...})``): a site->policy mapping
   installed by model entry points from ``ArchConfig.site_policies()``.
   These are *defaults*, deliberately below every ``policy_scope`` so a
   benchmark can sweep policies over unmodified model code.
3. **Scopes** (``policy_scope``): nested context managers.  A scope carries
   an optional default policy plus named-site overrides::

       with policy_scope("bf16x1", router="bf16x3", lm_head="bf16x6"):
           loss_fn(params, batch, cfg)   # three policies, three sites

   Resolution walks scopes innermost-first; within a scope a named-site
   override beats the scope default.  The first scope that pins the site
   (by name or by default) wins, so an inner ``policy_scope("bf16x6")``
   shadows an outer ``policy_scope(router=...)`` — plain lexical scoping.

Sites are just strings.  Model code tags its matmuls ("attn", "ffn", "ssm",
"router", "lm_head", ...); a site that no tier names falls through to the
nearest default.  ``resolve(site)`` returns a concrete ``TcecPolicy``.

Thread-safety:  the scope stacks live in ``contextvars`` (per-thread,
async-safe).  PyTorch runs eagerly, so every call resolves against the scope
active at that moment.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

from .policy import TcecPolicy, get_policy

__all__ = [
    "PolicyResolver", "policy_scope", "policy_defaults", "resolve",
    "resolve_policy", "set_global_default", "default_resolver", "DEFAULT_KEY",
]

PolicyLike = Union[str, TcecPolicy]

# Key under which a site-defaults mapping carries its bulk default.
DEFAULT_KEY = "default"


@dataclasses.dataclass(frozen=True)
class _Scope:
    default: Optional[TcecPolicy]
    overrides: Tuple[Tuple[str, TcecPolicy], ...]

    def lookup(self, site: Optional[str]) -> Optional[TcecPolicy]:
        if site is not None:
            for name, pol in self.overrides:
                if name == site:
                    return pol
        return self.default


class PolicyResolver:
    """Hierarchical site->policy resolution (global -> defaults -> scopes)."""

    def __init__(self, global_default: PolicyLike = "bf16x1"):
        self._global_default = get_policy(global_default)
        self._scopes: contextvars.ContextVar[Tuple[_Scope, ...]] = \
            contextvars.ContextVar("repro_policy_scopes", default=())
        self._defaults: contextvars.ContextVar[
            Tuple[Mapping[str, TcecPolicy], ...]] = \
            contextvars.ContextVar("repro_policy_defaults", default=())

    # -- resolution ---------------------------------------------------------

    def resolve(self, site: Optional[str] = None) -> TcecPolicy:
        """Innermost scope that pins ``site`` wins; then config defaults;
        then the global default."""
        for scope in reversed(self._scopes.get()):
            pol = scope.lookup(site)
            if pol is not None:
                return pol
        for mapping in reversed(self._defaults.get()):
            if site is not None and site in mapping:
                return mapping[site]
            if DEFAULT_KEY in mapping:
                return mapping[DEFAULT_KEY]
        return self._global_default

    # -- tiers --------------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, default: Optional[PolicyLike] = None,
              **overrides: PolicyLike):
        if default is None and not overrides:
            raise ValueError(
                "policy_scope needs a default policy and/or site overrides")
        new = _Scope(
            default=None if default is None else get_policy(default),
            overrides=tuple((site, get_policy(p))
                            for site, p in overrides.items()))
        token = self._scopes.set(self._scopes.get() + (new,))
        try:
            yield new
        finally:
            self._scopes.reset(token)

    @contextlib.contextmanager
    def defaults(self, site_policies: Mapping[str, PolicyLike]):
        """Install low-priority site defaults (config tier).  Any active or
        future ``policy_scope`` beats these."""
        resolved: Dict[str, TcecPolicy] = {
            site: get_policy(p) for site, p in site_policies.items()}
        token = self._defaults.set(self._defaults.get() + (resolved,))
        try:
            yield resolved
        finally:
            self._defaults.reset(token)

    def set_global_default(self, policy: PolicyLike) -> None:
        self._global_default = get_policy(policy)

    @property
    def global_default(self) -> TcecPolicy:
        return self._global_default


# Process-wide resolver; scope state is still per-thread via contextvars.
_RESOLVER = PolicyResolver()


def default_resolver() -> PolicyResolver:
    return _RESOLVER


def policy_scope(default: Optional[PolicyLike] = None, **overrides: PolicyLike):
    """Scoped policy selection: ``policy_scope("bf16x6")`` pins everything,
    ``policy_scope(lm_head="bf16x6", router="bf16x3")`` pins named sites.
    Unknown policy names raise immediately (fail-fast at scope entry)."""
    return _RESOLVER.scope(default, **overrides)


def policy_defaults(site_policies: Mapping[str, PolicyLike]):
    """Config-tier defaults: below every ``policy_scope``.  The mapping may
    carry per-site entries plus a bulk default under ``DEFAULT_KEY``."""
    return _RESOLVER.defaults(site_policies)


def resolve(site: Optional[str] = None) -> TcecPolicy:
    """Resolve the policy for a tagged site from the active context."""
    return _RESOLVER.resolve(site)


def resolve_policy(policy: Optional[PolicyLike] = None,
                   site: Optional[str] = None) -> TcecPolicy:
    """Explicit-or-context helper: an explicit ``policy`` argument wins;
    otherwise resolve ``site`` from the active context."""
    if policy is not None:
        return get_policy(policy)
    return _RESOLVER.resolve(site)


def set_global_default(policy: PolicyLike) -> None:
    """Set the process-wide fallback policy (tier 1)."""
    _RESOLVER.set_global_default(policy)
