"""Core numerics of the port: policies, scoped resolution, bf16 splits and
the split twin contraction (counterparts of ``repro.core``)."""
from .context import (policy_defaults, policy_scope, resolve, resolve_policy,
                      set_global_default)
from .policy import (PRESETS, SCHEDULES, TcecPolicy, get_policy,
                     register_policy, registered_policies, unregister_policy)

__all__ = [
    "policy_defaults", "policy_scope", "resolve", "resolve_policy",
    "set_global_default", "PRESETS", "SCHEDULES", "TcecPolicy", "get_policy",
    "register_policy", "registered_policies", "unregister_policy",
]
