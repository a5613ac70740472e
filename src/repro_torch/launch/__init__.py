"""Launchers of the port (counterpart of ``repro.launch``)."""
import contextlib


def add_policy_args(ap) -> None:
    """Shared --policy / --site-policy CLI surface for the launchers."""
    ap.add_argument("--policy", default=None,
                    help="TCEC policy scoped over the whole run (any "
                         "registered name, e.g. bf16x6_pallas)")
    ap.add_argument("--site-policy", action="append", default=[],
                    metavar="SITE=POLICY",
                    help="per-site policy override (repeatable), e.g. "
                         "--site-policy lm_head=bf16x6")


def policy_scope_from_args(args):
    """Build the policy_scope the launcher flags describe (or a no-op)."""
    from repro_torch.core.context import policy_scope
    overrides = {}
    for kv in args.site_policy:
        site, _, name = kv.partition("=")
        if not site or not name:
            raise SystemExit(f"--site-policy expects SITE=POLICY, got {kv!r}")
        overrides[site] = name
    if args.policy is None and not overrides:
        return contextlib.nullcontext()
    return policy_scope(args.policy, **overrides)
