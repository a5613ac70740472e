"""Plan search: analytic predict -> optional measure -> persist
(counterpart of ``repro.tune.tuner``, ``matmul_plan`` only).

For a ``(shape, policy, site)`` key the tuner enumerates feasible
candidates (``space``), ranks them with the analytic model (``model``), and
in ``measure`` mode times the top-K on the card and persists the winner in
the plan cache (``cache``).

Modes (``REPRO_TUNE``, overridable with the ``tune_mode`` context manager):

  * ``off``      — ``matmul_plan`` returns ``None``; callers use the
                   kernel's default tile.
  * ``analytic`` — the default.  A pure function of (shape, policy, chip
                   spec): no clocks, no disk, identical plans in every
                   process.
  * ``measure``  — the analytic ranking refined by timing the top-K
                   (``REPRO_TUNE_TOPK``, default 4) with CUDA events on the
                   card; winners are read from / written to the disk cache.
                   It needs a card and raises without one: it never times
                   a plain version.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policy import TcecPolicy, get_policy
from repro_torch.core.roofline import active_chip
from . import model, space
from .cache import PLANS, cache_dir, plan_cache

__all__ = ["MatmulPlan", "matmul_plan", "mode", "tune_mode", "MODES"]

MODES = ("off", "analytic", "measure")

_MODE_OVERRIDE: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("repro_torch_tune_mode", default=None)


def mode() -> str:
    """The active tuner mode (context override > ``REPRO_TUNE`` > analytic)."""
    override = _MODE_OVERRIDE.get()
    if override is not None:
        return override
    env = os.environ.get("REPRO_TUNE", "analytic").lower()
    if env not in MODES:
        raise ValueError(f"REPRO_TUNE={env!r} is not one of {MODES}")
    return env


@contextlib.contextmanager
def tune_mode(value: str):
    """Scoped mode override: ``with tune_mode("off"): ...``."""
    if value not in MODES:
        raise ValueError(f"tune mode must be one of {MODES}, got {value!r}")
    token = _MODE_OVERRIDE.set(value)
    try:
        yield
    finally:
        _MODE_OVERRIDE.reset(token)


def _topk() -> int:
    return max(1, int(os.environ.get("REPRO_TUNE_TOPK", "4")))


def _policy_key(pol: TcecPolicy) -> str:
    return f"p{pol.passes}-{pol.backend}-{pol.fragment_gen}-{pol.kernel}"


def _require_card():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "REPRO_TUNE=measure times the CUDA kernels and needs an NVIDIA "
            "card; use 'analytic' or 'off' without one")
    return torch


def _backend_key() -> str:
    """What a measured plan depends on besides the chip spec: the card's
    name, the torch version and the CUDA version."""
    torch = _require_card()
    return (f"{torch.cuda.get_device_name(0)}-torch{torch.__version__}"
            f"-cuda{torch.version.cuda}")


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    block: Tuple[int, int, int]
    variant: str
    predicted_us: float
    measured_us: Optional[float] = None
    source: str = "analytic"       # "analytic" | "measured"
    #: Every candidate the measure tier timed, as (variant, block, µs).
    trials: Tuple[Tuple[str, Tuple[int, int, int], float], ...] = ()

    def to_dict(self) -> Dict:
        return {"block": list(self.block), "variant": self.variant,
                "predicted_us": self.predicted_us,
                "measured_us": self.measured_us, "source": self.source,
                "trials": [[v, list(b), t] for v, b, t in self.trials]}

    @classmethod
    def from_dict(cls, d: Dict) -> "MatmulPlan":
        return cls(tuple(d["block"]), d["variant"], d["predicted_us"],
                   d.get("measured_us"), d.get("source", "analytic"),
                   tuple((v, tuple(b), t) for v, b, t in d.get("trials", ())))


# ---------------------------------------------------------------------------
# Measurement on the card (the refine tier)
# ---------------------------------------------------------------------------

def _time_call(fn, repeats: int = 5) -> float:
    """Best device time of ``fn()`` in microseconds over ``repeats`` calls,
    each between two CUDA events; the first call is discarded."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best


def _measure_matmul(m: int, n: int, k: int, batch: int, rhs_batched: bool,
                    cand: space.MatmulCandidate, pol: TcecPolicy) -> float:
    """Microseconds of one call of the candidate's kernel entry point on
    seeded normal inputs (the whole call: host split and guard included)."""
    torch = _require_card()
    from repro_torch.kernels import tcec_matmul as km
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn((m, k) if batch == 1 else (batch, m, k), generator=gen,
                    device=dev)
    b = torch.randn((batch, k, n) if batch > 1 and rhs_batched else (k, n),
                    generator=gen, device=dev)
    fn = {"fused": km.tcec_matmul_pallas, "vpu": km.tcec_matmul_pallas,
          "staged": km.tcec_matmul_staged,
          "staged_db": km.tcec_matmul_staged_db}[cand.variant]
    return _time_call(lambda: fn(a, b, pol, cand.block))


# ---------------------------------------------------------------------------
# The plan search
# ---------------------------------------------------------------------------

def _search(key: str, scored: List[Tuple[float, space.MatmulCandidate]],
            measure_fn) -> Optional[MatmulPlan]:
    """predict -> measure -> persist.  ``scored`` is [(predicted_seconds,
    candidate)]; ties break on the candidate's repr, so the ranking is
    total and process-independent."""
    scored = sorted(scored, key=lambda sc: (sc[0], repr(sc[1])))
    if not scored:
        return None
    if mode() == "analytic":
        pred, cand = scored[0]
        return MatmulPlan(cand.block, cand.variant, pred * 1e6)
    cache = plan_cache(active_chip().name, _backend_key())
    hit = cache.get(key)
    if hit is not None and hit.get("source") == "measured":
        return MatmulPlan.from_dict(hit)
    best, trials = None, []
    for pred, cand in scored[:_topk()]:
        t_us = measure_fn(cand)
        trials.append((cand.variant, cand.block, t_us))
        if best is None or t_us < best[0]:
            best = (t_us, pred, cand)
    t_us, pred, cand = best
    plan = MatmulPlan(cand.block, cand.variant, pred * 1e6, t_us, "measured",
                      tuple(trials))
    cache.put(key, plan.to_dict(), persist=True)
    return plan


def matmul_plan(m: int, n: int, k: int, *,
                policy: TcecPolicy | str,
                batch: int = 1, rhs_batched: bool = True,
                site: Optional[str] = None,
                variants: Optional[Sequence[str]] = None
                ) -> Optional[MatmulPlan]:
    """The plan for one matmul site, or ``None`` when tuning is off.

    ``variants`` restricts the search space (``("fused",)`` for a caller
    whose kernel is the on-the-fly data flow); ``tcec_matmul_auto``
    searches all of them.  The plan of a key is kept for the process (until
    ``clear_plan_cache()``), so only its first call scores candidates.
    """
    tier = mode()
    if tier == "off":
        return None
    pol = get_policy(policy)
    key = (f"matmul|{site or '-'}|b{batch}|m{m}|n{n}|k{k}"
           f"|rb{int(rhs_batched)}|{_policy_key(pol)}"
           f"|v{','.join(variants or space.matmul_variants(pol))}")
    memo = (tier, active_chip().name, str(cache_dir()), key)
    if memo in PLANS:
        return PLANS[memo]
    cands = space.matmul_candidates(m, n, k, pol, variants=variants)
    scored = [(model.score_matmul(m, n, k, batch, c, pol, rhs_batched), c)
              for c in cands]
    plan = _search(key, scored, lambda c: _measure_matmul(
        m, n, k, batch, rhs_batched, c, pol))
    PLANS[memo] = plan
    return plan
